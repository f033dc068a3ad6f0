"""Counterpart of repro.core."""
