"""Counterpart of repro.data."""
