"""Counterpart of repro.models."""
