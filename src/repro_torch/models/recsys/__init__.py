"""Counterpart of repro.models.recsys."""
