"""Counterpart of repro.launch."""
