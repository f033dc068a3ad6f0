"""Counterpart of repro.kernels.fm_interaction."""
