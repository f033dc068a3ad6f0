"""Counterpart of repro.kernels.segment_reduce."""
