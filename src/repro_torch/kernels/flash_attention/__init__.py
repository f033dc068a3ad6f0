"""Counterpart of repro.kernels.flash_attention."""
