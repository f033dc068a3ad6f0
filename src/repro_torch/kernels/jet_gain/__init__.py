"""Counterpart of repro.kernels.jet_gain."""
