"""Counterpart of repro.train: checkpoints and the fault-tolerant loop."""
