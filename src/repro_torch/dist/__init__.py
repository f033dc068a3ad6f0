"""Counterpart of repro.dist: the partition-aware device layout."""
