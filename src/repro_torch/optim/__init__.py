"""Counterpart of repro.optim: AdamW and int8 gradient compression."""
