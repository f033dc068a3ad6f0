"""Counterpart of repro.models.gnn: the four GNN models."""
