"""PyTorch/CUDA port of the Jet partitioner (counterpart of the repro package)."""
