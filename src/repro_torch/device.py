"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run it on the CPU")
    return device


def synchronize(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
