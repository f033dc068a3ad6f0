"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``launch_counts`` holds, per kernel name, how many times its wrapper has
launched the CUDA kernel in this process.  Only a launch adds to it, so a
run that resets it and reads it afterwards can show which kernels it went
through.

Each kernel and direction is also a ``torch.library.custom_op`` in the
``repro_torch`` namespace, named as its ``launch_counts`` key: the plain
version is its CPU implementation, the ``ctypes`` launch its CUDA one, and
a shape function its fake one, so a dispatch mode sees one call where the
kernel runs (``launch/op_cost.py``) and fake tensors pass through it.
``op_costs`` maps each op's name to its cost formula, a function of the
op's arguments giving the ``flops``, ``transcendentals`` and ``bytes`` of
one call: the work a kernel must do on those shapes, whatever implements
it, and what a bound in ``chip_smoke.py`` is computed from.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable

launch_counts: Counter = Counter()
op_costs: dict[str, Callable[..., dict]] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def cost(flops: int = 0, nbytes: int = 0, transcendentals: int = 0) -> dict:
    """One call's cost, as every formula in ``op_costs`` returns it."""
    return {"flops": int(flops), "transcendentals": int(transcendentals),
            "bytes": int(nbytes)}


def nbytes(*tensors) -> int:
    """Bytes of ``tensors`` at their shapes and types, each read or
    written once."""
    return sum(t.numel() * t.element_size() for t in tensors)
