"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``launch_counts`` holds, per kernel name, how many times its wrapper has
launched the CUDA kernel in this process.  Only a launch adds to it, so a
run that resets it and reads it afterwards can show which kernels it went
through.
"""
from __future__ import annotations

from collections import Counter

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
