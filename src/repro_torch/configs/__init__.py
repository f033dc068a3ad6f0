"""Architecture registry of the port (counterpart of ``repro.configs``).

Each arch module exports ``ARCH`` (see ``configs/base.py`` for the schema).
Only the archs whose models the port has are registered; the rest of the
reference's registry waits for later slices (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "fm": "repro_torch.configs.fm_cfg",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r} in the port; ported: {ARCH_IDS}. The "
            "reference's other archs are still to be ported (ROADMAP.md, "
            "Queue 1)")
    return import_module(_MODULES[arch_id]).ARCH
