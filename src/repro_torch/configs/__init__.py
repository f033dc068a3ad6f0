"""Architecture registry of the port (counterpart of ``repro.configs``).

Each arch module exports ``ARCH`` (see ``configs/base.py`` for the schema).
Only the archs whose models the port has are registered: every LM and FM;
the GNN archs wait for a later slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b",
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
