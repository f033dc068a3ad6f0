"""Architecture registry of the port (counterpart of ``repro.configs``).

Each arch module exports ``ARCH`` (see ``configs/base.py`` for the schema).
Every arch of the reference's registry: the LMs, the four GNNs and FM.
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b",
    "schnet": "repro_torch.configs.schnet_cfg",
    "nequip": "repro_torch.configs.nequip_cfg",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "meshgraphnet": "repro_torch.configs.meshgraphnet_cfg",
    "fm": "repro_torch.configs.fm_cfg",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return import_module(_MODULES[arch_id]).ARCH
