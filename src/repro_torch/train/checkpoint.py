"""Atomic checkpoints (counterpart of ``repro.train.checkpoint``).

Format, the reference's: a directory ``step_<N:08d>/`` holding
``arrays.npz`` (the tree's leaves keyed by their ``jax.tree_util`` key
path, ``['params']/['layers']/[0]/['w']``) and ``manifest.json`` (step,
time, process count, shapes, dtypes, extra).  Writes go to
``.tmp-<pid>`` and then ``os.replace``: a crash mid-write never corrupts
the latest checkpoint.  The keys are the reference's, so a checkpoint it
wrote restores into the port's tree of the same structure, and the other
way round.  One process writes (``process_count`` is 1).
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch import tree


def _flatten(t) -> dict[str, np.ndarray]:
    return {tree.keystr(path): leaf.detach().cpu().numpy()
            for path, leaf in tree.flatten_with_path(t)}


def save(ckpt_dir: str, step: int, t, extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(t)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "process_count": 1,
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and ".tmp-" not in d]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target):
    """Rebuild a ``target``-shaped tree from disk: each leaf takes the
    saved array of its key path, with the target leaf's dtype and device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for kpath, leaf in tree.flatten_with_path(target):
            key = tree.keystr(kpath)
            arr = data[key]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"{key}: saved shape {arr.shape}, target "
                                 f"{tuple(leaf.shape)}")
            new_leaves.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
    return tree.unflatten(target, new_leaves)


def read_manifest(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)
