"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C launcher, compiled for
``sm_90a`` into a shared library under ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of every ``.cu`` and ``.cuh`` file in the
source's directory (flash_attention's backward lives beside its
forward), so an edited source or header is never served a stale library.
Nothing is built at import time: :func:`load` builds at first use, and
:func:`build` starts one ``nvcc`` per source, all at once.

The libraries are the port's only compile that outlives a process, so
they are its compile cache: :func:`enable_compile_cache` points the
library directory elsewhere (a directory that several processes share),
and :func:`cache_stats` counts ``cache_misses`` (``nvcc`` builds) and
``cache_hits`` (first loads that find the library already on disk).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
KERNELS = ("jet_gain", "segment_reduce", "fm_interaction",
           "flash_attention", "flash_attention_bwd")  # every kernel source
# a source that lives in another kernel's directory
_DIRS = {"flash_attention_bwd": "flash_attention"}
BUILD_DIR = _KERNELS / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


class CompileCacheStats:
    """Hit and miss counts of the kernel-library cache in this process."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def add(self, key: str) -> None:
        self.counts[key] = self.counts.get(key, 0) + 1

    def snapshot(self) -> dict[str, int]:
        return dict(self.counts)

    @staticmethod
    def delta(before: dict, after: dict) -> dict[str, int]:
        return {k: after.get(k, 0) - before.get(k, 0)
                for k in set(before) | set(after)}


_CACHE_STATS = CompileCacheStats()


def cache_stats() -> CompileCacheStats:
    """The process-wide hit/miss counts."""
    return _CACHE_STATS


def enable_compile_cache(cache_dir) -> CompileCacheStats:
    """Build and load the kernel libraries in ``cache_dir`` from now on.

    Libraries stay named by the hash of their sources, so a directory
    shared by several processes (or checkouts) never serves a stale one;
    libraries this process has already loaded stay loaded.  Returns the
    hit/miss counts.
    """
    global BUILD_DIR
    BUILD_DIR = Path(cache_dir)
    return _CACHE_STATS


def source(name: str) -> Path:
    return _KERNELS / _DIRS.get(name, name) / f"{name}.cu"


def _library(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(source(name).parent.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def build(names=KERNELS) -> None:
    """Compile every named kernel that has no library yet, in parallel."""
    todo = [n for n in names if not _library(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = _library(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, _library(name))
            _CACHE_STATS.add("cache_misses")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library(name)
        if path.exists():
            _CACHE_STATS.add("cache_hits")
        else:
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
