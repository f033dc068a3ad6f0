"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C launcher, compiled for
``sm_90a`` into a shared library under ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the source so an edited source is never
served a stale library.  Nothing is built at import time: :func:`load`
builds at first use, and :func:`build` starts one ``nvcc`` per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
KERNELS = ("jet_gain", "segment_reduce")  # every kernel source of the port
BUILD_DIR = _KERNELS / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def source(name: str) -> Path:
    return _KERNELS / name / f"{name}.cu"


def _library(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


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
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(_library(name)))
    return lib
