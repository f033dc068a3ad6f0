"""Where the tensor-core flash_attention kernel spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablation

Builds ``flash_attention.cu`` as it is and in variants that each change one
thing, then times every build with CUDA events at Gemma-3 1B's global and
local prefill layers (B=4, H=4, Hkv=1, S=4096, D=256, bfloat16, causal;
window 512 for the local one) and prints each time and its error against
the plain version, as a share of the bfloat16 tolerance of the port's tests
(1e-5 + 1e-2 * |plain|, ``tests/torch_parity.py``).  Variants that drop
work compute a wrong result on purpose: their time says what that work
costs.  Builds and times run in turns (all variants, then all again in
reverse order) on one card.  Needs the CUDA toolkit and a card; nothing in
the port imports this module.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     flash_attention_ref)

SOURCE = _build.source("flash_attention")
OUT = _build.BUILD_DIR / "ablation"

_LO = """        mma<T>(acc[2 * dp], lo, b[0], b[1]);
        mma<T>(acc[2 * dp + 1], lo, b[2], b[3]);"""
_QK = """        mma<T>(s[2 * np], a, b[0], b[1]);
        mma<T>(s[2 * np + 1], a, b[2], b[3]);"""
_EXP = "exp2f((s[j][e] - m_safe) * kLog2e)"

# name -> (what it changes, [(text of the kernel, replacement)])
VARIANTS = {
    "kernel": ("as it is", []),
    "no_p_lo": ("drops the P_lo V product (wrong result)", [(_LO, "")]),
    "no_qk": ("drops the q k^T products (wrong result)", [(_QK, "")]),
    "no_pv": ("drops both P V products (wrong result)",
              [("for (int kk = 0; kk < BK / 16; ++kk) {",
                "for (int kk = 0; kk < 0; ++kk) {")]),
    "no_copies": ("copies only the first kv tile (wrong result)",
                  [("if (kt + 1 < kt_end) {  // the next tile's copy",
                    "if (false) {  // the next tile's copy")]),
    "no_exp": ("P = S - m without the exponential (wrong result)",
               [(_EXP, "(s[j][e] - m_safe)")]),
    "expf": ("expf(S - m) in place of exp2f((S - m) log2 e)",
             [(_EXP, "expf(s[j][e] - m_safe)")]),
    "always_rescale": ("rescales acc even when every factor is 1",
                       [("if (__any_sync(0xffffffffu, corr[0] != 1.f || "
                         "corr[1] != 1.f)) {", "{")]),
    "warps8": ("8 warps, 128 query rows per block",
               [("kTcWarps = 4;", "kTcWarps = 8;")]),
    "bk64": ("kv tiles of 64 keys at D = 256",
             [("launch_tc<T, 256, 32>", "launch_tc<T, 256, 64>")]),
}


def build(names) -> dict:
    """The C launcher of each variant, built in parallel."""
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name][1]:
            if old not in src:
                raise RuntimeError(f"{name}: the kernel has no {old!r}")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def error_ratio(got, want) -> float:
    """max |got - want| / (1e-5 + 1e-2 |want|): at most 1 passes."""
    w = want.float()
    return float(((got.float() - w).abs() / (1e-5 + 1e-2 * w.abs())).max())


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    fns = build(names)
    dev = torch.device("cuda")
    b, h, hkv, s, d = 4, 4, 1, 4096, 256
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for window in (0, 512):
        gen = torch.Generator(device=dev).manual_seed(window)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        want = flash_attention_ref(q, k, v, True, window)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None, b, h, hkv, s, s, d, d, 1, window, 0, 1, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        times, ratio = {n: [] for n in names}, {}
        for name in names + names[::-1]:
            call(fns[name])
            torch.cuda.synchronize()
            ratio[name] = error_ratio(out, want)
            times[name].append(time_ms(lambda: call(fns[name])))
        sdpa = F.scaled_dot_product_attention
        if window:
            allowed = ~attention_mask(s, s, True, window, 0, dev)
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=allowed,
                                          enable_gqa=True))
        else:
            lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True))
        layer = f"local (window {window})" if window else "global"
        print(f"{layer} layer (4, 4, 4096, 256) bfloat16; SDPA {lib_ms:.4f} "
              "ms")
        for name in names:
            print(f"  {name:15s} {min(times[name]):.4f} ms  (runs "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}; error "
                  f"ratio {ratio[name]:.3g}): {VARIANTS[name][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
