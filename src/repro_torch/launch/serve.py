"""Serving launcher: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 4 --prompt-len 32 --gen 16 [--device cuda|cpu]

The counterpart of ``repro.launch.serve``, with the same flags and report,
plus ``--device`` (default ``cuda``, which needs a card).  Like the
reference it runs the arch's smoke config; :func:`generate` is the serving
loop for any config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer as tf


def generate(cfg: tf.LMConfig, params, prompts, steps: int,
             max_len: int | None = None, keep_logits: bool = False) -> dict:
    """Prefill ``prompts`` (B, S), then ``steps`` greedy decode steps.

    Returns ``tokens`` (B, steps + 1): the argmax after the prefill and
    after each step; ``prefill_s`` and ``decode_s``, host seconds that end
    in a device sync; with ``keep_logits``, ``logits``, the (B, V) float32
    logits behind each token.  The cache holds ``max_len`` positions
    (default S + steps).
    """
    device = prompts.device
    max_len = max_len or prompts.shape[1] + steps
    t0 = time.perf_counter()
    logits, cache = tf.prefill(cfg, params, prompts, max_len=max_len)
    tokens = torch.argmax(logits, -1)
    synchronize(device)
    prefill_s = time.perf_counter() - t0
    out, kept = [tokens], [logits] if keep_logits else []
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = tf.decode_step(cfg, params, cache, tokens)
        tokens = torch.argmax(logits, -1)
        out.append(tokens)
        if keep_logits:
            kept.append(logits)
    synchronize(device)
    result = {"tokens": torch.stack(out, 1), "prefill_s": prefill_s,
              "decode_s": time.perf_counter() - t0}
    if keep_logits:
        result["logits"] = kept
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b",
                    choices=[a for a in ARCH_IDS
                             if get_arch(a).family == "lm"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.smoke
    params = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32)).to(device)
    steps = args.gen - 1
    res = generate(cfg, params, prompts, steps,
                   max_len=args.prompt_len + args.gen)

    gen = res["tokens"].cpu().numpy()
    t_decode = res["decode_s"]
    print(f"[serve] arch={args.arch} (smoke config) batch={args.batch}")
    print(f"  prefill {args.prompt_len} tokens: {res['prefill_s']*1e3:.1f} ms")
    print(f"  decode {steps} steps: {t_decode*1e3:.1f} ms "
          f"({t_decode/max(steps, 1)*1e3:.1f} ms/token)")
    print(f"  generated ids[0]: {gen[0][:12]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
