"""LM transformer, dense GQA and hybrid local/global (Gemma-3 style).

Counterpart of ``repro.models.transformer`` for ``attn_kind="gqa"`` without
MoE; MLA and MoE raise ``NotImplementedError`` (ROADMAP.md, Queue 1).
Parameters are a dict of tensors in the reference's layout: per-layer
weights stacked on a leading (L,) axis, ``x @ w`` with ``w`` (d_in, d_out),
tied embeddings.  The layer scan is a Python loop.

prefill : the flash_attention kernel (``kernels/flash_attention``) where the
          reference calls ``chunked_attention``; its plain version on the
          CPU.  Only the last token's logits are formed.
decode  : a KV cache per layer, attention by ``models/attention.py``
          ``decode_attention``.  The new token's k and v are written into
          the cache tensors in place (the reference returns new arrays).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_rope, dense_init, embed_init, rmsnorm, swiglu,
)


@dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    vocab: int = 1024
    attn_kind: str = "gqa"        # gqa | mla
    window: int = 0               # sliding window size for local layers
    local_ratio: int = 0          # gemma3: 5 (5 local : 1 global)
    kv_lora_rank: int = 0         # MLA
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    moe: bool = False
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0           # >1: group-local dispatch (GShard style)
    aux_loss_coef: float = 0.001
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024
    seq_parallel: bool = False    # Megatron SP (a mesh option of the reference)
    grad_cast: bool = False       # bf16 activation cotangents across layers
    # which serve shapes are valid (long_* skipped for pure full-attention)
    supports_long_context: bool = False

    @property
    def qk_dim(self) -> int:
        return (self.qk_nope_dim + self.qk_rope_dim
                if self.attn_kind == "mla" else self.head_dim)

    def window_pattern(self):
        """(L,) int32 — per-layer sliding window (0 = global)."""
        if self.local_ratio <= 0 or self.window <= 0:
            return torch.zeros((self.n_layers,), dtype=torch.int32)
        pat = np.arange(self.n_layers) % (self.local_ratio + 1)
        return torch.from_numpy(
            np.where(pat < self.local_ratio, self.window, 0).astype(np.int32))

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS roofline terms)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        if self.attn_kind == "mla":
            a = (d * self.n_heads * self.qk_dim
                 + d * (self.kv_lora_rank + self.qk_rope_dim)
                 + self.kv_lora_rank * self.n_heads
                 * (self.qk_nope_dim + self.v_head_dim)
                 + self.n_heads * self.v_head_dim * d)
        else:
            a = (d * self.n_heads * self.head_dim
                 + 2 * d * self.n_kv_heads * self.head_dim
                 + self.n_heads * self.head_dim * d)
        if self.moe:
            f = (d * self.n_experts
                 + 3 * self.n_experts * d * self.d_expert
                 + 3 * d * self.n_shared * self.d_expert)
        else:
            f = 3 * d * self.d_ff
        return emb + L * (a + f + 2 * d) + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        inactive = (self.n_experts - self.top_k)
        return full - L * 3 * inactive * d * self.d_expert


def _dt(cfg: LMConfig):
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: LMConfig) -> None:
    if cfg.attn_kind != "gqa" or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: attn_kind={cfg.attn_kind!r}, moe={cfg.moe} — the "
            "port has only dense GQA so far; MLA and MoE are still to be "
            "ported (ROADMAP.md, Queue 1)")


def init_params(cfg: LMConfig, gen: torch.Generator, device=None):
    """Stacked-layer parameters, drawn on ``gen``'s device, then moved to
    ``device`` (default: there)."""
    _check_ported(cfg)
    device = gen.device if device is None else torch.device(device)
    dt, d, L = _dt(cfg), cfg.d_model, cfg.n_layers
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layer = {}
    for name, d_in, d_out in (("wq", d, hd), ("wk", d, kvd), ("wv", d, kvd),
                              ("wo", hd, d), ("w_gate", d, cfg.d_ff),
                              ("w_up", d, cfg.d_ff), ("w_down", cfg.d_ff, d)):
        layer[name] = dense_init(gen, d_in, d_out, dt, lead=(L,)).to(device)
    layer["ln1"] = torch.ones((L, d), device=device)
    layer["ln2"] = torch.ones((L, d), device=device)
    return {
        "embed": embed_init(gen, cfg.vocab, d, dt).to(device),
        "layers": layer,
        "final_ln": torch.ones((d,), device=device),
    }


def _layer(params, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


def _logits(params, x):
    """(..., D) final hidden -> (..., V) float32 logits (tied embeddings)."""
    return x.float() @ params["embed"].float().T


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _gqa_attention(cfg: LMConfig, lp, x, window: int, positions):
    """x (B, S, D) -> (attention output (B, S, D), (k, v) (B, Hkv, S, Dh))."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"]).reshape(b, s, h, dh).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(b, s, hkv, dh).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(b, s, hkv, dh).transpose(1, 2).contiguous()
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    o = flash.flash_attention(q, k, v, causal=True, window=window)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return o @ lp["wo"], (k, v)


def _trunk(cfg: LMConfig, params, tokens, cache=None):
    """Embed and run every layer over the whole sequence; the k and v of
    layer i go to ``cache["k"][i]``, ``cache["v"][i]`` when a cache is
    given.  Returns the last hidden states (B, S, D), before the final
    norm."""
    _check_ported(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i, window in enumerate(cfg.window_pattern().tolist()):
        lp = _layer(params, i)
        o, (k, v) = _gqa_attention(cfg, lp, rmsnorm(x, lp["ln1"]), window,
                                   positions)
        x = x + o
        if cache is not None:
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
        x = x + swiglu(rmsnorm(x, lp["ln2"]), lp["w_gate"], lp["w_up"],
                       lp["w_down"])
    return x


def forward(cfg: LMConfig, params, tokens):
    """tokens (B, S) -> (logits (B, S, V) float32, aux_loss)."""
    x = _trunk(cfg, params, tokens)
    return _logits(params, rmsnorm(x, params["final_ln"])), 0.0


def prefill(cfg: LMConfig, params, tokens, max_len: int | None = None):
    """Prefill pass: (last-token logits (B, V), KV cache at len S).

    Never forms the (B, S, V) logits.  The cache holds ``max_len`` (default
    S) positions per layer.
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    x = _trunk(cfg, params, tokens, cache)
    cache["len"] = s
    return _logits(params, rmsnorm(x[:, -1], params["final_ln"])), cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    _check_ported(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=_dt(cfg), device=device),
        "v": torch.zeros(shape, dtype=_dt(cfg), device=device),
        "len": 0,
    }


def _gqa_decode_layer(cfg: LMConfig, lp, h, kc, vc, pos: int, window: int):
    """One layer's attention for one new token at position ``pos``; writes
    its k, v into ``kc``, ``vc`` (B, Hkv, S, Dh) in place."""
    b = h.shape[0]
    hds, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ lp["wq"]).reshape(b, hds, 1, dh)
    k = (h @ lp["wk"]).reshape(b, hkv, 1, dh)
    v = (h @ lp["wv"]).reshape(b, hkv, 1, dh)
    posb = torch.full((b, 1), pos, device=h.device)
    q = apply_rope(q, posb[:, None], cfg.rope_theta)
    k = apply_rope(k, posb[:, None], cfg.rope_theta)
    kc[:, :, pos] = k[:, :, 0]
    vc[:, :, pos] = v[:, :, 0]
    o = attn.decode_attention(q, kc, vc, pos + 1, window=window)
    return o.reshape(b, hds * dh) @ lp["wo"], kc, vc


def decode_step(cfg: LMConfig, params, cache, tokens):
    """One greedy decode step. tokens (B,) -> (logits (B, V), cache).

    The returned cache shares the k, v tensors of ``cache``, which hold the
    new token's entries at position ``cache["len"]``.
    """
    _check_ported(cfg)
    pos = int(cache["len"])
    if pos >= cache["k"].shape[3]:
        raise ValueError(f"the cache is full: {pos} of "
                         f"{cache['k'].shape[3]} positions used")
    x = params["embed"][tokens.long()]
    for i, window in enumerate(cfg.window_pattern().tolist()):
        lp = _layer(params, i)
        o, _, _ = _gqa_decode_layer(cfg, lp, rmsnorm(x, lp["ln1"]),
                                    cache["k"][i], cache["v"][i], pos, window)
        x = x + o
        x = x + swiglu(rmsnorm(x, lp["ln2"]), lp["w_gate"], lp["w_up"],
                       lp["w_down"])
    logits = _logits(params, rmsnorm(x, params["final_ln"]))
    return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}
