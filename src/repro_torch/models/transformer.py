"""LM transformer family: dense GQA, hybrid local/global (Gemma-3 style),
MLA + MoE (DeepSeek-V2 family).

Counterpart of ``repro.models.transformer``'s serving path.  Parameters are
a dict of tensors in the reference's layout: per-layer weights stacked on a
leading (L,) axis (the MoE experts' dict too), ``x @ w`` with ``w`` (d_in,
d_out), tied embeddings.  The layer scan is a Python loop.

prefill : the flash_attention kernel (``kernels/flash_attention``) where the
          reference calls ``chunked_attention``; its plain version on the
          CPU.  MLA's queries and keys are qk_nope + qk_rope wide and its
          values v_head_dim wide: the kernel takes both widths.  Only the
          last token's logits are formed.
decode  : GQA keeps a k, v cache per layer, attention by
          ``models/attention.py`` ``decode_attention``; MLA keeps the
          compressed c_kv and the roped k_rope per layer and attends in the
          c_kv space (the absorbed projection).  The new token's entries are
          written into the cache tensors in place (the reference returns new
          arrays).
MoE     : ``models/moe.py`` in place of the dense FFN, in plain PyTorch as
          the reference computes it outside any kernel.
training: ``loss_fn`` (the reference's sequence-chunked cross entropy) over
          ``hidden_states``.  Attention's gradient is flash_attention's
          backward kernel (the reference differentiates chunked_attention);
          the embedding lookup's is a segment_reduce sum
          (``models/gather.py``).  With ``cfg.remat`` each layer runs under
          ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
          with nothing saveable, and so does each CE chunk; no random op
          runs inside, so no RNG state is kept for the recompute.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.gather import embedding
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
        return torch.tensor(self.windows(), dtype=torch.int32)

    def windows(self) -> list[int]:
        """The per-layer windows of :meth:`window_pattern` as Python ints
        (the layer loops read them with no tensor op)."""
        if self.local_ratio <= 0 or self.window <= 0:
            return [0] * self.n_layers
        pat = np.arange(self.n_layers) % (self.local_ratio + 1)
        return np.where(pat < self.local_ratio, self.window, 0).tolist()

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


def tree_to(tree, device):
    """Nested dicts of tensors (parameters, caches' tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_params(cfg: LMConfig, gen: torch.Generator, device=None):
    """Stacked-layer parameters, drawn on ``gen``'s device, then moved to
    ``device`` (default: there).  MoE experts start equal within a layer,
    as the reference's ``moe_init`` draws them."""
    device = gen.device if device is None else torch.device(device)
    dt, d, L = _dt(cfg), cfg.d_model, cfg.n_layers
    h = cfg.n_heads
    if cfg.attn_kind == "mla":
        attn_shapes = (
            ("wq", d, h * cfg.qk_dim),
            ("w_dkv", d, cfg.kv_lora_rank + cfg.qk_rope_dim),
            ("w_ukv", cfg.kv_lora_rank,
             h * (cfg.qk_nope_dim + cfg.v_head_dim)),
            ("wo", h * cfg.v_head_dim, d))
    else:
        hd, kvd = h * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        attn_shapes = (("wq", d, hd), ("wk", d, kvd), ("wv", d, kvd),
                       ("wo", hd, d))
    ffn_shapes = () if cfg.moe else (
        ("w_gate", d, cfg.d_ff), ("w_up", d, cfg.d_ff),
        ("w_down", cfg.d_ff, d))
    layer = {}
    for name, d_in, d_out in attn_shapes + ffn_shapes:
        layer[name] = dense_init(gen, d_in, d_out, dt, lead=(L,)).to(device)
    if cfg.moe:
        layer["moe"] = tree_to(moe_lib.moe_init(
            gen, d, cfg.d_expert, cfg.n_experts, cfg.n_shared, dt,
            lead=(L,)), device)
    layer["ln1"] = torch.ones((L, d), device=device)
    layer["ln2"] = torch.ones((L, d), device=device)
    return {
        "embed": embed_init(gen, cfg.vocab, d, dt).to(device),
        "layers": layer,
        "final_ln": torch.ones((d,), device=device),
    }


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer(params, i: int) -> dict:
    return _index(params["layers"], i)


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


def _mla_attention(cfg: LMConfig, lp, x, window: int, positions):
    """x (B, S, D) -> (attention output (B, S, D), (ckv (B, S, r), k_rope
    (B, S, rope))).  k_rope is roped once with a single head and broadcast
    to the H heads; the cache keeps c_kv unroped and k_rope roped."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = (x @ lp["wq"]).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv_full = x @ lp["w_dkv"]
    ckv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    kv = (ckv @ lp["w_ukv"]).reshape(b, s, h, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None],
                        cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, None], positions[:, None], cfg.rope_theta)
    qh = torch.cat([q_nope.transpose(1, 2), q_rope], -1)
    kh = torch.cat([k_nope.transpose(1, 2), k_rope.expand(b, h, s, rope)],
                   -1)
    vh = v.transpose(1, 2).contiguous()
    o = flash.flash_attention(qh, kh, vh, causal=True, window=window)
    o = o.transpose(1, 2).reshape(b, s, h * dv)
    return o @ lp["wo"], (ckv, k_rope[:, 0])


def _ffn(cfg: LMConfig, lp, h, groups: int = 0):
    """The FFN of one layer on h (T, D) or (B, S, D): (output, MoE aux)."""
    if not cfg.moe:
        return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    y, aux = moe_lib.moe_apply(lp["moe"], h.reshape(-1, h.shape[-1]),
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               groups=groups)
    return y.reshape(h.shape), aux


def _block(cfg: LMConfig, lp, x, window: int, positions):
    """One layer: (x out, MoE aux, the attention's cache entries)."""
    attention = _mla_attention if cfg.attn_kind == "mla" else _gqa_attention
    o, kv = attention(cfg, lp, rmsnorm(x, lp["ln1"]), window, positions)
    x = x + o
    y, a = _ffn(cfg, lp, rmsnorm(x, lp["ln2"]), cfg.moe_groups)
    return x + y, a, kv


def _trunk(cfg: LMConfig, params, tokens, cache=None):
    """Embed and run every layer over the whole sequence; layer i's cache
    entries (GQA: k, v; MLA: ckv, krope) go to ``cache[...][i]`` when a
    cache is given.  Returns the last hidden states (B, S, D), before the
    final norm, and the sum of the layers' MoE aux losses.  With
    ``cfg.remat``, no cache and gradients on, each layer is checkpointed:
    only its input is kept, and the backward pass runs it again."""
    b, s = tokens.shape
    x = embedding(params["embed"], tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = 0.0
    for i, window in enumerate(cfg.windows()):
        lp = _layer(params, i)
        if remat:
            x, a, _ = checkpoint(_block, cfg, lp, x, window, positions,
                                 use_reentrant=False, preserve_rng_state=False)
        else:
            x, a, kv = _block(cfg, lp, x, window, positions)
            if cache is not None:
                for name, t in zip(names, kv):
                    cache[name][i, ..., :s, :] = t
        aux = aux + a
    return x, aux


def hidden_states(cfg: LMConfig, params, tokens):
    """Transformer trunk -> (final hidden (B, S, D) after the final norm,
    aux float32 scalar)."""
    x, aux = _trunk(cfg, params, tokens)
    return rmsnorm(x, params["final_ln"]), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


def _chunk_ce(xs, labels, embed_f):
    """(sum of the chunk's token losses, its count of labelled tokens): the
    (B, C, V) float32 logits are formed here and nowhere else."""
    logits = xs.float() @ embed_f.T
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != -1).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def loss_fn(cfg: LMConfig, params, batch, loss_chunk: int = 512):
    """Sequence-chunked cross entropy (the reference's): the (B, chunk, V)
    logits block is the only vocab-sized live tensor, and each chunk is
    checkpointed, so the backward pass forms it again.  Returns
    (ce + aux_loss_coef * aux, {"ce", "aux"})."""
    x, aux = hidden_states(cfg, params, batch["tokens"])
    b, s, d = x.shape
    labels = batch["labels"]
    c = min(loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the CE chunk "
                         f"{c}")
    embed_f = params["embed"].float()
    nll = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for j in range(s // c):
        part = (x[:, j * c:(j + 1) * c], labels[:, j * c:(j + 1) * c],
                embed_f)
        if torch.is_grad_enabled():
            n_j, c_j = checkpoint(_chunk_ce, *part, use_reentrant=False, preserve_rng_state=False)
        else:
            n_j, c_j = _chunk_ce(*part)
        nll = nll + n_j
        cnt = cnt + c_j
    ce = nll / torch.clamp(cnt, min=1.0)
    return ce + cfg.aux_loss_coef * aux, {"ce": ce, "aux": aux}


def forward(cfg: LMConfig, params, tokens):
    """tokens (B, S) -> (logits (B, S, V) float32, aux_loss)."""
    x, aux = _trunk(cfg, params, tokens)
    return _logits(params, rmsnorm(x, params["final_ln"])), aux


def prefill(cfg: LMConfig, params, tokens, max_len: int | None = None):
    """Prefill pass: (last-token logits (B, V), cache at len S).

    Never forms the (B, S, V) logits.  The cache holds ``max_len`` (default
    S) positions per layer.
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    x, _ = _trunk(cfg, params, tokens, cache)
    cache["len"] = s
    return _logits(params, rmsnorm(x[:, -1], params["final_ln"])), cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    """GQA: ``k``, ``v`` (L, B, Hkv, max_len, Dh); MLA: ``ckv`` (L, B,
    max_len, r) and ``krope`` (L, B, max_len, rope); ``len`` 0."""
    dt, L = _dt(cfg), cfg.n_layers
    if cfg.attn_kind == "mla":
        return {
            "ckv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank),
                               dtype=dt, device=device),
            "krope": torch.zeros((L, batch, max_len, cfg.qk_rope_dim),
                                 dtype=dt, device=device),
            "len": 0,
        }
    shape = (L, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
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
    return o.reshape(b, hds * dh) @ lp["wo"]


def _mla_decode_layer(cfg: LMConfig, lp, h, ckv_c, krope_c, pos: int):
    """Absorbed-projection MLA decode for one new token at ``pos``: W_uk is
    folded into the query and W_uv applied after attention, so attention
    runs over the compressed cache ckv (B, S, r) and krope (B, S, rope),
    into which the new entries are written in place.

    The reference's products take 16-bit operands with float32 sums; here
    the same tensors are rounded to the same types (q_abs and p to ckv's,
    q_rope to krope's, o_c to W_uv's) and multiplied in float32.
    """
    b = h.shape[0]
    hds, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = (h @ lp["wq"]).reshape(b, hds, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    posb = torch.full((b, 1), pos, device=h.device)
    q_rope = apply_rope(q_rope[:, :, None], posb[:, None],
                        cfg.rope_theta)[:, :, 0]
    new = h @ lp["w_dkv"]
    krope_new = apply_rope(new[:, None, None, r:], posb[:, None],
                           cfg.rope_theta)[:, 0, 0]
    ckv_c[:, pos] = new[:, :r]
    krope_c[:, pos] = krope_new
    w_ukv = lp["w_ukv"].reshape(r, hds, nope + dv)
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk.float())
    scale = 1.0 / ((nope + rope) ** 0.5)
    ckv = ckv_c.float()
    s_c = torch.einsum("bhr,bsr->bhs", q_abs.to(ckv_c.dtype).float(),
                       ckv) * scale
    s_r = torch.einsum("bhr,bsr->bhs", q_rope.to(krope_c.dtype).float(),
                       krope_c.float()) * scale
    s = s_c + s_r
    mask = torch.arange(ckv_c.shape[1], device=h.device) > pos
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", p.to(ckv_c.dtype).float(), ckv)
    o = torch.einsum("bhr,rhv->bhv", o_c.to(w_uv.dtype).float(),
                     w_uv.float())
    return o.reshape(b, hds * dv).to(h.dtype) @ lp["wo"]


def decode_step(cfg: LMConfig, params, cache, tokens):
    """One greedy decode step. tokens (B,) -> (logits (B, V), cache).

    The returned cache shares the tensors of ``cache``, which hold the new
    token's entries at position ``cache["len"]``.
    """
    pos = int(cache["len"])
    mla = cfg.attn_kind == "mla"
    names = ("ckv", "krope") if mla else ("k", "v")
    max_len = cache[names[0]].shape[2 if mla else 3]
    if pos >= max_len:
        raise ValueError(f"the cache is full: {pos} of {max_len} positions "
                         "used")
    x = embedding(params["embed"], tokens)
    for i, window in enumerate(cfg.windows()):
        lp = _layer(params, i)
        h = rmsnorm(x, lp["ln1"])
        if mla:
            o = _mla_decode_layer(cfg, lp, h, cache["ckv"][i],
                                  cache["krope"][i], pos)
        else:
            o = _gqa_decode_layer(cfg, lp, h, cache["k"][i], cache["v"][i],
                                  pos, window)
        x = x + o
        x = x + _ffn(cfg, lp, rmsnorm(x, lp["ln2"]))[0]
    logits = _logits(params, rmsnorm(x, params["final_ln"]))
    return logits, {**{n: cache[n] for n in names}, "len": pos + 1}
