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
sharded : on DTensors (``launch/steps.sharded_step``) the layers call
          ``constrain`` where the reference does, under the same axis names
          (``_res_spec``: the residual stream, sequence-parallel with
          ``cfg.seq_parallel``); flash_attention, the embedding and the MoE
          dispatch run in the regions of ``dist/regions.py``, and so do the
          cross entropy over a vocab-sharded logits block
          (``vocab_parallel_ce``) and the decode cache's writes
          (``cache_write``).  With a mesh of one device every ``constrain``
          is a no-op and each region runs the one-device code on the whole
          tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import regions
from repro_torch.dist.constrain import constrain
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.gather import embedding
from repro_torch.models.layers import (
    apply_rope, dense_init, embed_init, rmsnorm,
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


def _res_spec(cfg: LMConfig) -> tuple:
    """The residual stream's axes: sequence-parallel shards S over 'model'
    (the per-layer all-reduce becomes a reduce-scatter)."""
    return ("batch", "model", None) if cfg.seq_parallel else (
        "batch", None, None)


def _fsdp(tree):
    """Each DTensor weight of ``tree`` with its shards over the data-
    parallel axes ("pod", "data") gathered, sharded over "model" only:
    FSDP's gather before a layer's products, which the reference's XLA
    places itself.  DTensor would otherwise pick the product's layout by
    its bytes moved, and may shard the contracted dim, with every batch
    row on every data rank.  Plain tensors as they are."""
    from torch.distributed.tensor import Replicate

    def one(w):
        if not regions.is_dtensor(w):
            return w
        names = w.device_mesh.mesh_dim_names
        return regions.to(w, [Replicate() if names[d] in ("pod", "data")
                              else p for d, p in enumerate(w.placements)])

    if isinstance(tree, dict):
        return {k: _fsdp(v) for k, v in tree.items()}
    return one(tree)


def _heads(t, n: int):
    """(..., n * d) -> (..., n, d); a DTensor's last dim is gathered first
    where its axes do not divide the n heads (Gemma's 4 heads over 16)."""
    if regions.is_dtensor(t):
        t = regions.to(t, regions.divisible(t, (t.ndim - 1,), n))
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)


def _unheads(t):
    """(..., n, d) -> (..., n * d); a DTensor's head dim is gathered first
    where its axes do not divide the n heads."""
    if regions.is_dtensor(t):
        t = regions.to(t, regions.divisible(
            t, (t.ndim - 2, t.ndim - 1), t.shape[-2]))
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


def _logits(params, x):
    """(..., D) final hidden -> (..., V) float32 logits (tied embeddings)."""
    return x.float() @ _fsdp(params["embed"]).float().T


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _gqa_attention(cfg: LMConfig, lp, x, window: int, positions):
    """x (B, S, D) -> (attention output (B, S, D), (k, v) (B, Hkv, S, Dh))."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = constrain(_heads(x @ lp["wq"], h).transpose(1, 2),
                  "batch", "model", None, None)
    k = constrain(_heads(x @ lp["wk"], hkv).transpose(1, 2),
                  "batch", None, None, None)
    v = constrain(_heads(x @ lp["wv"], hkv).transpose(1, 2),
                  "batch", None, None, None).contiguous()
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    o = flash.flash_attention(q, k, v, causal=True, window=window)
    o = constrain(_unheads(o.transpose(1, 2)), "batch", None, "model")
    return constrain(o @ lp["wo"], *_res_spec(cfg)), (k, v)


def _mla_attention(cfg: LMConfig, lp, x, window: int, positions):
    """x (B, S, D) -> (attention output (B, S, D), (ckv (B, S, r), k_rope
    (B, S, rope))).  k_rope is roped once with a single head and broadcast
    to the H heads; the cache keeps c_kv unroped and k_rope roped."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = _heads(x @ lp["wq"], h)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv_full = x @ lp["w_dkv"]
    ckv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    kv = _heads(ckv @ lp["w_ukv"], h)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None],
                        cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, None], positions[:, None], cfg.rope_theta)
    qh = constrain(torch.cat([q_nope.transpose(1, 2), q_rope], -1),
                   "batch", "model", None, None)
    kh = constrain(torch.cat([k_nope.transpose(1, 2),
                              k_rope.expand(b, h, s, rope)], -1),
                   "batch", "model", None, None)
    vh = constrain(v.transpose(1, 2), "batch", "model", None, None) \
        .contiguous()
    o = flash.flash_attention(qh, kh, vh, causal=True, window=window)
    o = constrain(_unheads(o.transpose(1, 2)), "batch", None, "model")
    return constrain(o @ lp["wo"], *_res_spec(cfg)), (ckv, k_rope[:, 0])


def _ffn(cfg: LMConfig, lp, h, groups: int = 0):
    """The FFN of one layer on h (T, D) or (B, S, D): (output, MoE aux)."""
    ffn_spec, res_spec = (("batch", None, "model"), _res_spec(cfg)) \
        if h.dim() == 3 else (("batch", "model"), ("batch", None))
    if not cfg.moe:   # swiglu, with the reference's constrain sites
        y = constrain(h @ lp["w_gate"], *ffn_spec)
        u = constrain(h @ lp["w_up"], *ffn_spec)
        return constrain(F.silu(y) * u @ lp["w_down"], *res_spec), 0.0
    y, aux = moe_lib.moe_apply(lp["moe"], h.reshape(-1, h.shape[-1]),
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               groups=groups)
    if regions.is_dtensor(y):   # tokens back to (B, S): shard as B can
        y = regions.to(y, regions.divisible(y, (0,), h.shape[0]))
    return constrain(y.reshape(h.shape), *res_spec), aux


def _block(cfg: LMConfig, lp, x, window: int, positions):
    """One layer: (x out, MoE aux, the attention's cache entries)."""
    attention = _mla_attention if cfg.attn_kind == "mla" else _gqa_attention
    lp = _fsdp(lp)
    # the sequence-parallel layer input gathered once, before the norm (the
    # reference's grad_cast site: DTensor has no product of a sequence-
    # sharded input)
    x = constrain(x, "batch", None, None)
    o, kv = attention(cfg, lp, rmsnorm(x, lp["ln1"]), window, positions)
    x = x + o
    y, a = _ffn(cfg, lp, rmsnorm(x, lp["ln2"]), cfg.moe_groups)
    return x + y, a, kv


def _trunk(cfg: LMConfig, params, tokens, cache=None, kv_out=None):
    """Embed and run every layer over the whole sequence; layer i's cache
    entries (GQA: k, v; MLA: ckv, krope) go to ``cache[...][i]`` when a
    cache is given, or are appended to the lists of ``kv_out`` (a sharded
    prefill: DTensors are not written into in place).  Returns the last
    hidden states (B, S, D), before the final norm, and the sum of the
    layers' MoE aux losses.  With ``cfg.remat``, no cache and gradients
    on, each layer is checkpointed: only its input is kept, and the
    backward pass runs it again."""
    b, s = tokens.shape
    x = constrain(embedding(params["embed"], tokens), *_res_spec(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    serving = cache is not None or kv_out is not None
    remat = cfg.remat and not serving and torch.is_grad_enabled()
    aux = 0.0
    for i, window in enumerate(cfg.windows()):
        lp = _layer(params, i)
        if not serving:
            # Megatron-style sequence parallelism for the saved layer input
            # (the reference's scan carry)
            x = constrain(x, "batch", "model", None)
        if remat:
            x, a, _ = checkpoint(_block, cfg, lp, x, window, positions,
                                 use_reentrant=False, preserve_rng_state=False)
        else:
            x, a, kv = _block(cfg, lp, x, window, positions)
            for name, t in zip(names, kv):
                if cache is not None:
                    cache[name][i, ..., :s, :] = t
                elif kv_out is not None:
                    kv_out[name].append(t)
        aux = aux + a
    return x, aux


def hidden_states(cfg: LMConfig, params, tokens):
    """Transformer trunk -> (final hidden (B, S, D) after the final norm,
    aux float32 scalar)."""
    x, aux = _trunk(cfg, params, tokens)
    if not isinstance(aux, torch.Tensor):   # no MoE layer
        aux = torch.zeros((), device=x.device)
    return rmsnorm(x, params["final_ln"]), aux


def _chunk_ce(xs, labels, embed_f):
    """(sum of the chunk's token losses, its count of labelled tokens): the
    (B, C, V) float32 logits are formed here and nowhere else."""
    logits = constrain(xs.float() @ embed_f.T, "batch", None, "model")
    if regions.is_dtensor(logits):
        return _sharded_ce(logits, labels)
    return _ce_sums(logits, labels)


def _ce_sums(logits, labels):
    """The chunk's (loss sum, count) from its logits (B, C, V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != -1).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


class _VocabParallelCE(torch.autograd.Function):
    """Each rank's share of a chunk's cross entropy over its vocab block
    [v0, v0 + Vl) of the logits (B, C, Vl): the row max and the sum of
    exp all-reduced over the vocab mesh dims ``dims``, the gold logit
    summed there (it lies in one block).  The gradient is softmax minus
    one-hot on each rank's block, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, mesh, dims):
        vl = logits.shape[-1]
        m = logits.amax(dim=-1) if vl else torch.full(
            logits.shape[:-1], float("-inf"), device=logits.device)
        m = regions.all_reduce(m, "max", mesh, dims)
        z = regions.all_reduce(torch.exp(logits - m[..., None]).sum(-1),
                               "sum", mesh, dims)
        logz = m + torch.log(z)
        lab = labels.clamp(min=0).long() - v0
        hit = (lab >= 0) & (lab < vl)
        gold = torch.where(hit, logits.gather(
            -1, lab.clamp(0, max(vl - 1, 0))[..., None])[..., 0]
            if vl else 0.0, 0.0)
        gold = regions.all_reduce(gold, "sum", mesh, dims)
        mask = (labels != -1).float()
        ctx.save_for_backward(logits, logz, lab, hit, mask)
        return torch.sum((logz - gold) * mask), torch.sum(mask)

    @staticmethod
    def backward(ctx, g_nll, g_cnt):
        logits, logz, lab, hit, mask = ctx.saved_tensors
        onehot = (lab[..., None] == torch.arange(
            logits.shape[-1], device=logits.device)) & hit[..., None]
        p = torch.exp(logits - logz[..., None])
        return ((p - onehot.float()) * (g_nll * mask)[..., None],
                None, None, None, None)


def _sharded_ce(logits, labels):
    """:func:`_chunk_ce`'s sums on a DTensor logits block (the
    ``vocab_parallel_ce`` region): batch rows sharded as the logits' are,
    the vocab sharded where it is; the sums are each batch shard's
    (``Partial`` over the batch axes).  Where no axis shards the vocab
    (a mesh of one device), each rank runs the one-device sums."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    l_pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in logits.placements]
    b_pl = [p if p == Shard(0) else Replicate() for p in l_pl]
    dims = [d for d, p in enumerate(l_pl) if p == Shard(2)]
    logits = regions.to(logits, l_pl)
    labels = regions.to(labels, b_pl) if regions.is_dtensor(labels) else \
        regions.replicated(labels, mesh, b_pl)
    v = logits.shape[-1]

    def local(ll, lb):
        if not dims:
            return _ce_sums(ll, lb)
        v0, _ = regions.shard_range(mesh, l_pl, 2, v)
        return _VocabParallelCE.apply(ll, lb, v0, mesh, dims)

    out = [Partial() if p == Shard(0) else Replicate() for p in l_pl]
    return regions.run("vocab_parallel_ce", local, mesh, (logits, labels),
                       (l_pl, b_pl), (out, out), (l_pl, None), ((), ()))


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
    embed_f = _fsdp(params["embed"]).float()
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
    max_len = max_len or s
    if regions.is_dtensor(params["embed"]):
        names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
        kv = {n: [] for n in names}
        x, _ = _trunk(cfg, params, tokens, kv_out=kv)
        cache = {}
        for name in names:
            t = torch.stack(kv[name])
            pad = max_len - s
            cache[name] = torch.cat([t, t.new_zeros(
                (*t.shape[:-2], pad, t.shape[-1]))], -2) if pad else t
    else:
        cache = init_cache(cfg, b, max_len, device=tokens.device)
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


def _write_position(c, new, pos: int, dim: int) -> None:
    """DTensor cache ``c`` at position ``pos`` of its sequence axis
    ``dim`` set to ``new`` in place (the ``cache_write`` region): the rank
    whose block of the axis holds ``pos`` writes it."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = c.device_mesh
    n_pl = [Replicate() if not isinstance(p, Shard) or p.dim == dim else
            Shard(p.dim - (p.dim > dim)) for p in c.placements]
    n = c.shape[dim]

    def local(cl, nl):
        s0, s1 = regions.shard_range(mesh, c.placements, dim, n)
        if s0 <= pos < s1:
            cl.select(dim, pos - s0).copy_(nl)
        return cl

    new = regions.to(new, n_pl) if regions.is_dtensor(new) else \
        regions.replicated(new, mesh, n_pl)
    regions.run("cache_write", local, mesh, (c, new),
                (c.placements, n_pl), c.placements, None, c.shape)


def _gqa_decode_layer(cfg: LMConfig, lp, h, kc, vc, pos: int, window: int):
    """One layer's attention for one new token at position ``pos``; writes
    its k, v into ``kc``, ``vc`` (B, Hkv, S, Dh) in place."""
    b = h.shape[0]
    hds, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(h @ lp["wq"], hds).reshape(b, hds, 1, dh)
    k = _heads(h @ lp["wk"], hkv).reshape(b, hkv, 1, dh)
    v = _heads(h @ lp["wv"], hkv).reshape(b, hkv, 1, dh)
    posb = torch.full((b, 1), pos, device=h.device)
    q = apply_rope(q, posb[:, None], cfg.rope_theta)
    k = apply_rope(k, posb[:, None], cfg.rope_theta)
    if regions.is_dtensor(kc):
        _write_position(kc, k[:, :, 0], pos, 2)
        _write_position(vc, v[:, :, 0], pos, 2)
    else:
        kc[:, :, pos] = k[:, :, 0]
        vc[:, :, pos] = v[:, :, 0]
    o = attn.decode_attention(q, kc, vc, pos + 1, window=window)
    return _unheads(o[:, :, 0]) @ lp["wo"]


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
    q = _heads(h @ lp["wq"], hds)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    posb = torch.full((b, 1), pos, device=h.device)
    q_rope = apply_rope(q_rope[:, :, None], posb[:, None],
                        cfg.rope_theta)[:, :, 0]
    new = h @ lp["w_dkv"]
    krope_new = apply_rope(new[:, None, None, r:], posb[:, None],
                           cfg.rope_theta)[:, 0, 0]
    if regions.is_dtensor(ckv_c):
        _write_position(ckv_c, new[:, :r], pos, 1)
        _write_position(krope_c, krope_new, pos, 1)
    else:
        ckv_c[:, pos] = new[:, :r]
        krope_c[:, pos] = krope_new
    w_ukv = _heads(lp["w_ukv"], hds)
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
    return _unheads(o).to(h.dtype) @ lp["wo"]


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
        lp = _fsdp(_layer(params, i))
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
