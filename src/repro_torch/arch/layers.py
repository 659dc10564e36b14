"""Shared transformer layers: norms, RoPE / M-RoPE, GQA attention, MLPs.

All functions are plain functions on tensors; parameters come in as nested
dicts built by the matching ``*_specs`` builders. Compute dtype follows the
inputs (bf16), accumulation and softmax in f32 inside the attention
kernels. Every cast below is a rounding point of the reference and is kept.

Tensor parallelism: with ``tp`` (a ``distributed.sharding.TPContext``) the
attention and MLP blocks take one rank's shards of the ``model`` axis,
read from the weights' shapes. ``wq`` / ``bq`` narrower than H x hd hold
this rank's block of the fused columns, ``wo`` the matching row block;
the rank attends on its head slot (``head_range``): its ``H / tp`` whole
heads ``[r H/tp, (r+1) H/tp)`` where ``tp`` divides H, whose columns its
block holds, else ``ceil(H / tp)`` heads (the last slots short or empty),
its q moved there from the blocks and its output back by an all-to-all
over ``model`` (``TPContext.to_heads`` / ``to_cols``). ``wk``, ``wv``,
``bk``, ``bv`` stay whole and the rank computes only the KV heads its q
heads read (and, where a prefill writes a cache, every KV head, at its
sequence chunk where the cell chooses that; a decode step writes every KV
head); ``wo``'s partial sums are reduced before ``bo`` is added. In the
MLP, ``w_gate`` / ``w_up`` / ``w_in`` / ``b_in`` narrower than d_ff are
column shards and ``w_down`` the row shard. Without ``tp``, or with
whole weights, every block computes as without a mesh.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.decode_attention.distributed import decode_attention_distributed
from ..kernels.decode_attention.ops import decode_attention
from ..distributed.sharding import head_slots
from ..kernels.flash_attention.ops import flash_attention
from .params import ParamSpec

# ---------------------------------------------------------------- norms

def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones"),
                "bias": ParamSpec((d,), ("embed",), "zeros")}
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, correction=0)   # population
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = torch.mean(torch.square(xf), -1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (Qwen3): x (..., D), scale (D,)."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)

# ---------------------------------------------------------------- RoPE

def mrope_sections(head_dim: int):
    """Half-dim split for Qwen2-VL M-RoPE (t/h/w). 128 -> (16, 24, 24)."""
    half = head_dim // 2
    a = half // 4
    b = (half - a) // 2
    return (a, b, half - a - b)


def _freqs(half: int, theta: float, device):
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def _rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim//2)."""
    freqs = _freqs(head_dim // 2, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float, *, mrope: bool = False):
    """x: (B, S, H, D); positions: (B, S) or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): the half-dim frequency spectrum is PARTITIONED into
    (temporal, height, width) sections; each section keeps its slice of the
    full spectrum but rotates by its own position stream. The rotation pairs
    the two halves of the head dim (not interleaved pairs).
    """
    D = x.shape[-1]
    half = D // 2
    if mrope:
        freqs = _freqs(half, theta, x.device)
        parts_c, parts_s = [], []
        off = 0
        for i, sec in enumerate(mrope_sections(D)):
            ang = positions[i].to(torch.float32)[..., None] * freqs[off:off + sec]
            parts_c.append(torch.cos(ang))
            parts_s.append(torch.sin(ang))
            off += sec
        cos = torch.cat(parts_c, -1)
        sin = torch.cat(parts_s, -1)
    else:
        cos, sin = _rope_angles(positions, D, theta)
    cos = cos[:, :, None, :]                         # (B,S,1,half)
    sin = sin[:, :, None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)

# ---------------------------------------------------------------- attention

def attention_specs(cfg: ModelConfig, d_in: Optional[int] = None):
    """Projections are stored FUSED over (H*hd), as in the reference; the
    head structure is recovered by a reshape inside the layer."""
    d = d_in or cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sp = {
        "wq": ParamSpec((d, H * hd), ("embed", "heads")),
        "wk": ParamSpec((d, KV * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, KV * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, cfg.d_model), ("heads", "embed")),
    }
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), (None,), "ones")
        sp["k_norm"] = ParamSpec((hd,), (None,), "ones")
    if cfg.norm == "layernorm":                      # bias-ful archs
        sp["bq"] = ParamSpec((H * hd,), ("heads",), "zeros")
        sp["bk"] = ParamSpec((KV * hd,), ("kv_heads",), "zeros")
        sp["bv"] = ParamSpec((KV * hd,), ("kv_heads",), "zeros")
        sp["bo"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return sp


def _project_kv(cfg, p, x, kv=None):
    """k, v (B, S, b - a, hd) of KV heads ``kv`` = [a, b) (default: all
    of them)."""
    B, S, _ = x.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    a, b = kv or (0, KV)
    cols = slice(a * hd, b * hd)
    whole = (a, b) == (0, KV)
    wk = p["wk"] if whole else p["wk"][..., cols]
    wv = p["wv"] if whole else p["wv"][..., cols]
    k = x @ wk.to(x.dtype)
    v = x @ wv.to(x.dtype)
    if "bk" in p:
        k = k + (p["bk"] if whole else p["bk"][cols]).to(x.dtype)
        v = v + (p["bv"] if whole else p["bv"][cols]).to(x.dtype)
    k = k.reshape(B, S, b - a, hd)
    v = v.reshape(B, S, b - a, hd)
    if cfg.qk_norm:
        k = rms_head_norm(p["k_norm"], k)
    return k, v


def _project_q(cfg, p, x, to=None):
    """q (B, S, heads, hd) of the columns ``wq`` holds, moved by ``to``
    (a layout exchange of the last dim, or None) before they are cut into
    heads."""
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if to is not None:
        q = to(q)
    q = q.reshape(*q.shape[:2], -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
    return q


def head_range(cfg, p, tp) -> tuple:
    """(first q head, q heads) of this rank's head slot: all H where
    ``p["wq"]`` is whole, else ``sharding.head_slots``'s (H / tp heads
    where ``tp`` divides H; otherwise ceil(H / tp), the last slots short
    or empty)."""
    if p["wq"].shape[-1] == cfg.num_heads * cfg.head_dim:
        return 0, cfg.num_heads
    return head_slots(cfg.num_heads, tp.tp, tp.rank)


def kv_range(cfg, lo: int, hq: int) -> tuple:
    """[a, b): the KV heads that q heads [lo, lo + hq) read (none for no
    head)."""
    if not hq:
        return 0, 0
    G = cfg.num_heads // cfg.num_kv_heads
    return lo // G, (lo + hq - 1) // G + 1


def kv_for_heads(cfg, lo: int, hq: int, a: int, k, v):
    """k, v of KV heads [a, ...) (dim 2) as the kernels read them for q
    heads [lo, lo + hq): as they are where the rank's q heads group evenly
    over them, else each q head's KV head repeated (group 1)."""
    G = cfg.num_heads // cfg.num_kv_heads
    want = [(lo + j) // G - a for j in range(hq)]
    n = k.shape[2]
    if hq % n == 0 and want == [j // (hq // n) for j in range(hq)]:
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _slot_exchanges(cfg, tp, sharded: bool):
    """(to this rank's head slot, back to its columns): the exchanges of
    the fused head columns' last dim, or the identity without a split."""
    if not sharded:
        return None, lambda y: y
    H, hd = cfg.num_heads, cfg.head_dim
    return (lambda x: tp.to_heads(x, H, hd)), \
        (lambda y: tp.to_cols(y, H, hd))


def attention_block(cfg: ModelConfig, p, x, positions, tp=None,
                    cache: Union[bool, str] = True):
    """Full-sequence attention (train / prefill).

    x: (B, S, d_in) normed input. Returns (out (B,S,d_model), (k, v)) so
    prefill can populate caches. With ``tp`` and this rank's column block
    of the head projection, q is exchanged onto the rank's head slot
    (``head_range``), attends there and goes back to the block before its
    rows of ``wo`` (a rank whose slot holds no head attends on nothing
    but joins both exchanges); k and v are only of the KV heads its q
    heads read, or, where ``cache``, those of every KV head: at every
    position, or, where ``cache`` is ``"chunks"`` (the cell's choice,
    ``cells.kv_cache_chunks``, on whole-head slots), at this rank's
    sequence chunk (positions ``[r S/tp, (r+1) S/tp)``: the cache's layout
    over ``model``); ``out`` is reduced over the model axis (or, under
    sequence parallelism, ``x`` and ``out`` are this rank's sequence
    shards)."""
    KV = cfg.num_kv_heads
    lo, hq = head_range(cfg, p, tp)
    sharded = p["wq"].shape[-1] < cfg.num_heads * cfg.head_dim
    if tp is not None:
        x = tp.enter(x, sharded)
    S = x.shape[1]
    chunks = cache == "chunks"
    if chunks and (not sharded or S % tp.tp or cfg.num_heads % tp.tp):
        raise ValueError(f"k/v cache chunks need whole heads split over "
                         f"the model axis and S {S} a multiple of {tp.tp}")
    whole = bool(cache) and not chunks
    used = kv_range(cfg, lo, hq) if sharded else (0, KV)
    a = 0 if whole else used[0]
    to_slot, to_cols = _slot_exchanges(cfg, tp, sharded)
    q = _project_q(cfg, p, x, to_slot)
    k, v = _project_kv(cfg, p, x, None if whole else used)
    q = apply_rope(q, positions, cfg.rope_theta, mrope=cfg.use_mrope)
    k = apply_rope(k, positions, cfg.rope_theta, mrope=cfg.use_mrope)
    kc, vc = k, v
    if chunks:           # every KV head at this rank's positions
        n = S // tp.tp
        kc, vc = _project_kv(cfg, p, x.narrow(1, tp.rank * n, n))
        kc = apply_rope(kc, positions.narrow(-1, tp.rank * n, n),
                        cfg.rope_theta, mrope=cfg.use_mrope)
    if hq:
        ka, va = k, v
        if sharded:
            if (used[1] - used[0]) != k.shape[2]:
                ka = k[:, :, used[0] - a:used[1] - a].contiguous()
                va = v[:, :, used[0] - a:used[1] - a].contiguous()
            ka, va = kv_for_heads(cfg, lo, hq, used[0], ka, va)
        o = flash_attention(q, ka, va, causal=cfg.causal)
    else:                # an empty slot: no head to attend with
        o = q
    B, S = o.shape[:2]
    out = to_cols(o.reshape(B, S, -1)) @ p["wo"].to(x.dtype)
    if tp is not None:
        out = tp.leave(out, sharded)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out, (kc, vc)


def attention_decode(cfg: ModelConfig, p, x, kstack, vstack, layer, lengths,
                     dist=None, rows=None, tp=None):
    """One-token decode against STACKED caches (periods, B, S, KV, hd).

    Writes the new k/v IN PLACE at (layer, b, lengths[b]) — for every row,
    or only for the batch rows in ``rows`` (an index tensor) — then attends
    over lengths+1. The stacks are mutated, never copied. Returns
    (out (B,1,d_model), kstack, vstack).

    With ``dist`` ({"mesh": a DeviceMesh, optional "seq_axis" (default
    "model") and "batch_axes" (default ("data",))}) the stacks are this
    rank's S-chunk (periods, B, S_loc, KV, hd) of a cache sharded over the
    ranks of ``seq_axis``: only the rank whose chunk holds position
    ``lengths[b]`` writes the new k/v, at ``lengths[b] − offset`` in its
    chunk, and every rank attends over lengths+1 through the distributed
    flash-decode (``kernels/decode_attention/distributed.py``).

    With ``tp`` and this rank's column block of the head projection, the
    new k/v of every KV head are written (the caches hold them all); the
    rank's q goes to its head slot, attends with its q heads over the KV
    heads they read and comes back to its columns (``attention_block``),
    or, with ``dist``, every rank's q columns are gathered into whole
    heads, attend over its S-chunk and combine, and the rank keeps its own
    columns of the output for its row block of ``wo``.
    """
    B = x.shape[0]
    lo, hq = head_range(cfg, p, tp)
    cols = p["wq"].shape[-1]
    sharded = cols < cfg.num_heads * cfg.head_dim
    if tp is not None:
        x = tp.enter(x, sharded)
    to_slot, to_cols = _slot_exchanges(cfg, tp, sharded and dist is None)
    if sharded and dist is not None:     # every rank's columns: every head
        to_slot = lambda t: tp.gather_heads(t, 2)        # noqa: E731
    q = _project_q(cfg, p, x, to_slot)               # (B,1,heads,hd)
    k, v = _project_kv(cfg, p, x)                    # (B,1,KV,hd)
    pos = lengths[:, None]                           # (B,1)
    if cfg.use_mrope:
        pos3 = lengths[None, :, None].expand(3, B, 1)
        q = apply_rope(q, pos3, cfg.rope_theta, mrope=True)
        k = apply_rope(k, pos3, cfg.rope_theta, mrope=True)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    b_idx = torch.arange(B, device=x.device) if rows is None else rows
    at = lengths.long()[b_idx]
    if dist is None:
        kstack[layer, b_idx, at] = k[b_idx, 0].to(kstack.dtype)
        vstack[layer, b_idx, at] = v[b_idx, 0].to(vstack.dtype)
        kc, vc = kstack[layer], vstack[layer]
        if sharded and hq:
            a, b = kv_range(cfg, lo, hq)
            if b - a != kc.shape[2]:
                kc = kc[:, :, a:b].contiguous()
                vc = vc[:, :, a:b].contiguous()
            kc, vc = kv_for_heads(cfg, lo, hq, a, kc, vc)
        # an empty slot attends with no head
        o = decode_attention(q[:, 0], kc, vc, lengths + 1) if hq \
            else q[:, 0]
        o = to_cols(o.reshape(B, -1))
    else:
        seq_axis = dist.get("seq_axis", "model")
        S_loc = kstack.shape[2]
        at = at - dist["mesh"].get_local_rank(seq_axis) * S_loc
        # a row whose position lies in another rank's chunk rewrites the
        # slot it reads, so no rank waits on the host for a mask
        mine = ((at >= 0) & (at < S_loc))[:, None, None]
        at = at.clamp(0, S_loc - 1)
        for stack, new in ((kstack, k), (vstack, v)):
            stack[layer, b_idx, at] = torch.where(
                mine, new[b_idx, 0].to(stack.dtype), stack[layer, b_idx, at])
        o = decode_attention_distributed(
            q[:, 0], kstack[layer], vstack[layer], lengths + 1,
            mesh=dist["mesh"], seq_axis=seq_axis,
            batch_axes=dist.get("batch_axes", ("data",)))
        o = o.reshape(B, -1)
        if sharded:
            o = o[:, tp.rank * cols:(tp.rank + 1) * cols]
    out = o @ p["wo"].to(x.dtype)
    if tp is not None:
        out = tp.leave(out, sharded)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out[:, None], kstack, vstack

# ---------------------------------------------------------------- MLP

def mlp_specs(cfg: ModelConfig, d_in: Optional[int] = None):
    d = d_in or cfg.d_model
    ff = cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": ParamSpec((d, ff), ("embed", "mlp")),
                "w_up": ParamSpec((d, ff), ("embed", "mlp")),
                "w_down": ParamSpec((ff, cfg.d_model), ("mlp", "embed"))}
    sp = {"w_in": ParamSpec((d, ff), ("embed", "mlp")),
          "w_down": ParamSpec((ff, cfg.d_model), ("mlp", "embed"))}
    if cfg.norm == "layernorm":
        sp["b_in"] = ParamSpec((ff,), ("mlp",), "zeros")
        sp["b_down"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return sp


def mlp_block(cfg: ModelConfig, p, x, tp=None):
    """The MLP on x (B, S, d_in); with ``tp`` and this rank's column / row
    shards (``w_down`` shorter than d_ff), its partial sums reduced over
    the model axis before ``b_down`` is added."""
    sharded = p["w_down"].shape[0] < cfg.d_ff
    if tp is not None:
        x = tp.enter(x, sharded)
    if cfg.act == "swiglu":
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = x @ p["w_in"].to(x.dtype)
        if "b_in" in p:
            h = h + p["b_in"].to(x.dtype)
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    out = h @ p["w_down"].to(x.dtype)
    if tp is not None:
        out = tp.leave(out, sharded)
    if "b_down" in p:
        out = out + p["b_down"].to(x.dtype)
    return out
