"""The language model: the PyTorch twin of the reference's one
scan-over-superblocks code path (dense / GQA attention, MoE, Mamba2 hybrid
with Zamba2's weight-shared block, RWKV6, encoder), with the scan written
out as a Python loop over the stacked period leaves.

Public surface:
    build_param_specs(cfg)            ParamSpec tree (init & counting)
    init_params(cfg, generator, ...)  materialised params on a device
    param_shape_structs(cfg, dtype)   the param tree as meta tensors
    forward(cfg, params, batch, ...)  logits (train/prefill) or hidden
    train_loss(cfg, params, batch)    scalar CE (+ MoE aux), chunked for long S
    decode_state_specs(cfg, B, S)     TensorSpec tree of the decode state
    init_decode_state(cfg, B, S, ...) zeroed decode state on a device
    decode_step(cfg, params, state, batch)  (logits, state)
    param_count(cfg)                  exact parameter count
    active_param_count(cfg)           params touched per token

Under autograd, ``forward`` in modes "train" and "hidden" recomputes each
period in the backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scan body does.

``shard(x, names)`` is the layout hook of the reference, called at its
places with the same logical names (``distributed.sharding.make_shard_fn``
builds one; the default does nothing). ``scan_unroll`` is accepted with the
values ``lax.scan``'s ``unroll`` takes, a positive int or a bool: the loop
over periods is Python, so, as ``unroll`` in the reference, it changes no
result. ``attn_dist`` sends decode attention through the distributed
flash-decode (``layers.attention_decode``).

``tp`` (a ``distributed.sharding.TPContext``) runs the model on one rank's
shards of a mesh: each period's FSDP shards gathered over the data axes
just before the period (again in its recompute; the gradients
reduce-scattered back), the ``attn`` and ``mlp`` parts on their head and
column shards (``layers``), the ``moe`` part on its expert shards
(``moe``), the ``mamba2`` mixer on its SSD heads (``mamba2``), the
``rwkv6`` time-mix on its WKV heads and its channel-mix on its columns
(``rwkv6``), Zamba2's shared block on its heads and MLP columns as an
``attn`` block, the embedding, the LM head and the cross-entropy
vocab-parallel (an embedding table shorter than the vocabulary holds this
rank's rows), and, under sequence parallelism, the residual stream between
blocks as this rank's sequence shard. Parts whose weights are whole (a
part whose heads do not split over the model axis) compute on the whole
sequence. Without ``tp`` nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..configs.base import ModelConfig
from ..kernels.common import resolve_device
from . import layers, mamba2, moe, rwkv6
from .params import (ParamSpec, init_tree, param_count as _spec_count,
                     shape_structs, stack_specs, tree_leaves, tree_map)

def _id_shard(x, names):
    """The default ``shard`` hook: no layout to impose."""
    return x


def _check_unroll(scan_unroll) -> None:
    """Raise on a value ``lax.scan`` refuses for ``unroll``."""
    if not isinstance(scan_unroll, (bool, int)) or (
            not isinstance(scan_unroll, bool) and scan_unroll < 1):
        raise ValueError(f"scan_unroll must be a bool or a positive int, "
                         f"got {scan_unroll!r}")


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ------------------------------------------------------------------ specs

def _block_specs(cfg: ModelConfig, kind: str):
    if kind == "attn":
        return {"ln1": layers.norm_specs(cfg), "attn": layers.attention_specs(cfg),
                "ln2": layers.norm_specs(cfg), "mlp": layers.mlp_specs(cfg)}
    if kind == "attn_moe":
        return {"ln1": layers.norm_specs(cfg), "attn": layers.attention_specs(cfg),
                "ln2": layers.norm_specs(cfg), "moe": moe.moe_specs(cfg)}
    if kind == "mamba2":
        return {"ln1": layers.norm_specs(cfg), "mixer": mamba2.mamba2_specs(cfg)}
    if kind == "rwkv6":
        return {"ln1": layers.norm_specs(cfg), "tm": rwkv6.timemix_specs(cfg),
                "ln2": layers.norm_specs(cfg), "cm": rwkv6.channelmix_specs(cfg)}
    raise ValueError(kind)


def _shared_block_specs(cfg: ModelConfig):
    """Zamba2's weight-shared attention+MLP block, on concat(h, emb0)."""
    d2 = 2 * cfg.d_model
    return {"ln1": layers.norm_specs(cfg, d2),
            "attn": layers.attention_specs(cfg, d_in=d2),
            "ln2": layers.norm_specs(cfg, d2),
            "mlp": layers.mlp_specs(cfg, d_in=d2)}


def build_param_specs(cfg: ModelConfig):
    period = {f"pos{i}": _block_specs(cfg, kind)
              for i, kind in enumerate(cfg.pattern)}
    specs = {"blocks": stack_specs(period, cfg.num_periods),
             "final_norm": layers.norm_specs(cfg)}
    if cfg.frontend != "frames":
        specs["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), "embed")
    if "rwkv6" in cfg.pattern:
        specs["ln0"] = layers.norm_specs(cfg)
    if cfg.shared_attn_every_period:
        specs["shared"] = _shared_block_specs(cfg)
    if not (cfg.tie_embeddings and cfg.frontend != "frames"):
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), "normal")
    return specs


def param_count(cfg: ModelConfig) -> int:
    return _spec_count(build_param_specs(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k + shared experts only)."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    e_specs = moe.moe_specs(cfg)
    per_expert = _spec_count({k: e_specs[k] for k in ("w_gate", "w_up", "w_down")})
    n_moe_layers = cfg.num_periods * sum(k == "attn_moe" for k in cfg.pattern)
    inactive = per_expert * (1 - cfg.num_experts_per_tok / cfg.num_experts)
    return int(total - n_moe_layers * inactive)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Parameters drawn from ``generator`` (which lies on ``device``) with
    the reference's init laws, stored in ``dtype``."""
    return init_tree(build_param_specs(cfg), generator, _dtype(dtype),
                     resolve_device(device))


def param_shape_structs(cfg: ModelConfig, dtype=torch.float32):
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtype, no storage."""
    return shape_structs(build_param_specs(cfg), _dtype(dtype))


# ------------------------------------------------------------------ embed

def _embed(cfg: ModelConfig, params, batch, dtype, tp=None):
    """The residual stream's input (B, S, d); with ``tp`` its layout
    between blocks. A vocab shard of the table looks up the tokens in its
    range, writes zeros for the rest, and the ranks' rows are summed (each
    token's one nonzero: exact)."""
    whole = _whole(tp)[1]                   # SP: this rank's shard
    if cfg.frontend == "frames":
        return whole(batch["frames"].to(dtype))
    table, tokens = params["embed"], batch["tokens"]
    if tp is not None and table.shape[0] < cfg.vocab_size:
        n = table.shape[0]
        local = tokens.long() - tp.rank * n
        mine = (local >= 0) & (local < n)
        h = torch.where(mine[..., None], table[local.clamp(0, n - 1)],
                        0).to(dtype)
        h = tp.leave(h, True)
    else:
        # gather, then cast: the same values as casting the table first
        h = whole(table[tokens].to(dtype))
    if cfg.frontend == "patches" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(dtype)
        s0 = 0 if tp is None or not tp.seq else tp.rank * h.shape[1]
        hi = min(ve.shape[1], s0 + h.shape[1])
        if hi > s0:
            h = torch.cat([ve[:, s0:hi], h[:, hi - s0:]], dim=1)
    return h


def _positions(cfg: ModelConfig, batch, B, S, device):
    if cfg.use_mrope:
        if "positions" in batch:
            return batch["positions"]
        base = torch.arange(S, device=device)[None].expand(B, S)
        return torch.stack([base] * 3)
    return torch.arange(S, device=device)[None].expand(B, S)


def _head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings and "embed" in params:
        return params["embed"].T
    return params["lm_head"]


def _head_sharded(cfg: ModelConfig, params, tp) -> bool:
    """Whether this rank holds a vocab shard of the LM head."""
    return tp is not None \
        and _head_weight(cfg, params).shape[-1] < cfg.vocab_size


def _unembed(cfg: ModelConfig, params, h, tp=None):
    """Logits of ``h`` (whole along the sequence where the head is
    sharded): this rank's vocab columns with a vocab shard."""
    w = _head_weight(cfg, params).to(h.dtype)
    if _head_sharded(cfg, params, tp) and not tp.seq:
        h = tp.enter(h, True)
    return h @ w


def _head_input(cfg: ModelConfig, params, h, tp):
    """Under sequence parallelism with a vocab shard of the head, the
    final hidden states whole along the sequence (every rank then holds
    every token's logits for its columns); else as they are."""
    if tp is None or not tp.seq or not _head_sharded(cfg, params, tp):
        return h
    return tp.enter(h, False)


def _head_labels(cfg: ModelConfig, params, labels, tp):
    """(labels, whether the ranks' losses are summed): under sequence
    parallelism with a whole head, each rank's loss is that of its
    sequence shard's tokens."""
    if tp is None or not tp.seq or _head_sharded(cfg, params, tp):
        return labels, False
    k = labels.shape[1] // tp.tp
    return labels.narrow(1, tp.rank * k, k), True


def _checkpoint(fn, *args, tp=None):
    """``checkpoint`` (non-reentrant); with ``tp`` the recompute runs the
    whole function, so every rank issues the same collectives in it."""
    ctx = set_checkpoint_early_stop(False) if tp is not None \
        else contextlib.nullcontext()
    with ctx:
        return checkpoint(fn, *args, use_reentrant=False)


def _periods(blocks) -> list:
    """Every period's parameters, views from one ``unbind`` of each stacked
    leaf. Under autograd the unbind's backward stacks the periods'
    gradients once; indexing each period (``t[i]``) would instead build a
    zero-filled stack-sized gradient per period and sum them, work that
    grows with the square of the depth."""
    slices = tree_map(lambda t: t.unbind(0), blocks)
    n = tree_leaves(blocks)[0].shape[0]
    return [tree_map(lambda s: s[i], slices) for i in range(n)]


# ------------------------------------------------------------------ forward

def _whole(tp):
    """A part on whole weights, in and out of the residual stream's
    layout (under sequence parallelism: the sequence gathered, then this
    rank's shard of the output kept)."""
    if tp is None:
        return (lambda x: x), (lambda y: y)
    return (lambda x: tp.enter(x, False)), (lambda y: tp.leave(y, False))


def _apply_block(cfg, kind, p, h, positions, shard, moe_path, moe_groups,
                 token_mean=None, tp=None, want_cache=True):
    """Full-sequence application of one block. Returns (h, cache, aux):
    aux holds an ``attn_moe`` block's router losses, else it is empty."""
    if kind in ("attn", "attn_moe"):
        a, (k, v) = layers.attention_block(cfg, p["attn"],
                                           layers.apply_norm(cfg, p["ln1"], h),
                                           positions, tp=tp,
                                           cache=want_cache)
        h = h + a
        aux = {}
        if kind == "attn":
            h = h + layers.mlp_block(cfg, p["mlp"],
                                     layers.apply_norm(cfg, p["ln2"], h),
                                     tp=tp)
        else:
            m, aux = moe.moe_block(cfg, p["moe"],
                                   layers.apply_norm(cfg, p["ln2"], h),
                                   path=moe_path, shard=shard,
                                   groups=moe_groups, token_mean=token_mean,
                                   tp=tp)
            h = h + m
        return h, {"k": k, "v": v}, aux
    if kind == "mamba2":
        m, (conv_s, ssd_s) = mamba2.mamba2_block(
            cfg, p["mixer"], layers.apply_norm(cfg, p["ln1"], h), tp=tp,
            cache=want_cache)
        return h + m, {"conv": conv_s, "ssd": ssd_s}, {}
    if kind == "rwkv6":
        x_prev0 = torch.zeros((h.shape[0], h.shape[2]), dtype=h.dtype,
                              device=h.device)
        t, x_tm, wkv = rwkv6.timemix_block(
            cfg, p["tm"], layers.apply_norm(cfg, p["ln1"], h), x_prev0,
            tp=tp)
        h = h + t
        c, x_cm = rwkv6.channelmix_block(
            cfg, p["cm"], layers.apply_norm(cfg, p["ln2"], h), x_prev0,
            tp=tp)
        return h + c, {"x_tm": x_tm, "x_cm": x_cm, "wkv": wkv}, {}
    raise ValueError(kind)


def _apply_shared(cfg, p, h, emb0, positions, tp=None, want_cache=True):
    """Zamba2 weight-shared attention+MLP block on concat(h, emb0)."""
    cat = torch.cat([h, emb0], dim=-1)
    a, (k, v) = layers.attention_block(cfg, p["attn"],
                                       layers.apply_norm(cfg, p["ln1"], cat),
                                       positions, tp=tp, cache=want_cache)
    h = h + a
    cat = torch.cat([h, emb0], dim=-1)
    h = h + layers.mlp_block(cfg, p["mlp"],
                             layers.apply_norm(cfg, p["ln2"], cat), tp=tp)
    return h, {"k": k, "v": v}


def _apply_period(cfg, p, h, positions, emb0, shared_p, want_cache,
                  shard, moe_path, moe_groups, token_mean=None, tp=None):
    """One period: its blocks in pattern order, then Zamba2's shared block.
    Returns (h, the period's caches or {}, the sum of its MoE blocks' aux
    or {}). With ``tp`` the period's FSDP shards are gathered first."""
    if tp is not None:
        p = tp.period(p)
    h = shard(h, ("batch", "seq", None))
    caches, auxes = {}, []
    for j, kind in enumerate(cfg.pattern):
        h, cache, aux = _apply_block(cfg, kind, p[f"pos{j}"], h, positions,
                                     shard, moe_path, moe_groups, token_mean,
                                     tp, want_cache)
        if want_cache:
            caches[f"pos{j}"] = cache
        if aux:
            auxes.append(aux)
    if cfg.shared_attn_every_period:
        h, sc = _apply_shared(cfg, shared_p, h, emb0, positions, tp,
                              want_cache)
        if want_cache:
            caches["shared"] = sc
    return h, caches, {k: sum(a[k] for a in auxes) for k in auxes[0]} \
        if auxes else {}


def forward(cfg: ModelConfig, params, batch, *, mode: str = "train",
            shard: Callable = _id_shard, remat: bool = True,
            moe_path: str = "dispatch", scan_unroll=1,
            moe_groups: int = 0, token_mean: Optional[Callable] = None,
            tp=None, cache: Union[bool, str] = True):
    """Full-sequence forward. mode: "train" -> (logits (B,S,V) f32, aux);
    "prefill" -> (last-token logits (B,V) f32, decode_state whose caches
    are the per-period caches stacked over periods: k/v (periods, B, S,
    KV, hd), Mamba2's conv/ssd and RWKV6's x_tm/x_cm/wkv states, Zamba2's
    shared k/v); "hidden" -> (final hidden states, aux). aux is the MoE
    router losses (each period's sum over its MoE blocks, averaged over
    periods), {} without MoE blocks. With ``remat``, in modes "train" and
    "hidden" under autograd, each period keeps only its input for the
    backward and is recomputed there. ``token_mean`` reaches the MoE
    routers (``moe._router``). With ``tp`` (see the module's docstring)
    the logits are this rank's vocab columns where the head is sharded,
    and mode "hidden" returns the residual stream's layout (under
    sequence parallelism this rank's sequence shard), and ``cache`` says
    how a prefill's attention writes its k/v caches (``True``, or
    ``"chunks"``: ``layers.attention_block``)."""
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_unroll(scan_unroll)
    dtype = _dtype(cfg.dtype)
    if cfg.frontend == "frames":
        B, S = batch["frames"].shape[:2]
        device = batch["frames"].device
    else:
        B, S = batch["tokens"].shape
        device = batch["tokens"].device
    if tp is not None:
        params = tp.top(params)
    h = shard(_embed(cfg, params, batch, dtype, tp), ("batch", "seq", None))
    positions = _positions(cfg, batch, B, S, device)
    if "ln0" in params:
        h = layers.apply_norm(cfg, params["ln0"], h)
    emb0 = h
    shared_p = params.get("shared")

    want_cache = cache if mode == "prefill" else False
    recompute = remat and mode in ("train", "hidden") \
        and torch.is_grad_enabled()
    def recomputed(h, p):
        # the period's aux comes out of the recomputed region too
        h, _, aux = _apply_period(cfg, p, h, positions, emb0, shared_p,
                                  False, shard, moe_path, moe_groups,
                                  token_mean, tp)
        return h, aux

    per_period, auxes = [], []
    for p in _periods(params["blocks"]):
        if recompute:
            h, aux = _checkpoint(recomputed, h, p, tp=tp)
        else:
            h, caches, aux = _apply_period(cfg, p, h, positions, emb0,
                                           shared_p, want_cache, shard,
                                           moe_path, moe_groups, token_mean,
                                           tp)
            per_period.append(caches)
        auxes.append(aux)
    aux = {k: torch.mean(torch.stack([a[k] for a in auxes]))
           for k in auxes[0]}

    h = layers.apply_norm(cfg, params["final_norm"], h)
    if mode == "hidden":
        return h, aux
    if mode == "train":
        h = _head_input(cfg, params, h, tp)
        return _unembed(cfg, params, h, tp).to(torch.float32), aux
    # prefill: logits for the last position + populated decode state
    if tp is not None and tp.seq:
        h = tp.enter(h, False)
    logits = _unembed(cfg, params, h[:, -1], tp).to(torch.float32)
    caches = {key: {n: torch.stack([c[key][n] for c in per_period])
                    for n in leaves}
              for key, leaves in per_period[0].items()}
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    return logits, {"caches": caches, "lengths": lengths}


def _ce_from_logits(logits, labels, tp=None, vocab: int = 0):
    """Summed next-token cross-entropy of f32 logits (..., V). With
    ``tp`` and logits narrower than ``vocab`` (this rank's vocab columns),
    the max, the sum of exponentials and the label's logit (held by the
    rank whose columns hold the label) are each combined over the model
    axis."""
    if tp is None or logits.shape[-1] == vocab:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.sum(lse - ll)
    n = logits.shape[-1]
    m = tp.max(logits.detach().amax(-1))
    lse = m + torch.log(tp.reduce(torch.sum(torch.exp(logits - m[..., None]),
                                            -1)))
    local = labels.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = tp.reduce(torch.where(mine, ll, 0))
    return torch.sum(lse - ll)


def chunked_ce(cfg: ModelConfig, params, h, labels, *, chunks: int,
               shard: Callable = _id_shard, tp=None, total: int = 0):
    """Sequence-chunked mean cross-entropy: the (B, S, V) f32 logits are
    never materialised. Each S/chunks slice computes its own logits and,
    under autograd, recomputes them in the backward. ``total``: the token
    count to divide by (default ``h``'s)."""
    B, S, _ = h.shape
    csz = S // chunks

    def one(hc, lc):
        hc = shard(hc, ("batch", None, None))
        return _ce_from_logits(
            _unembed(cfg, params, hc, tp).to(torch.float32), lc, tp,
            cfg.vocab_size)

    acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for ci in range(chunks):
        hc = h[:, ci * csz:(ci + 1) * csz]
        lc = labels[:, ci * csz:(ci + 1) * csz]
        ce = _checkpoint(one, hc, lc, tp=tp) \
            if torch.is_grad_enabled() else one(hc, lc)
        acc = acc + ce
    return acc / (total or B * S)


def train_loss(cfg: ModelConfig, params, batch, *,
               shard: Callable = _id_shard, remat: bool = True,
               moe_path: str = "dispatch", scan_unroll=1,
               loss_chunks: int = 0, moe_groups: int = 0,
               token_mean: Optional[Callable] = None, tp=None):
    """Mean next-token cross-entropy of ``batch["labels"]``, plus 0.01 of
    the MoE load-balance loss and 1e-3 of its z-loss where the model has
    MoE blocks. Returns (loss, {"loss", "ce", and the aux losses}).
    ``loss_chunks`` 0 chunks long sequences (``max(1, min(16, S //
    512))``); the count is lowered until it divides S. More than one chunk
    goes through ``chunked_ce``. ``token_mean`` and ``tp``: ``forward``'s.
    Under sequence parallelism with a whole head, each rank's loss is that
    of its sequence shard's tokens, summed over the ranks."""
    labels = batch["labels"]
    S = labels.shape[1]
    if loss_chunks == 0:
        loss_chunks = max(1, min(16, S // 512))
    while S % loss_chunks:
        loss_chunks -= 1
    kw = dict(shard=shard, remat=remat, moe_path=moe_path,
              scan_unroll=scan_unroll, moe_groups=moe_groups,
              token_mean=token_mean, tp=tp)
    if tp is not None:      # gathered once, for the forward and the head
        params = tp.top(params)
    if loss_chunks > 1:
        h, aux = forward(cfg, params, batch, mode="hidden", **kw)
        h = _head_input(cfg, params, h, tp)
        lab, part = _head_labels(cfg, params, labels, tp)
        ce = chunked_ce(cfg, params, h, lab, chunks=loss_chunks, shard=shard,
                        tp=tp, total=labels.numel())
    else:
        logits, aux = forward(cfg, params, batch, mode="train", **kw)
        lab, part = _head_labels(cfg, params, labels, tp)
        ce = _ce_from_logits(logits, lab, tp, cfg.vocab_size) \
            / labels.numel()
    if part:
        ce = tp.reduce(ce)
    loss = ce
    if aux:
        loss = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    return loss, {"loss": loss, "ce": ce, **aux}


# ------------------------------------------------------------------ decode

def _cache_entry_spec(cfg: ModelConfig, kind: str, B: int, S: int, dtype):
    if kind in ("attn", "attn_moe", "shared"):
        shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
        return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}
    if kind == "mamba2":
        di, H, N, conv_ch, _ = mamba2._dims(cfg)
        return {"conv": TensorSpec((B, cfg.ssm_conv - 1, conv_ch), dtype),
                "ssd": TensorSpec((B, H, cfg.ssm_head_dim, N), torch.float32)}
    if kind == "rwkv6":
        H, K = cfg.rwkv_heads, cfg.rwkv_head_size
        return {"x_tm": TensorSpec((B, cfg.d_model), dtype),
                "x_cm": TensorSpec((B, cfg.d_model), dtype),
                "wkv": TensorSpec((B, H, K, K), torch.float32)}
    raise ValueError(kind)


def decode_state_specs(cfg: ModelConfig, B: int, S: int, dtype=None):
    """Every cache leaf stacked over periods: (periods, B, ...). Recurrent
    states (``ssd``, ``wkv``) are f32 whatever ``dtype`` is."""
    dtype = _dtype(dtype or cfg.dtype)
    per = {f"pos{i}": _cache_entry_spec(cfg, kind, B, S, dtype)
           for i, kind in enumerate(cfg.pattern)}
    if cfg.shared_attn_every_period:
        per["shared"] = _cache_entry_spec(cfg, "shared", B, S, dtype)
    caches = tree_map(
        lambda s: TensorSpec((cfg.num_periods,) + s.shape, s.dtype), per)
    return {"caches": caches, "lengths": TensorSpec((B,), torch.int32)}


def init_decode_state(cfg: ModelConfig, B: int, S: int, dtype=None,
                      device="cuda"):
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    decode_state_specs(cfg, B, S, dtype))


def _put(stack, layer: int, new, rows) -> None:
    """Write one layer's new recurrent state (B, ...) into its stack
    (periods, B, ...) IN PLACE: every row, or only the rows in ``rows``."""
    if rows is None:
        stack[layer] = new.to(stack.dtype)
    else:
        stack[layer, rows] = new[rows].to(stack.dtype)


def _decode_block(cfg, kind, p, h, cs, layer, lengths, rows, shard,
                  moe_path, moe_groups, attn_dist=None, tp=None):
    """One block against its STACKED caches ``cs``, updated in place."""
    if kind in ("attn", "attn_moe"):
        a, _, _ = layers.attention_decode(
            cfg, p["attn"], layers.apply_norm(cfg, p["ln1"], h),
            cs["k"], cs["v"], layer, lengths, dist=attn_dist, rows=rows,
            tp=tp)
        h = h + a
        if kind == "attn":
            return h + layers.mlp_block(cfg, p["mlp"],
                                        layers.apply_norm(cfg, p["ln2"], h),
                                        tp=tp)
        m, _ = moe.moe_block(cfg, p["moe"],
                             layers.apply_norm(cfg, p["ln2"], h),
                             path=moe_path, shard=shard, groups=moe_groups,
                             tp=tp)
        return h + m
    if kind == "mamba2":
        m, (conv_s, ssd_s) = mamba2.mamba2_decode(
            cfg, p["mixer"], layers.apply_norm(cfg, p["ln1"], h),
            (cs["conv"][layer], cs["ssd"][layer]), tp=tp)
        _put(cs["conv"], layer, conv_s, rows)
        _put(cs["ssd"], layer, ssd_s, rows)
        return h + m
    if kind == "rwkv6":
        t, x_tm, wkv = rwkv6.timemix_decode(
            cfg, p["tm"], layers.apply_norm(cfg, p["ln1"], h),
            cs["x_tm"][layer], cs["wkv"][layer], tp=tp)
        h = h + t
        # channelmix's shift uses x_prev at t=0 == stored last token
        c, x_cm = rwkv6.channelmix_block(
            cfg, p["cm"], layers.apply_norm(cfg, p["ln2"], h),
            cs["x_cm"][layer], tp=tp)
        _put(cs["x_tm"], layer, x_tm, rows)
        _put(cs["x_cm"], layer, x_cm, rows)
        _put(cs["wkv"], layer, wkv, rows)
        return h + c
    raise ValueError(kind)


def _decode_shared(cfg, p, h, emb0, cs, layer, lengths, rows,
                   attn_dist=None, tp=None):
    """The Zamba2 shared block for one token; period ``layer``'s slice of
    the shared k/v stack is written in place."""
    cat = torch.cat([h, emb0], dim=-1)
    a, _, _ = layers.attention_decode(
        cfg, p["attn"], layers.apply_norm(cfg, p["ln1"], cat),
        cs["k"], cs["v"], layer, lengths, dist=attn_dist, rows=rows, tp=tp)
    h = h + a
    cat = torch.cat([h, emb0], dim=-1)
    return h + layers.mlp_block(cfg, p["mlp"],
                                layers.apply_norm(cfg, p["ln2"], cat), tp=tp)


def decode_step(cfg: ModelConfig, params, state, batch, *, rows=None,
                shard: Callable = _id_shard, moe_path: str = "dispatch",
                scan_unroll=1, moe_groups: int = 0, attn_dist=None,
                tp=None):
    """One-token decode. batch: {"tokens": (B,1)} (or {"frames": (B,1,d)}).

    The stacked caches in ``state`` are updated IN PLACE: each layer writes
    its new k/v at ``lengths`` and its new recurrent state (conv, ssd,
    x_tm, x_cm, wkv) for every row, or only for the batch rows in ``rows``
    (an index tensor), so rows outside it keep their caches exactly.
    MoE blocks route every row, each row a group of its own by default
    (so no choice drops). With ``attn_dist`` (see
    ``layers.attention_decode``) the k/v stacks are this rank's S-chunk of
    caches sharded over a mesh axis. With ``tp`` (the module's docstring)
    the logits are this rank's vocab columns where the head is sharded.
    Returns (logits (B,V) f32, {"caches": the same caches, "lengths":
    lengths + 1}).
    """
    if not cfg.is_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step")
    _check_unroll(scan_unroll)
    dtype = _dtype(cfg.dtype)
    lengths = state["lengths"]
    caches = state["caches"]
    if tp is not None:
        params = tp.top(params)
    h = _embed(cfg, params, batch, dtype, tp)
    if "ln0" in params:
        h = layers.apply_norm(cfg, params["ln0"], h)
    h = shard(h, ("batch", None, None))
    emb0 = h
    for layer, p in enumerate(_periods(params["blocks"])):
        if tp is not None:
            p = tp.period(p)
        for j, kind in enumerate(cfg.pattern):
            h = _decode_block(cfg, kind, p[f"pos{j}"], h, caches[f"pos{j}"],
                              layer, lengths, rows, shard, moe_path,
                              moe_groups, attn_dist, tp)
        if cfg.shared_attn_every_period:
            h = _decode_shared(cfg, params["shared"], h, emb0,
                               caches["shared"], layer, lengths, rows,
                               attn_dist, tp)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    logits = _unembed(cfg, params, h[:, 0], tp).to(torch.float32)
    return logits, {"caches": caches, "lengths": lengths + 1}
