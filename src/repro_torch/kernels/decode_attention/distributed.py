"""Distributed flash-decode: the KV cache stays SHARD-RESIDENT along S (the
``seq_axis`` of a ``DeviceMesh``); each rank computes a partial
(unnormalised output, running max, denominator) over its local cache chunk
with the kernel's stats route (``ops.decode_attention_partial``), and the
ranks combine with all-reduces of exp-corrected statistics — (B, H, D+2)
per layer instead of gathering the (B, S, KV, D) cache.

The twin of ``src/repro/kernels/decode_attention/distributed.py``, whose
``shard_map`` body becomes ``torch.distributed`` collectives over
``mesh.get_group(seq_axis)``. Rank ``i`` on ``seq_axis`` holds positions
``i·S_loc … (i+1)·S_loc − 1``.
"""
from __future__ import annotations

import functools
import math

import torch

from .ops import decode_attention_partial


def _partial(q, k, v, lengths, offset: int):
    """Local unnormalised attention over one S-chunk.
    q: (B,H,D), k/v: (B,S_loc,KV,D), positions offset..offset+S_loc.
    Returns o_unnorm (B,H,D) f32, m (B,H) f32, l (B,H) f32 (m = -1e30,
    l = 0 and o = 0 for a row with no valid position in the chunk)."""
    S_loc = k.shape[1]
    local = (lengths.to(torch.int64) - offset).clamp(0, S_loc)
    # a chunk cut out of a cache is not always contiguous; the kernel
    # takes contiguous tensors
    return decode_attention_partial(q.contiguous(), k.contiguous(),
                                    v.contiguous(),
                                    local.to(torch.int32).contiguous())


def _all_reduce(t, op, group):
    import torch.distributed as dist
    dist.all_reduce(t, op=op, group=group)
    return t


def combine_partials(o, m, l, group=None):
    """Merge partials ``(o, m, l)`` (f32; see ``_partial``) into the
    normalised output ``o / max(l, 1e-30)`` (B, H, D), f32: the shards'
    max of ``m``, then ``corr = exp(m − m_max)``, then the sums of
    ``o·corr`` and ``l·corr``. With ``group`` each rank holds one shard's
    partials and the max and sums are all-reduces over ``group`` (every
    rank gets the result); without, the partials carry a leading axis of
    shards on one device and the max and sums run over it. A group of
    one rank holds every shard: nothing is reduced."""
    import torch.distributed as dist
    if group is None:
        rmax, rsum = (lambda t: t.amax(0)), (lambda t: t.sum(0))
    elif dist.get_world_size(group) == 1:
        rmax = rsum = lambda t: t           # noqa: E731
    else:
        rmax = functools.partial(_all_reduce, op=dist.ReduceOp.MAX,
                                 group=group)
        rsum = functools.partial(_all_reduce, op=dist.ReduceOp.SUM,
                                 group=group)
    m_max = rmax(m.clone())
    corr = torch.exp(m - m_max)
    o = rsum(o * corr[..., None])
    l = rsum(l * corr)
    return o / torch.clamp_min(l, 1e-30)[..., None]


def _local(x, mesh, pls):
    """The rank's block of ``x`` under placements ``pls``: a DTensor is
    redistributed there, a plain tensor is taken as whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, pls).to_local()


def decode_attention_distributed(q, k_cache, v_cache, lengths, *, mesh,
                                 seq_axis: str = "model",
                                 batch_axes=("data",)):
    """q (B,H,D); caches (B,S,KV,D) with S sharded on ``seq_axis`` and B on
    ``batch_axes`` of ``mesh`` (a ``DeviceMesh``). Returns (B,H,D) in
    ``q.dtype``.

    With DTensor caches, ``q`` and ``lengths`` are DTensors or tensors whole
    on every rank; the inputs are redistributed to that layout (B kept
    replicated where it does not divide the batch axes' extent, e.g. B=1
    long context) and the output is a DTensor with B on the batch axes.
    With plain caches, every input is already the rank's block: its rows of
    ``q`` and ``lengths`` (global positions) and its (rows, S-chunk) of the
    caches; the output is the rank's rows."""
    from torch.distributed.tensor import DTensor
    from ...arch.params import PartitionSpec as P
    from ...distributed.sharding import placements
    names = tuple(mesh.mesh_dim_names)
    b_ax = tuple(a for a in batch_axes if a in names)
    if b_ax and q.shape[0] % math.prod(
            mesh.shape[names.index(a)] for a in b_ax) != 0:
        b_ax = ()                      # e.g. B=1 long-context: replicate B
    bspec = b_ax if len(b_ax) > 1 else (b_ax[0] if b_ax else None)
    sharded = isinstance(k_cache, DTensor)
    if sharded:
        S = k_cache.shape[1]
        extent = mesh.shape[names.index(seq_axis)]
        if S % extent:
            raise ValueError(f"cache length {S} does not split evenly over "
                             f"{extent} ranks of {seq_axis!r}")
        cache_pl = placements(mesh, P(bspec, seq_axis, None, None))
        out_pl = placements(mesh, P(bspec, None, None))
        q_l = _local(q, mesh, out_pl)
        k_l = _local(k_cache, mesh, cache_pl)
        v_l = _local(v_cache, mesh, cache_pl)
        len_l = _local(lengths, mesh, placements(mesh, P(bspec)))
    else:
        q_l, k_l, v_l, len_l = q, k_cache, v_cache, lengths
    i = mesh.get_local_rank(seq_axis)
    o, m, l = _partial(q_l, k_l, v_l, len_l, i * k_l.shape[1])
    out = combine_partials(o, m, l, mesh.get_group(seq_axis)).to(q_l.dtype)
    if sharded:
        return DTensor.from_local(out, mesh, out_pl, run_check=False)
    return out
