"""Builds and launches the hand-written CUDA ``decode_attention`` kernels
(``csrc/decode_attention.cu``): split-KV flash-decoding, a partial pass
over ``split_plan``'s cache ranges and a combine pass, so each call is two
launches on the card. The stats route (``decode_attention_partial_cuda``)
runs the same pair but keeps the softmax statistics, for a sequence shard
that is merged with the others.

The source compiles at first use through ``kernels/build.py`` (``nvcc``
into a ``ctypes`` library under ``build/repro_torch/``). Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# Launch geometry of csrc/decode_attention.cu; checked against the
# library's own constants when it loads.
BLOCK_K = 64
THREADS = 256
STAGES = 3
MAX_HEAD_DIM = 128
MAX_GROUP = 16
MAX_SMEM_BYTES = 232448
# the split rule: at most SPLIT_SLOTS cache slots per partial block, halved
# (down to one tile) while the grid has fewer than TARGET_BLOCKS blocks,
# about two per SM of the H100's 132
SPLIT_SLOTS = 256
TARGET_BLOCKS = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile the kernel library unless a build of this exact source and
    these flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "decode_attention")


def _bind(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_forward.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                             i, i, i, ctypes.c_float, i, p]
    lib.decode_attention_forward.restype = i
    lib.decode_attention_partial_forward.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.decode_attention_partial_forward.restype = i
    lib.decode_attention_config.argtypes = [ctypes.POINTER(i)]
    lib.decode_attention_config.restype = None
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    cfg = (i * 6)()
    lib.decode_attention_config(cfg)
    want = (BLOCK_K, THREADS, STAGES, MAX_HEAD_DIM, MAX_GROUP,
            MAX_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "decode_attention", _bind)


def split_plan(batch: int, kv_heads: int, seq: int) -> tuple:
    """``(n_split, split_len)`` of the partial pass: the cache axis cut
    into ranges of ``split_len`` slots. It depends on the shapes alone,
    never on ``lengths``, which stay on the card."""
    slots = SPLIT_SLOTS
    while slots > BLOCK_K and \
            batch * kv_heads * -(-seq // slots) < TARGET_BLOCKS:
        slots //= 2
    return -(-seq // slots), slots


def smem_bytes(group: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one partial block: the ``STAGES``-deep
    ring of k and v tiles in the cache's type, then in f32 the group's
    queries, the probability tile and the group's running max, sum and
    rescale factor."""
    return dtype.itemsize * 2 * STAGES * BLOCK_K * head_dim \
        + 4 * (group * head_dim + group * BLOCK_K + 3 * group)


def check_launch(group: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise on a head dim or a group the kernel does not take: a multiple
    of 8 (16-byte copies, 8 elements per lane of a slot's half-warp) up to
    ``MAX_HEAD_DIM`` (16 lanes x 8), at most ``MAX_GROUP`` query heads per
    KV head (the per-thread output registers)."""
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes a head dim that is "
                         f"a multiple of 8 up to {MAX_HEAD_DIM}, got "
                         f"{head_dim}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"decode_attention kernel serves 1..{MAX_GROUP} "
                         f"query heads per KV head, got {group}")
    if smem_bytes(group, head_dim, dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention kernel needs "
                         f"{smem_bytes(group, head_dim, dtype)} bytes of "
                         "shared memory")


def _checked(q, k_cache, v_cache, lengths) -> tuple:
    """What the kernels need of their inputs, checked; returns
    ``(dtype code, (B, S, H, KV, D), (n_split, split_len))``. Shapes are
    checked by the ops."""
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"decode_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for t in (q, k_cache, v_cache):
        if t.dtype != q.dtype:
            raise TypeError("decode_attention kernel takes one dtype: "
                            f"{t.dtype} vs {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attention kernel takes contiguous "
                             "tensors on 16-byte boundaries")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"decode_attention kernel takes contiguous int32 "
                        f"lengths, got {lengths.dtype}")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    check_launch(H // KV, D, q.dtype)
    return code, (B, S, H, KV, D), split_plan(B, KV, S)


def _workspace(q, KV: int, n_split: int) -> torch.Tensor:
    """Each split's (m, l) per query head and unnormalised output, f32."""
    B, H, D = q.shape
    return torch.empty(B * KV * n_split * (H // KV) * (D + 2),
                       dtype=torch.float32, device=q.device)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Launch the partial and the combine pass on the current stream of
    ``q``'s card and return the output without synchronising. Shapes are
    checked by ``ops.decode_attention``; this checks what the kernel itself
    needs.
    ``lengths`` is read on the card: a length above S counts as S, and a
    row of length 0 gives zeros."""
    code, (B, S, H, KV, D), (n_split, split_len) = _checked(
        q, k_cache, v_cache, lengths)
    lib = _library()
    out = torch.empty_like(q)
    ws = _workspace(q, KV, n_split)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), ws.data_ptr(), out.data_ptr(), B, S, H, KV,
            D, n_split, split_len, D ** -0.5, code, stream)
    _build.check_error(lib, "decode_attention", err)
    return out


def decode_attention_partial_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  lengths: torch.Tensor) -> tuple:
    """The stats route: the same partial pass, then a combine that writes
    ``(o, m, l)`` in f32 — the unnormalised output (B, H, D), the running
    max and the denominator (B, H) over the cache's first ``lengths[b]``
    slots — without synchronising. A row with no valid slot gives m =
    -1e30, l = 0 and o = 0."""
    code, (B, S, H, KV, D), (n_split, split_len) = _checked(
        q, k_cache, v_cache, lengths)
    lib = _library()
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    ws = _workspace(q, KV, n_split)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_partial_forward(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), ws.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), B, S, H, KV, D, n_split, split_len, D ** -0.5,
            code, stream)
    _build.check_error(lib, "decode_attention", err)
    return o, m, l
