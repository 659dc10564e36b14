"""Builds and launches the hand-written CUDA ``decode_attention`` kernel
(``csrc/decode_attention.cu``).

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
MAX_HEAD_DIM = 128
MAX_GROUP = 16
MAX_SMEM_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile the kernel library unless a build of this exact source and
    these flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "decode_attention")


def _bind(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_forward.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                             ctypes.c_float, i, p]
    lib.decode_attention_forward.restype = i
    lib.decode_attention_config.argtypes = [ctypes.POINTER(i)]
    lib.decode_attention_config.restype = None
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    cfg = (i * 5)()
    lib.decode_attention_config(cfg)
    want = (BLOCK_K, THREADS, MAX_HEAD_DIM, MAX_GROUP, MAX_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "decode_attention", _bind)


def smem_bytes(group: int, head_dim: int) -> int:
    """Dynamic shared memory of one block, all f32: the group's queries,
    the k tile (padded rows), the v tile, the probability tile and the
    group's running max, sum and rescale factor."""
    return 4 * (group * head_dim + BLOCK_K * (head_dim + 1)
                + BLOCK_K * head_dim + group * BLOCK_K + 3 * group)


def check_launch(group: int, head_dim: int) -> None:
    """Raise on a head dim or a group the kernel does not take."""
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes a head dim that is "
                         f"a multiple of 8 up to {MAX_HEAD_DIM}, got "
                         f"{head_dim}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"decode_attention kernel serves 1..{MAX_GROUP} "
                         f"query heads per KV head, got {group}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream of ``q``'s card and return
    the output without synchronising. Shapes are checked by
    ``ops.decode_attention``; this checks what the kernel itself needs.
    ``lengths`` is read on the card: a length above S counts as S, and a
    row of length 0 gives zeros."""
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
    check_launch(H // KV, D)
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, S, H, KV, D, D ** -0.5,
            code, stream)
    _build.check_error(lib, "decode_attention", err)
    return out
