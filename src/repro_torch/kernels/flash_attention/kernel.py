"""Builds and launches the hand-written CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The source compiles at first use through ``kernels/build.py`` (``nvcc``
into a ``ctypes`` library under ``build/repro_torch/``). Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# Launch geometry of csrc/flash_attention.cu; checked against the
# library's own constants when it loads.
BLOCK_Q = 64
BLOCK_K = 64
THREADS = 256
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile the kernel library unless a build of this exact source and
    these flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "flash_attention")


def _bind(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                            ctypes.c_float, i, p]
    lib.flash_attention_forward.restype = i
    lib.flash_attention_config.argtypes = [ctypes.POINTER(i)]
    lib.flash_attention_config.restype = None
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    cfg = (i * 5)()
    lib.flash_attention_config(cfg)
    want = (BLOCK_Q, BLOCK_K, THREADS, MAX_HEAD_DIM, MAX_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "flash_attention", _bind)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block, all f32: the scaled q tile
    (padded rows), the transposed k tile (padded rows), the v tile and the
    probability tile (padded rows)."""
    return 4 * (BLOCK_Q * (head_dim + 1) + head_dim * (BLOCK_K + 1)
                + BLOCK_K * head_dim + BLOCK_Q * (BLOCK_K + 1))


def check_launch(head_dim: int) -> None:
    """Raise on a head dim the kernel does not take: a multiple of 8 (its
    16-byte loads) up to ``MAX_HEAD_DIM`` (its register tile)."""
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes a head dim that is "
                         f"a multiple of 8 up to {MAX_HEAD_DIM}, got "
                         f"{head_dim}")
    if smem_bytes(head_dim) > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention kernel needs "
                         f"{smem_bytes(head_dim)} bytes of shared memory")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """Launch the kernel on the current stream of ``q``'s card and return
    the output without synchronising. Shapes are checked by
    ``ops.flash_attention``; this checks what the kernel itself needs."""
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise TypeError("flash_attention kernel takes one dtype: "
                            f"{t.dtype} vs {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel takes contiguous "
                             "tensors on 16-byte boundaries")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    check_launch(D)
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, D, int(causal), D ** -0.5, code, stream)
    _build.check_error(lib, "flash_attention", err)
    return out
