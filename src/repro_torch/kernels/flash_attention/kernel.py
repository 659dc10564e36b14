"""Builds and launches the hand-written CUDA ``flash_attention`` kernels
(``csrc/flash_attention.cu``). The forward has one route per dtype:

    bfloat16   tensor cores: wgmma (m64n128k16 for QK^T, m64n64k16 for PV),
               128-key K/V tiles by TMA into a ring of mbarrier-guarded
               stages, 128 q rows per block
    float32    CUDA cores: f32 FMAs, 64 q rows per block. f32 attention is
               held to 2e-5, which TF32 tensor cores (about 3 digits)
               cannot meet; no model path runs it on the card

Both are launches of ``flash_attention``, and both write each row's
log-sum-exp ``lse`` (B, H, Sq) f32 when asked. The backward is three
launches: ``delta = rowsum(dO * O)``, then dK/dV (one block per 64-key
tile and KV head, over the group's query heads) and dQ (one block per
64-row q tile and head), without atomics: for bf16 on the tensor cores
(``mma.sync`` m16n8k16, 4 warps of 16 rows), for f32 in CUDA-core FMAs
(256 threads).

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
# library's own constants when it loads. The f32 route:
BLOCK_Q = 64
BLOCK_K = 64
THREADS = 256
# the bf16 backward: 4 warps; q, k, v, dO tiles of 64 rows staged as bf16
# with rows padded to MAX_HEAD_DIM + 8 columns, and a tile's lse and delta
TC_THREADS = 128
TC_SMEM_BYTES = 4 * 64 * (128 + 8) * 2 + 2 * 64 * 4
# the bf16 route: two consumer warpgroups of 64 q rows and a producer warp
WG_BLOCK_Q = 128
WG_BLOCK_K = 128
WG_THREADS = 288
STAGES = 3
Q_ATOM_BYTES = 64 * 64 * 2              # q box: 64 rows of 64 bf16 columns
KV_ATOM_BYTES = WG_BLOCK_K * 64 * 2     # k / v box: 128 rows of 64 columns
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile the kernel library unless a build of this exact source and
    these flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "flash_attention")


def _bind(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, ctypes.c_float, i, p]
    lib.flash_attention_forward.restype = i
    lib.flash_attention_backward.argtypes = [p] * 10 + [i] * 7 + [
        ctypes.c_float, i, p]
    lib.flash_attention_backward.restype = i
    lib.flash_attention_config.argtypes = [ctypes.POINTER(i)]
    lib.flash_attention_config.restype = None
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    cfg = (i * 11)()
    lib.flash_attention_config(cfg)
    want = (BLOCK_Q, BLOCK_K, THREADS, WG_BLOCK_Q, WG_BLOCK_K, WG_THREADS,
            STAGES, MAX_HEAD_DIM, MAX_SMEM_BYTES, TC_THREADS, TC_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "flash_attention", _bind)


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block of ``dtype``'s route.

    bf16: 1024 bytes of alignment slack, then 128-byte-swizzled tiles in
    64-column atoms (one for D <= 64, two up to 128; TMA zero-fills the
    columns past D): the two warpgroups' 64-row q tiles and ``STAGES``
    128-key K and V tiles, and 2 * ``STAGES`` + 1 mbarriers of 8 bytes.
    f32: the scaled q tile (padded rows), the transposed k tile (padded
    rows), the v tile and the probability tile (padded rows)."""
    if dtype == torch.bfloat16:
        atoms = 1 if head_dim <= 64 else 2
        return 1024 + atoms * (2 * Q_ATOM_BYTES + 2 * STAGES * KV_ATOM_BYTES) \
            + 8 * (2 * STAGES + 1)
    return 4 * (BLOCK_Q * (head_dim + 1) + head_dim * (BLOCK_K + 1)
                + BLOCK_K * head_dim + BLOCK_Q * (BLOCK_K + 1))


def backward_smem_bytes(head_dim: int,
                        dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of the larger backward block of ``dtype``'s
    route (dK/dV). bf16: ``TC_SMEM_BYTES`` at every head dim. f32: the k
    and v tiles (padded rows), the transposed q and dO tiles, the P^T and
    dS^T tiles (padded rows) and the tile's lse and delta, all f32."""
    if dtype == torch.bfloat16:
        return TC_SMEM_BYTES
    ld = BLOCK_Q + 1
    return 4 * (2 * BLOCK_K * (head_dim + 1) + 2 * head_dim * ld
                + 2 * BLOCK_K * ld + 2 * BLOCK_Q)


def check_launch(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise on a head dim the kernels do not take: a multiple of 8 (the
    f32 route's 16-byte loads; the bf16 route's TMA rows of 16-byte
    multiples and wgmma's N) up to ``MAX_HEAD_DIM`` (two 64-column atoms,
    the register tiles of both routes)."""
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes a head dim that is "
                         f"a multiple of 8 up to {MAX_HEAD_DIM}, got "
                         f"{head_dim}")
    need = max(smem_bytes(head_dim, dtype),
               backward_smem_bytes(head_dim, dtype))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention kernel needs {need} bytes of "
                         "shared memory")


def _check_tensors(*tensors: torch.Tensor) -> int:
    """The dtype code of the tensors, which the kernels take contiguous,
    on 16-byte boundaries and of one dtype."""
    code = _DTYPE_CODES.get(tensors[0].dtype)
    if code is None:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {tensors[0].dtype}")
    for t in tensors:
        if t.dtype != tensors[0].dtype:
            raise TypeError("flash_attention kernel takes one dtype: "
                            f"{t.dtype} vs {tensors[0].dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel takes contiguous "
                             "tensors on 16-byte boundaries")
    return code


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, *, with_lse: bool = False):
    """Launch the kernel of ``q.dtype``'s route on the current stream of
    ``q``'s card and return the output without synchronising, and with
    ``with_lse`` also each row's log-sum-exp (B, H, Sq) f32. Shapes are
    checked by ``ops.flash_attention``; this checks what the kernel itself
    needs."""
    code = _check_tensors(q, k, v)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    check_launch(D, q.dtype)
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Skv, H, KV, D, int(causal), D ** -0.5, code, stream)
    _build.check_error(lib, "flash_attention", err)
    return (out, lse) if with_lse else out


def flash_attention_backward_cuda(q, k, v, out, dout, lse, causal: bool):
    """Launch the backward's three kernels on the current stream of ``q``'s
    card: ``(dq, dk, dv)`` in the inputs' dtype, not synchronised.
    ``out`` and ``lse`` are the forward's; ``dout`` is the output's
    gradient."""
    code = _check_tensors(q, k, v, out, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention backward takes a contiguous f32 "
                         "lse")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (B, H, Sq) or tuple(dout.shape) != tuple(q.shape) \
            or tuple(out.shape) != tuple(q.shape):
        raise ValueError(f"out, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    check_launch(D, q.dtype)
    lib = _library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KV, D, int(causal),
            D ** -0.5, code, stream)
    _build.check_error(lib, "flash_attention", err)
    return dq, dk, dv
