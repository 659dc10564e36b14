"""Builds and launches the hand-written CUDA ``fleet_mlp`` kernel
(``csrc/fleet_mlp.cu``).

The source compiles at first use through ``kernels/build.py`` (``nvcc``
into a ``ctypes`` library under ``build/repro_torch/``). Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fleet_mlp.cu"

# Launch geometry of csrc/fleet_mlp.cu; checked against the library's own
# constants when it loads.
MAX_DEPTH = 8
THREADS = 256
ROW_BLOCK = 4
MAX_SMEM_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile the kernel library unless a build of these exact sources
    and flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "fleet_mlp")


def _bind(lib, path) -> None:
    lib.fleet_mlp_forward.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fleet_mlp_forward.restype = ctypes.c_int
    lib.fleet_mlp_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fleet_mlp_config.restype = None
    lib.fleet_mlp_error_string.argtypes = [ctypes.c_int]
    lib.fleet_mlp_error_string.restype = ctypes.c_char_p
    cfg = (ctypes.c_int * 4)()
    lib.fleet_mlp_config(cfg)
    want = (MAX_DEPTH, THREADS, ROW_BLOCK, MAX_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "fleet_mlp", _bind)


def smem_bytes(rows: int, widths: Sequence[int]) -> int:
    """Dynamic shared memory of one block: two f32 activation buffers of
    ``rows x max(widths)`` plus the split-K partial sums."""
    return 4 * (2 * rows * max(widths) + ROW_BLOCK * THREADS)


def check_launch(rows: int, widths: Sequence[int]) -> None:
    """Raise on a depth or a rows x width product the kernel cannot hold."""
    depth = len(widths) - 1
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"fleet_mlp kernel takes depth 1..{MAX_DEPTH}, "
                         f"got {depth}")
    need = smem_bytes(rows, widths)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"fleet_mlp kernel needs {need} bytes of shared memory for "
            f"b={rows} x width {max(widths)}; a block has {MAX_SMEM_BYTES}")


def fleet_mlp_cuda(x: torch.Tensor, weights: List[torch.Tensor],
                   biases: List[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on the current stream of ``x``'s card and return
    the output without synchronising. Layer shapes are checked by
    ``ops.fleet_mlp``; this checks what the kernel itself needs."""
    if x.device.type != "cuda":
        raise ValueError(f"fleet_mlp_cuda takes CUDA tensors, got {x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"fleet_mlp kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    for t in (x, *weights, *biases):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("fleet_mlp kernel takes one dtype on one device: "
                            f"{t.dtype}@{t.device} vs {x.dtype}@{x.device}")
        if not t.is_contiguous():
            raise ValueError("fleet_mlp kernel takes contiguous tensors")
    n, rows, _ = x.shape
    widths = [x.shape[2]] + [w.shape[2] for w in weights]
    check_launch(rows, widths)
    lib = _library()
    depth = len(weights)
    out = torch.empty((n, rows, widths[-1]), dtype=x.dtype, device=x.device)
    w_ptrs = (ctypes.c_void_p * depth)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * depth)(*[b.data_ptr() for b in biases])
    c_widths = (ctypes.c_int * (depth + 1))(*widths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fleet_mlp_forward(x.data_ptr(), w_ptrs, b_ptrs, c_widths,
                                    depth, n, rows, code, out.data_ptr(),
                                    stream)
    _build.check_error(lib, "fleet_mlp", err)
    return out
