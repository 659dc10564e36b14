"""Builds and launches the hand-written CUDA ``fleet_mlp`` kernel
(``csrc/fleet_mlp.cu``).

The source compiles at first use with ``nvcc`` into a shared library with a
plain C interface, named by a hash of the source and the flags, under
``build/repro_torch/`` at the repository root, and is loaded with
``ctypes``. Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fleet_mlp.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launch geometry of csrc/fleet_mlp.cu; checked against the library's own
# constants when it loads.
MAX_DEPTH = 8
THREADS = 256
ROW_BLOCK = 4
MAX_SMEM_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the fleet_mlp kernel cannot be built")


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless a build of these exact sources
    and flags exists. Returns ``(path, compiler output)``; the output is
    empty when the build was already there."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfleet_mlp_{key}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)     # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
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
        _lib = lib
    return _lib


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
    if err != 0:
        raise RuntimeError("fleet_mlp launch failed: CUDA error "
                           f"{err} ({lib.fleet_mlp_error_string(err).decode()})")
    return out
