"""Builds and launches the hand-written CUDA ``wkv6_scan`` kernel
(``csrc/wkv6_scan.cu``).

The source compiles at first use through ``kernels/build.py`` (``nvcc``
into a ``ctypes`` library under ``build/repro_torch/``). Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6_scan.cu"

# Launch geometry of csrc/wkv6_scan.cu; checked against the library's own
# constants when it loads.
THREADS = 256
LANES_PER_COL = 4
MAX_K = 64
MAX_V = 64
TOKENS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """Compile the kernel library unless a build of this exact source and
    these flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "wkv6_scan")


def _bind(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_scan_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      p]
    lib.wkv6_scan_forward.restype = i
    lib.wkv6_scan_config.argtypes = [ctypes.POINTER(i)]
    lib.wkv6_scan_config.restype = None
    lib.wkv6_scan_error_string.argtypes = [i]
    lib.wkv6_scan_error_string.restype = ctypes.c_char_p
    cfg = (i * 5)()
    lib.wkv6_scan_config(cfg)
    want = (THREADS, LANES_PER_COL, MAX_K, MAX_V, TOKENS)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "wkv6_scan", _bind)


def check_launch(K: int, V: int) -> None:
    """Raise on a head size the kernel does not take: K a multiple of 16
    up to ``MAX_K`` (its float4 register groups), V up to ``MAX_V`` (its
    columns of threads)."""
    if K % 16 or not 16 <= K <= MAX_K:
        raise ValueError(f"wkv6_scan kernel takes a key size that is a "
                         f"multiple of 16 up to {MAX_K}, got {K}")
    if not 1 <= V <= MAX_V:
        raise ValueError(f"wkv6_scan kernel takes 1..{MAX_V} values per "
                         f"head, got {V}")


def wkv6_scan_cuda(r, k, v, w, u, init_state=None):
    """Launch the kernel on the current stream of ``r``'s card and return
    ``(y, final_state)`` without synchronising. Shapes are checked by
    ``ops.wkv6_scan``; this checks what the kernel itself needs, every
    check before the library is built or loaded."""
    if init_state is not None:
        raise ValueError("wkv6_scan kernel starts from a zero state "
                         "(prefill); an init_state takes the plain version "
                         "on the CPU")
    code = _DTYPE_CODES.get(r.dtype)
    if code is None:
        raise TypeError(f"wkv6_scan kernel takes float32 or bfloat16 r, got "
                        f"{r.dtype}")
    for name, t, want in (("k", k, r.dtype), ("v", v, r.dtype),
                          ("w", w, torch.float32), ("u", u, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"wkv6_scan kernel takes {name} in {want}, got "
                            f"{t.dtype}")
    for t in (r, k, v, w, u):
        if t.device.type != "cuda":
            raise ValueError(f"wkv6_scan kernel takes CUDA tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("wkv6_scan kernel takes contiguous tensors")
    B, S, H, K = r.shape
    V = v.shape[3]
    check_launch(K, V)
    lib = _library()
    y = torch.empty_like(v)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv6_scan_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, K, V,
            code, stream)
    _build.check_error(lib, "wkv6_scan", err)
    return y, state
