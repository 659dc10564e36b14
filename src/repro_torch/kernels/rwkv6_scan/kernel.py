"""Builds and launches the hand-written CUDA ``wkv6_scan`` kernel
(``csrc/wkv6_scan.cu``). Two routes, chosen by dtype alone: float32 takes
the per-token recurrence on CUDA cores, bfloat16 the chunked scan on the
tensor cores (``ROUTES``). So does the backward
(``wkv6_scan_backward_cuda``, ``BACKWARD_ROUTES``): float32 takes one
per-token kernel on CUDA cores, bfloat16 a state sweep (the forward's bf16
kernel saving the state before each chunk) and a chunked reverse sweep on
the tensor cores; then a launch that sums the partials of du in a fixed
order.

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
# constants when it loads. f32 route: one column of the state per 4
# threads, TOKENS staged per pass.
THREADS = 256
LANES_PER_COL = 4
MAX_K = 64
MAX_V = 64
TOKENS = 32
# bf16 route: 8 warps, CHUNK tokens per chunk, the levels that split a
# chunk's scores, and its dynamic shared memory: a two-stage ring of r, k,
# v (bf16, 32 x 64) and w (f32), the quarters' products of w (4 x 64 f32),
# the bonus sums (2 x 32 f32), six operands as bf16 hi and lo tiles (the
# decayed r and k, levels 16, 8, 4, 2), the scores A (32 x 40 f32) and the
# state as bf16 hi and lo (64 x 64)
TC_THREADS = 256
TC_CHUNK = 32
LEVELS = (16, 8, 4, 2, 1)
TC_STAGES = 2
_TILE = TC_CHUNK * 64 * 2
TC_SMEM_BYTES = TC_STAGES * (3 * _TILE + TC_CHUNK * 64 * 4) \
    + 4 * 64 * 4 + 2 * TC_CHUNK * 4 + 6 * 2 * _TILE + TC_CHUNK * 40 * 4 \
    + 2 * 64 * 64 * 2
# the backward's f32 route: 256 threads, the state saved every BWD_CHUNK
# tokens, and its dynamic shared memory: r, k, v, w, dy as f32 tiles
# (BWD_CHUNK x 64), three sums over V per (token, row), v . dy and r . u k
# per token, and each warp's partial sums of dv (BWD_CHUNK x 8 x 64)
BWD_THREADS = 256
BWD_CHUNK = 16
_BWD_ROW = BWD_CHUNK * 64
BWD_SMEM_BYTES = 4 * (8 * _BWD_ROW + 2 * BWD_CHUNK + BWD_CHUNK * 8 * 64)
# the backward's bf16 route: the reverse sweep's 8 warps over TC_CHUNK-token
# chunks and its dynamic shared memory: r, k, v, dy (bf16, 32 x 64) and w
# (f32) in one stage, w's region then holding each warp's bonus sums, Z
# (32 x 32 as bf16 hi, mid, lo) and v . dy; the level 16, 8, 4, 2
# operands, r a and k g as bf16 hi and lo tiles; S_in and dS_end as bf16
# hi and lo planes (64 x 64); A^T as bf16 hi and lo (32 x 32); the
# quarters' products of w (4 x 64 f32)
BWD_TC_THREADS = 256
BWD_TC_SMEM_BYTES = 3 * _TILE + TC_CHUNK * 64 * 4 + _TILE \
    + 6 * 2 * _TILE + 2 * 2 * 64 * 64 * 2 + 2 * TC_CHUNK * TC_CHUNK * 2 \
    + 4 * 64 * 4
MAX_SMEM_BYTES = 232448          # the most one block may hold
SM_SMEM_BYTES = 233472           # an SM's shared memory, 1 KB kept per block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel function each dtype launches
ROUTES = {torch.float32: "wkv6_scan_kernel (per token, CUDA cores)",
          torch.bfloat16: "wkv6_scan_tc_kernel (chunked, mma.sync tensor cores)"}
#: the backward's kernels for each dtype, in launch order (the sum after)
BACKWARD_ROUTES = {
    torch.float32: "wkv6_scan_bwd_kernel (per token, CUDA cores)",
    torch.bfloat16: "wkv6_scan_tc_kernel<kStates> (the state sweep), then "
                    "wkv6_scan_bwd_tc_kernel (chunked, mma.sync tensor cores)"}


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
    lib.wkv6_scan_backward.argtypes = [p] * 13 + [i] * 6 + [p]
    lib.wkv6_scan_backward.restype = i
    lib.wkv6_scan_backward_work.argtypes = [i, i, i, i, i]
    lib.wkv6_scan_backward_work.restype = ctypes.c_size_t
    lib.wkv6_scan_backward_occupancy.argtypes = [ctypes.POINTER(i)]
    lib.wkv6_scan_backward_occupancy.restype = i
    lib.wkv6_scan_error_string.argtypes = [i]
    lib.wkv6_scan_error_string.restype = ctypes.c_char_p
    cfg = (i * 13)()
    lib.wkv6_scan_config(cfg)
    want = (THREADS, LANES_PER_COL, MAX_K, MAX_V, TOKENS, TC_THREADS,
            TC_CHUNK, TC_SMEM_BYTES, BWD_THREADS, BWD_CHUNK, BWD_SMEM_BYTES,
            BWD_TC_THREADS, BWD_TC_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "wkv6_scan", _bind)


def blocks_per_sm(smem_bytes: int = TC_SMEM_BYTES) -> int:
    """Blocks of a bf16 route (the forward's by default) one SM holds by
    shared memory."""
    return SM_SMEM_BYTES // (smem_bytes + 1024)


def backward_occupancy() -> dict:
    """The bf16 backward's reverse sweep as the card built it: registers a
    thread, spilled (local) bytes a thread and blocks an SM, from the
    runtime's function attributes and occupancy calculator. Needs a card."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    _build.check_error(lib, "wkv6_scan", lib.wkv6_scan_backward_occupancy(out))
    return {"registers": out[0], "spilled_bytes": out[1],
            "blocks_per_sm": out[2]}


def backward_work_bytes(B: int, S: int, H: int, K: int, dtype) -> int:
    """Bytes of the scratch buffer the backward of ``dtype`` takes (the
    library's ``wkv6_scan_backward_work``: the route's saved states, then
    the per-row partials of du). Builds the library."""
    return 4 * _library().wkv6_scan_backward_work(B, S, H, K,
                                                  _DTYPE_CODES[dtype])


def backward_states_bytes(B: int, S: int, H: int, dtype) -> int:
    """Bytes of the states the backward saves: f32 (64, 64) every
    ``BWD_CHUNK`` tokens, or bf16 hi and lo (2, 64, 64) every
    ``TC_CHUNK``."""
    if dtype == torch.float32:
        return B * H * -(-S // BWD_CHUNK) * 64 * 64 * 4
    return B * H * -(-S // TC_CHUNK) * 2 * 64 * 64 * 2


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


def _check_inputs(r, k, v, w, u, init_state) -> None:
    """What both kernels need of the forward's inputs."""
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
    check_launch(r.shape[3], v.shape[3])


def wkv6_scan_cuda(r, k, v, w, u, init_state=None):
    """Launch the kernel on the current stream of ``r``'s card and return
    ``(y, final_state)`` without synchronising. Shapes are checked by
    ``ops.wkv6_scan``; this checks what the kernel itself needs, every
    check before the library is built or loaded."""
    _check_inputs(r, k, v, w, u, init_state)
    B, S, H, K = r.shape
    V = v.shape[3]
    lib = _library()
    y = torch.empty_like(v)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv6_scan_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, K, V,
            _DTYPE_CODES[r.dtype], stream)
    _build.check_error(lib, "wkv6_scan", err)
    return y, state


def wkv6_scan_backward_cuda(r, k, v, w, u, dy, d_final_state=None):
    """Launch the backward on the current stream of ``r``'s card and return
    ``(dr, dk, dv, dw, du)`` in the inputs' dtypes without synchronising:
    the gradient of ``wkv6_scan_cuda``'s ``(y, final_state)`` given ``dy``
    (v's shape, r's dtype) and ``d_final_state`` ((B, H, K, V) f32, or
    None for none). The route follows r's dtype (``BACKWARD_ROUTES``); it
    takes what the forward takes. Every check before the library is built
    or loaded."""
    if dy.dtype != r.dtype or dy.shape != v.shape:
        raise ValueError(f"wkv6_scan backward takes dy like v "
                         f"{tuple(v.shape)} in {r.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    B, S, H, K = r.shape
    V = v.shape[3]
    extra = (dy,)
    if d_final_state is not None:
        if d_final_state.dtype != torch.float32 or \
                tuple(d_final_state.shape) != (B, H, K, V):
            raise ValueError(f"wkv6_scan backward takes d_final_state "
                             f"{(B, H, K, V)} float32, got "
                             f"{tuple(d_final_state.shape)} "
                             f"{d_final_state.dtype}")
        extra += (d_final_state,)
    _check_inputs(r, k, v, w, u, None)
    for t in extra:
        if t.device != r.device or not t.is_contiguous():
            raise ValueError("wkv6_scan backward takes contiguous gradients "
                             "on r's card")
    lib = _library()
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw, du = torch.empty_like(w), torch.empty_like(u)
    work = torch.empty(lib.wkv6_scan_backward_work(B, S, H, K,
                                                   _DTYPE_CODES[r.dtype]),
                       dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv6_scan_backward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(),
            None if d_final_state is None else d_final_state.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), work.data_ptr(), B, S, H, K, V,
            _DTYPE_CODES[r.dtype], stream)
    _build.check_error(lib, "wkv6_scan", err)
    return dr, dk, dv, dw, du
