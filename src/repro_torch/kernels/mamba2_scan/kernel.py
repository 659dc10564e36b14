"""Builds and launches the hand-written CUDA ``ssd_scan`` kernel
(``csrc/ssd_scan.cu``). Two routes, chosen by dtype alone: float32 takes
the per-token recurrence on CUDA cores, bfloat16 the chunked scan on the
tensor cores (``ROUTES``). So does the backward (``ssd_scan_backward_cuda``,
``BACKWARD_ROUTES``): float32 takes one per-token kernel on CUDA cores,
bfloat16 a state sweep (the forward's bf16 kernel saving the state before
each chunk) and a chunked reverse sweep on the tensor cores; then launches
that sum their partials in a fixed order.

The source compiles at first use through ``kernels/build.py`` (``nvcc``
into a ``ctypes`` library under ``build/repro_torch/``). Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

# Launch geometry of csrc/ssd_scan.cu; checked against the library's own
# constants when it loads. f32 route: one row of the state per 4 threads,
# TOKENS staged per pass.
THREADS = 256
LANES_PER_ROW = 4
MAX_P = 64
MAX_N = 64
TOKENS = 32
# bf16 route: 4 warps, CHUNK tokens per chunk, and its dynamic shared
# memory: a two-stage ring of x, B, C (bf16, 64 x 64) and dt, the state as
# bf16 hi and lo, and each warp's cum and weights
TC_THREADS = 128
TC_CHUNK = 64
TC_STAGES = 2
_TILE = TC_CHUNK * 64 * 2
TC_SMEM_BYTES = TC_STAGES * (3 * _TILE + TC_CHUNK * 4) + 2 * _TILE \
    + 2 * (TC_THREADS // 32) * TC_CHUNK * 4
# the backward's f32 route: 256 threads, the state saved every BWD_CHUNK
# tokens, and its dynamic shared memory: x, dy, B, C as f32 tiles
# (BWD_CHUNK x 64), dt and the decays, g (BWD_CHUNK x 64), each warp's
# <dS, S_{t-1}> and each warp's partial sums of dC and dB (BWD_CHUNK x 8 x
# 64 each)
BWD_THREADS = 256
BWD_CHUNK = 16
_BWD_ROW = BWD_CHUNK * 64
BWD_SMEM_BYTES = 4 * (5 * _BWD_ROW + 2 * BWD_CHUNK + BWD_CHUNK * 8
                      + 2 * BWD_CHUNK * 8 * 64)
# the backward's bf16 route: the reverse sweep's 4 warps over TC_CHUNK-token
# chunks and its dynamic shared memory: a two-stage ring of x, B, C (bf16,
# 64 x 64) and dt, dy's tile, the saved state and dS_end as bf16 hi, mid
# and lo planes, each warp's cum (f64), exp(cum), exp(total - cum) and the
# decays within and across 16-token tiles, per token two f64 sums and one
# f32, and each warp's <dS_end, S_prev> (f64)
BWD_TC_THREADS = 128
_WARPS = BWD_TC_THREADS // 32
BWD_TC_SMEM_BYTES = TC_STAGES * (3 * _TILE + TC_CHUNK * 4) + 7 * _TILE \
    + _WARPS * TC_CHUNK * (8 + 4 * 4) + TC_CHUNK * (8 + 8 + 4) + _WARPS * 8
MAX_SMEM_BYTES = 232448          # the most one block may hold
SM_SMEM_BYTES = 233472           # an SM's shared memory, 1 KB kept per block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel function each dtype launches
ROUTES = {torch.float32: "ssd_scan_kernel (per token, CUDA cores)",
          torch.bfloat16: "ssd_scan_tc_kernel (chunked, mma.sync tensor cores)"}
#: the backward's kernels for each dtype, in launch order (the sums after)
BACKWARD_ROUTES = {
    torch.float32: "ssd_scan_bwd_kernel (per token, CUDA cores)",
    torch.bfloat16: "ssd_scan_tc_kernel<kStates> (the state sweep), then "
                    "ssd_scan_bwd_tc_kernel (chunked, mma.sync tensor cores)"}


def build():
    """Compile the kernel library unless a build of this exact source and
    these flags exists. Returns ``(path, compiler output)``."""
    return _build.build(SOURCE, "ssd_scan")


def _bind(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_forward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                     i, p]
    lib.ssd_scan_forward.restype = i
    lib.ssd_scan_config.argtypes = [ctypes.POINTER(i)]
    lib.ssd_scan_config.restype = None
    lib.ssd_scan_backward.argtypes = [p] * 15 + [i] * 6 + [p]
    lib.ssd_scan_backward.restype = i
    lib.ssd_scan_backward_work.argtypes = [i, i, i, i]
    lib.ssd_scan_backward_work.restype = ctypes.c_size_t
    lib.ssd_scan_backward_occupancy.argtypes = [ctypes.POINTER(i)]
    lib.ssd_scan_backward_occupancy.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    cfg = (i * 13)()
    lib.ssd_scan_config(cfg)
    want = (THREADS, LANES_PER_ROW, MAX_P, MAX_N, TOKENS, TC_THREADS,
            TC_CHUNK, TC_SMEM_BYTES, BWD_THREADS, BWD_CHUNK, BWD_SMEM_BYTES,
            BWD_TC_THREADS, BWD_TC_SMEM_BYTES)
    if tuple(cfg) != want:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {want}")


def _library():
    return _build.load(SOURCE, "ssd_scan", _bind)


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
    _build.check_error(lib, "ssd_scan", lib.ssd_scan_backward_occupancy(out))
    return {"registers": out[0], "spilled_bytes": out[1],
            "blocks_per_sm": out[2]}


def backward_work_bytes(B: int, S: int, H: int, N: int) -> int:
    """Bytes of the scratch buffer the backward takes (the library's
    ``ssd_scan_backward_work``: the larger route's states, then the
    partials of dB, dC, dA and dD). Builds the library."""
    return 4 * _library().ssd_scan_backward_work(B, S, H, N)


def backward_states_bytes(B: int, S: int, H: int, dtype) -> int:
    """Bytes of the states the backward saves: f32 (64, 64) every
    ``BWD_CHUNK`` tokens, or bf16 hi, mid and lo (3, 64, 64) every
    ``TC_CHUNK``."""
    if dtype == torch.float32:
        return B * H * -(-S // BWD_CHUNK) * 64 * 64 * 4
    return B * H * -(-S // TC_CHUNK) * 3 * 64 * 64 * 2


def check_launch(P: int, N: int) -> None:
    """Raise on a head width or a state size the kernel does not take:
    P up to ``MAX_P`` (its rows of threads), N a multiple of 16 up to
    ``MAX_N`` (its float4 register groups)."""
    if not 1 <= P <= MAX_P:
        raise ValueError(f"ssd_scan kernel takes 1..{MAX_P} channels per "
                         f"head, got {P}")
    if N % 16 or not 16 <= N <= MAX_N:
        raise ValueError(f"ssd_scan kernel takes a state size that is a "
                         f"multiple of 16 up to {MAX_N}, got {N}")


def _check_inputs(x, dt, A, Bm, Cm, D, init_state) -> None:
    """What both kernels need of the forward's inputs."""
    if init_state is not None:
        raise ValueError("ssd_scan kernel starts from a zero state (prefill); "
                         "an init_state takes the plain version on the CPU")
    if Bm.shape[2] != 1:
        raise ValueError(f"ssd_scan kernel takes one group, got "
                         f"{Bm.shape[2]}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for name, t, want in (("Bm", Bm, x.dtype), ("Cm", Cm, x.dtype),
                          ("dt", dt, torch.float32), ("A", A, torch.float32),
                          ("D", D, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"ssd_scan kernel takes {name} in {want}, got "
                            f"{t.dtype}")
    check_launch(x.shape[3], Bm.shape[3])
    for t in (x, dt, A, Bm, Cm, D):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan kernel takes CUDA tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("ssd_scan kernel takes contiguous tensors")


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, init_state=None):
    """Launch the kernel on the current stream of ``x``'s card and return
    ``(y, final_state)`` without synchronising. Shapes are checked by
    ``ops.ssd_scan``; this checks what the kernel itself needs, every
    check before the library is built or loaded."""
    _check_inputs(x, dt, A, Bm, Cm, D, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    lib = _library()
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_forward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
            B, S, H, P, N, _DTYPE_CODES[x.dtype], stream)
    _build.check_error(lib, "ssd_scan", err)
    return y, state


def ssd_scan_backward_cuda(x, dt, A, Bm, Cm, D, dy, d_final_state=None):
    """Launch the backward on the current stream of ``x``'s card and return
    ``(dx, ddt, dA, dBm, dCm, dD)`` in the inputs' dtypes without
    synchronising: the gradient of ``ssd_scan_cuda``'s ``(y,
    final_state)`` given ``dy`` (x's shape and dtype) and
    ``d_final_state`` ((B, H, P, N) f32, or None for none). The route
    follows x's dtype (``BACKWARD_ROUTES``); it takes what the forward
    takes. Every check before the library is built or loaded."""
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"ssd_scan backward takes dy like x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    B, S, H, P = x.shape
    N = Bm.shape[3]
    extra = (dy,)
    if d_final_state is not None:
        if d_final_state.dtype != torch.float32 or \
                tuple(d_final_state.shape) != (B, H, P, N):
            raise ValueError(f"ssd_scan backward takes d_final_state "
                             f"{(B, H, P, N)} float32, got "
                             f"{tuple(d_final_state.shape)} "
                             f"{d_final_state.dtype}")
        extra += (d_final_state,)
    _check_inputs(x, dt, A, Bm, Cm, D, None)
    for t in extra:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ssd_scan backward takes contiguous gradients on "
                             "x's card")
    lib = _library()
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    work = torch.empty(lib.ssd_scan_backward_work(B, S, H, N),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_backward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), dy.data_ptr(),
            None if d_final_state is None else d_final_state.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(),
            dCm.data_ptr(), dD.data_ptr(), work.data_ptr(), B, S, H, P, N,
            _DTYPE_CODES[x.dtype], stream)
    _build.check_error(lib, "ssd_scan", err)
    return dx, ddt, dA, dBm, dCm, dD
