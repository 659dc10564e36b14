"""Builds and launches the hand-written CUDA ``fleet_mlp`` kernel
(``csrc/fleet_mlp.cu``).

The source compiles at first use through ``kernels/build.py`` (``nvcc``
into a ``ctypes`` library under ``build/repro_torch/``). Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, NamedTuple, Sequence

import torch

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fleet_mlp.cu"

# Launch geometry of csrc/fleet_mlp.cu; checked against the library's own
# constants when it loads.
MAX_DEPTH = 8
MAX_SMEM_BYTES = 232448          # the most a block can have (227 KB)
SM_SMEM_BYTES = 233472           # an SM's (228 KB), 1 KB of it per block
ROW_BLOCK = 4                    # rows of x folded together when b > 1
SLACK = 32                       # a ring stage's bytes beyond its chunk
BAR_BYTES = 1024                 # mbarriers and layer tables, ahead of the rings
WIDE_THREADS = 288               # 8 consumer warps + 1 producer warp
WIDE_STAGES = 4
WIDE_CHUNK_BYTES = 16384
WIDE_BLOCKS_PER_SM = 2
NARROW_MAX_WIDTH = 64            # widest layer output the narrow route takes
NARROW_WARPS = 4                 # instances a narrow block, one a warp
NARROW_MAX_STAGES = 6
NARROW_CHUNK_BYTES = 8192        # the most; a stage holds the largest chunk
CONFIG = (MAX_DEPTH, MAX_SMEM_BYTES, SM_SMEM_BYTES, ROW_BLOCK, SLACK,
          BAR_BYTES, WIDE_THREADS, WIDE_STAGES, WIDE_CHUNK_BYTES,
          WIDE_BLOCKS_PER_SM, NARROW_MAX_WIDTH, NARROW_WARPS,
          NARROW_MAX_STAGES, NARROW_CHUNK_BYTES)
ROUTES = ("narrow", "wide")      # the C side's route codes 0 and 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (rows, widths, N) the library's own plan must agree with ``plan_launch``
# on when it loads: both routes, their edges, and shapes neither holds;
# planned for a card of _PROBE_SMS SMs (compared, never launched)
_PROBE_SMS = 132
_PLAN_PROBES = (
    (1, (54, 512, 512, 512, 512, 1), 512), (1, (54, 64, 64, 64, 64, 1), 512),
    (1, (54, 32, 32, 32, 32, 1), 13), (1, (30, 16, 16, 16, 16, 1), 1024),
    (2, (7, 13, 13, 1), 6), (2, (7, 131, 131, 1), 5),
    (3, (54, 64, 64, 64, 64, 1), 9), (3, (54, 512, 512, 512, 512, 1), 5),
    (1, (54, 65, 1), 3), (1, (2048, 64, 1), 7), (100, (54, 64, 1), 7),
    (1, (8, 1), 3), (40, (54, 512, 512, 1), 3), (54, (54, 512, 512, 1), 3),
    (56, (54, 512, 512, 1), 3), (64, (8, 1024, 1), 2), (1, (8, 4097, 1), 2),
    (1, (8,) * (MAX_DEPTH + 2), 2))


class Plan(NamedTuple):
    """How ``fleet_mlp_forward`` launches: the route, threads a block,
    dynamic shared memory, instances a block (narrow: one a warp; wide: 0,
    the blocks are persistent and walk the instances), and the ring of
    weight chunks (a block's on the wide route, a warp's on the narrow):
    stages, and bytes a stage (a chunk plus ``SLACK``)."""
    route: str
    threads: int
    smem: int
    per_block: int
    stages: int
    stage_bytes: int

    def blocks(self, n: int, sms: int) -> int:
        """The grid for ``n`` instances on a card of ``sms`` SMs."""
        if self.route == "narrow":
            return -(-n // self.per_block)
        per_sm = min(WIDE_BLOCKS_PER_SM, SM_SMEM_BYTES // (self.smem + 1024))
        return min(n, sms * per_sm)


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
    lib.fleet_mlp_plan.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.fleet_mlp_plan.restype = None
    lib.fleet_mlp_error_string.argtypes = [ctypes.c_int]
    lib.fleet_mlp_error_string.restype = ctypes.c_char_p
    cfg = (ctypes.c_int * len(CONFIG))()
    lib.fleet_mlp_config(cfg)
    if tuple(cfg) != CONFIG:
        raise RuntimeError(f"{path.name}: launch geometry {tuple(cfg)} "
                           f"!= the wrapper's {CONFIG}")
    for rows, widths, n in _PLAN_PROBES:
        got, want = library_plan(lib, rows, widths, n, _PROBE_SMS), None
        try:
            p = plan_launch(rows, widths)
            want = (ROUTES.index(p.route), p.threads, p.smem,
                    p.blocks(n, _PROBE_SMS), p.stages, p.stage_bytes)
        except ValueError:
            pass
        if (got[0] < 0) != (want is None) or (want and got != want):
            raise RuntimeError(f"{path.name}: plan {got} at b={rows}, "
                               f"widths {list(widths)}, N {n} != the "
                               f"wrapper's {want}")


def library_plan(lib, rows: int, widths: Sequence[int], n: int,
                 sms: int) -> tuple:
    """The library's own plan: (route code, threads, shared memory,
    blocks, stages, bytes a stage), route -1 where it holds no launch."""
    out = (ctypes.c_int * 6)()
    lib.fleet_mlp_plan((ctypes.c_int * len(widths))(*widths),
                       len(widths) - 1, rows, n, sms, out)
    return tuple(out)


def _library():
    return _build.load(SOURCE, "fleet_mlp", _bind)


def plan_launch(rows: int, widths: Sequence[int]) -> Plan:
    """The route and geometry ``fleet_mlp_forward`` picks for ``rows``
    (b) and the layer widths, or ``ValueError`` for a shape neither route
    holds. Sized at f32 width, so the plan does not depend on the type.

    Narrow when no layer is wider than ``NARROW_MAX_WIDTH`` and
    ``NARROW_WARPS`` warps' rings (two stages at least, unless one chunk
    holds the instance) and f32 buffers (two ``rows x max(widths)``
    activation buffers and the biases) fit a block. A narrow stage holds
    the largest chunk of whole rows the layers need, up to
    ``NARROW_CHUNK_BYTES``; a ring holds every chunk of an instance, up to
    ``NARROW_MAX_STAGES``, or what shared memory allows. Wide otherwise,
    when a row of every layer fits a chunk and one instance's buffers fit
    beside a ring of ``WIDE_STAGES`` chunks, or fewer (two at least), or
    two smaller ones (a row of the widest layer at least)."""
    depth = len(widths) - 1
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"fleet_mlp kernel takes depth 1..{MAX_DEPTH}, "
                         f"got {depth}")
    if rows < 1 or min(widths) < 1:
        raise ValueError(f"fleet_mlp kernel takes b >= 1 and widths >= 1, "
                         f"got b={rows}, widths {list(widths)}")
    own = 4 * (2 * rows * max(widths) + sum(widths[1:]))
    widest = max(widths[1:])
    if widest <= NARROW_MAX_WIDTH:
        rpc = [min(fin, NARROW_CHUNK_BYTES // (4 * fout))
               for fin, fout in zip(widths, widths[1:])]
        chunks = sum(-(-fin // r) for fin, r in zip(widths, rpc))
        biggest = max(r * 4 * fout for r, fout in zip(rpc, widths[1:]))
        stage_bytes = -(-biggest // 16) * 16 + SLACK
        room = ((MAX_SMEM_BYTES - BAR_BYTES) // NARROW_WARPS - own) \
            // stage_bytes
        stages = min(chunks, NARROW_MAX_STAGES, room)
        if stages >= 2 or stages == chunks == 1:
            return Plan("narrow", NARROW_WARPS * 32,
                        BAR_BYTES + NARROW_WARPS * (stages * stage_bytes + own),
                        NARROW_WARPS, stages, stage_bytes)
    if 4 * widest > WIDE_CHUNK_BYTES:
        raise ValueError(f"fleet_mlp kernel takes layers up to "
                         f"{WIDE_CHUNK_BYTES // 4} wide (a row of W in one "
                         f"{WIDE_CHUNK_BYTES}-byte chunk), got {widest}")
    room = MAX_SMEM_BYTES - BAR_BYTES - own
    stages = min(WIDE_STAGES, room // (WIDE_CHUNK_BYTES + SLACK))
    stage_bytes = WIDE_CHUNK_BYTES + SLACK
    if stages < 2:
        stages, stage_bytes = 2, room // 2 // 16 * 16
        if stage_bytes - SLACK < -(-4 * widest // 16) * 16:
            raise ValueError(
                f"fleet_mlp kernel needs more shared memory than a block "
                f"has ({MAX_SMEM_BYTES} bytes) for b={rows} x width "
                f"{max(widths)}: {own} bytes of f32 buffers and two rows "
                f"of W")
    return Plan("wide", WIDE_THREADS, BAR_BYTES + stages * stage_bytes + own,
                0, stages, stage_bytes)


def smem_bytes(rows: int, widths: Sequence[int]) -> int:
    """Dynamic shared memory of one block of the planned route."""
    return plan_launch(rows, widths).smem


def check_launch(rows: int, widths: Sequence[int]) -> None:
    """Raise on a shape neither route can hold."""
    plan_launch(rows, widths)


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
