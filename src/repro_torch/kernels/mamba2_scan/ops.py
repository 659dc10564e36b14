"""Public entry point for the Mamba2 SSD scan."""
from __future__ import annotations

import torch

from ..common import KERNEL, forbid_autograd, resolve
from .kernel import ssd_scan_cuda
from .ref import ssd_chunked

#: Dispatch counter, one per call that ran. A CUDA tensor only ever reaches
#: the kernel, so on a card each count is one kernel launch.
_invocations = 0


def invocation_count() -> int:
    return _invocations


def reset_invocation_count() -> None:
    global _invocations
    _invocations = 0


def _check_shapes(x, dt, A, Bm, Cm, D, init_state, chunk: int) -> None:
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P) and Bm, Cm (B,S,G,N), got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G != 1:
        raise ValueError(f"ssd_scan takes one group (ngroups = 1, as every "
                         f"assigned arch), got {G}")
    want = {"dt": (B, S, H), "A": (H,), "Bm": (B, S, 1, N),
            "Cm": (B, S, 1, N), "D": (H,)}
    got = {"dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape} for x "
                             f"{tuple(x.shape)}, got "
                             f"{tuple(got[name].shape)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"init_state must be {(B, H, P, N)}, got "
                         f"{tuple(init_state.shape)}")
    if chunk < 1 or S % min(chunk, S):
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {min(chunk, S)}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             init_state=None, *, chunk: int = 64):
    """Chunked SSD scan. Returns ``(y (B,S,H,P) in x.dtype, final_state
    (B,H,P,N) f32)``; shapes as in ``ref.py``, one group. ``S`` must be a
    multiple of ``min(chunk, S)``, as in the reference. CPU tensors take
    the plain version (which continues from ``init_state``), CUDA tensors
    the kernel (which starts from zero; an ``init_state`` raises); any
    other device raises. On a card, a call that autograd would record
    raises: the kernel has no backward."""
    global _invocations
    _check_shapes(x, dt, A, Bm, Cm, D, init_state, chunk)
    chunk = min(chunk, x.shape[1])
    extra = () if init_state is None else (init_state,)
    if resolve(x, dt, A, Bm, Cm, D, *extra) == KERNEL:
        forbid_autograd("ssd_scan", "ROADMAP.md Queue 1 item 4b",
                        x, dt, A, Bm, Cm, D, *extra)
        out = ssd_scan_cuda(x, dt, A, Bm, Cm, D, init_state)
    else:
        out = ssd_chunked(x, dt, A, Bm, Cm, D, init_state, chunk=chunk)
    _invocations += 1
    return out
