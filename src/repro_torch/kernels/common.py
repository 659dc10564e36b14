"""Shared kernel-dispatch policy, by device alone.

A kernel's public op takes tensors and routes them by where they lie:

    cpu    the plain PyTorch version (the CPU tests' path)
    cuda   the hand-written kernel — or the op raises

Any other device raises. There is no switch that sends a CUDA tensor to
the plain version: a card either runs the kernel or the call fails. A
kernel without a backward kernel (``decode_attention`` and ``fleet_mlp``,
which serve and score and which no training path differentiates)
refuses, on a card, a call that autograd would record
(``forbid_autograd``), rather than return a result that carries no
gradient.
"""
from __future__ import annotations

import torch

PLAIN = "plain"
KERNEL = "kernel"


def resolve(*tensors: torch.Tensor) -> str:
    """``PLAIN`` for CPU tensors, ``KERNEL`` for CUDA tensors; raises for
    mixed devices and for every other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return PLAIN
    if device.type == "cuda":
        return KERNEL
    raise RuntimeError(f"no kernel and no plain route for device {device}")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA card "
                           "is available (pass device='cpu' to run on the "
                           "CPU)")
    return dev


def forbid_autograd(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would record a kernel
    call: grad mode is on and one of ``tensors`` requires grad. Called by
    the ops whose kernels have no backward, on their kernel route only
    (their plain versions differentiate)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward, so its output would "
            f"carry no gradient; no training path of the JAX package "
            f"differentiates it (serving and forecast scoring only). Call "
            f"it under torch.no_grad() or on detached tensors.")
