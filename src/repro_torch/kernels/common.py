"""Shared kernel-dispatch policy, by device alone.

A kernel's public op takes tensors and routes them by where they lie:

    cpu    the plain PyTorch version (the CPU tests' path)
    cuda   the hand-written kernel — or the op raises

Any other device raises. There is no switch that sends a CUDA tensor to
the plain version: a card either runs the kernel or the call fails.
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
