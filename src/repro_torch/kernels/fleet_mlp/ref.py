"""Plain PyTorch version of the fleet-batched MLP: N independent model
instances, each with its OWN weights, scored in one batched computation.

    x:       (N, b, F)                per-instance feature batch
    weights: [ (N, F, H1), (N, H1, H2), ..., (N, Hk, O) ]
    biases:  [ (N, H1), ..., (N, O) ]
ReLU between layers, final layer linear. float32 accumulation, output in
``x.dtype``. The CPU path of ``ops.fleet_mlp`` and the yardstick the CUDA
kernel is held against.
"""
from __future__ import annotations

import torch


def fleet_mlp_reference(x, weights, biases):
    h = x.to(torch.float32)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.bmm(h, w.to(torch.float32)) + b.to(torch.float32)[:, None, :]
        if i < n - 1:
            h = torch.relu(h)
    return h.to(x.dtype)
