"""Fault tolerance: failure detection and supervised restart.

  * ``HealthMonitor`` — heartbeat registry with failure injection (tests
    simulate node loss deterministically).
  * ``TrainSupervisor`` — wraps a train loop: on a step failure, restore
    from the last checkpoint and continue. On SIGTERM, checkpoint and exit
    (preemption).
  * ``largest_mesh_shape`` — the (data, model) grid an elastic restart
    would shrink to.

``elastic_remesh`` (rebuilding a device mesh from the survivors) waits for
the multi-GPU slice (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import math
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch


class NodeFailure(RuntimeError):
    pass


#: The card's runtime error (a failed or faulted launch, a lost device),
#: which a step may raise and the supervisor restarts from. Never a bare
#: RuntimeError: that would also swallow the program's own faults.
DEVICE_ERRORS = (torch.AcceleratorError,) \
    if hasattr(torch, "AcceleratorError") else ()


@dataclass
class HealthMonitor:
    """Heartbeat table + deterministic failure injection."""
    heartbeat_timeout_s: float = 30.0
    _last_beat: Dict[int, float] = field(default_factory=dict)
    _failed: set = field(default_factory=set)

    def beat(self, node_id: int, now: Optional[float] = None):
        if node_id in self._failed:
            raise NodeFailure(f"node {node_id} marked failed")
        self._last_beat[node_id] = time.time() if now is None else now

    def inject_failure(self, node_id: int):
        self._failed.add(node_id)

    def heal(self, node_id: int):
        self._failed.discard(node_id)

    def alive(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return sorted(n for n, t in self._last_beat.items()
                      if n not in self._failed
                      and now - t <= self.heartbeat_timeout_s)

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return sorted(set(self._last_beat) - set(self.alive(now)))


def largest_mesh_shape(n_devices: int, *, model_axis: int = 16):
    """Largest (data, model) grid using <= n_devices, keeping the model axis
    if possible (elasticity shrinks the DATA axis first)."""
    while model_axis > 1 and n_devices < model_axis:
        model_axis //= 2
    data = max(n_devices // model_axis, 1)
    # data axis must stay a power of two for clean batch resharding
    data = 2 ** int(math.log2(data))
    return (data, model_axis)


@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures_handled: int = 0
    restores: int = 0
    remeshes: int = 0
    preempted: bool = False
    final_step: int = 0


class TrainSupervisor:
    """Checkpoint/restart wrapper around a step function.

    ``step_fn(state, batch) -> state`` runs under supervision; a step that
    raises ``NodeFailure`` or the card's runtime error triggers a restore
    from the latest checkpoint (and ``on_remesh``, if given). SIGTERM
    triggers checkpoint-and-exit.
    """

    def __init__(self, ckpt_manager, *, checkpoint_every: int = 50,
                 max_restores: int = 8,
                 on_remesh: Optional[Callable[[int], None]] = None,
                 install_sigterm: bool = False):
        self.ckpt = ckpt_manager
        self.every = checkpoint_every
        self.max_restores = max_restores
        self.on_remesh = on_remesh
        self._preempt = threading.Event()
        if install_sigterm:
            signal.signal(signal.SIGTERM, lambda *_: self._preempt.set())

    def request_preemption(self):
        self._preempt.set()

    def run(self, state, batches, step_fn, *, start_step: int = 0,
            num_steps: int = 100) -> tuple:
        rep = SupervisorReport()
        step = start_step
        it = iter(batches)
        while step < num_steps:
            if self._preempt.is_set():
                self.ckpt.save_sync(state, step=step, extra={"preempted": True})
                rep.preempted = True
                break
            batch = next(it)
            try:
                state = step_fn(state, batch)
                step += 1
                rep.steps_run += 1
                if step % self.every == 0:
                    self.ckpt.save_async(state, step=step)
            except (NodeFailure, *DEVICE_ERRORS):
                rep.failures_handled += 1
                if rep.restores >= self.max_restores:
                    raise
                restored, manifest = self.ckpt.restore_latest(state)
                if restored is None:
                    raise
                state = restored
                step = manifest["step"]
                rep.restores += 1
                if self.on_remesh is not None:
                    self.on_remesh(rep.failures_handled)
                    rep.remeshes += 1
        self.ckpt.wait()
        rep.final_step = step
        return state, rep
