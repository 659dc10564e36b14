"""Deterministic fault injection for the serverless subsystem.

``ChaosPolicy`` makes every failure mode of a real serverless platform
injectable IN-PROCESS and reproducible by seed. Decisions are pure
functions of ``(seed, kind, invocation_id, attempt)`` — never of thread
timing — so a chaos run injects the identical fault set no matter how the
scheduler interleaves workers, and a failing seed replays exactly.

The four faults and where they bite (threaded through ``backend.py`` /
``worker.py``):

* **kill-mid-action** — the worker executes a strict PREFIX of the
  action's bins (their effects persist!) and then dies. The retry
  re-executes the WHOLE action on another worker; the already-persisted
  prefix must no-op at the idempotent stores.
* **drop-result** — the action executes to completion but its result
  never reaches the invoker (transport loss). The invoker retries a
  fully-persisted action; every effect must dedupe.
* **duplicate** — the payload is delivered (and executed) twice, the
  at-least-once delivery case.
* **delay** — the worker stalls before executing: stragglers, which with
  speculation enabled also provoke backup copies (another duplicate
  path).

``max_attempt`` bounds injection to early delivery attempts (default: the
first), so with fault probability 1.0 every invocation fails exactly once
and its retry proceeds cleanly — chaos that never lets work finish proves
nothing. The exactly-once invariant under all of this is pinned bitwise
by ``tests/test_torch_serverless.py``.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional


class ChaosKill(RuntimeError):
    """Injected worker death (possibly after partial persisted effects).
    Backend-level: the whole action is retriable on another worker."""


def _u01(seed: int, kind: str, invocation_id: str, attempt: int) -> float:
    """Deterministic uniform [0, 1) from the fault coordinates."""
    h = zlib.crc32(f"{seed}|{kind}|{invocation_id}|{attempt}"
                   .encode("utf-8"))
    return h / 4294967296.0


@dataclass
class ChaosPolicy:
    """Seeded fault probabilities, applied per (invocation, attempt).

    Probabilities are evaluated independently per fault kind; an
    invocation can draw delay AND kill. Injection only happens while
    ``payload.attempt <= max_attempt`` (default 1: first delivery only),
    which keeps at-least-once convergent by construction.
    """
    seed: int = 0
    kill_mid_action: float = 0.0   # P(worker dies after a prefix of bins)
    drop_result: float = 0.0       # P(result lost after full execution)
    duplicate: float = 0.0         # P(payload delivered twice)
    delay: float = 0.0             # P(straggler stall before execution)
    delay_s: float = 0.2           # stall duration when delay fires
    max_attempt: int = 1           # inject only on attempts <= this
    injected: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    # ------------------------------------------------------------ draws
    def _fires(self, kind: str, prob: float, payload) -> bool:
        if prob <= 0.0 or payload.attempt > self.max_attempt:
            return False
        if _u01(self.seed, kind, payload.invocation_id,
                payload.attempt) >= prob:
            return False
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1
        return True

    def kill_point(self, payload) -> Optional[int]:
        """None, or how many whole bins the worker completes before
        dying — a deterministic draw in [0, n_bins-1], so a multi-bin
        action can die with PARTIAL effects persisted."""
        if not self._fires("kill", self.kill_mid_action, payload):
            return None
        u = _u01(self.seed, "kill_point", payload.invocation_id,
                 payload.attempt)
        return int(u * max(1, payload.n_bins))

    def should_drop(self, payload) -> bool:
        return self._fires("drop", self.drop_result, payload)

    def should_duplicate(self, payload) -> bool:
        return self._fires("duplicate", self.duplicate, payload)

    def maybe_delay(self, payload) -> float:
        """Sleep the injected stall (returns the seconds slept)."""
        if not self._fires("delay", self.delay, payload):
            return 0.0
        time.sleep(self.delay_s)
        return self.delay_s

    # ------------------------------------------------------------ stats
    def summary(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.injected)
        out["total"] = sum(out.values())
        return out
