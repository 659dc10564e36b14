"""Futures API for the serverless invoker (the Lithops ``ResponseFuture``
+ ``wait()`` surface, adapted).

One ``ResponseFuture`` tracks one logical invocation across its whole
at-least-once lifecycle — retries, backoff, speculative backup copies are
all the SAME future; it completes once, with the first winning
``InvocationResult`` (after the invoker has absorbed/persisted its
effects) or with the terminal error after every copy burned its budget.

``wait(fs, return_when=ANY_COMPLETED | ALL_COMPLETED | ALWAYS)`` mirrors
Lithops semantics:

* ``ANY_COMPLETED`` — block until at least one future is done; the
  returned ``done`` list is in COMPLETION order, so streaming consumers
  can absorb results as workers finish instead of at a phase barrier.
* ``ALL_COMPLETED`` — block until every future is done.
* ``ALWAYS`` — never block; partition by current state.

On ``timeout`` expiry ``wait`` raises ``FuturesTimeoutError`` carrying the
still-pending futures, after CANCELLING them: the invoker observes the
cancellation, stops retrying that invocation, and marks its jobs failed so
the scheduler re-fires each occurrence at its original boundary — a timed
out action's late effects stay consistent because all persistence is
idempotent on the occurrence stamp.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

ANY_COMPLETED = "ANY_COMPLETED"
ALL_COMPLETED = "ALL_COMPLETED"
ALWAYS = "ALWAYS"


class FuturesTimeoutError(TimeoutError):
    """``wait`` timed out; ``pending`` holds the (now cancelled) futures
    that had not completed when the deadline expired."""

    def __init__(self, msg: str, pending: Sequence["ResponseFuture"]):
        super().__init__(msg)
        self.pending = list(pending)


class ResponseFuture:
    """State machine: pending -> (success | error | cancelled), one
    transition, observable via ``done``/``result()`` and done-callbacks.
    The invoker owns the setter side (``_set_result``/``_set_error``);
    consumers own ``result``/``cancel``/``wait``."""

    def __init__(self, invocation_id: str = "", payload=None):
        self.invocation_id = invocation_id
        self.payload = payload
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._callbacks: List[Callable[["ResponseFuture"], None]] = []
        self._result = None
        self._error: Optional[BaseException] = None
        self._cancelled = False

    # ---------------------------------------------------------- state
    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def success(self) -> bool:
        return self.done and self._error is None and not self._cancelled

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    # ---------------------------------------------------------- consumer
    def result(self, timeout: Optional[float] = None, *,
               throw_except: bool = True):
        """Block until done; return the ``InvocationResult`` of the
        winning copy. Raises the terminal error / ``CancelledError`` when
        ``throw_except`` (default), else returns None."""
        if not self._event.wait(timeout):
            raise FuturesTimeoutError(
                f"invocation {self.invocation_id or '?'} not done "
                f"after {timeout}s", [self])
        if self._cancelled:
            if throw_except:
                raise CancelledError(
                    f"invocation {self.invocation_id or '?'} cancelled")
            return None
        if self._error is not None:
            if throw_except:
                raise self._error
            return None
        return self._result

    def cancel(self) -> bool:
        """Cancel if not yet done. The action itself cannot be interrupted
        mid-flight — cancellation means the invoker stops retrying and the
        jobs re-fire via the scheduler; late effects of an already-running
        copy are absorbed by store idempotency."""
        with self._lock:
            if self._event.is_set():
                return False
            self._cancelled = True
            cbs = self._finish_locked()
        self._fire(cbs)
        return True

    # ---------------------------------------------------------- producer
    def _set_result(self, result) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            cbs = self._finish_locked()
        self._fire(cbs)
        return True

    def _set_error(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = exc
            cbs = self._finish_locked()
        self._fire(cbs)
        return True

    def _finish_locked(self):
        cbs, self._callbacks = self._callbacks, []
        self._event.set()
        return cbs

    def _fire(self, cbs) -> None:
        for cb in cbs:
            cb(self)

    def _on_done(self, cb: Callable[["ResponseFuture"], None]) -> None:
        """Register a completion callback; fired immediately if already
        done (from the completing thread otherwise)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def __repr__(self) -> str:
        state = ("cancelled" if self._cancelled else
                 "error" if self._error is not None else
                 "success" if self.done else "pending")
        return f"ResponseFuture({self.invocation_id!r}, {state})"


class CancelledError(RuntimeError):
    pass


def wait(fs: Sequence[ResponseFuture], *,
         return_when: str = ALL_COMPLETED,
         timeout: Optional[float] = None,
         throw_except: bool = True,
         ) -> Tuple[List[ResponseFuture], List[ResponseFuture]]:
    """Partition ``fs`` into ``(done, pending)``.

    ``done`` lists futures in completion order (futures already done at
    entry first, in input order). With ``return_when=ANY_COMPLETED`` the
    call returns as soon as one future is done; ``ALL_COMPLETED`` waits
    for every one; ``ALWAYS`` never blocks. A ``timeout`` expiry cancels
    the pending futures and raises ``FuturesTimeoutError`` when
    ``throw_except`` (default), else returns the partition as-is.
    """
    if return_when not in (ANY_COMPLETED, ALL_COMPLETED, ALWAYS):
        raise ValueError(f"unknown return_when {return_when!r}")
    fs = list(fs)
    done: List[ResponseFuture] = [f for f in fs if f.done]
    if return_when == ALWAYS or not fs:
        return done, [f for f in fs if not f.done]

    cond = threading.Condition()
    order: List[ResponseFuture] = []

    def _cb(f: ResponseFuture) -> None:
        with cond:
            if f not in done and f not in order:
                order.append(f)
            cond.notify_all()

    for f in fs:
        if f not in done:
            f._on_done(_cb)

    need = 1 if return_when == ANY_COMPLETED else len(fs)
    deadline = None if timeout is None else time.monotonic() + timeout
    with cond:
        while len(done) + len(order) < need:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
            cond.wait(remaining)
        done = done + list(order)
    pending = [f for f in fs if f not in done]
    if pending and len(done) < need:
        for f in pending:
            f.cancel()
        if throw_except:
            raise FuturesTimeoutError(
                f"{len(pending)} of {len(fs)} invocations not done after "
                f"{timeout}s (cancelled)", pending)
    return done, pending
