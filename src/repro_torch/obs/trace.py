"""Hierarchical span tracer with cross-process stitching.

A span is one timed interval on the request path — ``castor.tick`` →
``scheduler.poll`` → ``exec.phase.*`` → ``exec.bin`` → ``store.*`` /
``journal.flush``. Spans nest via a per-thread stack: a span opened
while another is active becomes its child and inherits its trace id, so
every tick is one trace.

Design constraints:

- **Counter-based ids.** Span and trace ids come from
  ``itertools.count().__next__`` (atomic in CPython) — no uuid/random,
  so traces are deterministic under an injected clock.
- **Injectable monotonic clock.** ``Tracer(clock=...)`` lets tests
  drive time explicitly; ``epoch`` anchors the monotonic clock to wall
  time for Perfetto export.
- **Bounded ring.** Finished spans land in a ``deque(maxlen=capacity)``
  — O(1) append, oldest evicted; ``evicted`` is derivable from
  ``finished - len(buf)``.
- **Cheap when off.** ``span()`` on a disabled tracer returns one
  shared no-op context manager: no allocation, two attribute loads.

Cross-process stitching: the invoker puts ``current()`` —
``{"trace_id", "parent_id"}`` — on the JSON invocation payload; the
worker process opens its spans under ``adopt(ctx)`` so they carry the
invoker's trace id and parent under the invoker's (pre-allocated)
invoke-span id; ``export_since(mark)`` ships the worker's finished
spans back on the result JSON; ``absorb()`` re-ids them onto the
invoker's counter (remapping internal parent links, preserving the
remote parent link) and optionally re-bases their timestamps onto the
invoker's clock — one stitched trace, correct parentage, no shared
memory.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple


class Span:
    """One finished interval. ``args`` is a small dict or None.
    ``remote_parent`` marks a span whose ``parent_id`` lives in ANOTHER
    process's id space (it was opened under ``adopt``): two processes
    draw ids from independent counters, so without the flag ``absorb``
    could not tell a remote parent from a numerically-colliding local
    one."""
    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "t0", "t1", "tid", "args", "seq", "remote_parent")

    def __init__(self, trace_id, span_id, parent_id, name, t0, t1, tid,
                 args, seq, remote_parent=False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.args = args
        self.seq = seq
        self.remote_parent = remote_parent

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "t0": self.t0, "t1": self.t1, "tid": self.tid}
        if self.args:
            d["args"] = self.args
        if self.remote_parent:
            d["rp"] = 1
        return d

    @staticmethod
    def from_dict(d: dict) -> "Span":
        return Span(d["trace_id"], d["span_id"], d["parent_id"],
                    d["name"], d["t0"], d["t1"], d.get("tid", 0),
                    d.get("args"), 0, bool(d.get("rp")))

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, trace={self.trace_id}, "
                f"dur={self.duration:.6f})")


class _NullCtx:
    """Shared no-op span for disabled tracers."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


_NULL_CTX = _NullCtx()


class _SpanCtx:
    __slots__ = ("tracer", "name", "args", "trace_id", "span_id",
                 "parent_id", "remote", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        if stack:
            top = stack[-1]
            self.trace_id = top[0]
            self.parent_id = top[1]
            self.remote = top[2]
        else:
            self.trace_id = tr._next_trace()
            self.parent_id = 0
            self.remote = False
        self.span_id = tr._next_id()
        stack.append((self.trace_id, self.span_id, False))
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        t1 = tr.clock()
        tr._stack().pop()
        tr._finish(Span(self.trace_id, self.span_id, self.parent_id,
                        self.name, self.t0, t1,
                        threading.get_ident(), self.args, 0,
                        self.remote))
        return False

    def set(self, **kw):
        """Attach args discovered mid-span (e.g. a result count)."""
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)
        return self


class _AdoptCtx:
    """Pushes a remote (trace_id, parent_id) frame so spans opened under
    it stitch into a trace that lives in another process. The frame is
    marked remote: direct children record ``remote_parent=True`` so
    ``absorb`` never confuses their parent — an id from the INVOKER's
    counter — with a same-valued local worker span id."""
    __slots__ = ("tracer", "frame")

    def __init__(self, tracer: "Tracer", trace_id: int, parent_id: int):
        self.tracer = tracer
        self.frame = (trace_id, parent_id, True)

    def __enter__(self):
        self.tracer._stack().append(self.frame)
        return self

    def __exit__(self, *exc):
        self.tracer._stack().pop()
        return False


class Tracer:
    def __init__(self, capacity: int = 65536, clock=time.perf_counter,
                 enabled: bool = True,
                 epoch: Optional[Tuple[float, float]] = None):
        self.capacity = int(capacity)
        self.clock = clock
        self.enabled = enabled
        self.buf: deque = deque(maxlen=self.capacity)
        self._next_id = itertools.count(1).__next__
        self._next_trace = itertools.count(1).__next__
        self._seq = itertools.count(1).__next__
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.finished = 0
        # (wall_time, monotonic_time) anchor pairing the injectable
        # clock with the epoch, so export can emit absolute timestamps
        self.epoch = epoch if epoch is not None \
            else (time.time(), self.clock())

    # -- span lifecycle ------------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def span(self, name: str, **args):
        """Context manager timing one nested interval. On a disabled
        tracer this is the shared no-op (kwargs are still evaluated by
        the caller — keep call sites' kwargs cheap)."""
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, args or None)

    def _finish(self, span: Span) -> None:
        with self._lock:
            span.seq = self._seq()
            self.finished += 1
            self.buf.append(span)

    def record(self, name: str, t0: float, t1: float, *,
               span_id: Optional[int] = None, parent_id: int = 0,
               trace_id: Optional[int] = None,
               args: Optional[dict] = None) -> int:
        """Append an interval measured outside a ``with`` block (e.g. a
        serverless invocation whose dispatch and settle happen on
        different control-flow legs). ``span_id`` may be pre-allocated
        via ``allocate_id`` so children created elsewhere (a worker
        process) can parent under it before it is recorded."""
        if not self.enabled:
            return 0
        if span_id is None:
            span_id = self._next_id()
        if trace_id is None:
            trace_id = self._next_trace()
        self._finish(Span(trace_id, span_id, parent_id, name, t0, t1,
                          threading.get_ident(), args or None, 0))
        return span_id

    def allocate_id(self) -> int:
        return self._next_id()

    def new_trace_id(self) -> int:
        return self._next_trace()

    # -- cross-process stitching --------------------------------------
    def current(self) -> Optional[Dict[str, int]]:
        """Trace context of the innermost open span on this thread, as a
        JSON-ready dict — or None when no span is open (or disabled)."""
        if not self.enabled:
            return None
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        return {"trace_id": top[0], "parent_id": top[1]}

    def adopt(self, ctx: Optional[Dict[str, int]]):
        """Open spans under a remote trace context (see module doc)."""
        if not self.enabled or not ctx:
            return _NULL_CTX
        return _AdoptCtx(self, int(ctx["trace_id"]),
                         int(ctx["parent_id"]))

    def mark(self) -> int:
        """Watermark for ``export_since`` — spans finished after this
        call have a strictly greater ``seq``."""
        with self._lock:
            return self.finished

    def export_since(self, mark: int) -> List[dict]:
        """Finished spans with ``seq > mark``, oldest first, as JSON
        dicts. Walks the ring from the right so the cost is O(exported),
        not O(capacity)."""
        out: List[dict] = []
        with self._lock:
            for span in reversed(self.buf):
                if span.seq <= mark:
                    break
                out.append(span.to_dict())
        out.reverse()
        return out

    def absorb(self, spans: List[dict], t_base: Optional[float] = None) -> int:
        """Stitch spans shipped from another process into this tracer.

        Span ids are re-assigned from this tracer's counter (two
        processes draw from independent counters, so shipped ids may
        collide with local ones); parent links *within* the shipped set
        are remapped, while ``remote_parent`` spans — opened under
        ``adopt``, their parent being this process's invoke span — pass
        through untouched. When ``t_base`` is given, timestamps are
        shifted so
        the earliest shipped span starts at ``t_base`` (worker and
        invoker monotonic clocks are not comparable; the dispatch time
        on the invoker's clock is the honest anchor). Returns the number
        of spans absorbed."""
        if not self.enabled or not spans:
            return 0
        idmap = {d["span_id"]: self._next_id() for d in spans}
        shift = 0.0
        if t_base is not None:
            shift = t_base - min(d["t0"] for d in spans)
        for d in spans:
            s = Span.from_dict(d)
            s.span_id = idmap[s.span_id]
            if s.remote_parent:
                s.remote_parent = False     # parent is local to us now
            else:
                s.parent_id = idmap.get(s.parent_id, s.parent_id)
            s.t0 += shift
            s.t1 += shift
            self._finish(s)
        return len(spans)

    # -- inspection ----------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self.buf)

    @property
    def evicted(self) -> int:
        return self.finished - len(self.buf)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "finished": self.finished,
                    "buffered": len(self.buf),
                    "evicted": self.finished - len(self.buf)}

    def clear(self) -> None:
        """Drop every buffered span and restart the sequence, so a
        ``mark()`` taken after a clear is the last span's ``seq``."""
        with self._lock:
            self.buf.clear()
            self.finished = 0
            self._seq = itertools.count(1).__next__


NULL_TRACER = Tracer(capacity=1, enabled=False)

_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer. ``Castor`` and directly-constructed
    components (executors, stores, journals) default to this, so a
    worker process's spans land in one place for shipping."""
    return _DEFAULT


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests, ``benchmarks/run.py
    --trace``). Returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = tracer
    return prev
