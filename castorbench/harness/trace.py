"""The device's side of a ``--trace 1`` run: ``torch.profiler`` records
the card's operations (kernels, copies, fills) over the measured window;
this module reads their intervals, the busy time (their union), the time
by operation, and the idle gaps, each under the host span that was open.

The profiler's clock is tied to the host's by a marker: right after a
synchronise, the host clock is read and one operation is queued; it is
the trace's first operation."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class DeviceTrace:
    start: np.ndarray          # seconds on the host clock
    end: np.ndarray
    window: Tuple[float, float]
    by_name: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def merged(self) -> np.ndarray:
        """Union of the operations' intervals inside the window:
        ``(k, 2)``."""
        lo, hi = self.window
        s, e = np.clip(self.start, lo, hi), np.clip(self.end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if s.size == 0:
            return np.zeros((0, 2))
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(s.size, bool)
        new[1:] = s[1:] > e[:-1]
        first = np.nonzero(new)[0]
        last = np.append(first[1:] - 1, s.size - 1)
        return np.stack([s[first], e[last]], axis=1)

    def busy_s(self) -> float:
        m = self.merged()
        return float((m[:, 1] - m[:, 0]).sum())

    def gaps(self) -> np.ndarray:
        """Idle intervals inside the window: ``(k, 2)``."""
        m = self.merged()
        lo, hi = self.window
        edges = np.concatenate([[lo], m.ravel(), [hi]]).reshape(-1, 2)
        return edges[edges[:, 1] > edges[:, 0]]

    def time_of(self, needle: str) -> float:
        return sum(v for k, v in self.by_name.items() if needle in k)


def _kineto_events(prof):
    """``(name, start_s, end_s)`` of the trace's device operations, on the
    profiler's clock."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e9,
             (e.start_ns() + e.duration_ns()) / 1e9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class DeviceRecorder:
    """Starts the profiler and the marker; ``stop`` returns the
    ``DeviceTrace`` of the window ``[marker, t_end]`` on the host clock.
    On the CPU it records nothing and returns None."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None

    def start(self) -> "DeviceRecorder":
        if not self.cuda:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.ones(1, device="cuda").add_(1)
        return self

    def stop(self, t_end: float):
        if self.prof is None:
            return None
        import torch
        torch.cuda.synchronize()
        self.prof.stop()
        events = _kineto_events(self.prof)
        if not events:
            raise RuntimeError("the profiler recorded no device operation")
        first = min(events, key=lambda e: e[1])
        shift = first[1] - self.t_mark
        start = np.asarray([e[1] for e in events]) - shift
        end = np.asarray([e[2] for e in events]) - shift
        by_name: Dict[str, float] = {}
        for (n, _, _), s, e in zip(events, start, end):
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        return DeviceTrace(start, end, (self.t_mark, t_end), by_name)


def host_labels(run, mids: np.ndarray) -> List[str]:
    """What the host was doing at each time of ``mids``: the innermost
    program span open then, else the benchmark's own step (its ingest,
    its wait for the card, or its loop between ticks)."""
    labels = np.full(mids.size, "bench.loop", dtype=object)
    order = np.argsort(mids)
    sm = mids[order]
    intervals = []
    for t in run.ticks:
        intervals.append((t.t0, t.t_ingested, "bench.ingest"))
        intervals.append((t.t_ticked, t.t1, "bench.sync"))
        intervals.extend((s.t0, s.t1, s.name) for s in t.spans)
    # widest first, so an inner span overwrites its parents
    for lo, hi, name in sorted(intervals, key=lambda x: x[0] - x[1]):
        a, b = np.searchsorted(sm, lo), np.searchsorted(sm, hi, "right")
        labels[order[a:b]] = name
    return list(labels)


def breakdown(run, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each as ``[[name, seconds], ...]``."""
    tr = run.trace
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = tr.gaps()
    idle: Dict[str, float] = {}
    if gaps.size:
        for lab, g in zip(host_labels(run, gaps.mean(axis=1)),
                          gaps[:, 1] - gaps[:, 0]):
            idle[lab] = idle.get(lab, 0.0) + float(g)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], float(s)] for n, s in ops],
            "idle_gaps": [[n, float(s)] for n, s in gaps_top]}
