"""Chunked, compacting columnar time-series store (LSM-lite).

Semantics match the paper's store: ingestion is append-only (irregular,
possibly out-of-order timestamps allowed), reads return time-sorted views,
nothing is ever overwritten. Persistence is NPZ so a real backend (the
paper used a relational DB) could be swapped behind the same interface.

Engine design
-------------
The seed implementation concatenated and re-sorted a series' entire append
history on every ``read()`` (and even ``last_time()``), so read cost grew
superlinearly with ingestion. This engine organizes each series as:

* an unsorted **tail**: raw appended chunks, bounded by ``tail_max`` points;
* a list of sorted immutable **segments**: columnar ``(times, values)``
  pairs, each ascending in time, ordered oldest-to-newest by creation.

Write path: ``append`` lands chunks in the tail in O(1). When the tail
exceeds ``tail_max`` it is stable-sorted into a new segment (touching only
the new points) and similar-sized segments are tiered-merged two at a time.
A merge of two sorted runs is a single linear interleave (the searchsorted
trick) — the full history is **never** re-sorted in one shot, and total
ingest cost stays O(n log n) amortized with O(log n) live segments.

Read path: ``read``/``read_many`` binary-search every segment's window
boundaries plus a cached sorted view of the tail, and linearly interleave
only the returned window points — O(log n + k + dirty) for a k-point
window, where *dirty* is the (usually tiny) data not yet in the oldest
segment. When dirty data exceeds 1/8 of the series, the read first
consolidates (flush tail, linear-merge segments to one) so the cost is
amortized against the appends that created it; after that, reads are pure
O(log n + k) slices until enough new appends arrive. Steady interleaved
append/read workloads therefore never rewrite the full history per read.
``last_time``/``first_time`` are O(1) (tracked incrementally on append).

Invariants (checked by ``tests/test_store.py``):

1. every segment is sorted ascending by time;
2. segments are ordered oldest-to-newest by creation, and points with equal
   timestamps keep global append order across tail sorts and merges (stable
   compaction — reads observe exactly the seed store's ordering);
3. ``sum(segment sizes) + tail size == count`` — compaction moves points,
   it never drops or duplicates them;
4. returned arrays are read-only views of immutable segment storage —
   many parallel model executions share one columnar copy (copy before
   mutating).

Concurrency: one lock per store guards both paths (appends are chunk-level,
as in the paper's parallel-sender ingestion benchmark); reads may compact
but observe the same points an uncompacted read would.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _merge_sorted(t_old: np.ndarray, v_old: np.ndarray,
                  t_new: np.ndarray, v_new: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Linear stable interleave of two sorted runs (older run wins ties)."""
    n1, n2 = t_old.size, t_new.size
    pos_old = np.searchsorted(t_new, t_old, side="left") + np.arange(n1)
    pos_new = np.searchsorted(t_old, t_new, side="right") + np.arange(n2)
    t = np.empty(n1 + n2, np.float64)
    v = np.empty(n1 + n2, np.float64)
    t[pos_old], t[pos_new] = t_old, t_new
    v[pos_old], v[pos_new] = v_old, v_new
    return t, v


def _freeze(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@dataclass
class _Segment:
    """Immutable sorted columnar run."""
    times: np.ndarray
    values: np.ndarray

    @property
    def n(self) -> int:
        return self.times.size


@dataclass
class _Series:
    segments: List[_Segment] = field(default_factory=list)
    tail_t: List[np.ndarray] = field(default_factory=list)
    tail_v: List[np.ndarray] = field(default_factory=list)
    tail_n: int = 0
    count: int = 0
    t_min: float = math.inf
    t_max: float = -math.inf
    tail_view: Optional[_Segment] = None    # cached sorted tail (ephemeral)


_EMPTY = _freeze(np.empty(0, np.float64))


class TimeSeriesStore:
    """Append-only columnar store; see module docstring for the design."""

    def __init__(self, *, tail_max: int = 1024, merge_factor: int = 2):
        self._data: Dict[str, _Series] = {}
        self._lock = threading.Lock()
        self.tail_max = int(tail_max)
        self.merge_factor = int(merge_factor)
        # telemetry (Fig. 2 benchmark + executor bin stats)
        self.append_count = 0          # points ingested
        self.read_count = 0            # single-series read() calls
        self.read_many_count = 0       # batched read_many() calls
        self.delta_read_count = 0      # watermark-delta read_many(since=...)
        self.compaction_count = 0      # tail flushes
        self.merge_count = 0           # segment merges
        self.merged_points = 0         # points moved by merges
        self.journal = None            # durability.Journal when Castor.open'd

    # ---------------- write path ----------------
    def append(self, ts_id: str, times, values) -> int:
        times = np.asarray(times, np.float64).ravel()
        values = np.asarray(values, np.float64).ravel()
        assert times.shape == values.shape, (times.shape, values.shape)
        if times.size == 0:
            return 0
        with self._lock:
            s = self._data.setdefault(ts_id, _Series())
            s.tail_t.append(times)
            s.tail_v.append(values)
            s.tail_n += times.size
            s.tail_view = None
            s.count += times.size
            s.t_min = min(s.t_min, float(times.min()))
            s.t_max = max(s.t_max, float(times.max()))
            self.append_count += times.size
            j = self.journal
            if j is not None:      # one record per append call (atomic:
                j.append("ts", {   # a chunk replays whole or not at all)
                    "id": ts_id, "t": times, "v": values})
            if s.tail_n >= self.tail_max:
                self._flush_tail(s)
                self._tier_merge(s)
        return times.size

    def append_points(self, ts_ids: Sequence[str], times, values) -> int:
        """Batched one-point-per-series append under ONE lock — the
        detection flow's derived-signal write-back (a minutely bin lands
        exactly one (t, score) point on every sensor's anomaly series;
        N ``append()`` calls would pay N lock round-trips and N array
        coercions for scalar writes)."""
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        if not tracer.enabled:
            return self._append_points(ts_ids, times, values)
        with tracer.span("store.append_points", n=len(ts_ids)):
            return self._append_points(ts_ids, times, values)

    def _append_points(self, ts_ids: Sequence[str], times, values) -> int:
        t = np.asarray(times, np.float64).ravel()
        v = np.asarray(values, np.float64).ravel()
        assert len(ts_ids) == t.size == v.size, (len(ts_ids), t.size, v.size)
        t_list = t.tolist()                  # python floats: cheap compares
        # one C-loop view split per column instead of a python slice pair
        # per point (rows of the (n, 1) reshape are the same 1-element
        # float64 views t[k:k+1] would produce)
        rows_t = list(t.reshape(-1, 1))
        rows_v = list(v.reshape(-1, 1))
        data_get = self._data.get
        tail_max = self.tail_max
        with self._lock:
            for k, ts_id in enumerate(ts_ids):
                # get-then-create, not setdefault(_Series()): steady state
                # always hits, and a throwaway _Series per point is real
                # money at fleet width
                s = data_get(ts_id)
                if s is None:
                    s = self._data[ts_id] = _Series()
                s.tail_t.append(rows_t[k])
                s.tail_v.append(rows_v[k])
                s.tail_n += 1
                s.tail_view = None
                s.count += 1
                tk = t_list[k]
                if tk < s.t_min:
                    s.t_min = tk
                if tk > s.t_max:
                    s.t_max = tk
                if s.tail_n >= tail_max:
                    self._flush_tail(s)
                    self._tier_merge(s)
            self.append_count += t.size
            j = self.journal
            if j is not None:      # whole batch = one atomic record (the
                j.append("tsp", {  # detection flow suppresses this and
                    "ids": list(ts_ids), "t": t, "v": v})   # journals the
            # coarser "det" record instead — see DetectionStore.save_many)
        return int(t.size)

    def _flush_tail(self, s: _Series) -> None:
        """Promote the sorted tail view to a new immutable segment."""
        if not s.tail_n:
            return
        s.segments.append(self._tail_segment(s))   # reuses the cached sort
        s.tail_t, s.tail_v, s.tail_n = [], [], 0
        s.tail_view = None
        self.compaction_count += 1

    def _tier_merge(self, s: _Series) -> None:
        """Merge newest segments while similar-sized (amortized O(n log n))."""
        while (len(s.segments) >= 2 and
               s.segments[-1].n * self.merge_factor >= s.segments[-2].n):
            self._merge_last_two(s)

    def _merge_last_two(self, s: _Series) -> None:
        new = s.segments.pop()
        old = s.segments.pop()
        t, v = _merge_sorted(old.times, old.values, new.times, new.values)
        s.segments.append(_Segment(_freeze(t), _freeze(v)))
        self.merge_count += 1
        self.merged_points += t.size

    def _consolidate(self, s: _Series) -> None:
        """Flush tail + linear-merge down to a single sorted segment."""
        self._flush_tail(s)
        while len(s.segments) > 1:
            self._merge_last_two(s)

    def compact(self, ts_id: Optional[str] = None) -> None:
        """Force full consolidation (one sorted segment per series).

        Call after bulk ingest so the first fleet read is already a pure
        binary-search slice.
        """
        with self._lock:
            if ts_id is not None:
                s = self._data.get(ts_id)       # unknown id: no-op, like read
                targets = [s] if s is not None else []
            else:
                targets = list(self._data.values())
            for s in targets:
                self._consolidate(s)

    # ---------------- read path ----------------
    def _tail_segment(self, s: _Series) -> _Segment:
        """Sorted view of the tail, cached until the next append."""
        if s.tail_view is None:
            t = np.concatenate(s.tail_t) if len(s.tail_t) > 1 else s.tail_t[0]
            v = np.concatenate(s.tail_v) if len(s.tail_v) > 1 else s.tail_v[0]
            order = np.argsort(t, kind="stable")
            s.tail_view = _Segment(_freeze(t[order]), _freeze(v[order]))
        return s.tail_view

    def _prior_count_locked(self, s: Optional[_Series], t) -> int:
        """Number of stored points with time < ``t`` — O(log n) binary
        searches over the sorted segments plus the cached sorted tail.
        This is the late-data watermark check for delta readers: a count
        that moved under an unchanged watermark means an out-of-order
        append landed in already-consumed history."""
        if s is None or s.count == 0 or t is None:
            return 0
        n = sum(int(np.searchsorted(seg.times, t)) for seg in s.segments)
        if s.tail_n:
            n += int(np.searchsorted(self._tail_segment(s).times, t))
        return n

    def _read_locked(self, s: Optional[_Series], start, end,
                     consolidate: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if s is None or s.count == 0:
            return _EMPTY, _EMPTY
        # amortized consolidation: once dirty (non-oldest-segment) data
        # reaches 1/8 of the series, merge it down so future reads are
        # slices; below that, serve via an ephemeral window merge so a
        # small append never forces an O(n) rewrite on the next read.
        # Watermark-delta reads (read_many(since=...)) skip this: their
        # windows touch only the newest points, so triggering an O(n)
        # rewrite on the steady-state hot path would defeat the O(delta)
        # contract.
        dirty = s.count - (s.segments[0].n if s.segments else 0)
        if consolidate and dirty and dirty * 8 >= s.count:
            self._consolidate(s)
        segs = list(s.segments)
        if s.tail_n:
            segs.append(self._tail_segment(s))   # newest run: append order
        parts: List[Tuple[np.ndarray, np.ndarray]] = []
        for seg in segs:
            lo = 0 if start is None else int(np.searchsorted(seg.times, start))
            hi = seg.n if end is None else int(np.searchsorted(seg.times, end))
            if hi > lo:
                parts.append((seg.times[lo:hi], seg.values[lo:hi]))
        if not parts:
            return _EMPTY, _EMPTY
        t, v = parts[0]
        for t2, v2 in parts[1:]:                 # oldest-first: ties stable
            t, v = _merge_sorted(t, v, t2, v2)
        if t.flags.writeable:                    # merged copies: same
            _freeze(t), _freeze(v)               # read-only contract as views
        return t, v

    def read(self, ts_id: str, start: Optional[float] = None,
             end: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Time-sorted read-only view of [start, end)."""
        with self._lock:
            self.read_count += 1
            return self._read_locked(self._data.get(ts_id), start, end)

    def read_many(self, ts_ids: Sequence[str], start: Optional[float] = None,
                  end: Optional[float] = None, *,
                  since: Optional[float] = None, prior_counts: bool = False):
        """Batched read: ONE store round-trip for a whole fleet bin.

        Returns one ``(times, values)`` pair per id (empty arrays for
        unknown ids), all under a single lock acquisition. This is the
        entry point ``FleetExecutor`` bins use instead of N ``read()``s.

        ``since`` is the watermark-delta form: equivalent to
        ``start=since`` but served without the amortized consolidation
        pass (the window touches only the newest points — O(log n + delta)
        guaranteed) and counted in ``delta_read_count`` telemetry.

        With ``prior_counts=True`` the return value is ``(pairs, prior)``
        where ``prior[i]`` is the number of stored points of ``ts_ids[i]``
        strictly before ``start``/``since`` — computed under the SAME lock
        acquisition as the read, so a delta reader can detect out-of-order
        (late) appends race-free: if ``prior`` moved since the last poll,
        history changed behind the watermark and cached state is stale.
        """
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        if not tracer.enabled:
            return self._read_many(ts_ids, start, end, since=since,
                                   prior_counts=prior_counts)
        with tracer.span("store.read_many", n=len(ts_ids),
                         delta=since is not None):
            return self._read_many(ts_ids, start, end, since=since,
                                   prior_counts=prior_counts)

    def _read_many(self, ts_ids: Sequence[str],
                   start: Optional[float] = None,
                   end: Optional[float] = None, *,
                   since: Optional[float] = None,
                   prior_counts: bool = False):
        fast = since is not None
        if fast:
            start = since
        consolidate = not fast
        data_get = self._data.get
        with self._lock:
            self.read_many_count += 1
            if fast:
                self.delta_read_count += 1
            out, prior = [], []
            for i in ts_ids:
                s = data_get(i)
                if fast and s is not None and s.count \
                        and len(s.segments) == 1 and not s.tail_n:
                    # steady-state fast path: consolidated series, delta
                    # window — two binary searches, zero-copy views
                    # (ndarray.searchsorted directly: the np.searchsorted
                    # dispatch wrapper is measurable at fleet width)
                    seg = s.segments[0]
                    lo = seg.times.searchsorted(start)
                    hi = seg.n if end is None else \
                        seg.times.searchsorted(end)
                    if prior_counts:
                        prior.append(int(lo))
                    out.append((seg.times[lo:hi], seg.values[lo:hi]))
                    continue
                if prior_counts:
                    prior.append(self._prior_count_locked(s, start))
                out.append(self._read_locked(s, start, end, consolidate))
            if prior_counts:
                return out, np.asarray(prior, np.int64)
            return out

    def read_many_flat(self, ts_ids: Sequence[str],
                       start: Optional[float] = None,
                       end: Optional[float] = None, *,
                       since: Optional[float] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``read_many`` flattened for vectorized consumers: ONE
        ``(sizes, times, values)`` triple — per-series windows
        concatenated in order, ``sizes[i]`` points belonging to
        ``ts_ids[i]``. Skips the per-series pair materialization that a
        fleet-width caller would immediately re-concatenate (measurable
        at minutely detection width). Counts as one ``read_many`` (and
        one delta read with ``since=``) in telemetry."""
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        if not tracer.enabled:
            return self._read_many_flat(ts_ids, start, end, since=since)
        with tracer.span("store.read_many", n=len(ts_ids),
                         delta=since is not None, flat=True):
            return self._read_many_flat(ts_ids, start, end, since=since)

    def _read_many_flat(self, ts_ids: Sequence[str],
                        start: Optional[float] = None,
                        end: Optional[float] = None, *,
                        since: Optional[float] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        fast = since is not None
        if fast:
            start = since
        consolidate = not fast
        data_get = self._data.get
        no_end = end is None
        parts_t: List[np.ndarray] = []
        parts_v: List[np.ndarray] = []
        pt_append, pv_append = parts_t.append, parts_v.append
        sizes_l: List[int] = []
        sz_append = sizes_l.append
        with self._lock:
            self.read_many_count += 1
            if fast:
                self.delta_read_count += 1
            for i in ts_ids:
                s = data_get(i)
                if fast and s is not None and s.count \
                        and len(s.segments) == 1 and not s.tail_n:
                    seg = s.segments[0]
                    st = seg.times
                    lo = st.searchsorted(start)
                    hi = seg.n if no_end else st.searchsorted(end)
                    if hi > lo:
                        sz_append(hi - lo)
                        pt_append(st[lo:hi])
                        pv_append(seg.values[lo:hi])
                    else:
                        sz_append(0)
                    continue
                t, v = self._read_locked(s, start, end, consolidate)
                sz_append(t.size)
                if t.size:
                    pt_append(t)
                    pv_append(v)
        sizes = np.asarray(sizes_l, np.int64)
        if parts_t:
            return sizes, np.concatenate(parts_t), np.concatenate(parts_v)
        return sizes, _EMPTY, _EMPTY

    def read_window_batch(self, ts_ids: Sequence[str],
                          start: Optional[float] = None,
                          end: Optional[float] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fleet windowing helper: padded ``(N, T)`` matrices + validity mask.

        Rows are left-aligned and zero-padded to the longest series in the
        window; ``mask[i, j]`` is True where ``times[i, j]``/``values[i, j]``
        hold real points. Ready to feed vmapped per-series kernels.
        """
        series = self.read_many(ts_ids, start, end)
        n = len(series)
        width = max((t.size for t, _ in series), default=0)
        times = np.zeros((n, width), np.float64)
        values = np.zeros((n, width), np.float64)
        mask = np.zeros((n, width), bool)
        for i, (t, v) in enumerate(series):
            times[i, :t.size] = t
            values[i, :t.size] = v
            mask[i, :t.size] = True
        return times, values, mask

    def last_time(self, ts_id: str) -> Optional[float]:
        with self._lock:                # metadata is written under the lock
            s = self._data.get(ts_id)
            return s.t_max if s is not None and s.count else None

    def first_time(self, ts_id: str) -> Optional[float]:
        with self._lock:
            s = self._data.get(ts_id)
            return s.t_min if s is not None and s.count else None

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._data)

    def length(self, ts_id: str) -> int:
        with self._lock:
            s = self._data.get(ts_id)
            return s.count if s else 0

    def total_points(self) -> int:
        with self._lock:
            return sum(s.count for s in self._data.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._data),
                "points": sum(s.count for s in self._data.values()),
                "segments": sum(len(s.segments) for s in self._data.values()),
                "tail_points": sum(s.tail_n for s in self._data.values()),
                "appends": self.append_count,
                "reads": self.read_count,
                "read_many": self.read_many_count,
                "delta_reads": self.delta_read_count,
                "compactions": self.compaction_count,
                "merges": self.merge_count,
                "merged_points": self.merged_points,
            }

    # ---------------- persistence ----------------
    def save(self, path: str):
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        arrays = {}
        with self._lock:
            for ts_id, s in self._data.items():
                self._consolidate(s)
                seg = s.segments[0] if s.segments else None
                arrays[f"t::{ts_id}"] = seg.times if seg else _EMPTY
                arrays[f"v::{ts_id}"] = seg.values if seg else _EMPTY
        np.savez_compressed(p / "timeseries.npz", **arrays)

    @classmethod
    def load(cls, path: str) -> "TimeSeriesStore":
        st = cls()
        f = Path(path) / "timeseries.npz"
        if f.exists():
            z = np.load(f)
            ids = {k[3:] for k in z.files if k.startswith("t::")}
            for ts_id in ids:
                st.append(ts_id, z[f"t::{ts_id}"], z[f"v::{ts_id}"])
            st.compact()
        return st
