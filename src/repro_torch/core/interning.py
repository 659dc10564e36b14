"""Process-wide intern tables: dense integer handles for the control
plane's hot composite keys (job bin keys, sticky-routing affinity keys,
semantic-graph concepts).

At fleet scale the control plane's cost is dominated by re-hashing and
re-comparing tuples of strings — every poll rebuilt each job's
``(package, version, task, params_key, scheduled_at)`` bin key and every
routing decision crc32'd a sorted member list. Interning replaces that
with one dict hit the *first* time a key is seen and an int thereafter,
and gives numpy an integer axis to ``argsort``/``unique`` when grouping
jobs into bins (``scheduler.bin_jobs``).

Ids are dense, stable for the process lifetime, and NEVER cross process
boundaries: serverless payloads ship names over the wire and workers
re-intern locally (two processes' tables need not agree).
"""
from __future__ import annotations

import threading
from typing import Dict, Hashable, List


class InternTable:
    """Bidirectional value <-> dense int id map. Append-only; thread-safe
    (reads are lock-free CPython dict hits, inserts take a lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids: Dict[Hashable, int] = {}
        self._vals: List[Hashable] = []

    def intern(self, value: Hashable) -> int:
        i = self._ids.get(value)
        if i is None:
            with self._lock:
                i = self._ids.get(value)
                if i is None:
                    i = len(self._vals)
                    self._vals.append(value)
                    self._ids[value] = i
        return i

    def value(self, i: int) -> Hashable:
        """The original value behind an id (inverse of ``intern``)."""
        return self._vals[i]

    def get(self, value: Hashable):
        """The id if ``value`` was ever interned, else None (no insert)."""
        return self._ids.get(value)

    def __len__(self) -> int:
        return len(self._vals)

    def __contains__(self, value: Hashable) -> bool:
        return value in self._ids
