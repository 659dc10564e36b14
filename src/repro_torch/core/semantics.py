"""Knowledge-based representation of IoT data (paper §2, §4.1, Fig. 3).

Every time-series is a node connected to a ``Signal`` concept (what physical
quantity) and an ``Entity`` concept (where / what thing); entity topology
(prosumer -> feeder -> substation) is an edge set. Model code expresses
feature engineering against these concepts, which is what enables
programmatic fleet deployment ("deploy this forecaster to every entity with
an ENERGY_LOAD signal").

Scale architecture (the Castor companion paper frames the knowledge layer
as the thing that must stay cheap as the application grows): concepts are
**interned** — every signal/entity gets a dense int handle at definition
time — and all topology/index state lives in int space:

* adjacency lists ``_children``/``_parents`` over entity ids;
* an inverted signal -> entity-ids index, so
  ``find_entities(has_signal=...)`` and ``contexts_for_signal`` touch
  only that signal's entities, never scan all entities or series;
* a per-kind entity-id index for ``find_entities(kind=...)``;
* memoized ``descendants`` per root id, invalidated on edge insert by
  walking the new edge's ancestor chain (only the roots whose subtree
  actually changed recompute).

Queries still return name-sorted ``Entity``/``Context`` objects — sorting
happens on the RESULT set, so cost is O(matches log matches), flat in
graph size."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .interning import InternTable


@dataclass(frozen=True)
class Signal:
    name: str                      # e.g. ENERGY_LOAD
    unit: str = ""                 # e.g. kWh
    description: str = ""


@dataclass(frozen=True)
class Entity:
    name: str                      # e.g. SUBSTATION_S1
    kind: str = "ENTITY"           # SUBSTATION | FEEDER | PROSUMER | ...
    lat: float = 0.0
    lon: float = 0.0


@dataclass(frozen=True)
class Context:
    """A semantic context = (signal, entity) + its time-series node."""
    signal: Signal
    entity: Entity
    ts_id: str

    @property
    def key(self) -> Tuple[str, str]:
        return (self.signal.name, self.entity.name)


class SemanticGraph:
    def __init__(self):
        self.signals: Dict[str, Signal] = {}
        self.entities: Dict[str, Entity] = {}
        self._ent_ids = InternTable()                  # name <-> int handle
        self._sig_ids = InternTable()
        self._children: Dict[int, List[int]] = {}      # parent id -> child ids
        self._parents: Dict[int, int] = {}             # child id -> parent id
        # every parent an entity was EVER linked under (re-parenting keeps
        # the old edge, matching the scanner): memo invalidation must walk
        # all upward paths, not just the latest one
        self._all_parents: Dict[int, Set[int]] = {}
        self._ts: Dict[Tuple[str, str], str] = {}      # (signal, entity) -> ts_id
        self._ts_rev: Dict[str, Tuple[str, str]] = {}
        self._sig_ents: Dict[int, Set[int]] = {}       # signal id -> entity ids
        self._kind_ents: Dict[str, Set[int]] = {}      # kind -> entity ids
        self._desc_memo: Dict[int, List[str]] = {}     # root id -> desc names
        self.journal = None           # durability.Journal when Castor.open'd

    # ---------------- int handles ----------------
    def entity_id(self, name: str) -> int:
        """Dense int handle of an entity (stable for the graph's life)."""
        i = self._ent_ids.get(name)
        if i is None:
            raise KeyError(f"unknown entity {name}")
        return i

    def signal_id(self, name: str) -> int:
        i = self._sig_ids.get(name)
        if i is None:
            raise KeyError(f"unknown signal {name}")
        return i

    # ---------------- concept definition ----------------
    def add_signal(self, sig: Signal) -> Signal:
        changed = self.signals.get(sig.name) != sig
        self.signals[sig.name] = sig
        self._sig_ids.intern(sig.name)
        j = self.journal
        if j is not None and changed:      # idempotent re-adds stay silent
            j.append("sig", {"name": sig.name, "unit": sig.unit,
                             "description": sig.description})
        return sig

    def add_entity(self, ent: Entity, parent: Optional[str] = None) -> Entity:
        prev = self.entities.get(ent.name)
        eid = self._ent_ids.intern(ent.name)
        if prev is not None and prev.kind != ent.kind:
            self._kind_ents.get(prev.kind, set()).discard(eid)
        self.entities[ent.name] = ent
        self._kind_ents.setdefault(ent.kind, set()).add(eid)
        changed = prev != ent
        if parent is not None:
            assert parent in self.entities, f"unknown parent {parent}"
            pid = self._ent_ids.intern(parent)
            if self._parents.get(eid) != pid:
                changed = True
            siblings = self._children.setdefault(pid, [])
            if eid not in siblings:
                siblings.append(eid)
                self._invalidate_descendants(pid)
            self._parents[eid] = pid
            self._all_parents.setdefault(eid, set()).add(pid)
        j = self.journal
        if j is not None and changed:      # idempotent re-adds stay silent
            j.append("ent", {"name": ent.name, "kind": ent.kind,
                             "lat": ent.lat, "lon": ent.lon,
                             "parent": parent})
        return ent

    def _invalidate_descendants(self, pid: int) -> None:
        """A new edge under ``pid`` changes the descendant set of ``pid``
        and every ancestor above it — drop exactly those memos (the rest
        of the graph's memoized subtrees stay warm). Walks ALL recorded
        upward edges, so a subtree reachable through a since-replaced
        parent link still invalidates."""
        seen: Set[int] = set()
        stack = [pid]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            self._desc_memo.pop(cur, None)
            stack.extend(self._all_parents.get(cur, ()))

    def _link(self, signal: str, entity: str, ts_id: str) -> None:
        self._ts[(signal, entity)] = ts_id
        self._ts_rev[ts_id] = (signal, entity)
        self._sig_ents.setdefault(self._sig_ids.intern(signal),
                                  set()).add(self._ent_ids.intern(entity))

    def link_timeseries(self, ts_id: str, signal: str, entity: str) -> Context:
        """Attach semantics to an ingested series (paper step (2))."""
        assert signal in self.signals, f"unknown signal {signal}"
        assert entity in self.entities, f"unknown entity {entity}"
        changed = self._ts.get((signal, entity)) != ts_id
        self._link(signal, entity, ts_id)
        j = self.journal
        if j is not None and changed:
            # explicit links only: the ``context()`` auto-created
            # ``ts::{signal}::{entity}`` node is deterministic and
            # regenerates identically on first touch after recovery
            j.append("lnk", {"ts_id": ts_id, "signal": signal,
                             "entity": entity})
        return self.context(signal, entity)

    # ---------------- queries (semantic reasoning) ----------------
    def context(self, signal: str, entity: str) -> Context:
        ts_id = self._ts.get((signal, entity))
        if ts_id is None:
            # contexts may exist before data arrives (predictions attach here)
            ts_id = f"ts::{signal}::{entity}"
            self._link(signal, entity, ts_id)
        return Context(self.signals[signal], self.entities[entity], ts_id)

    def has_series(self, signal: str, entity: str) -> bool:
        return (signal, entity) in self._ts

    def _name(self, eid: int) -> str:
        return self._ent_ids.value(eid)

    def children(self, entity: str) -> List[Entity]:
        eid = self._ent_ids.get(entity)
        kids = self._children.get(eid, ()) if eid is not None else ()
        return [self.entities[n] for n in sorted(map(self._name, kids))]

    def parent(self, entity: str) -> Optional[Entity]:
        eid = self._ent_ids.get(entity)
        pid = self._parents.get(eid) if eid is not None else None
        return self.entities[self._name(pid)] if pid is not None else None

    def _descendant_names(self, root: int) -> List[str]:
        """Memoized transitive closure under one root, in the traversal
        order the scanner always produced (a pure function of the tree
        shape — children visited name-sorted — so it is insertion-order
        independent). Memos are dropped by ``_invalidate_descendants``
        when an edge lands in the subtree."""
        memo = self._desc_memo.get(root)
        if memo is None:
            out: List[str] = []
            stack = [root]
            while stack:
                kids = self._children.get(stack.pop(), ())
                for name in sorted(map(self._name, kids)):
                    out.append(name)
                    stack.append(self._ent_ids.intern(name))
            self._desc_memo[root] = memo = out
        return memo

    def descendants(self, entity: str) -> List[Entity]:
        eid = self._ent_ids.get(entity)
        if eid is None:
            return []
        return [self.entities[n] for n in self._descendant_names(eid)]

    def find_entities(self, kind: Optional[str] = None,
                      has_signal: Optional[str] = None,
                      under: Optional[str] = None) -> List[Entity]:
        """The fleet-deployment query: all entities matching semantic
        rules. Each predicate is an index: the candidate set starts from
        the most selective one given and the rest filter by membership —
        no predicate ever walks all entities (the no-predicate call
        returns the whole graph by definition)."""
        cand: Optional[Set[int]] = None
        if has_signal is not None:
            sid = self._sig_ids.get(has_signal)
            ents = self._sig_ents.get(sid, set()) if sid is not None else set()
            cand = set(ents)
        if kind is not None:
            ents = self._kind_ents.get(kind, set())
            cand = set(ents) if cand is None else cand & ents
        if under is not None:
            uid = self._ent_ids.get(under)
            down = ({self._ent_ids.intern(n)
                     for n in self._descendant_names(uid)}
                    if uid is not None else set())
            cand = down if cand is None else cand & down
        if cand is None:
            names = list(self.entities)
        else:
            names = [self._name(i) for i in cand]
        return [self.entities[n] for n in sorted(names)]

    def contexts_for_signal(self, signal: str) -> List[Context]:
        """All contexts carrying one signal, entity-name-sorted — an
        inverted-index hit, not a scan of every linked series."""
        sid = self._sig_ids.get(signal)
        ents = self._sig_ents.get(sid, ()) if sid is not None else ()
        return [self.context(signal, n)
                for n in sorted(map(self._name, ents))]

    def signal_of(self, ts_id: str) -> Optional[str]:
        pair = self._ts_rev.get(ts_id)
        return pair[0] if pair else None

    def stats(self) -> dict:
        return {"signals": len(self.signals), "entities": len(self.entities),
                "timeseries": len(self._ts),
                "edges": sum(map(len, self._children.values()))}
