"""Exporters over the trace ring and metrics registry.

Three output shapes, one source of truth:

- ``chrome_trace`` / ``write_chrome_trace`` — Chrome trace-event JSON
  (``ph: "X"`` complete events) that Perfetto (ui.perfetto.dev) and
  ``chrome://tracing`` open directly. ``Castor.dump_trace(path)`` is a
  thin wrapper.
- ``prometheus_text`` — Prometheus text exposition (counters, gauges,
  and cumulative ``_bucket{le=...}`` histogram series).
- ``obs_snapshot`` — the JSON snapshot ``Castor.stats()`` is a
  backward-compatible view over: ``{"stats": <legacy schema>,
  "metrics": ..., "trace": ...}``.

``write_json_artifact`` is the single code path for the repo's
``artifacts/*.json`` telemetry files — the bench
modules that used to hand-roll ``Path.write_text(json.dumps(...))``
now route here, keeping one serialization convention (sorted keys,
indent=1, trailing newline) without changing file shapes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from .metrics import (Histogram, MetricsRegistry, bucket_bounds,
                      get_metrics)
from .trace import Tracer, get_tracer


# -- Perfetto / Chrome trace-event JSON -------------------------------

def chrome_trace(tracer: Optional[Tracer] = None, *,
                 pid: int = 1) -> dict:
    """Chrome trace-event JSON for every span in the ring.

    Timestamps are microseconds on the wall clock, derived from the
    tracer's ``epoch`` anchor — ``(wall, mono)`` captured at tracer
    construction — so traces from injected deterministic clocks export
    reproducibly (inject ``epoch=(0.0, 0.0)``).
    """
    tr = tracer if tracer is not None else get_tracer()
    wall0, mono0 = tr.epoch
    events = []
    for s in tr.spans():
        ev = {
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": (wall0 + (s.t0 - mono0)) * 1e6,
            "dur": (s.t1 - s.t0) * 1e6,
            "pid": pid,
            "tid": s.tid,
            "args": dict(s.args or {},
                         trace_id=s.trace_id, span_id=s.span_id,
                         parent_id=s.parent_id),
        }
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, tracer: Optional[Tracer] = None, *,
                       pid: int = 1) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer, pid=pid)) + "\n")
    return path


# -- Prometheus text exposition ---------------------------------------

def _prom_name(name: str) -> str:
    return "repro_" + name.replace(".", "_").replace("-", "_")


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text format, one family per metric. Histograms emit
    cumulative ``_bucket{le="..."}`` series plus ``_sum``/``_count``."""
    reg = registry if registry is not None else get_metrics()
    lines = []
    for name, m in reg.items():
        pname = _prom_name(name)
        if type(m) is Histogram:
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for i, c in enumerate(m.counts):
                if c == 0:
                    continue
                cum += c
                le = bucket_bounds(i)[1]
                lines.append(f'{pname}_bucket{{le="{le!r}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pname}_sum {m.sum!r}")
            lines.append(f"{pname}_count {m.count}")
        elif type(m).__name__ == "Counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {m.value}")
        else:
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m.value!r}")
    return "\n".join(lines) + "\n"


# -- JSON snapshot -----------------------------------------------------

def obs_snapshot(stats: dict, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None) -> dict:
    """The unified snapshot: the legacy ``Castor.stats()`` dict rides
    under ``"stats"`` (unchanged schema — ``Castor.stats()`` returns
    exactly that sub-dict), next to the metrics registry snapshot and
    the tracer's ring stats."""
    tr = tracer if tracer is not None else get_tracer()
    reg = registry if registry is not None else get_metrics()
    return {"stats": stats, "metrics": reg.snapshot(),
            "trace": tr.stats()}


# -- artifact files (satellite 3) -------------------------------------

def write_json_artifact(path, payload: dict) -> Path:
    """One code path for ``artifacts/*.json`` telemetry emission."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return path
