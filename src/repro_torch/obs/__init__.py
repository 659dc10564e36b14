"""Observability plane: ``trace`` (hierarchical span tracer),
``metrics`` (namespaced counters / gauges / log-bucket histograms) and
``export`` (Perfetto/Chrome trace-event JSON, Prometheus text, and the
JSON snapshot ``Castor.stats()`` is a view over).
Host-side Python with a process-global default tracer/registry, so that
components constructed outside a ``Castor`` are still instrumented."""
from .export import (chrome_trace, obs_snapshot, prometheus_text,
                     write_chrome_trace, write_json_artifact)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_metrics, note_retrace, retrace_counts)
from .trace import NULL_TRACER, Span, Tracer, get_tracer, set_tracer

__all__ = [
    "chrome_trace", "obs_snapshot", "prometheus_text", "write_chrome_trace",
    "write_json_artifact",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
    "note_retrace", "retrace_counts",
    "NULL_TRACER", "Span", "Tracer", "get_tracer", "set_tracer",
]
