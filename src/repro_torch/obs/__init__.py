"""Observability plane: ``trace`` (hierarchical span tracer) and
``metrics`` (namespaced counters / gauges / log-bucket histograms).
Host-side Python with a process-global default tracer/registry, so that
components constructed outside a ``Castor`` are still instrumented."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_metrics, note_retrace, retrace_counts)
from .trace import NULL_TRACER, Span, Tracer, get_tracer, set_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
    "note_retrace", "retrace_counts",
    "NULL_TRACER", "Span", "Tracer", "get_tracer", "set_tracer",
]
