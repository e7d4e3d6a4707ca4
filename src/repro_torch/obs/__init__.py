"""Observability for the port's serving engine: a typed metrics registry
(``metrics``) behind the engine's stats dict, and a bounded span tracer
(``trace``)."""
from repro_torch.obs.metrics import (SAMPLING_STATS_SCHEMA, EngineMetrics,
                                     MetricsRegistry, StatsView,
                                     engine_stats_view, extend_stats_view)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, SpanTracer

__all__ = ["EngineMetrics", "MetricsRegistry", "SAMPLING_STATS_SCHEMA",
           "StatsView", "engine_stats_view", "extend_stats_view",
           "NULL_TRACER", "NullTracer", "Span", "SpanTracer"]
