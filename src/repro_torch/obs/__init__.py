"""Observability for the port's serving engine: a typed metrics registry
(``metrics``) behind the engine's stats dict and the process-wide kernel
counters (``global_registry``), a bounded span tracer (``trace``), and the
exporters (``export``): Chrome trace-event JSON, Prometheus text, JSON
snapshots, the span-chain integrity validator behind ``serve --check``,
and the card's busy share from the tiles' device spans."""
from repro_torch.obs.export import (chrome_trace, device_busy,
                                    prometheus_text, snapshot,
                                    validate_chrome_trace, validate_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (CLUSTER_STATS_SCHEMA,
                                     ENGINE_STATS_SCHEMA,
                                     PERCELL_STATS_SCHEMA,
                                     ROUTING_STATS_SCHEMA,
                                     SAMPLING_STATS_SCHEMA, CountsView,
                                     EngineMetrics, Histogram,
                                     MetricsRegistry, StatsView,
                                     engine_stats_view, extend_stats_view,
                                     global_registry, log_buckets)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, SpanTracer

__all__ = ["SpanTracer", "NullTracer", "NULL_TRACER", "Span",
           "MetricsRegistry", "StatsView", "EngineMetrics", "Histogram",
           "engine_stats_view", "extend_stats_view", "global_registry",
           "log_buckets", "ENGINE_STATS_SCHEMA", "CLUSTER_STATS_SCHEMA",
           "SAMPLING_STATS_SCHEMA", "ROUTING_STATS_SCHEMA",
           "PERCELL_STATS_SCHEMA",
           "CountsView", "chrome_trace", "write_chrome_trace",
           "prometheus_text", "snapshot", "validate_trace",
           "validate_chrome_trace", "device_busy"]
