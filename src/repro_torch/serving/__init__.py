"""Multi-tenant PLCore serving on one card: many concurrent requests over
many scenes, behind three layers (see ``engine``'s module docstring):

* ``engine``      — ``TileScheduler`` (queue, priority/sticky policy,
                    cross-request ray coalescing) -> ``TileExecutor``
                    (in-flight tile slots over CUDA events) ->
                    ``CompletionSink`` (out-of-order framebuffer scatter),
                    behind the ``RenderEngine`` facade.
* ``scene_cache`` — LRU of resident ``PackedPlcore`` weight sets with
                    in-flight pin refcounts.
* ``loadgen``     — synthetic open/closed-loop client reporting
                    throughput and tail latency, split into queueing delay
                    and service time.
* ``faults``      — deterministic seeded fault injection (dispatch errors,
                    corrupted tiles, loader failures, stragglers, host
                    kills and slow-downs) exercising the engine's
                    recovery ladder.
* ``cluster``     — the multi-host fabric: a ``HostPool`` of isolated
                    per-host cache + executor workers (each over its own
                    device group) behind one global ``ClusterScheduler``;
                    heartbeat health states, cross-host tile failover,
                    per-host scene quarantine with recovery probes,
                    aggregate SLO admission, graceful drain and rejoin.
"""
from repro_torch.serving.cluster import (HOST_STATES, ClusterEngine,
                                         ClusterScheduler, Host, HostEvent,
                                         HostPool, split_devices)
from repro_torch.serving.engine import (STATUSES, CompletionSink,
                                        RenderEngine, RenderRequest,
                                        RenderResult, TileExecutor,
                                        TileScheduler)
from repro_torch.serving.faults import (FaultConfig, FaultPlan,
                                        InjectedDispatchError,
                                        InjectedLoaderError)
from repro_torch.serving.scene_cache import SceneCache, SceneLoadError

__all__ = ["RenderEngine", "RenderRequest", "RenderResult", "SceneCache",
           "SceneLoadError", "TileScheduler", "TileExecutor",
           "CompletionSink", "FaultConfig", "FaultPlan",
           "InjectedDispatchError", "InjectedLoaderError", "STATUSES",
           "ClusterEngine", "ClusterScheduler", "Host", "HostEvent",
           "HostPool", "HOST_STATES", "split_devices"]
