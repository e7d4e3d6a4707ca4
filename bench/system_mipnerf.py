"""The system under test of the Mip-NeRF configuration: the port's serving
engine over its scene cache, as ``serve --mode engine --model mipnerf
--full --kernel --fuse-two-pass`` builds it, from the library: a
``PackedMipNerf`` resident per scene (one network, packed once), K2's
Mip-NeRF instance one launch a tile, the engine building each view's cones
(origin, direction with camera z = -1, radius) with the resident's
``view_rays``.

Each scene's network is the benchmark's input (the reference's ``draw``);
the program gets a copy of it. Every scene of the cell is loaded into the
cache here, and the tile shape is warmed up, so no load and no first
launch falls in the window.

A configuration names this module as its ``system``; beside
``bench/system.py``, it is the only kind of module of the benchmark that
imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.mipnerf import MipNerfConfig
from repro_torch.core.mipnerf import PackedMipNerf
from repro_torch.kernels import build
from repro_torch.obs.trace import SpanTracer
from repro_torch.serving.engine import RenderEngine, RenderRequest
from repro_torch.serving.scene_cache import SceneCache, plcore_nbytes

#: the device-trace keys that metric readers use -> the kernel's symbol
#: as the device names its launches (K2's Mip-NeRF instance)
KERNELS = {"plcore_two_pass": "plcore_two_pass_mip_kernel"}
#: the engine's own host ranges around its layers (``SpanTracer.range``)
HOST_RANGES = ("engine.submit", "scheduler.next_tile", "plcore.dispatch",
               "executor.drain", "completion.scatter")
#: closed spans the tracer of a traced run keeps
TRACE_CAPACITY = 1 << 21

_FIELDS = {f.name for f in dataclasses.fields(MipNerfConfig)}


def mip_config(cfg: dict) -> MipNerfConfig:
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in _FIELDS and k != "name"}
    return MipNerfConfig(**kw)


def scene_id(scene: int) -> str:
    return f"scene{scene}"


def port_params(cfg: dict, net: dict) -> dict:
    """The drawn network as the port's parameter tree."""
    def lin(name):
        w, b = net[name]
        return {"w": w.clone(), "b": b.clone()}
    return {"trunk": {f"l{i}": lin(f"trunk.{i}")
                      for i in range(cfg["trunk_layers"])},
            **{k: lin(k) for k in ("sigma", "feat", "color0", "rgb")}}


def load(cfg: dict, net: dict, device) -> PackedMipNerf:
    return PackedMipNerf(mip_config(cfg), port_params(cfg, net),
                         use_kernel=True, device=device)


def request(view) -> RenderRequest:
    return RenderRequest(scene_id=scene_id(view.scene), hw=view.hw,
                         theta=view.theta, phi=view.phi, radius=view.radius)


def build_seconds():
    """Seconds this process spent building the kernel library (None when
    it found the library built)."""
    return build.BUILD_LOG["seconds"]


class System:
    """The engine of one run and its residents. ``weights``: scene index ->
    the network the reference drew; ``trace``: the engine gets a span
    tracer (``tracer``, else None)."""

    def __init__(self, cfg: dict, weights: dict, device, trace: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tracer = SpanTracer(capacity=TRACE_CAPACITY) if trace else None
        self.weights = {scene_id(i): net for i, net in weights.items()}
        self.cache = SceneCache(
            lambda sid: load(cfg, self.weights[sid], self.device),
            capacity_mb=float(cfg["cache_mb"]))
        self.engine = RenderEngine(
            self.cache, tile_rays=int(cfg["tile_rays"]),
            pipeline_depth=int(cfg["pipeline_depth"]),
            max_sticky_tiles=int(cfg["max_sticky_tiles"]),
            tracer=self.tracer)
        self.residents = {sid: self.cache.get(sid) for sid in self.weights}
        if len(self.cache) != len(weights):
            raise RuntimeError(f"the cache of {cfg['cache_mb']} MB holds "
                               f"{len(self.cache)} of {len(weights)} scenes")

    def resident_bytes(self) -> int:
        return sum(plcore_nbytes(pp) for pp in self.residents.values())

    def warm_up(self) -> None:
        """One tile of the cell's one tile shape through every resident."""
        n = int(self.cfg["tile_rays"])
        o = np.zeros((n, 3), np.float32)
        o[:, 2] = 4.0
        d = np.zeros((n, 3), np.float32)
        d[:, 2] = -1.0
        r = np.full((n, 1), 1e-3, np.float32)
        for pp in self.residents.values():
            handle, _ = pp.dispatch_tile(o, d, r)
            handle.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Drop the program's state (engine, cache, residents)."""
        self.engine = self.cache = self.residents = None
