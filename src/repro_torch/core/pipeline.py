"""Serving pipeline — a loaded PLCore that packs its weights once.

* ``PackedPlcore`` — loads a param set ONCE: packs the kernel weight layout
  (``kernel_weights``, RMCM included) a single time, moves it to the
  device, and reuses it for every ray batch, tile and image
  (``kernels.ops.pack_count`` does not move after load).
* ``render_image_single`` — a whole image in one render call: the padded
  ray tiles are rendered as one batch, so on the fused path one kernel
  launch covers every tile of the image. Each ray's pixel depends only on
  that ray, so a tile rendered alone gives the same pixels.
* ``PackedPlcore.render_tile`` / ``dispatch_tile`` — one coalesced ray tile
  in, pixels out, for a serving engine. ``dispatch_tile`` returns a
  ``TileHandle`` without waiting for the card: the tile's rays go up and
  its pixels come back through pinned host buffers with non-blocking
  copies, and CUDA events mark the start and end of the tile's own work,
  so draining tile k never waits for tile k+1 queued behind it, and the
  tile's interval on the device can be read after it drains. Given a
  tracer on the card, a fused-path tile runs K2's traced instance and its
  handle brings back K2's phase cycles with the pixels.
  ``render_tile_oracle`` renders the tile through the two-dispatch kernel
  chain, the fallback of a retry ladder. ``budget=`` renders a tile at an
  adaptive fine-sample count, ``alive=`` masks dead rows out of K2.
* ``PackedPlcore(shard_mesh=...)`` — the trunk weight stacks layer-sharded
  over a cell list (``runtime.sharding``): renders gather them
  (``_materialize``), ``tile_gather_cost(home_cell)`` prices the layers a
  routed tile's home cell does not own, and ``dispatch_tile(percell=True)``
  runs a tile on its home cell against weights staged there once
  (``cell_view``, ``render_tile_cell``), on the cell's own CUDA stream.
* ASDR, adaptive sampling: ``build_scene_aux`` (the load-time density
  probe), ``trunk_rows`` (coarse-trunk rows for the memo),
  ``recon_rows`` (dead rays' pixels from memo rows) and
  ``AdaptiveRenderer`` (budget classes, dead rows, all-dead tiles that
  never reach the kernel); see the section's comment.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device, to_device
from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import plcore, sampling, volume
from repro_torch.core.encoding import nerf_encoding
from repro_torch.core.mlp import nerf_color_apply, nerf_trunk_apply
from repro_torch.data import rays as drays
from repro_torch.obs.metrics import K2_ROW_STATS


def render_image_single(cfg: NerfConfig, params, rays_o, rays_d, *,
                        quant: Optional[dict] = None,
                        packed: Optional[dict] = None,
                        use_kernel: bool = False,
                        fuse_two_pass: bool = False,
                        rays_per_batch: int = 4096,
                        ert_eps: Optional[float] = None) -> torch.Tensor:
    """Full-image render. rays: (H, W, 3) -> rgb (H, W, 3)."""
    H, W, _ = rays_o.shape
    eps = cfg.ert_eps if ert_eps is None else float(ert_eps)
    o_tiles, d_tiles, n = plcore.flatten_pad_rays(rays_o, rays_d,
                                                  rays_per_batch)
    out = plcore.render_rays(cfg, params, o_tiles.reshape(-1, 3),
                             d_tiles.reshape(-1, 3), quant=quant,
                             packed=packed, use_kernel=use_kernel,
                             fuse_two_pass=fuse_two_pass, ert_eps=eps,
                             white_bkgd=True)
    return out["rgb"][:n].reshape(H, W, 3)


class TileHandle:
    """The pixels of one dispatched tile. ``result()`` waits for this
    tile's own work (its end event), not for the stream, and returns the
    (n, 3) float32 host array; on the CPU the work is already done. On the
    card the tile's work lies between two timing events, ``start``
    (recorded before its render was enqueued) and ``end`` (after its
    pixels' copy to the host): ``device_interval`` reads it once the
    result is in. ``phase_cycles`` reads K2's phase rows (pinned host
    memory the traced instance wrote) when the tile ran it."""
    __slots__ = ("_host", "_event", "_device_rgb", "start", "end",
                 "_phase")

    def __init__(self, host: torch.Tensor, event=None, device_rgb=None,
                 start=None, phase=None):
        self._host = host
        self._event = event
        self._device_rgb = device_rgb    # alive until the copy has run
        self.start = start
        self.end = event
        self._phase = phase

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = self._device_rgb = None
        return self._host.numpy()

    def done(self) -> bool:
        """Whether the tile's work has run, asked without waiting (an
        event query); always true on the CPU."""
        return self._event is None or self._event.query()

    def phase_cycles(self) -> Optional[list]:
        """K2's row per ``obs.metrics.K2_ROW_STATS`` slot (the phase
        cycles, then the row counts), summed over the tile's blocks, or
        None when the tile did not run the traced instance. Call after
        ``result()``."""
        return None if self._phase is None else self._phase.sum(0).tolist()

    def device_interval(self, anchor) -> Optional[tuple]:
        """(start, end) of the tile's work in seconds after the ``anchor``
        event (recorded earlier on the same device), or None on the CPU
        or without a start event. Call after ``result()``."""
        if self.start is None or self.end is None:
            return None
        return (anchor.elapsed_time(self.start) / 1e3,
                anchor.elapsed_time(self.end) / 1e3)


def _materialize(cfg: NerfConfig, params, quant, packed, shard_mesh,
                 use_kernel: bool, device, count: bool):
    """The weights a render computes with when they are layer-sharded over
    a cell list: every trunk stack gathered onto ``device`` layer by layer
    (``runtime.sharding.gather_plcore_packed``; its counters tick when
    ``count``). The kernel path reads the gathered layout; the plain path
    rebuilds the per-layer trunk params (and RMCM quant dicts) from it,
    losslessly (``unstack_trunk_params``), so both render the replicated
    pixels bit for bit. Without a cell list the weights pass through."""
    if shard_mesh is None:
        return params, quant, packed
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import sharding as rsh
    gathered = {net: rsh.gather_plcore_packed(p, device, count)
                for net, p in packed.items()}
    if use_kernel:
        return params, quant, gathered
    new_p: dict = {}
    new_q = None if quant is None else {}
    for net, g in gathered.items():
        trunk_p, trunk_q = kops.unstack_trunk_params(cfg, g)
        new_p[net] = {**params[net], "trunk": trunk_p}
        if new_q is not None:
            new_q[net] = {**quant[net], "trunk": trunk_q}
    return new_p, new_q, None


class TileIO:
    """How a resident's tiles meet the card, shared by the resident
    models (``PackedPlcore``, ``core.mipnerf.PackedMipNerf``): uploads
    without a stream sync, a tile's start event and its ``TileHandle``.
    The resident sets ``device``."""

    def tile_start(self):
        """On the card, a timing event recorded now on the current stream:
        the start of a tile's device work, for ``handle``; None on the
        CPU."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def handle(self, rgb: torch.Tensor, start=None,
               phase=None) -> TileHandle:
        """A ``TileHandle`` for pixels rendered on the card or the CPU (the
        pixels' own device decides): on the card, a non-blocking copy into
        pinned host memory and a timing event after it on the current
        stream (``start``: the event of ``tile_start`` before the render);
        on the CPU, the pixels themselves. ``phase``: the pinned rows K2's
        traced instance writes, kept with the pixels."""
        if rgb.device.type != "cuda":
            return TileHandle(rgb)
        host = torch.empty(rgb.shape, dtype=rgb.dtype, pin_memory=True)
        host.copy_(rgb, non_blocking=True)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return TileHandle(host, event, rgb, start, phase)

    def _upload(self, x, dtype=torch.float32, device=None) -> torch.Tensor:
        """Host data -> the device (this instance's, or ``device``) without
        a stream sync: a pageable host-to-device copy would wait for every
        tile queued before it."""
        device = self.device if device is None else torch.device(device)
        t = torch.as_tensor(x, dtype=dtype)
        if device.type != "cuda" or t.device.type == "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)


class PackedPlcore(TileIO):
    """A loaded PLCore: params + optional RMCM quantization + the kernel
    weight layout, packed once at construction and kept on ``device``
    (default ``"cuda"``; without a card only an explicit ``"cpu"`` works).

    ``shard_mesh``: a cell list (``runtime.sharding.plcore_mesh``) over
    which the trunk weight stacks shard layer-wise. The sharded stacks
    are then the only resident trunk copy (the raw trunk params are
    dropped, so each cell holds about 1/n of the trunk), and every render
    re-gathers the layers onto ``device`` (default: the first cell's)
    with the same pixels bit for bit. With a cell list the weights are
    packed even without ``use_kernel``: the plain path keeps only the
    trunk stacks of the layout and rebuilds its trunk params from them.
    Routed tiles can instead run on their home cell against a staged copy
    (``cell_view``, ``render_tile_cell``, ``dispatch_tile(percell=True)``),
    each cell's launches on its own CUDA stream."""

    #: the engine's per-ray columns of a view: (o, unit d)
    view_rays = staticmethod(drays.nerf_view_rays)

    def __init__(self, cfg: NerfConfig, params: dict, *,
                 quant: Optional[dict] = None, use_kernel: bool = False,
                 fuse_two_pass: bool = False,
                 ert_eps: Optional[float] = None, device=None,
                 shard_mesh=None):
        if fuse_two_pass and not use_kernel:
            raise ValueError("fuse_two_pass routes through the fused kernel "
                             "— pass use_kernel=True")
        self.cfg = cfg
        self.shard_mesh = None if shard_mesh is None else tuple(shard_mesh)
        if device is None and self.shard_mesh is not None:
            device = self.shard_mesh[0]
        self.device = resolve_device(device, "PackedPlcore")
        self.use_kernel = use_kernel
        self.fuse_two_pass = fuse_two_pass
        self.ert_eps = cfg.ert_eps if ert_eps is None else float(ert_eps)
        self._gather_costs: dict = {}   # home cell -> tile_gather_cost
        self._cell_views: dict = {}     # cell -> staged per-cell view
        params = to_device(params, self.device)
        quant = None if quant is None else to_device(quant, self.device)
        packed = None
        if use_kernel or self.shard_mesh is not None:
            from repro_torch.kernels import ops as kops
            q = quant or {}
            pack = kops.kernel_weights if use_kernel else \
                kops.stack_plcore_weights
            packed = {net: pack(cfg, params[net], q.get(net))
                      for net in ("coarse", "fine")}
        if self.shard_mesh is not None:
            from repro_torch.runtime import sharding as rsh
            if not use_kernel:
                # the plain path reads only the trunk stacks of the layout
                # (its heads render from the raw params kept below)
                packed = {net: {k: v for k, v in p.items()
                                if k.startswith("trunk")}
                          for net, p in packed.items()}
            # the program shape whose first render counts the gathers
            self._layout = tuple(
                (net, k, tuple(v.shape), str(v.dtype))
                for net, p in packed.items() for k, v in sorted(p.items()))
            packed = {net: rsh.shard_plcore_packed(p, self.shard_mesh, cfg)
                      for net, p in packed.items()}
            # the sharded stacks are the only trunk residency now
            params = {net: {k: v for k, v in params[net].items()
                            if k != "trunk"} for net in ("coarse", "fine")}
            if quant is not None:
                quant = {net: {k: v for k, v in quant[net].items()
                               if k != "trunk"}
                         for net in ("coarse", "fine")}
        self.params = params
        self.quant = quant
        self.packed = packed

    def _rays(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _eps(self, ert_eps: Optional[float]) -> float:
        return self.ert_eps if ert_eps is None else float(ert_eps)

    def _weights(self, *program):
        """(params, quant, packed) to render with: as resident, or gathered
        from the cell list (``_materialize``), the gathers counted the first
        time this program shape runs."""
        if self.shard_mesh is None:
            return self.params, self.quant, self.packed
        from repro_torch.runtime import sharding as rsh
        count = rsh.note_program((program, self.cfg, self.use_kernel,
                                  self.fuse_two_pass, self.shard_mesh,
                                  self._layout))
        return _materialize(self.cfg, self.params, self.quant, self.packed,
                            self.shard_mesh, self.use_kernel, self.device,
                            count)

    def render_rays(self, rays_o, rays_d, generator=None, *,
                    ert_eps: Optional[float] = None) -> dict:
        """Render one ray batch (R, 3) -> {rgb, rgb_coarse, depth, acc}."""
        eps = self._eps(ert_eps)
        params, quant, packed = self._weights("rays", eps)
        return plcore.render_rays(
            self.cfg, params, self._rays(rays_o), self._rays(rays_d),
            generator, quant=quant, packed=packed,
            use_kernel=self.use_kernel, fuse_two_pass=self.fuse_two_pass,
            ert_eps=eps, white_bkgd=True)

    def render_image(self, rays_o, rays_d, *, rays_per_batch: int = 4096,
                     ert_eps: Optional[float] = None) -> torch.Tensor:
        eps = self._eps(ert_eps)
        params, quant, packed = self._weights("image", eps)
        return render_image_single(
            self.cfg, params, self._rays(rays_o), self._rays(rays_d),
            quant=quant, packed=packed,
            use_kernel=self.use_kernel, fuse_two_pass=self.fuse_two_pass,
            rays_per_batch=rays_per_batch, ert_eps=eps)

    def render_tile(self, o_tile, d_tile, ert_eps: Optional[float] = None,
                    coarse_only: bool = False, budget: Optional[int] = None,
                    alive=None, phase_cycles=None) -> torch.Tensor:
        """ONE pre-coalesced ray tile (n, 3) -> rgb (n, 3), the same per-ray
        body as ``render_image``. ``coarse_only`` is the overload
        degradation: the coarse pass only, no resample, no fine pass.
        ``budget`` (adaptive sampling) renders the tile with ``n_fine =
        budget`` (K2 gets that config, so ``sample_rows`` gives it the
        budget's resample grid); ``alive`` is an optional (n,) dead-row
        mask, 0 = dead, for the fused path; ``phase_cycles`` K2's phase rows
        (``kernels.fused_plcore.two_pass_plcore_call``), fused path
        only."""
        eps = self._eps(ert_eps)
        weights = self._weights("tile", eps, coarse_only, budget,
                                alive is not None)
        return self._tile_body(weights, self._rays(o_tile),
                               self._rays(d_tile), eps, coarse_only, budget,
                               None if alive is None else self._rays(alive),
                               phase_cycles)

    def _tile_body(self, weights, o, d, eps: float, coarse_only: bool,
                   budget: Optional[int] = None, alive=None,
                   phase_cycles=None) -> torch.Tensor:
        """The tile render on ``weights`` = (params, quant, packed), on the
        device the rays lie on."""
        params, quant, packed = weights
        cfg = self.cfg
        if budget is not None and int(budget) != cfg.n_fine:
            cfg = dataclasses.replace(cfg, n_fine=int(budget))
        if coarse_only:
            t_c = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse,
                                      o.shape[:-1], device=o.device)
            rgb_c, aux_c = plcore._eval_pass(
                cfg, params["coarse"], (quant or {}).get("coarse"),
                o, d, t_c, self.use_kernel, (packed or {}).get("coarse"))
            return volume.white_background(rgb_c, aux_c["acc"])
        return plcore.render_rays(
            cfg, params, o, d, quant=quant, packed=packed,
            use_kernel=self.use_kernel, fuse_two_pass=self.fuse_two_pass,
            ert_eps=eps, white_bkgd=True, alive=alive,
            phase_cycles=phase_cycles)["rgb"]

    def render_tile_oracle(self, o_tile, d_tile,
                           ert_eps: Optional[float] = None) -> torch.Tensor:
        """The retry ladder's last rung: the tile through the two-dispatch
        chain (K1 for each pass, the resample between them on the host);
        for a non-fused instance, its own tile program."""
        eps = self._eps(ert_eps)
        params, quant, packed = self._weights("oracle", eps)
        return plcore.render_rays(
            self.cfg, params, self._rays(o_tile), self._rays(d_tile),
            quant=quant, packed=packed,
            use_kernel=self.use_kernel, fuse_two_pass=False,
            ert_eps=eps, white_bkgd=True)["rgb"]

    def dispatch_tile(self, o_tile, d_tile, *,
                      home_cell: Optional[int] = None,
                      ert_eps: Optional[float] = None,
                      coarse_only: bool = False, percell: bool = False,
                      budget: Optional[int] = None, alive=None,
                      tracer=None, trace_attrs=None):
        """Enqueue ONE tile and return ``(handle, cost)`` at once. On the
        card: the rays go up through pinned memory in one copy, the render
        is launched on the current stream (the fused path: K2 alone, which
        composites the white background itself), a non-blocking copy of
        the pixels into a pinned host buffer and a CUDA event follow it, and
        ``handle.result()`` waits on that event only. On the CPU the
        handle holds the finished pixels. ``budget``/``alive`` as in
        ``render_tile``; ``cost`` is the weight-gather record,
        ``tile_gather_cost(home_cell)``.

        ``percell=True`` with a routed ``home_cell`` and a cell list runs
        the tile on its home cell instead (``render_tile_cell``): against
        the cell's staged weights, on the cell's own CUDA stream (the
        handle's events are recorded there). The cost record then carries
        ``layers = bytes = 0``, the ``cell``, and ``stage_layers`` /
        ``stage_bytes``, nonzero only on the dispatch that staged the
        (scene, cell) weights. ``tracer`` records the host-side enqueue as
        a ``plcore.dispatch`` range (``trace_attrs`` added to it); on the
        card a fused-path tile then runs K2's traced instance, which writes
        its phase cycles to zeroed pinned rows the handle keeps
        (``TileHandle.phase_cycles``)."""
        use_percell = (percell and home_cell is not None
                       and self.shard_mesh is not None)
        if use_percell and (budget is not None or alive is not None):
            raise ValueError("adaptive budgets and dead-row masks are a "
                             "replicated single-cell feature — not with "
                             "percell")
        traced = tracer is not None and tracer.enabled
        with (tracer.range("plcore.dispatch", "plcore") if traced
              else contextlib.nullcontext({})) as attrs:
            if use_percell:
                cell = int(home_cell)
                staged_now = cell not in self._cell_views
                handle = self.render_tile_cell(o_tile, d_tile, cell,
                                               ert_eps=ert_eps,
                                               coarse_only=coarse_only,
                                               tracer=tracer, handle=True)
                stage = self.cell_stage_cost(cell)
                cost = {"layers": 0, "bytes": 0, "cell": cell,
                        "stage_layers": stage["layers"] if staged_now else 0,
                        "stage_bytes": stage["bytes"] if staged_now else 0}
            else:
                # origins and directions go up in one copy
                o, d = self._upload(torch.stack((torch.as_tensor(o_tile),
                                                 torch.as_tensor(d_tile)))
                                    ).unbind(0)
                a = None if alive is None else self._upload(alive)
                phase = None
                if (traced and self.device.type == "cuda"
                        and self.fuse_two_pass and not coarse_only):
                    phase = torch.zeros((len(o_tile), len(K2_ROW_STATS)),
                                        dtype=torch.int64, pin_memory=True)
                start = self.tile_start()
                rgb = self.render_tile(o, d, ert_eps=ert_eps,
                                       coarse_only=coarse_only, budget=budget,
                                       alive=a, phase_cycles=phase)
                handle = self.handle(rgb, start, phase)
                cost = self.tile_gather_cost(home_cell)
            attrs.update(rays=int(o_tile.shape[0]),
                         coarse_only=bool(coarse_only),
                         percell=bool(use_percell),
                         cell=int(home_cell) if use_percell else -1,
                         gather_layers=cost["layers"],
                         gather_bytes=cost["bytes"],
                         **(trace_attrs or {}))
        return handle, cost

    def tile_gather_cost(self, home_cell: Optional[int] = None) -> dict:
        """Weight-gather traffic of one tile dispatch in the owner-map
        model: every trunk layer the tile's home cell does NOT own is one
        remote layer fetch, priced per layer-stacked array of the packed
        layout (the tensor-core stream's trunk segments included) at its
        bytes. ``home_cell=None`` (unrouted) owns nothing, the worst case.
        Zero without a cell list: every weight is on the one device that
        renders the tile."""
        if self.shard_mesh is None or not self.packed:
            return {"layers": 0, "bytes": 0}
        cost = self._gather_costs.get(home_cell)
        if cost is None:
            from repro_torch.runtime import sharding as rsh
            layers = nbytes = 0
            for p in self.packed.values():
                for a in p.values():
                    if not isinstance(a, rsh.LayerShards):
                        continue
                    remote = ~rsh.plcore_owned_layer_mask(
                        self.shard_mesh, a.n_layers, home_cell)
                    layers += int(remote.sum())
                    nbytes += sum(nb for nb, r in zip(a.layer_nbytes, remote)
                                  if r)
            cost = {"layers": layers, "bytes": nbytes}
            self._gather_costs[home_cell] = cost
        return dict(cost)

    def cell_stage_cost(self, cell: int) -> dict:
        """One-time cost of staging this scene's weights on cell ``cell``:
        the layers and bytes ``tile_gather_cost(cell)`` prices per
        dispatch, paid once per (scene, cell) instead."""
        return self.tile_gather_cost(int(cell))

    def staged_cells(self) -> list:
        """Cells holding a staged view of this scene."""
        return sorted(self._cell_views)

    def cell_view(self, cell: int, tracer=None) -> dict:
        """The staged view of cell ``cell``: ``{"params", "quant",
        "packed"}`` with every tensor on the cell's device
        (``runtime.sharding.stage_plcore_packed_to_cell`` fetches, and
        counts, the layers the cell does not own). Built once per cell on
        the current stream, traced as a ``plcore.stage`` span. For the
        plain path the per-layer trunk params are rebuilt from the staged
        stacks (``unstack_trunk_params``, lossless)."""
        if self.shard_mesh is None:
            raise ValueError("per-cell views need a shard_mesh cell list")
        cell = int(cell)
        view = self._cell_views.get(cell)
        if view is not None:
            return view
        t0 = tracer.clock() if tracer is not None else None
        from repro_torch.kernels import ops as kops
        from repro_torch.runtime import sharding as rsh
        dev = self.shard_mesh[cell]
        staged = {net: rsh.stage_plcore_packed_to_cell(
            p, self.shard_mesh, cell) for net, p in self.packed.items()}
        params = to_device(self.params, dev)
        quant = None if self.quant is None else to_device(self.quant, dev)
        if self.use_kernel:
            packed = staged
            if self.fuse_two_pass:
                # K2's sample grids on the cell's device, made here on the
                # current stream before any cell stream reads them
                kops.sample_rows(self.cfg, dev)
        else:
            packed = None
            params, quant = _materialize(self.cfg, params, quant, staged,
                                         (dev,), False, dev, False)[:2]
        view = {"params": params, "quant": quant, "packed": packed}
        self._cell_views[cell] = view
        if tracer is not None:
            cost = self.cell_stage_cost(cell)
            tracer.complete("plcore.stage", t0, cat="plcore", cell=cell,
                            stage_layers=cost["layers"],
                            stage_bytes=cost["bytes"])
        return view

    def render_tile_cell(self, o_tile, d_tile, cell: int,
                         ert_eps: Optional[float] = None,
                         coarse_only: bool = False, tracer=None,
                         handle: bool = False):
        """``render_tile`` on cell ``cell``: the rays go to the cell's
        device and render against its staged ``cell_view``, on the cell's
        own CUDA stream (which first waits for the work queued before it
        on the current stream). Pixels equal ``render_tile``'s bit for bit
        (placement only). Returns the pixels, or with ``handle`` a
        ``TileHandle`` whose events are recorded on the cell's stream."""
        from repro_torch.runtime import sharding as rsh
        cell = int(cell)
        view = self.cell_view(cell, tracer=tracer)
        dev = self.shard_mesh[cell]
        stream = rsh.cell_stream(self.shard_mesh, cell)
        ctx = contextlib.nullcontext()
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
            ctx = torch.cuda.stream(stream)
        with ctx:
            o = self._upload(o_tile, device=dev)
            d = self._upload(d_tile, device=dev)
            start = self.tile_start() if stream is not None else None
            rgb = self._tile_body((view["params"], view["quant"],
                                   view["packed"]), o, d,
                                  self._eps(ert_eps), coarse_only)
            return self.handle(rgb, start) if handle else rgb


# ----------------------------------------------------------------- ASDR -----
# Adaptive per-ray sample budgets + cross-ray trunk memoization, the device
# side. A load-time coarse probe calibrates a per-scene density grid
# (``sampling.SampleStats``); rays classify into fine-sample budget classes
# from the stats along their frustum; the position-only trunk half of the
# coarse network is memoized per calibration voxel (``sampling.TrunkMemo``),
# so rays whose frustum is memo-resident and provably empty enter K2 as
# dead rows (it skips their fine pass) and their pixels are rebuilt from the
# memo. ``trunk_rows`` and the reconstruction are plain tensor code on the
# instance's device, float32 with TF32 off.

#: rows per ``trunk_rows`` block: one fixed shape, so a memoized row equals
#: a fresh evaluation at the same position bit for bit
TRUNK_CHUNK = 2048


@contextmanager
def _exact_f32():
    """Float32 matrix products at full precision (no TF32) inside the
    block; the caller's setting is restored after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def trunk_rows(pp: PackedPlcore, pts, chunk: int = TRUNK_CHUNK) -> np.ndarray:
    """Coarse-trunk ``sigma|feat`` rows at host positions (M, 3) -> (M, 1+W)
    float32 on the host. The plain trunk (direct sin/cos encoding, RMCM
    layers through the dequantized product of ``rmcm_matmul_ref``) in
    ``cfg.compute_dtype`` on ``pp``'s device, in blocks of ``chunk`` rows,
    the last one zero-padded, so every row comes out of the same product
    shape."""
    cfg = pp.cfg
    cdt = getattr(torch, cfg.compute_dtype)
    params_c = plcore.cast_params(pp.params["coarse"], cdt)
    quant_c = (pp.quant or {}).get("coarse")
    pts = _host(pts).reshape(-1, 3)
    M = pts.shape[0]
    out = np.empty((M, 1 + cfg.trunk_width), np.float32)
    with _exact_f32():
        for s in range(0, M, chunk):
            n = min(chunk, M - s)
            blk = np.zeros((chunk, 3), np.float32)
            blk[:n] = pts[s:s + n]
            x = torch.from_numpy(blk).to(pp.device)
            sigma, feat = nerf_trunk_apply(
                cfg, params_c, nerf_encoding(x, cfg.pos_freqs).to(cdt),
                quant=quant_c)
            rows = torch.cat([sigma[:, None], feat], dim=-1).float()
            out[s:s + n] = rows[:n].cpu().numpy()
    return out


def recon_rows(pp: PackedPlcore, rows: np.ndarray, inv: np.ndarray,
               d: np.ndarray, t_row: np.ndarray) -> torch.Tensor:
    """Pixels (n, 3) of dead rays rebuilt from memoized coarse-trunk rows,
    on ``pp``'s device: ``rows`` (U, 1+W) the distinct memo rows, ``inv``
    (n, C) the row of each ray's coarse sample, ``d`` (n, 3) the rays'
    directions, ``t_row`` (C,) the coarse positions. The coarse colour
    branch (in ``cfg.compute_dtype``), ``render_parallel`` in f32 and the
    white background: the coarse-only render with the trunk replaced by
    memo reads (for provably empty frustums, where fine ~= coarse ~= the
    background)."""
    cfg = pp.cfg
    with _exact_f32():
        g = pp._upload(rows)[pp._upload(inv, torch.int64)]   # (n, C, 1+W)
        d = pp._upload(d)
        t = pp._upload(t_row).expand(d.shape[0], -1)
        deltas = sampling.deltas_from_t(t, far_cap=1e10)
        dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        cdt = getattr(torch, cfg.compute_dtype)
        pe_dir = nerf_encoding(dirs, cfg.dir_freqs).to(cdt)[..., None, :]
        rgb_s = nerf_color_apply(cfg, plcore.cast_params(pp.params["coarse"],
                                                         cdt),
                                 g[..., 1:].to(cdt), pe_dir,
                                 quant=(pp.quant or {}).get("coarse"))
        rgb, aux = volume.render_parallel(g[..., 0], rgb_s.float(), deltas)
        return volume.white_background(rgb, aux["acc"])


def build_scene_aux(pp: PackedPlcore, *, grid_res: int = 48,
                    n_classes: int = 3, memo_mb: float = 32.0,
                    probe_hw: int = 12, probe_radius: float = 4.0,
                    empty_tau: float = 1e-2, n_probe_theta: int = 8,
                    warm_memo: bool = True) -> sampling.SceneAux:
    """Per-scene density calibration, the cheap probe at scene load. It
    renders no pixels: it evaluates the coarse trunk at the coarse sample
    positions of a small spherical pose sweep (the load generator's poses:
    theta 0..360, phi -35 and -15, radius 4) and keeps the max sigma per
    calibration voxel in a ``SampleStats``. ``warm_memo`` pre-fills the
    trunk memo with the rows of the probed empty voxels, up to its
    capacity; dispatches top up the rest. Returns the ``SceneAux`` that
    rides beside the scene in the ``SceneCache``."""
    cfg = pp.cfg
    t_row = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse,
                                (1,))[0].numpy().astype(np.float32)
    os_, ds_ = [], []
    for phi in (-35.0, -15.0):
        for th in np.linspace(0.0, 360.0, n_probe_theta, endpoint=False):
            c2w = drays.pose_spherical(float(th), float(phi), probe_radius)
            o, d = drays.camera_rays(c2w, probe_hw, probe_hw, 0.9 * probe_hw)
            os_.append(o.numpy().reshape(-1, 3))
            ds_.append(d.numpy().reshape(-1, 3))
    o = np.concatenate(os_).astype(np.float32)
    d = np.concatenate(ds_).astype(np.float32)
    pts = o[:, None, :] + t_row[None, :, None] * d[:, None, :]
    rows = trunk_rows(pp, pts.reshape(-1, 3))
    sigma = rows[:, 0].reshape(pts.shape[:2])
    stats = sampling.build_sample_stats(pts, sigma, grid_res=grid_res,
                                        n_classes=n_classes,
                                        empty_tau=empty_tau)
    aux = sampling.SceneAux(stats=stats,
                            memo=sampling.TrunkMemo(capacity_mb=memo_mb),
                            t_row=t_row)
    if warm_memo:
        warm_trunk_memo(pp, aux)
    return aux


def warm_trunk_memo(pp: PackedPlcore, aux: sampling.SceneAux) -> None:
    """Insert the trunk rows of the probed empty voxels (the only rows
    dead-row detection needs resident) into ``aux.memo``, in voxel order,
    as many as its capacity holds."""
    stats, memo = aux.stats, aux.memo
    g = stats.grid.reshape(-1)
    p = stats.probed.reshape(-1)
    empty = np.nonzero(p & (g < stats.empty_tau))[0]
    row_b = (1 + pp.cfg.trunk_width) * 4 + 48
    empty = empty[:max(0, memo.capacity_bytes // row_b)]
    if empty.size:
        memo.insert("c", empty, trunk_rows(pp, stats.voxel_centers(empty)))


class AdaptiveRenderer:
    """Adaptive sample budgets and trunk memoization for one scene: a
    fused-kernel ``PackedPlcore`` plus its ``SceneAux``. Tiles render in
    three tiers:

    * every ray classifies into a fine-sample budget class from the
      calibration stats along its frustum (``classify_rays``); callers
      coalesce rays by (scene, class) and render each tile at its class's
      ``n_fine`` (``PackedPlcore.render_tile(budget=)``);
    * rays whose frustum is memo-resident AND provably empty enter K2 as
      dead rows (it skips their fine pass), and their pixels are rebuilt on
      the device from the memoized rows of the dead rays only
      (``recon_rows``);
    * a tile whose rays are ALL dead never reaches the kernel.

    ``report()`` feeds the engine's ``sampling`` stats block. Host time is
    kept in two sums: ``host_s``, of ``render_tile`` (dead-row resolution,
    memo work and the enqueue of the device work, without waiting for the
    card), and ``classify_s``, of ``classify_rays`` and ``dead_hint``."""

    def __init__(self, pp: PackedPlcore, aux, budgets=None, *,
                 topup_voxels: int = 1024):
        if not (pp.use_kernel and pp.fuse_two_pass):
            raise ValueError("adaptive sampling rides the fused two-pass "
                             "kernel's dead rows — build the PackedPlcore "
                             "with use_kernel=True, fuse_two_pass=True")
        self.pp = pp
        self.aux = aux
        self.budgets = (tuple(int(b) for b in budgets) if budgets
                        else sampling.default_budget_classes(pp.cfg.n_fine))
        self.topup_voxels = int(topup_voxels)
        self.counters = {"tiles": 0, "rays": 0, "dead_rays": 0,
                         "full_dead_tiles": 0, "skipped_fine_samples": 0,
                         "topup_voxels": 0}
        self.budget_tiles = {b: 0 for b in self.budgets}
        self.budget_rays = {b: 0 for b in self.budgets}
        self.host_s = 0.0
        self.classify_s = 0.0

    # ------------------------------------------------------------- classify
    def _frustum_pts(self, o: np.ndarray, d: np.ndarray) -> np.ndarray:
        t = self.aux.t_row
        return (o[:, None, :] + t[None, :, None] * d[:, None, :]).astype(
            np.float32)

    def classify_rays(self, o, d) -> np.ndarray:
        """Rays (R, 3) x 2 -> budget-class index (R,) into ``budgets``."""
        t0 = time.perf_counter()
        cls = self.aux.stats.classify(self._frustum_pts(_host(o), _host(d)),
                                      self.budgets)
        self.classify_s += time.perf_counter() - t0
        return cls

    def dead_hint(self, o, d) -> np.ndarray:
        """Stats-only provisional deadness (R,) bool: every frustum voxel
        probed AND below empty_tau. Residency is not checked (the per-tile
        top-up makes hinted rows resident at dispatch), so schedulers can
        afford it to put hinted-dead rays into tiles of their own, which
        resolve fully dead and skip the kernel."""
        t0 = time.perf_counter()
        stats = self.aux.stats
        hint = stats.empty_mask(stats.voxel_ids(
            self._frustum_pts(_host(o), _host(d))))
        self.classify_s += time.perf_counter() - t0
        return hint

    # ------------------------------------------------------------- dead rows
    def dead_and_rows(self, o: np.ndarray, d: np.ndarray):
        """Per-tile dead-row resolution: top up the memo (capped), then
        return ``(dead (R,) bool, vox (R, C) voxel ids, rows (U, 1+W),
        inv (n_dead, C))``: the distinct memo rows the dead rays read and,
        per dead ray and coarse sample, its row in ``rows``. Only the dead
        rays' rows are gathered. The hit counter ticks once per consumed
        sample, as a lookup per sample would."""
        stats, memo = self.aux.stats, self.aux.memo
        vox = stats.voxel_ids(self._frustum_pts(o, d))
        flat = np.unique(vox)
        g = stats.grid.reshape(-1)[flat]
        p = stats.probed.reshape(-1)[flat]
        cand = flat[p & (g < stats.empty_tau)]
        if cand.size:
            # pin this tile's candidate rows (resident and about to be
            # inserted) so the top-up's own LRU eviction cannot drop rows
            # the tile is about to read; released once they are read
            memo.pin("c", cand)
            missing = cand[~memo.contains("c", cand)][:self.topup_voxels]
            if missing.size:
                memo.insert("c", missing,
                            trunk_rows(self.pp, stats.voxel_centers(missing)))
                self.counters["topup_voxels"] += int(missing.size)
        resident = memo.contains("c", vox.reshape(-1)).reshape(vox.shape)
        dead = resident.all(axis=1) & stats.empty_mask(vox)
        rows = np.zeros((0, 1 + self.pp.cfg.trunk_width), np.float32)
        inv = np.zeros((0, vox.shape[1]), np.int64)
        if dead.any():
            uniq, inv = np.unique(vox[dead].reshape(-1), return_inverse=True)
            _, rows = memo.lookup("c", uniq)
            memo.hits += inv.size - uniq.size
            inv = inv.reshape(-1, vox.shape[1])
        if cand.size:
            memo.unpin("c", cand)
        return dead, vox, rows, inv

    # -------------------------------------------------------------- render
    def render_tile(self, o_tile, d_tile, budget: Optional[int] = None,
                    ert_eps: Optional[float] = None,
                    resolve_dead: bool = True):
        """Render one budget-pure coalesced tile -> ``(rgb (R, 3) on the
        device, info)``. K2 gets the dead-row mask; dead pixels are
        replaced by the memo reconstruction; an all-dead tile never reaches
        the kernel. ``resolve_dead=False`` skips the memo outright, for
        tiles whose rays are all hinted non-empty (dead rays are a subset
        of the hinted ones). ``info["dead_mask"]`` is the (R,) dead mask."""
        t0 = time.perf_counter()
        pp = self.pp
        o, d = _host(o_tile), _host(d_tile)
        R = o.shape[0]
        b = int(budget) if budget is not None else int(self.budgets[-1])
        if resolve_dead:
            dead, _, rows, inv = self.dead_and_rows(o, d)
        else:
            dead = np.zeros(R, bool)
        n_dead = int(dead.sum())
        info = {"rays": R, "dead": n_dead, "budget": b,
                "full_dead": n_dead == R,
                "skipped_fine_samples": n_dead * b, "dead_mask": dead}
        recon = None
        if n_dead:
            # memo rows whose sigma relu to exactly 0 composite to exactly
            # the white background (w = 0, acc = 0): only "tinted" empty
            # space, sigma in (0, tau), pays for the reconstruction
            if bool((rows[:, 0] <= 0.0).all()):
                recon = torch.ones((n_dead, 3), dtype=torch.float32,
                                   device=pp.device)
            else:
                recon = recon_rows(pp, rows, inv, d[dead], self.aux.t_row)
        if n_dead == R:
            rgb = recon
            self.counters["full_dead_tiles"] += 1
        else:
            alive = pp._upload((~dead).astype(np.float32)) if n_dead else None
            rgb = pp.render_tile(pp._upload(o), pp._upload(d),
                                 ert_eps=ert_eps, budget=b, alive=alive)
            if n_dead:
                rgb[pp._upload(np.nonzero(dead)[0], torch.int64)] = recon
        self.counters["tiles"] += 1
        self.counters["rays"] += R
        self.counters["dead_rays"] += n_dead
        self.counters["skipped_fine_samples"] += info["skipped_fine_samples"]
        self.budget_tiles[b] = self.budget_tiles.get(b, 0) + 1
        self.budget_rays[b] = self.budget_rays.get(b, 0) + R
        self.host_s += time.perf_counter() - t0
        return rgb, info

    def render_image(self, rays_o, rays_d, *,
                     rays_per_tile: Optional[int] = None,
                     with_dead: bool = False):
        """Full-image adaptive render: classify every ray, coalesce by
        budget class into tiles (a tail tile repeats its last ray), render
        each at its class budget, scatter the pixels back. Returns the
        image (..., 3) on the host, and with ``with_dead`` also the
        (...,) mask of the rays that rendered dead."""
        o, d = _host(rays_o), _host(rays_d)
        shape = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        rt = int(rays_per_tile or self.pp.cfg.rays_per_tile)
        cls = self.classify_rays(o, d)
        hint = self.dead_hint(o, d)
        out = np.zeros((o.shape[0], 3), np.float32)
        dead = np.zeros(o.shape[0], bool)
        for c, b in enumerate(self.budgets):
            idx = np.nonzero(cls == c)[0]
            if not idx.size:
                continue
            # hinted-dead rays first: they pack into all-dead tiles that
            # skip the kernel (a stable sort keeps the output deterministic)
            idx = idx[np.argsort(~hint[idx], kind="stable")]
            # a minority class takes the next power-of-two tile, so a
            # 6-ray class does not pad to a full tile; shapes stay few
            rt_c = (rt if idx.size >= rt
                    else max(32, 1 << int(np.ceil(np.log2(idx.size)))))
            for s in range(0, idx.size, rt_c):
                span = idx[s:s + rt_c]
                pad = rt_c - span.size
                take = (np.concatenate([span, np.repeat(span[-1:], pad)])
                        if pad else span)
                rgb, info = self.render_tile(
                    o[take], d[take], budget=b,
                    resolve_dead=bool(hint[take].any()))
                out[span] = rgb.cpu().numpy()[:span.size]
                dead[span] = info["dead_mask"][:span.size]
        img = out.reshape(*shape, 3)
        return (img, dead.reshape(shape)) if with_dead else img

    # ------------------------------------------------------------- reports
    def report(self) -> dict:
        """The ``sampling`` stats block of this scene: budget histogram,
        memo traffic, dead-row and skipped-sample totals, host ms per
        rendered tile and host ms spent classifying rays."""
        c = dict(self.counters)
        return {
            **c,
            "dead_ray_fraction": (round(c["dead_rays"] / c["rays"], 4)
                                  if c["rays"] else 0.0),
            "budgets": list(self.budgets),
            "budget_tiles": {str(b): n for b, n in
                             sorted(self.budget_tiles.items())},
            "budget_rays": {str(b): n for b, n in
                            sorted(self.budget_rays.items())},
            "memo": self.aux.memo.stats(),
            "host_ms_per_tile": (1e3 * self.host_s / c["tiles"]
                                 if c["tiles"] else None),
            "classify_ms": 1e3 * self.classify_s,
        }
