"""Mip-NeRF on the port's render path (arXiv:2103.13415; the model and its
published settings: ``configs.mipnerf``).

* ``render_rays`` renders cones (origins, directions with camera z = -1,
  radii) through both levels of ONE network in plain tensor code (the IPE
  of ``core.encoding``, the MLP, ``volume.render_parallel`` over finite
  deltas, ``sampling.mip_resample``): the port's in-package oracle of K2's
  Mip-NeRF instance (``kernels.ops.fused_render_mip``).
* ``PackedMipNerf`` is a loaded scene for the serving engine, the sibling
  of ``core.pipeline.PackedPlcore``: one network packed once
  (``kernels.ops.kernel_weights``, the same layout as one NeRF network),
  ``dispatch_tile``/``render_tile`` on K2's Mip-NeRF instance,
  ``render_tile_oracle`` on it again (the plain path on the CPU), and
  ``view_rays``, the per-ray columns (o, d, r) the engine builds for it.
  It serves float32 weights only, and refuses RMCM, early ray
  termination, adaptive sampling, the coarse-only degradation, weight
  sharding and per-cell routing: none of them is defined for this model
  here.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.bridge import resolve_device, to_device
from repro_torch.configs.mipnerf import MipNerfConfig
from repro_torch.core import sampling, volume
from repro_torch.core.encoding import (frustum_rows, integrated_pos_enc,
                                       lift_gaussian, mip_dir_encoding)
from repro_torch.core.mlp import (_matmul, _matmul_split, nerf_mlp_decls,
                                  nerf_trunk_apply, softplus)
from repro_torch.core.pipeline import TileIO
from repro_torch.data.rays import mip_view_rays
from repro_torch.obs.metrics import K2_MIP_ROW_STATS


def mip_decls(cfg: MipNerfConfig) -> dict:
    """The one network: NeRF's layer tree at Mip-NeRF's widths (trunk with
    the encoding joined again at ``skip_at``, density head, bottleneck
    ``feat``, ``color0`` on [bottleneck, viewdir encoding], ``rgb``)."""
    return nerf_mlp_decls(cfg)


def mlp_apply(cfg: MipNerfConfig, params: dict, enc, pe_dir):
    """(IPE features (..., 6L), viewdir encoding (..., de) or per-ray (R, 1,
    de)) -> (density (...,), rgb (..., 3)), mip-NeRF's heads applied."""
    raw_sigma, feat = nerf_trunk_apply(cfg, params, enc)
    hc = torch.relu(_matmul_split([feat, pe_dir], params["color0"], None))
    raw_rgb = _matmul(hc, params["rgb"], None)
    pad = cfg.rgb_padding
    return (softplus(raw_sigma + cfg.density_bias),
            torch.sigmoid(raw_rgb) * (1.0 + 2.0 * pad) - pad)


def _level(cfg, params, o, d, r, pe_dir, t_edges):
    t_mean, t_var, r_unit = frustum_rows(t_edges[..., :-1], t_edges[..., 1:])
    mean, cov = lift_gaussian(o, d, r, t_mean, t_var, r_unit)
    enc = integrated_pos_enc(mean, cov, cfg.min_deg_point, cfg.max_deg_point)
    cdt = getattr(torch, cfg.compute_dtype)
    sigma, rgb = mlp_apply(cfg, params, enc.to(cdt), pe_dir.to(cdt))
    rgb, aux = volume.render_parallel(sigma.float(), rgb.float(),
                                      volume.interval_deltas(t_edges, d))
    return rgb, aux["weights"], aux["acc"]


def render_rays(cfg: MipNerfConfig, params: dict, rays_o, rays_d, radii, *,
                white_bkgd: bool = True) -> dict:
    """Mip-NeRF's two-level render of R cones: origins and directions (R,
    3), radii (R,) or (R, 1). Returns {rgb, rgb_coarse, acc, acc_coarse,
    depth}."""
    r = radii.reshape(rays_o.shape[:-1])
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pe_dir = mip_dir_encoding(viewdirs, cfg.deg_view)[..., None, :]
    t_c = sampling.mip_edges(cfg.near, cfg.far, cfg.n_edges,
                             rays_o.device).expand(*r.shape, cfg.n_edges)
    rgb_c, w_c, acc_c = _level(cfg, params, rays_o, rays_d, r, pe_dir, t_c)
    t_f = sampling.mip_resample(t_c, w_c, cfg.resample_padding)
    rgb, w, acc = _level(cfg, params, rays_o, rays_d, r, pe_dir, t_f)
    depth = volume.interval_depth(w, t_f, acc)
    if white_bkgd:
        rgb = volume.white_background(rgb, acc)
        rgb_c = volume.white_background(rgb_c, acc_c)
    return {"rgb": rgb, "rgb_coarse": rgb_c, "acc": acc,
            "acc_coarse": acc_c, "depth": depth}


class PackedMipNerf(TileIO):
    """A loaded Mip-NeRF scene: ``params`` (one network) on ``device`` and,
    with ``use_kernel``, its kernel layout packed once. The serving
    engine's resident for this model (``SceneCache`` counts ``params`` and
    ``packed``): ``dispatch_tile`` renders a tile through K2's Mip-NeRF
    instance (the CPU: its plain version), ``render_tile_oracle`` through
    it once more outside the engine's fault plan (the CPU: the plain
    path). Without ``use_kernel`` both take the plain path."""

    #: the engine's per-ray columns of a view: (o, d, r)
    view_rays = staticmethod(mip_view_rays)
    #: float32 weights only
    quant = None

    def __init__(self, cfg: MipNerfConfig, params: dict, *,
                 use_kernel: bool = False, quant: Optional[dict] = None,
                 ert_eps: Optional[float] = None, device=None,
                 shard_mesh=None):
        if quant is not None:
            raise ValueError("Mip-NeRF serves float32 weights: RMCM is not "
                             "defined for it")
        if ert_eps:
            raise ValueError("Mip-NeRF renders every ray's two levels: early "
                             "ray termination is not defined for it")
        if shard_mesh is not None:
            raise ValueError("Mip-NeRF residents are replicated: weight "
                             "sharding and per-cell dispatch are not defined "
                             "for them")
        self.cfg = cfg
        self.device = resolve_device(device, "PackedMipNerf")
        self.use_kernel = bool(use_kernel)
        self.params = to_device(params, self.device)
        self.packed = None
        if use_kernel:
            from repro_torch.kernels import ops as kops
            self.packed = kops.kernel_weights(cfg, self.params)

    @staticmethod
    def _refuse(ert_eps=None, budget=None, alive=None, percell=False,
                home_cell=None, coarse_only=False) -> None:
        if ert_eps:
            raise ValueError("Mip-NeRF: no early ray termination")
        if coarse_only:
            raise ValueError("Mip-NeRF: the coarse-only degradation is not "
                             "defined for it (K2's instance renders both "
                             "levels)")
        if budget is not None or alive is not None:
            raise ValueError("Mip-NeRF: adaptive sampling (budgets, dead "
                             "rows) is not defined for it")
        if percell or home_cell is not None:
            raise ValueError("Mip-NeRF: no per-cell routing; its residents "
                             "are replicated")

    def _rays(self, o, d, r) -> torch.Tensor:
        """(n, 7) rays o | d | r on the device, host columns in one
        upload."""
        cols = [torch.as_tensor(x, dtype=torch.float32).reshape(len(o), -1)
                for x in (o, d, r)]
        if any(c.device.type != "cpu" for c in cols):
            return torch.cat([c.to(self.device) for c in cols], dim=1)
        return self._upload(torch.cat(cols, dim=1))

    def _render(self, rays: torch.Tensor, phase_cycles=None,
                use_kernel: Optional[bool] = None):
        """rgb on white of the (n, 7) rays: K2's Mip-NeRF instance on them
        as they lie, or the plain path (``use_kernel=False``)."""
        kernel = self.use_kernel if use_kernel is None else use_kernel
        if kernel:
            from repro_torch.kernels import ops as kops
            return kops.fused_render_mip(self.cfg, self.packed, rays,
                                         phase_cycles=phase_cycles,
                                         white_bkgd=True)["rgb"]
        return render_rays(self.cfg, self.params, rays[:, :3], rays[:, 3:6],
                           rays[:, 6])["rgb"]

    def render_tile(self, o_tile, d_tile, r_tile, ert_eps=None,
                    coarse_only: bool = False, budget=None, alive=None,
                    phase_cycles=None) -> torch.Tensor:
        """ONE coalesced tile of cones -> rgb (n, 3) on white."""
        self._refuse(ert_eps, budget, alive, coarse_only=coarse_only)
        return self._render(self._rays(o_tile, d_tile, r_tile), phase_cycles)

    def render_tile_oracle(self, o_tile, d_tile, r_tile,
                           ert_eps=None) -> torch.Tensor:
        """The retry ladder's last rung: on the card K2's Mip-NeRF instance
        once more, synchronously and outside the engine's fault plan (the
        model has no second kernel); on the CPU the plain path."""
        self._refuse(ert_eps)
        return self._render(self._rays(o_tile, d_tile, r_tile),
                            use_kernel=(self.use_kernel
                                        and self.device.type == "cuda"))

    def dispatch_tile(self, o_tile, d_tile, r_tile, *,
                      home_cell: Optional[int] = None, ert_eps=None,
                      coarse_only: bool = False, percell: bool = False,
                      budget=None, alive=None, tracer=None,
                      trace_attrs=None):
        """Enqueue ONE tile and return ``(handle, cost)`` at once, as
        ``PackedPlcore.dispatch_tile`` does: the rays go up in one copy of
        (n, 7) rows, K2's Mip-NeRF instance renders them onto white, the
        pixels come back through pinned memory behind an event. A tracer
        records the enqueue as a ``plcore.dispatch`` range and, on the
        card, runs the traced instance (``TileHandle.phase_cycles``: a row
        of ``obs.metrics.K2_MIP_ROW_STATS``). ``cost``: no weight gathers."""
        self._refuse(ert_eps, budget, alive, percell, home_cell, coarse_only)
        traced = tracer is not None and tracer.enabled
        with (tracer.range("plcore.dispatch", "plcore") if traced
              else contextlib.nullcontext({})) as attrs:
            rays = self._rays(o_tile, d_tile, r_tile)
            phase = None
            if traced and self.device.type == "cuda" and self.use_kernel:
                phase = torch.zeros((len(o_tile), len(K2_MIP_ROW_STATS)),
                                    dtype=torch.int64, pin_memory=True)
            start = self.tile_start()
            rgb = self._render(rays, phase)
            handle = self.handle(rgb, start, phase)
            cost = self.tile_gather_cost()
            attrs.update(rays=int(len(o_tile)), coarse_only=False,
                         percell=False, cell=-1, gather_layers=0,
                         gather_bytes=0, **(trace_attrs or {}))
        return handle, cost

    def tile_gather_cost(self, home_cell: Optional[int] = None) -> dict:
        """Replicated weights: a tile gathers nothing."""
        return {"layers": 0, "bytes": 0}
