"""Serving pipeline — a loaded PLCore that packs its weights once.

* ``PackedPlcore`` — loads a param set ONCE: packs the kernel weight layout
  (``stack_plcore_weights``, RMCM included) a single time, moves it to the
  device, and reuses it for every ray batch, tile and image
  (``kernels.ops.pack_count`` does not move after load).
* ``render_image_single`` — a whole image in one render call: the padded
  ray tiles are rendered as one batch, so on the fused path one kernel
  launch covers every tile of the image. Each ray's pixel depends only on
  that ray, so a tile rendered alone gives the same pixels.
* ``PackedPlcore.render_tile`` / ``dispatch_tile`` — one coalesced ray tile
  in, pixels out, for a serving engine; ``dispatch_tile`` returns without
  waiting for the card. ``render_tile_oracle`` renders the tile through the
  two-dispatch kernel chain, the fallback of a retry ladder.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.bridge import to_device
from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import plcore, sampling, volume


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


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("PackedPlcore runs on the card by default and no "
                           "CUDA device is available; pass device='cpu' to "
                           "run the plain versions")
    return dev


class PackedPlcore:
    """A loaded PLCore: params + optional RMCM quantization + the kernel
    weight layout, packed once at construction and kept on ``device``
    (default ``"cuda"``; without a card only an explicit ``"cpu"`` works)."""

    def __init__(self, cfg: NerfConfig, params: dict, *,
                 quant: Optional[dict] = None, use_kernel: bool = False,
                 fuse_two_pass: bool = False,
                 ert_eps: Optional[float] = None, device=None):
        if fuse_two_pass and not use_kernel:
            raise ValueError("fuse_two_pass routes through the fused kernel "
                             "— pass use_kernel=True")
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.use_kernel = use_kernel
        self.fuse_two_pass = fuse_two_pass
        self.ert_eps = cfg.ert_eps if ert_eps is None else float(ert_eps)
        self.params = to_device(params, self.device)
        self.quant = None if quant is None else to_device(quant, self.device)
        self.packed = None
        if use_kernel:
            from repro_torch.kernels import ops as kops
            q = self.quant or {}
            self.packed = {
                net: kops.stack_plcore_weights(cfg, self.params[net],
                                               q.get(net))
                for net in ("coarse", "fine")}

    def _rays(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _eps(self, ert_eps: Optional[float]) -> float:
        return self.ert_eps if ert_eps is None else float(ert_eps)

    def render_rays(self, rays_o, rays_d, generator=None, *,
                    ert_eps: Optional[float] = None) -> dict:
        """Render one ray batch (R, 3) -> {rgb, rgb_coarse, depth, acc}."""
        return plcore.render_rays(
            self.cfg, self.params, self._rays(rays_o), self._rays(rays_d),
            generator, quant=self.quant, packed=self.packed,
            use_kernel=self.use_kernel, fuse_two_pass=self.fuse_two_pass,
            ert_eps=self._eps(ert_eps), white_bkgd=True)

    def render_image(self, rays_o, rays_d, *, rays_per_batch: int = 4096,
                     ert_eps: Optional[float] = None) -> torch.Tensor:
        return render_image_single(
            self.cfg, self.params, self._rays(rays_o), self._rays(rays_d),
            quant=self.quant, packed=self.packed,
            use_kernel=self.use_kernel, fuse_two_pass=self.fuse_two_pass,
            rays_per_batch=rays_per_batch, ert_eps=self._eps(ert_eps))

    def render_tile(self, o_tile, d_tile, ert_eps: Optional[float] = None,
                    coarse_only: bool = False) -> torch.Tensor:
        """ONE pre-coalesced ray tile (n, 3) -> rgb (n, 3), the same per-ray
        body as ``render_image``. ``coarse_only`` is the overload
        degradation: the coarse pass only, no resample, no fine pass."""
        o, d = self._rays(o_tile), self._rays(d_tile)
        if coarse_only:
            cfg = self.cfg
            t_c = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse,
                                      o.shape[:-1], device=self.device)
            rgb_c, aux_c = plcore._eval_pass(
                cfg, self.params["coarse"], (self.quant or {}).get("coarse"),
                o, d, t_c, self.use_kernel,
                (self.packed or {}).get("coarse"))
            return volume.white_background(rgb_c, aux_c["acc"])
        return plcore.render_rays(
            self.cfg, self.params, o, d, quant=self.quant,
            packed=self.packed, use_kernel=self.use_kernel,
            fuse_two_pass=self.fuse_two_pass, ert_eps=self._eps(ert_eps),
            white_bkgd=True)["rgb"]

    def render_tile_oracle(self, o_tile, d_tile,
                           ert_eps: Optional[float] = None) -> torch.Tensor:
        """The retry ladder's last rung: the tile through the two-dispatch
        chain (K1 for each pass, the resample between them on the host);
        for a non-fused instance, its own tile program."""
        return plcore.render_rays(
            self.cfg, self.params, self._rays(o_tile), self._rays(d_tile),
            quant=self.quant, packed=self.packed,
            use_kernel=self.use_kernel, fuse_two_pass=False,
            ert_eps=self._eps(ert_eps), white_bkgd=True)["rgb"]

    def dispatch_tile(self, o_tile, d_tile, *,
                      ert_eps: Optional[float] = None,
                      coarse_only: bool = False):
        """Enqueue ONE tile and return ``(rgb, cost)`` at once: ``rgb`` is
        not synchronized (materialize it with ``.cpu()`` or an event at a
        drain point); ``cost`` is the weight-gather record, zero with
        replicated weights."""
        rgb = self.render_tile(o_tile, d_tile, ert_eps=ert_eps,
                               coarse_only=coarse_only)
        return rgb, {"layers": 0, "bytes": 0}
