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
  copies, and a CUDA event marks the end of the tile's own work, so
  draining tile k never waits for tile k+1 queued behind it.
  ``render_tile_oracle`` renders the tile through the two-dispatch kernel
  chain, the fallback of a retry ladder.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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


class TileHandle:
    """The pixels of one dispatched tile. ``result()`` waits for this
    tile's own work (its event), not for the stream, and returns the
    (n, 3) float32 host array; on the CPU the work is already done."""
    __slots__ = ("_host", "_event", "_device_rgb")

    def __init__(self, host: torch.Tensor, event=None, device_rgb=None):
        self._host = host
        self._event = event
        self._device_rgb = device_rgb    # alive until the copy has run

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = self._device_rgb = None
        return self._host.numpy()


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
                net: kops.kernel_weights(cfg, self.params[net],
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
        """Enqueue ONE tile and return ``(handle, cost)`` at once. On the
        card: the rays go up through pinned memory, the render is
        launched on the current stream, a non-blocking copy of the pixels
        into a pinned host buffer and a CUDA event follow it, and
        ``handle.result()`` waits on that event only. On the CPU the
        handle holds the finished pixels. ``cost`` is the weight-gather
        record, ``tile_gather_cost()``."""
        rgb = self.render_tile(self._upload(o_tile), self._upload(d_tile),
                               ert_eps=ert_eps, coarse_only=coarse_only)
        if self.device.type != "cuda":
            return TileHandle(rgb), self.tile_gather_cost()
        host = torch.empty(rgb.shape, dtype=rgb.dtype, pin_memory=True)
        host.copy_(rgb, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return TileHandle(host, event, rgb), self.tile_gather_cost()

    def tile_gather_cost(self) -> dict:
        """Weight-gather traffic of one tile dispatch: zero, since every
        weight is replicated on the one device that renders the tile."""
        return {"layers": 0, "bytes": 0}

    def _upload(self, x) -> torch.Tensor:
        """Host rays -> the device without a stream sync: a pageable
        host-to-device copy would wait for every tile queued before it."""
        t = torch.as_tensor(x, dtype=torch.float32)
        if self.device.type != "cuda" or t.device.type == "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)
