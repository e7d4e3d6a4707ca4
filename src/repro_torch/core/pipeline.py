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
  chain, the fallback of a retry ladder. ``budget=`` renders a tile at an
  adaptive fine-sample count, ``alive=`` masks dead rows out of K2.
* ASDR, adaptive sampling: ``build_scene_aux`` (the load-time density
  probe), ``trunk_rows`` (coarse-trunk rows for the memo),
  ``recon_rows`` (dead rays' pixels from memo rows) and
  ``AdaptiveRenderer`` (budget classes, dead rows, all-dead tiles that
  never reach the kernel); see the section's comment.
"""
from __future__ import annotations

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
        self.device = resolve_device(device, "PackedPlcore")
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
                    coarse_only: bool = False, budget: Optional[int] = None,
                    alive=None) -> torch.Tensor:
        """ONE pre-coalesced ray tile (n, 3) -> rgb (n, 3), the same per-ray
        body as ``render_image``. ``coarse_only`` is the overload
        degradation: the coarse pass only, no resample, no fine pass.
        ``budget`` (adaptive sampling) renders the tile with ``n_fine =
        budget`` (K2 gets that config, so ``sample_rows`` gives it the
        budget's resample grid); ``alive`` is an optional (n,) dead-row
        mask, 0 = dead, for the fused path."""
        o, d = self._rays(o_tile), self._rays(d_tile)
        cfg = self.cfg
        if budget is not None and int(budget) != cfg.n_fine:
            cfg = dataclasses.replace(cfg, n_fine=int(budget))
        if coarse_only:
            t_c = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse,
                                      o.shape[:-1], device=self.device)
            rgb_c, aux_c = plcore._eval_pass(
                cfg, self.params["coarse"], (self.quant or {}).get("coarse"),
                o, d, t_c, self.use_kernel,
                (self.packed or {}).get("coarse"))
            return volume.white_background(rgb_c, aux_c["acc"])
        return plcore.render_rays(
            cfg, self.params, o, d, quant=self.quant,
            packed=self.packed, use_kernel=self.use_kernel,
            fuse_two_pass=self.fuse_two_pass, ert_eps=self._eps(ert_eps),
            white_bkgd=True,
            alive=None if alive is None else self._rays(alive))["rgb"]

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
                      coarse_only: bool = False,
                      budget: Optional[int] = None, alive=None):
        """Enqueue ONE tile and return ``(handle, cost)`` at once. On the
        card: the rays go up through pinned memory, the render is
        launched on the current stream, a non-blocking copy of the pixels
        into a pinned host buffer and a CUDA event follow it, and
        ``handle.result()`` waits on that event only. On the CPU the
        handle holds the finished pixels. ``budget``/``alive`` as in
        ``render_tile``; ``cost`` is the weight-gather record,
        ``tile_gather_cost()``."""
        rgb = self.render_tile(
            self._upload(o_tile), self._upload(d_tile), ert_eps=ert_eps,
            coarse_only=coarse_only, budget=budget,
            alive=None if alive is None else self._upload(alive))
        return self.handle(rgb), self.tile_gather_cost()

    def handle(self, rgb: torch.Tensor) -> TileHandle:
        """A ``TileHandle`` for pixels rendered on this instance's device:
        on the card, a non-blocking copy into pinned host memory and an
        event after it; on the CPU, the pixels themselves."""
        if self.device.type != "cuda":
            return TileHandle(rgb)
        host = torch.empty(rgb.shape, dtype=rgb.dtype, pin_memory=True)
        host.copy_(rgb, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return TileHandle(host, event, rgb)

    def tile_gather_cost(self) -> dict:
        """Weight-gather traffic of one tile dispatch: zero, since every
        weight is replicated on the one device that renders the tile."""
        return {"layers": 0, "bytes": 0}

    def _upload(self, x, dtype=torch.float32) -> torch.Tensor:
        """Host data -> the device without a stream sync: a pageable
        host-to-device copy would wait for every tile queued before it."""
        t = torch.as_tensor(x, dtype=dtype)
        if self.device.type != "cuda" or t.device.type == "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)


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
    layers through the dequantized product of ``rmcm_matmul_ref``) on
    ``pp``'s device, in blocks of ``chunk`` rows, the last one zero-padded,
    so every row comes out of the same product shape."""
    cfg = pp.cfg
    params_c = pp.params["coarse"]
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
                cfg, params_c, nerf_encoding(x, cfg.pos_freqs), quant=quant_c)
            rows = torch.cat([sigma[:, None], feat], dim=-1)
            out[s:s + n] = rows[:n].cpu().numpy()
    return out


def recon_rows(pp: PackedPlcore, rows: np.ndarray, inv: np.ndarray,
               d: np.ndarray, t_row: np.ndarray) -> torch.Tensor:
    """Pixels (n, 3) of dead rays rebuilt from memoized coarse-trunk rows,
    on ``pp``'s device: ``rows`` (U, 1+W) the distinct memo rows, ``inv``
    (n, C) the row of each ray's coarse sample, ``d`` (n, 3) the rays'
    directions, ``t_row`` (C,) the coarse positions. The coarse colour
    branch, ``render_parallel`` and the white background: the coarse-only
    render with the trunk replaced by memo reads (for provably empty
    frustums, where fine ~= coarse ~= the background)."""
    cfg = pp.cfg
    with _exact_f32():
        g = pp._upload(rows)[pp._upload(inv, torch.int64)]   # (n, C, 1+W)
        d = pp._upload(d)
        t = pp._upload(t_row).expand(d.shape[0], -1)
        deltas = sampling.deltas_from_t(t, far_cap=1e10)
        dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        pe_dir = nerf_encoding(dirs, cfg.dir_freqs)[..., None, :]
        rgb_s = nerf_color_apply(cfg, pp.params["coarse"], g[..., 1:], pe_dir,
                                 quant=(pp.quant or {}).get("coarse"))
        rgb, aux = volume.render_parallel(g[..., 0], rgb_s, deltas)
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
