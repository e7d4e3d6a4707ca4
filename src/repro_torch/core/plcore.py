"""PLCore — the plenoptic core: PEU -> MLP engine -> VRU (paper Fig. 3).

``render_rays`` runs the two-pass NeRF render for a batch of rays:
positions and directions in, pixel colors out. Three routes:

* ``use_kernel=True, fuse_two_pass=True`` — the main path: the whole
  coarse -> importance -> fine chain in ONE fused kernel launch (K2);
* ``use_kernel=True`` — the two-dispatch chain: K1 for the coarse pass,
  the importance resample and merge here, K1 again for the fine pass;
* ``use_kernel=False`` — plain tensor code (direct sin/cos encoding,
  ``/ norm`` directions, the log-space VRU), the port's in-package oracle.

Multi-core scaling (paper §4.1: "the information of different clusters of
rays are fed to different PLCores") is the ray batch sharded over the
mesh's data axes with the weights replicated: ``make_render_step`` builds
that step on a ``DeviceMesh``, each rank rendering its own rays.
``PlcoreModel`` is the adapter that puts nerf-icarus in the dry run's grid.

Images: ``render_image`` renders a whole image in one render call
(``pipeline.render_image_single``); ``render_image_tiled`` is the seed's
per-tile host loop, one render call (and, with ``use_kernel``, two K1
launches) per tile of ``rays_per_batch`` rays, kept as the regression
oracle of the single-call path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import sampling, volume
from repro_torch.core.encoding import nerf_encoding
from repro_torch.core.mlp import nerf_mlp_apply, nerf_mlp_decls


def plcore_decls(cfg: NerfConfig) -> dict:
    """Coarse + fine networks (original NeRF trains both)."""
    return {"coarse": nerf_mlp_decls(cfg), "fine": nerf_mlp_decls(cfg)}


def _eval_pass(cfg: NerfConfig, params, quant, rays_o, rays_d, t,
               use_kernel: bool, packed: Optional[dict] = None, alive=None):
    """Encode -> MLP -> volume-render one sample set t: (R, N).
    ``packed``: pre-stacked kernel layout; ``alive``: optional (R,) mask
    forwarded to the kernel. The plain route computes the encodings and
    the MLP in ``cfg.compute_dtype``; the kernel route keeps its own
    precision, as the reference's does."""
    deltas = sampling.deltas_from_t(t, far_cap=1e10)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.fused_render(cfg, params, rays_o, rays_d, t, deltas,
                                 quant=quant, packed=packed, alive=alive)
    cdt = getattr(torch, cfg.compute_dtype)
    pts = rays_o[..., None, :] + t[..., None] * rays_d[..., None, :]
    pe_pos = nerf_encoding(pts, cfg.pos_freqs).to(cdt)
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    # per-ray (R, 1, de): the split color matmul broadcasts it lazily
    pe_dir = nerf_encoding(dirs, cfg.dir_freqs).to(cdt)[..., None, :]
    sigma, rgb = nerf_mlp_apply(cfg, cast_params(params, cdt), pe_pos, pe_dir,
                                quant=quant)
    # the VRU integrates in f32 whatever the MLP engine's dtype
    return volume.render_parallel(sigma.float(), rgb.float(), deltas)


def cast_params(params, dtype: torch.dtype):
    """``params``' tensors in ``dtype`` (the same tree when it is f32): the
    plain route's MLP engine runs in ``NerfConfig.compute_dtype``."""
    if dtype == torch.float32 or params is None:
        return params
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


def render_rays(cfg: NerfConfig, params: dict, rays_o, rays_d,
                generator: Optional[torch.Generator] = None, *,
                quant: Optional[dict] = None, use_kernel: bool = False,
                fuse_two_pass: bool = False,
                packed: Optional[dict] = None, ert_eps: float = 0.0,
                white_bkgd: bool = True, alive=None,
                phase_cycles=None) -> dict:
    """Two-pass render (paper §5.1): n_coarse stratified + n_fine importance.

    rays_o/rays_d: (R, 3). Returns {rgb, rgb_coarse, depth, acc}.
    ``quant``/``packed``: optional {"coarse", "fine"} RMCM trees / kernel
    layouts. ``ert_eps`` > 0: rays whose transmittance after the coarse
    pass is below it keep the coarse color and skip the fine pass.
    ``alive`` (fused path only): optional (R,) mask, 0 = dead row.
    ``phase_cycles`` (fused path only): K2's phase rows
    (``kernels.fused_plcore.two_pass_plcore_call``).
    ``generator`` jitters the samples (training mode); the fused path is
    deterministic and refuses one.
    """
    qc = (quant or {}).get("coarse")
    qf = (quant or {}).get("fine")
    pc = (packed or {}).get("coarse")
    pf = (packed or {}).get("fine")

    if alive is not None and not (use_kernel and fuse_two_pass):
        raise ValueError("an external alive mask rides the fused two-pass "
                         "kernel — pass use_kernel=True, fuse_two_pass=True")

    if use_kernel and fuse_two_pass:
        if generator is not None:
            raise ValueError("fuse_two_pass is the deterministic serving "
                             "path — no sampling generator")
        from repro_torch.kernels import ops as kops
        if pc is None or pf is None:
            pc = kops.kernel_weights(cfg, params["coarse"], qc)
            pf = kops.kernel_weights(cfg, params["fine"], qf)
        out = kops.fused_render_two_pass(
            cfg, {"coarse": pc, "fine": pf}, rays_o, rays_d,
            ert_eps=ert_eps, alive=alive, phase_cycles=phase_cycles,
            white_bkgd=white_bkgd)
        return {"rgb": out["rgb"], "rgb_coarse": out["rgb_coarse"],
                "depth": out["depth"], "acc": out["acc"]}

    # ---- pass 1: coarse --------------------------------------------------
    R = rays_o.shape[:-1]
    t_c = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse, R, generator,
                              device=rays_o.device)
    rgb_c, aux_c = _eval_pass(cfg, (params or {}).get("coarse"), qc, rays_o,
                              rays_d, t_c, use_kernel, pc)

    # ---- pass 2: importance resample near surfaces ------------------------
    t_f = sampling.importance(t_c, aux_c["weights"].detach(), cfg.n_fine,
                              generator)
    t_all = sampling.merge_sorted(t_c, t_f)
    if ert_eps > 0.0:
        # acc = 1 - T_N, so "T < eps" == "acc > 1 - eps"
        live = aux_c["acc"] < (1.0 - ert_eps)
        if bool(live.any()):
            rgb_f, aux = _eval_pass(
                cfg, (params or {}).get("fine"), qf, rays_o, rays_d, t_all,
                use_kernel, pf, live.to(torch.float32) if use_kernel else None)
            acc_f, depth_f = aux["acc"], volume.composite_depth(
                aux["weights"], t_all)
        else:   # every ray terminated: the fine pass is skipped entirely
            rgb_f = torch.zeros_like(rgb_c)
            acc_f = depth_f = torch.zeros_like(aux_c["acc"])
        # dead rays: the coarse estimate already holds ~all the radiance
        rgb_f = torch.where(live[..., None], rgb_f, rgb_c)
        aux_f = {"acc": torch.where(live, acc_f, aux_c["acc"])}
        depth = torch.where(live, depth_f,
                            volume.composite_depth(aux_c["weights"], t_c))
    else:
        rgb_f, aux_f = _eval_pass(cfg, (params or {}).get("fine"), qf,
                                  rays_o, rays_d, t_all, use_kernel, pf)
        depth = volume.composite_depth(aux_f["weights"], t_all)

    if white_bkgd:
        rgb_f = volume.white_background(rgb_f, aux_f["acc"])
        rgb_c = volume.white_background(rgb_c, aux_c["acc"])
    return {"rgb": rgb_f, "rgb_coarse": rgb_c, "depth": depth,
            "acc": aux_f["acc"]}


def flatten_pad_rays(rays_o, rays_d, rays_per_batch: int):
    """(H, W, 3) -> tiles (T, rays_per_batch, 3) + true ray count. Padded
    origins are 0 and padded directions 1.0 (no zero-norm direction)."""
    flat_o = rays_o.reshape(-1, 3)
    flat_d = rays_d.reshape(-1, 3)
    n = flat_o.shape[0]
    pad = (-n) % rays_per_batch
    flat_o = torch.cat([flat_o, flat_o.new_zeros((pad, 3))])
    flat_d = torch.cat([flat_d, flat_d.new_ones((pad, 3))])
    T = (n + pad) // rays_per_batch
    return (flat_o.reshape(T, rays_per_batch, 3),
            flat_d.reshape(T, rays_per_batch, 3), n)


def render_image_tiled(cfg: NerfConfig, params, rays_o, rays_d, *,
                       quant=None, use_kernel: bool = False,
                       rays_per_batch: int = 4096) -> torch.Tensor:
    """The seed per-tile host loop: one ``render_rays`` call per padded
    tile of ``rays_per_batch`` rays (the two-dispatch chain with
    ``use_kernel``), deterministic midpoint sampling, white background.
    rays: (H, W, 3) -> rgb (H, W, 3)."""
    H, W, _ = rays_o.shape
    o_tiles, d_tiles, n = flatten_pad_rays(rays_o, rays_d, rays_per_batch)
    outs = [render_rays(cfg, params, o_tiles[i], d_tiles[i], quant=quant,
                        use_kernel=use_kernel, white_bkgd=True)["rgb"]
            for i in range(o_tiles.shape[0])]
    return torch.cat(outs, dim=0)[:n].reshape(H, W, 3)


def render_image(cfg: NerfConfig, params, rays_o, rays_d, *, quant=None,
                 use_kernel: bool = False, rays_per_batch: int = 4096,
                 ert_eps: Optional[float] = None) -> torch.Tensor:
    """A full image in one render call (deterministic midpoint sampling),
    ``pipeline.render_image_single``. rays: (H, W, 3) -> rgb (H, W, 3);
    ``ert_eps`` overrides ``cfg.ert_eps`` (None: the config's)."""
    from repro_torch.core import pipeline
    return pipeline.render_image_single(
        cfg, params, rays_o, rays_d, quant=quant, use_kernel=use_kernel,
        rays_per_batch=rays_per_batch, ert_eps=ert_eps)


# ------------------------------------------------- multi-core dispatch ------
def ray_parallel(fn, mesh, rules):
    """``fn(params, batch) -> rgb`` on one rank's rays, made a step on
    ``mesh``: every (R, 3) batch leaf sharded over ``rules.batch_axes``
    (a plain tensor is laid out so; a DTensor is redistributed), the
    params replicated, and the result a ray-sharded DTensor. Rays are
    independent, so each rank's program is ``fn`` on its own rays, with
    no collective."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.runtime.sharding import placements

    ray_pl = placements(rules.batch_spec(mesh, 2), mesh)

    def shard(x):
        if isinstance(x, DTensor):
            return x.redistribute(mesh, ray_pl).to_local()
        return distribute_tensor(x, mesh, ray_pl).to_local()

    def local_params(p):
        if isinstance(p, dict):
            return {k: local_params(v) for k, v in p.items()}
        return p.to_local() if isinstance(p, DTensor) else p

    def step(params, batch):
        rgb = fn(local_params(params), {k: shard(v) for k, v in batch.items()})
        n = next(iter(batch.values())).shape[0]
        return DTensor.from_local(rgb, mesh, ray_pl, run_check=False,
                                  shape=(n,) + tuple(rgb.shape[1:]),
                                  stride=rgb.stride())

    return step


def make_render_step(cfg: NerfConfig, mesh, rules, *, use_kernel=False):
    """``step(params, rays_o, rays_d) -> rgb``: rays sharded over the data
    axes and weights replicated, one PLCore per mesh cell, the paper's
    scaling model. ``use_kernel=True`` is the reference's kernel route,
    the two-dispatch chain: two K1 launches per call on the card."""
    def render(params, batch):
        return render_rays(cfg, params, batch["rays_o"], batch["rays_d"],
                           use_kernel=use_kernel)["rgb"]

    sharded = ray_parallel(render, mesh, rules)

    def step(params, rays_o, rays_d):
        return sharded(params, {"rays_o": rays_o, "rays_d": rays_d})

    return step


# ------------------------------------------------------------- dry-run API --
class PlcoreModel:
    """Adapter so nerf-icarus joins the dry-run/roofline grid alongside the
    LM architectures."""

    def __init__(self, cfg: NerfConfig):
        self.cfg = cfg

    def param_decls(self):
        return plcore_decls(self.cfg)

    def render_step(self, params, batch):
        out = render_rays(self.cfg, params, batch["rays_o"], batch["rays_d"])
        return out["rgb"]

    def input_specs(self, n_rays: int) -> dict:
        return {k: torch.empty((n_rays, 3), dtype=torch.float32, device="meta")
                for k in ("rays_o", "rays_d")}

    def input_logical(self) -> dict:
        return {"rays_o": ("batch", None), "rays_d": ("batch", None)}
