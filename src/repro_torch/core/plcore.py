"""PLCore — the plenoptic core: PEU -> MLP engine -> VRU (paper Fig. 3).

``render_rays`` runs the two-pass NeRF render for a batch of rays:
positions and directions in, pixel colors out. Three routes:

* ``use_kernel=True, fuse_two_pass=True`` — the main path: the whole
  coarse -> importance -> fine chain in ONE fused kernel launch (K2);
* ``use_kernel=True`` — the two-dispatch chain: K1 for the coarse pass,
  the importance resample and merge here, K1 again for the fine pass;
* ``use_kernel=False`` — plain tensor code (direct sin/cos encoding,
  ``/ norm`` directions, the log-space VRU), the port's in-package oracle.
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
    forwarded to the kernel."""
    deltas = sampling.deltas_from_t(t, far_cap=1e10)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.fused_render(cfg, params, rays_o, rays_d, t, deltas,
                                 quant=quant, packed=packed, alive=alive)
    pts = rays_o[..., None, :] + t[..., None] * rays_d[..., None, :]
    pe_pos = nerf_encoding(pts, cfg.pos_freqs)
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pe_dir = nerf_encoding(dirs, cfg.dir_freqs)[..., None, :]   # (R, 1, de)
    sigma, rgb = nerf_mlp_apply(cfg, params, pe_pos, pe_dir, quant=quant)
    return volume.render_parallel(sigma, rgb, deltas)


def render_rays(cfg: NerfConfig, params: dict, rays_o, rays_d,
                generator: Optional[torch.Generator] = None, *,
                quant: Optional[dict] = None, use_kernel: bool = False,
                fuse_two_pass: bool = False,
                packed: Optional[dict] = None, ert_eps: float = 0.0,
                white_bkgd: bool = True, alive=None) -> dict:
    """Two-pass render (paper §5.1): n_coarse stratified + n_fine importance.

    rays_o/rays_d: (R, 3). Returns {rgb, rgb_coarse, depth, acc}.
    ``quant``/``packed``: optional {"coarse", "fine"} RMCM trees / kernel
    layouts. ``ert_eps`` > 0: rays whose transmittance after the coarse
    pass is below it keep the coarse color and skip the fine pass.
    ``alive`` (fused path only): optional (R,) mask, 0 = dead row.
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
            ert_eps=ert_eps, alive=alive)
        rgb_f, rgb_c = out["rgb"], out["rgb_coarse"]
        if white_bkgd:
            rgb_f = volume.white_background(rgb_f, out["acc"])
            rgb_c = volume.white_background(rgb_c, out["acc_coarse"])
        return {"rgb": rgb_f, "rgb_coarse": rgb_c, "depth": out["depth"],
                "acc": out["acc"]}

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
