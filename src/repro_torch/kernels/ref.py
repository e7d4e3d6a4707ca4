"""Plain PyTorch versions of the port's kernels.

These are the kernels' tile bodies written as tensor code, computing what
the reference's Pallas kernels compute: the double-angle PEU, direction
normalization by ``rsqrt``, the split skip and color matmuls, the fused
sigma|feat head, and the closed-form VRU ``T = exp(cumsum(x))`` with
``w = T_i - T_next``. The CPU tests run them against the reference, the
kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.

* ``fused_render_ref`` — the composed-core oracle of K1: the core
  modules' PEU (``nerf_encoding``), NeRF MLP and VRU recurrence
  (``volume.render_scan``) on the unpacked params, the reference's own
  oracle for its kernel.
* ``fused_plcore_ref`` — K1: one sample set per ray. A dead ray of the
  optional ``alive`` mask outputs zeros (the kernel skips it per ray).
* ``two_pass_ref`` — K2: coarse pass over the pinned ``t_row``, the
  deterministic inverse-CDF resample, the sorted merge, the fine pass.
  With ERT or a mask, a dead ray keeps its coarse rgb/acc/depth.
* ``rmcm_matmul_ref`` — K3: the RMCM dequant-fused matmul, in the
  kernel's order (f32 product with the signed magnitudes, then the
  per-column scale, then the cast to ``x.dtype``).
* ``split_bf16x3`` — the kernels' split of an f32 operand into three bf16
  pieces (``csrc/mma_split.cuh``), each rounded to nearest even.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import rmcm, sampling, volume
from repro_torch.core.encoding import (nerf_encoding,
                                       nerf_encoding_double_angle)
from repro_torch.core.mlp import nerf_mlp_apply


def fused_render_ref(cfg: NerfConfig, params: dict, rays_o, rays_d, t,
                     deltas, quant: Optional[dict] = None):
    """(rays_o/rays_d (R,3), t/deltas (R,N)) -> (rgb (R,3), aux).

    The math the fused PLCore kernel implements, from the core modules:
    encode positions (and directions) from the ray parametrization, run
    the NeRF MLP on every sample, volume-render with the eq. (5)
    recurrence. aux: {"weights", "acc"}.
    """
    pts = rays_o[..., None, :] + t[..., None] * rays_d[..., None, :]
    pe_pos = nerf_encoding(pts, cfg.pos_freqs)
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pe_dir = nerf_encoding(dirs, cfg.dir_freqs)[..., None, :]   # (R,1,de)
    sigma, rgb = nerf_mlp_apply(cfg, params, pe_pos, pe_dir, quant=quant)
    out, aux = volume.render_scan(sigma, rgb, deltas)
    return out, {"weights": aux["weights"], "acc": aux["acc"]}


def _dq(mag, sgn_bits, scale, rows):
    sg = rmcm.unpack_signs(sgn_bits, rows).to(torch.float32)
    return mag.to(torch.float32) * (1.0 - 2.0 * sg) * scale


def net_arrays(cfg: NerfConfig, packed: dict):
    """One network's packed layout -> dense f32 matrices (RMCM layers
    dequantized once)."""
    W = cfg.trunk_width
    P, P2 = packed_rows(cfg)
    if "trunk_mag" in packed:
        tw = [_dq(packed["trunk_mag"][i], packed["trunk_sgn"][i],
                  packed["trunk_scl"][i], P) for i in range(cfg.trunk_layers)]
        fw = _dq(packed["feat_mag"], packed["feat_sgn"], packed["feat_scl"],
                 packed["feat_mag"].shape[0])
        cw = _dq(packed["color0_mag"], packed["color0_sgn"],
                 packed["color0_scl"], P2)
        fw = fw[:W]
    else:
        tw = [packed["trunk_w"][i] for i in range(cfg.trunk_layers)]
        fw, cw = packed["feat_w"], packed["color0_w"]
    return (tw, packed["trunk_b"], packed["sigma_w"], packed["sigma_b"], fw,
            packed["feat_b"], cw, packed["color0_b"], packed["rgb_w"],
            packed["rgb_b"])


def packed_rows(cfg: NerfConfig):
    """(P, P2): the 128-aligned row counts of the trunk and color0 stacks."""
    rup = lambda v: -(-v // 128) * 128  # noqa: E731
    return (rup(cfg.trunk_width + cfg.pos_enc_dim),
            rup(cfg.trunk_width + cfg.dir_enc_dim))


def encode_dirs(cfg: NerfConfig, d):
    dn = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return nerf_encoding_double_angle(dn, cfg.dir_freqs)


def pass_body(cfg: NerfConfig, net, o, d, ts, deltas, ped=None):
    """One PEU -> MLP -> VRU pass over (rt, N) samples. Returns
    (rgb (rt, 3), w (rt, N), T_next (rt, N)); acc = 1 - T_next[:, -1]."""
    tw, tb, sw, sb, fw, fb, cw, cb, rw, rb = net
    W = cfg.trunk_width
    pe_dim, de_dim = cfg.pos_enc_dim, cfg.dir_enc_dim
    rt, N = ts.shape
    T = rt * N

    pts = (o[:, None, :] + ts[..., None] * d[:, None, :]).reshape(T, 3)
    pe = nerf_encoding_double_angle(pts, cfg.pos_freqs)     # (T, pe_dim)
    if ped is None:
        ped = encode_dirs(cfg, d)                           # (rt, de_dim)

    h = pe
    for i in range(cfg.trunk_layers):
        if i == 0:
            h = torch.relu(pe @ tw[i][:pe_dim] + tb[i])
        elif i in cfg.skip_at:
            h = torch.relu(h @ tw[i][:W] + pe @ tw[i][W:W + pe_dim] + tb[i])
        else:
            h = torch.relu(h @ tw[i][:W] + tb[i])

    sf = h @ torch.cat([sw, fw], dim=-1)                    # (T, 1 + W)
    sigma = sf[:, 0] + sb[0]
    feat = sf[:, 1:] + fb
    C = cw.shape[-1]
    colf = feat @ cw[:W]
    cold = ped @ cw[W:W + de_dim]                           # (rt, C)
    hc = torch.relu((colf.reshape(rt, N, C) + cold[:, None, :]).reshape(T, C)
                    + cb)
    rgb = torch.sigmoid(hc @ rw + rb).reshape(rt, N, 3)

    x = -(torch.clamp(sigma, min=0.0).reshape(rt, N)) * deltas
    T_next = torch.exp(torch.cumsum(x, dim=-1))
    T_i = torch.cat([torch.ones_like(T_next[:, :1]), T_next[:, :-1]], dim=-1)
    w = T_i - T_next
    return torch.sum(w[..., None] * rgb, dim=1), w, T_next


def _tiles(R: int, rt: int):
    return [(s, min(s + rt, R)) for s in range(0, R, rt)]


def fused_plcore_ref(cfg: NerfConfig, weights: dict, rays_o, rays_d, t,
                     deltas, *, rt: int, alive=None):
    """K1's plain version: (rgb (R,3), w (R,N), acc (R,)), ``rt`` rays at a
    time."""
    net = net_arrays(cfg, weights)
    outs = []
    for s, e in _tiles(t.shape[0], rt):
        rgb, w, Tn = pass_body(cfg, net, rays_o[s:e], rays_d[s:e], t[s:e],
                               deltas[s:e])
        outs.append((rgb, w, 1.0 - Tn[:, -1]))
    rgb, w, acc = (torch.cat(x) for x in zip(*outs))
    if alive is not None:
        live = alive > 0
        rgb = torch.where(live[:, None], rgb, 0.0)
        w = torch.where(live[:, None], w, 0.0)
        acc = torch.where(live, acc, 0.0)
    return rgb, w, acc


def two_pass_tile(cfg: NerfConfig, net_c, net_f, o, d, t_row, u_row,
                  thr: float, ert: bool, m=None):
    """K2's tile body for rt rays. ``u_row``: the (n_fine,) resample grid;
    ``thr``: a ray stays alive while acc_c < thr (under ``ert``); ``m``:
    optional (rt,) mask, 0 = dead. Returns (rgb, rgb_coarse, acc,
    acc_coarse, depth)."""
    rt = o.shape[0]
    Nc = t_row.shape[-1]
    t_c = torch.broadcast_to(t_row, (rt, Nc))
    dl_c = sampling.deltas_from_t(t_c)
    ped = encode_dirs(cfg, d)

    rgb_c, w_c, Tn_c = pass_body(cfg, net_c, o, d, t_c, dl_c, ped)
    acc_c = 1.0 - Tn_c[:, -1]
    depth_c = torch.sum(w_c * t_c, dim=-1)

    t_f = sampling.importance_det(t_c, w_c, cfg.n_fine, u_row=u_row)
    t_all = sampling.merge_sorted_ranks(t_c, t_f)
    dl_all = sampling.deltas_from_t(t_all)
    rgb, w, Tn = pass_body(cfg, net_f, o, d, t_all, dl_all, ped)
    acc = 1.0 - Tn[:, -1]
    depth = torch.sum(w * t_all, dim=-1)
    if ert or m is not None:
        live = acc_c < thr if ert else torch.ones_like(acc_c, dtype=torch.bool)
        if m is not None:
            live = live & (m > 0)
        rgb = torch.where(live[:, None], rgb, rgb_c)
        acc = torch.where(live, acc, acc_c)
        depth = torch.where(live, depth, depth_c)
    return rgb, rgb_c, acc, acc_c, depth


def two_pass_ref(cfg: NerfConfig, packed_c: dict, packed_f: dict, rays_o,
                 rays_d, t_row, u_row, *, rt: int, ert_eps: float,
                 alive: Optional[torch.Tensor] = None,
                 white_bkgd: bool = False):
    """K2's plain version over R rays, ``rt`` rays at a time; with
    ``white_bkgd`` rgb and rgb_coarse composited onto white."""
    net_c, net_f = net_arrays(cfg, packed_c), net_arrays(cfg, packed_f)
    thr = ert_threshold(ert_eps)
    outs = []
    for s, e in _tiles(rays_o.shape[0], rt):
        outs.append(two_pass_tile(
            cfg, net_c, net_f, rays_o[s:e], rays_d[s:e], t_row, u_row, thr,
            ert_eps > 0.0, None if alive is None else alive[s:e]))
    rgb, rgb_c, acc, acc_c, depth = (torch.cat(x) for x in zip(*outs))
    if white_bkgd:
        rgb = volume.white_background(rgb, acc)
        rgb_c = volume.white_background(rgb_c, acc_c)
    return rgb, rgb_c, acc, acc_c, depth


def rmcm_matmul_ref(x: torch.Tensor, packed: dict) -> torch.Tensor:
    """K3's plain version. x (M, K) float; ``packed`` the ``rmcm.pack`` of
    a (K, N) weight. Returns (M, N) in ``x.dtype``."""
    K = packed["k"]
    sg = rmcm.unpack_signs(packed["sign_bits"],
                           packed["sign_bits"].shape[0] * 8)[:K]
    w = packed["mag"].to(torch.float32) * (1.0 - 2.0 * sg.to(torch.float32))
    y = (x.to(torch.float32) @ w) * packed["scale"].reshape(1, -1)
    return y.to(x.dtype)


def split_bf16x3(x: torch.Tensor):
    """f32 -> (h, m, l), bf16 values held in f32: h = bf16(x), m = bf16(x -
    h), l = bf16(x - h - m). h + m + l == x exactly (3 x 8 significant
    bits cover f32's 24)."""
    def bf(v):
        return v.to(torch.bfloat16).to(torch.float32)
    x = x.to(torch.float32)
    h = bf(x)
    m = bf(x - h)
    return h, m, bf(x - h - m)


def ert_threshold(ert_eps: float) -> float:
    """1 - eps rounded to float32: the exact bound both versions compare
    the coarse acc against."""
    return float(torch.tensor(1.0 - ert_eps, dtype=torch.float32))
