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
* ``mip_two_pass_ref`` — K2's Mip-NeRF instance: both levels through one
  network, the integrated encoding of each frustum, the blurred resample
  (``sampling.mip_resample``), softplus density and padded sigmoid, the
  VRU over finite deltas (t1 - t0) |d|. Its ``mm`` takes the products
  that K2 forms on the tensor cores; ``tf32x3_matmul`` is that arithmetic
  as the full-width instance forms it.
* ``rmcm_matmul_ref`` — K3: the RMCM dequant-fused matmul, in the
  kernel's order (f32 product with the signed magnitudes, then the
  per-column scale, then the cast to ``x.dtype``).
* ``split_bf16x3`` — the kernels' split of an f32 operand into three bf16
  pieces (``csrc/mma_split.cuh``), each rounded to nearest even.
* ``tf32x3_matmul`` — an f32 product as 3xTF32 MMAs form it
  (``csrc/mma_split.cuh``): split operands, k steps of 8, each MMA's sum
  rounded toward zero (the tensor cores' f32 additions truncate) or to
  nearest.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import rmcm, sampling, volume
from repro_torch.core.encoding import (frustum_rows, integrated_pos_enc,
                                       lift_gaussian, mip_dir_encoding,
                                       nerf_encoding,
                                       nerf_encoding_double_angle)
from repro_torch.core.mlp import nerf_mlp_apply, softplus


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


def mip_pass_body(cfg, net, o, d, r, t_edges, ped, norm, mm=torch.matmul):
    """One Mip-NeRF level over (rt, N) intervals with edges ``t_edges``
    (rt, N + 1) (or a shared (1, N + 1) row): the IPE of each frustum's
    Gaussian, the MLP with mip-NeRF's heads, the VRU in K2's closed form
    over the deltas (t1 - t0) ``norm``. ``mm`` forms the products K2 forms
    on the tensor cores (the trunk, the skip layer's [h, encoding] in one
    sum, the bottleneck, the colour layer's bottleneck part). Returns (rgb
    (rt, 3), w (rt, N), T_next (rt, N), sum(w t_mid) (rt,))."""
    tw, tb, sw, sb, fw, fb, cw, cb, rw, rb = net
    W, de_dim = cfg.trunk_width, cfg.dir_enc_dim
    t0, t1 = t_edges[..., :-1], t_edges[..., 1:]
    rt, N = o.shape[0], t0.shape[-1]
    x, var = lift_gaussian(o, d, r, *frustum_rows(t0, t1))
    pe = integrated_pos_enc(x, var, cfg.min_deg_point,
                            cfg.max_deg_point).reshape(rt * N, -1)
    pe_dim = pe.shape[-1]
    h = pe
    for i in range(cfg.trunk_layers):
        if i == 0:
            h = torch.relu(mm(pe, tw[i][:pe_dim]) + tb[i])
        elif i in cfg.skip_at:
            h = torch.relu(mm(torch.cat([h, pe], dim=-1),
                              tw[i][:W + pe_dim]) + tb[i])
        else:
            h = torch.relu(mm(h, tw[i][:W]) + tb[i])
    sigma = softplus(((h @ sw)[:, 0] + sb[0]) + cfg.density_bias)
    feat = mm(h, fw) + fb
    C = cw.shape[-1]
    cold = ped @ cw[W:W + de_dim]
    hc = torch.relu((mm(feat, cw[:W]).reshape(rt, N, C)
                     + cold[:, None, :]).reshape(rt * N, C) + cb)
    rgb = (torch.sigmoid(hc @ rw + rb) * (1.0 + 2.0 * cfg.rgb_padding)
           - cfg.rgb_padding).reshape(rt, N, 3)
    dl = (t1 - t0) * norm[:, None]
    x_t = -sigma.reshape(rt, N) * dl
    T_next = torch.exp(torch.cumsum(x_t, dim=-1))
    T_i = torch.cat([torch.ones_like(T_next[:, :1]), T_next[:, :-1]], dim=-1)
    w = T_i - T_next
    mids = (t0 + t1) * 0.5
    return (torch.sum(w[..., None] * rgb, dim=1), w, T_next,
            torch.sum(w * mids, dim=-1))


def mip_two_pass_tile(cfg, net, rays, t_row, u_row, mm=torch.matmul):
    """K2's Mip-NeRF tile body for rt rays (rt, 7): the coarse level over
    the shared edges ``t_row`` (N + 1,), the blurred resample at ``u_row``,
    the fine level through the same network (``mm``: as
    ``mip_pass_body``'s). Returns (rgb, rgb_coarse, acc, acc_coarse,
    depth); depth is sum(w t_mid) / acc clipped to the fine edges."""
    o, d, r = rays[:, :3], rays[:, 3:6], rays[:, 6]
    d2 = d * d
    ss = (d2[:, 0] + d2[:, 1]) + d2[:, 2]
    # the unit direction by rsqrt, as the kernels' PEU takes it
    ped = mip_dir_encoding(d * torch.rsqrt(ss)[:, None], cfg.deg_view)
    norm = torch.sqrt(ss)
    t_c = t_row[None, :]
    rgb_c, w_c, Tn_c, _ = mip_pass_body(cfg, net, o, d, r, t_c, ped, norm,
                                        mm)
    t_f = sampling.mip_resample(t_c.expand(o.shape[0], -1), w_c,
                                cfg.resample_padding, u_row=u_row)
    rgb, _, Tn, dep = mip_pass_body(cfg, net, o, d, r, t_f, ped, norm, mm)
    acc = 1.0 - Tn[:, -1]
    dist = torch.nan_to_num(dep / acc, nan=float("inf"))
    depth = torch.minimum(torch.maximum(dist, t_f[:, 0]), t_f[:, -1])
    return rgb, rgb_c, acc, 1.0 - Tn_c[:, -1], depth


def mip_two_pass_ref(cfg, packed: dict, rays, t_row, u_row, *, rt: int,
                     white_bkgd: bool = False, mm=torch.matmul):
    """K2's Mip-NeRF instance's plain version over R rays (R, 7), ``rt``
    rays at a time; with ``white_bkgd`` both rgb outputs composited onto
    white. ``mm``: the tensor-core products' arithmetic (the plain f32
    product, or ``tf32x3_matmul``'s)."""
    net = net_arrays(cfg, packed)
    outs = [mip_two_pass_tile(cfg, net, rays[s:e], t_row, u_row, mm)
            for s, e in _tiles(rays.shape[0], rt)]
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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 fraction bits) held in f32, rounded to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _to_f32(s: torch.Tensor, truncate: bool) -> torch.Tensor:
    y = s.to(torch.float32)
    if truncate:
        over = y.to(s.dtype).abs() > s.abs()
        y = torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)
    return y


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  truncate: bool = True) -> torch.Tensor:
    """a (M, K) @ b (K, N) in f32 as K2's full-width 3xTF32 MMAs form it
    (``mma_segment`` at W = 256): each operand split into hi = tf32(x) and
    lo = tf32(x - hi); per k step of 8, three MMAs (a_lo b_hi, a_hi b_lo,
    a_hi b_hi, in that order) each add their 8 products to the f32
    accumulator in one sum. That sum is taken exactly (float64) and
    rounded once to f32: toward zero with ``truncate`` (the tensor cores'
    additions), else to nearest. Slow: a model of the arithmetic for
    small shapes, not a kernel."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k in range(0, a.shape[1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            s = acc.double() + x[:, k:k + 8].double() @ y[k:k + 8].double()
            acc = _to_f32(s, truncate)
    return acc


def ert_threshold(ert_eps: float) -> float:
    """1 - eps rounded to float32: the exact bound both versions compare
    the coarse acc against."""
    return float(torch.tensor(1.0 - ert_eps, dtype=torch.float32))
