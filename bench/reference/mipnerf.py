"""The plain reference of the Mip-NeRF cells: Mip-NeRF's two-level render of
single cones, written from its published code in plain PyTorch and numpy
(Barron et al., arXiv:2103.13415; github.com/google/mip-nerf,
``internal/mip.py``, ``internal/models.py``, ``configs/blender.gin``).

What it computes, per pixel:

* the cone of the pixel centre of a spherical-orbit pose: origin, the
  direction with camera z = -1 (unnormalised) and the base radius
  2 / (sqrt(12) f), the spacing of neighbouring pixels' directions times
  2 / sqrt(12), as mip-NeRF's Blender loader computes it;
* ``n_samples + 1`` coarse edges, near (1 - s) + far s at s = linspace(0,
  1); each interval a conical frustum, its Gaussian by the stable forms of
  ``conical_frustum_to_gaussian`` (mean along the ray, variance along it
  and across it) and ``lift_gaussian`` (the diagonal covariance);
* the integrated positional encoding over degrees [``min_deg_point``,
  ``max_deg_point``): sin(2^l x) exp(-4^l var / 2) for every degree and
  axis, then the cosines; the view direction d / |d| encoded as [x,
  sin(2^l x), cos(2^l x)] over degrees [0, ``deg_view``), sines first;
* ONE MLP for both levels: a ReLU trunk of ``trunk_layers`` x
  ``trunk_width`` with the encoding joined again before each layer of
  ``skip_at`` (hidden state first; mip-NeRF's join after its layer index 4
  is the input of layer 5), a density head, a ``trunk_width`` bottleneck,
  one ReLU layer of ``color_width`` on [bottleneck, viewdir encoding] and
  an RGB head; density softplus(raw + ``density_bias``), colour
  sigmoid(raw) (1 + 2 ``rgb_padding``) - ``rgb_padding``;
* ``volumetric_rendering``: deltas (t1 - t0) |d|, alpha = 1 - exp(-sigma
  delta), weights alpha exp(-exclusive cumsum), a white background;
* the fine level's ``n_samples + 1`` edges from ``resample_along_rays``:
  the coarse weights padded by their end values, neighbour maxima, their
  pairwise means, + ``resample_padding``; ``sorted_piecewise_constant_pdf``
  deterministic, u = linspace(0, 1 - 2^-23, n_samples + 1), each point in
  the interval ``find_interval`` picks (written with the same masks); no
  union with the coarse edges. The image is the fine level's.

Departures from the published code: the engine's camera (focal 0.9 x the
view's side, pixel centres, the orbit's poses); no jitter of the samples
(view serving renders deterministically); the cosines as cos(y), the value
of mip-NeRF's sin(y + pi / 2) without the rounding of the sum, so a float32
render does not lose the phase of its highest degrees there.

``render`` computes in float64 (``precision="f64"``). The lower precisions
round every matrix product's operands first (``"tf32"`` to 10 mantissa
bits, ``"bf16"`` to 7), the products exact and summed in float32;
``"f32"`` is plain float32: the controls, the reference computed a step
below the configuration's float32.

The counts follow from the configuration: model FLOPs per ray are 2 x the
network's weights x 2 ``n_samples`` evaluations (each level runs the one
network on its ``n_samples`` intervals); bytes per launch are each ray's
inputs (origin, direction, radius) and outputs (rgb, coarse rgb, acc,
coarse acc, depth) once and the one network's weights and biases once, 4
bytes each.

The scenes' weights, the benchmark's input, are drawn here (``draw``): one
network per scene, in one ``torch.randn`` call, at the NeRF reference's
gains (sqrt(2 / fan-in) where a ReLU follows, 1 / sqrt(fan-in) elsewhere;
biases N(0, 0.1^2)). The density head's bias is drawn around
``DENSITY_BIAS`` = 1, which offsets the published -1 inside the softplus:
the density softplus(raw) then makes most draws hold opaque matter (the
acc of most rays near 1), few render as an empty, white view. A distinct
draw stands in for a distinct trained scene.

This module imports torch, numpy, the benchmark's ``scenes`` and the NeRF
reference's pose and precision helpers only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import scenes
from bench.reference.nerf import _Maths, pose

PRECISIONS = ("f64", "f32", "tf32", "bf16")
#: sorted_piecewise_constant_pdf's floor, and the grid's end (1 - f32 eps)
PDF_EPS = 1e-5
U_END = 1.0 - 2.0 ** -23
#: the drawn biases' spread, and the density head's mean
BIAS_STD = 0.1
DENSITY_BIAS = 1.0
#: the layers whose weights a ReLU follows
RELU_LAYERS = ("trunk", "color0")
#: a ray's inputs (origin, direction, radius) and outputs (rgb, coarse
#: rgb, acc, coarse acc, depth) in float32
RAY_IN_BYTES = 7 * 4
RAY_OUT_BYTES = 9 * 4


def ipe_dim(cfg: dict) -> int:
    return 6 * (cfg["max_deg_point"] - cfg["min_deg_point"])


def dir_dim(cfg: dict) -> int:
    return 3 + 6 * cfg["deg_view"]


def layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, inputs, outputs) of the network's layers, in order; the trunk
    layers are ``trunk.<i>``."""
    W, C = cfg["trunk_width"], cfg["color_width"]
    pe, de = ipe_dim(cfg), dir_dim(cfg)
    out, din = [], pe
    for i in range(cfg["trunk_layers"]):
        if i in cfg["skip_at"]:
            din = W + pe
        out.append((f"trunk.{i}", din, W))
        din = W
    return out + [("sigma", W, 1), ("feat", W, W), ("color0", W + de, C),
                  ("rgb", C, 3)]


def weight_count(cfg: dict) -> int:
    """Weights of the network, biases left out: its multiply-adds per
    sample evaluation."""
    return sum(i * o for _, i, o in layers(cfg))


def param_count(cfg: dict) -> int:
    """Weights and biases of the network."""
    return sum(i * o + o for _, i, o in layers(cfg))


# ------------------------------------------------------------------ work --
def samples_per_ray(cfg: dict) -> int:
    """Sample evaluations per ray: ``n_samples`` intervals at each level."""
    return 2 * cfg["n_samples"]


def flops_per_ray(cfg: dict) -> int:
    return 2 * weight_count(cfg) * samples_per_ray(cfg)


def weight_bytes(cfg: dict) -> int:
    """The one network's weights and biases, float32, read once a launch."""
    return 4 * param_count(cfg)


def launch_bytes(cfg: dict, rays: int) -> int:
    return rays * (RAY_IN_BYTES + RAY_OUT_BYTES) + weight_bytes(cfg)


# ------------------------------------------------------------------ rays --
def pixel_rays(theta: float, phi: float, radius: float, hw: int,
               pixels: np.ndarray):
    """Cones (origins (n, 3), directions with camera z = -1 (n, 3), base
    radii (n,)), float64, of the pixels ``pixels`` (row-major indices into
    an hw x hw view)."""
    rot, eye = pose(theta, phi, radius)
    row, col = np.divmod(np.asarray(pixels, np.int64), hw)
    f = 0.9 * hw
    cam = np.stack([(col + 0.5 - hw / 2) / f, -(row + 0.5 - hw / 2) / f,
                    -np.ones(len(row))], axis=-1)
    d = cam @ rot.T
    r = np.full(len(row), 2.0 / (math.sqrt(12.0) * f))
    return np.broadcast_to(eye, d.shape).copy(), d, r


# --------------------------------------------------------------- weights --
def draw(cfg: dict, seed: int, scene: int, device) -> dict:
    """The scene's one network, in one ``torch.randn`` call on ``device``:
    {layer name: (w (in, out), b (out,))}."""
    gen = scenes.generator(seed, scene, device)
    z = torch.randn(param_count(cfg), generator=gen, device=device)
    lay, off = {}, 0
    for name, i, o in layers(cfg):
        gain = 2.0 if name.split(".")[0] in RELU_LAYERS else 1.0
        w = z[off:off + i * o].view(i, o) * (gain / i) ** 0.5
        off += i * o
        b = z[off:off + o] * BIAS_STD
        lay[name] = (w, b + DENSITY_BIAS if name == "sigma" else b)
        off += o
    return lay


def served_weights(cfg: dict, net: dict) -> dict:
    """The weights the configuration serves: the drawn float32 network."""
    if cfg["weights"] != "f32":
        raise ValueError(f"Mip-NeRF is served in float32, not "
                         f"{cfg['weights']!r}")
    return net


# ----------------------------------------------------------------- maths --
def _frustum_gaussian(d, t0, t1, base_radius):
    """``conical_frustum_to_gaussian`` (stable) + ``lift_gaussian``
    (diagonal): the means (rays, n, 3) relative to the origin and the
    diagonal covariances (rays, n, 3)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                        / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius[:, None] ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                         - 4 / 15 * (hw ** 4)
                                         / (3 * mu ** 2 + hw ** 2))
    mean = d[:, None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True),
                           min=1e-10)
    d_outer = d ** 2
    null_outer = 1 - d_outer / d_mag_sq
    cov = (t_var[..., None] * d_outer[:, None, :]
           + r_var[..., None] * null_outer[:, None, :])
    return mean, cov


def _ipe(x, x_var, min_deg: int, max_deg: int):
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    shape = x.shape[:-1] + (-1,)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    w = torch.exp(-0.5 * y_var)
    return torch.cat([w * torch.sin(y), w * torch.cos(y)], dim=-1)


def _pos_enc(x, min_deg: int, max_deg: int):
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)


def _mlp(cfg: dict, net: dict, mx: _Maths, enc, view_enc):
    """(rgb (rays, n, 3), density (rays, n)) of the samples whose encodings
    are ``enc`` (rays, n, P); ``view_enc`` (rays, D) each ray's."""
    rays, n, _ = enc.shape
    inputs = enc.reshape(rays * n, -1)
    x = inputs
    for i in range(cfg["trunk_layers"]):
        if i in cfg["skip_at"]:
            x = torch.cat([x, inputs], dim=-1)
        w, b = net[f"trunk.{i}"]
        x = torch.relu(mx.mm(x, w) + b)
    w, b = net["sigma"]
    raw_density = (mx.mm(x, w) + b)[:, 0]
    w, b = net["feat"]
    bottleneck = mx.mm(x, w) + b
    cond = view_enc[:, None, :].expand(rays, n, view_enc.shape[-1])
    x = torch.cat([bottleneck, cond.reshape(rays * n, -1)], dim=-1)
    w, b = net["color0"]
    x = torch.relu(mx.mm(x, w) + b)
    w, b = net["rgb"]
    raw_rgb = mx.mm(x, w) + b
    pad = cfg["rgb_padding"]
    rgb = torch.sigmoid(raw_rgb) * (1 + 2 * pad) - pad
    x = raw_density + cfg["density_bias"]
    density = torch.logaddexp(x, torch.zeros_like(x))     # jax.nn.softplus
    return rgb.reshape(rays, n, 3), density.reshape(rays, n)


def _volumetric_rendering(rgb, density, t_vals, dirs):
    """rgb on white and the weights of ``volumetric_rendering``."""
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1],
                                               dim=-1)], dim=-1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    acc = weights.sum(dim=-1)
    return comp_rgb + (1.0 - acc[..., None]), weights


def _find_interval(mask, x):
    """``find_interval`` of ``sorted_piecewise_constant_pdf``: per point,
    the largest x where u >= cdf and the smallest where u < cdf (the ends
    otherwise). ``mask`` (rays, n_cdf, n_u); x (rays, n_cdf)."""
    x0 = torch.where(mask, x[..., :, None], x[..., :1, None]).amax(dim=-2)
    x1 = torch.where(~mask, x[..., :, None], x[..., -1:, None]).amin(dim=-2)
    return x0, x1


def _resample(cfg: dict, t_vals, weights):
    """``resample_along_rays`` with ``sorted_piecewise_constant_pdf``,
    deterministic: ``n_samples + 1`` new edges."""
    w_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    w_max = torch.maximum(w_pad[..., :-1], w_pad[..., 1:])
    w = 0.5 * (w_max[..., :-1] + w_max[..., 1:]) + cfg["resample_padding"]
    w_sum = w.sum(dim=-1, keepdim=True)
    padding = torch.clamp(PDF_EPS - w_sum, min=0.0)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    pdf = w / w_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)
    n = t_vals.shape[-1]
    u = torch.linspace(0.0, U_END, n, dtype=torch.float64,
                       device=cdf.device).to(cdf.dtype)
    u = u.expand(cdf.shape[0], n)
    mask = u[..., None, :] >= cdf[..., :, None]
    bins_g0, bins_g1 = _find_interval(mask, t_vals)
    cdf_g0, cdf_g1 = _find_interval(mask, cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0),
                                     nan=0.0), 0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def render(cfg: dict, net: Dict[str, tuple], rays_o, rays_d, radii, *,
           precision: str = "f64", block: int = 1024) -> torch.Tensor:
    """White-background RGB (n, 3) of the fine level for the cones (rays
    (n, 3) x 2, radii (n,)), ``block`` at a time, on the device that
    ``net`` lies on. ``net``: {layer name: (w, b)}, as ``served_weights``
    gives it."""
    mx = _Maths(precision)
    dev = next(iter(net.values()))[0].device
    cast = {k: (w.to(dev, mx.dtype), b.to(dev, mx.dtype))
            for k, (w, b) in net.items()}
    o_all = torch.as_tensor(np.asarray(rays_o), dtype=mx.dtype, device=dev)
    d_all = torch.as_tensor(np.asarray(rays_d), dtype=mx.dtype, device=dev)
    r_all = torch.as_tensor(np.asarray(radii), dtype=mx.dtype,
                            device=dev).reshape(-1)
    n = cfg["n_samples"] + 1
    s = torch.linspace(0.0, 1.0, n, dtype=torch.float64,
                       device=dev).to(mx.dtype)
    t_coarse = cfg["near"] * (1.0 - s) + cfg["far"] * s
    out = []
    for at in range(0, o_all.shape[0], block):
        o, d = o_all[at:at + block], d_all[at:at + block]
        r = r_all[at:at + block]
        viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        view_enc = _pos_enc(viewdirs, 0, cfg["deg_view"])
        t_vals = t_coarse.expand(o.shape[0], n)
        for level in range(2):
            if level:
                t_vals = _resample(cfg, t_vals, weights)
            mean, cov = _frustum_gaussian(d, t_vals[..., :-1],
                                          t_vals[..., 1:], r)
            enc = _ipe(mean + o[:, None, :], cov, cfg["min_deg_point"],
                       cfg["max_deg_point"])
            rgb, density = _mlp(cfg, cast, mx, enc, view_enc)
            comp, weights = _volumetric_rendering(rgb, density, t_vals, d)
        out.append(comp)
    return torch.cat(out)
