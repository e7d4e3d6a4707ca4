"""The plain reference of the NeRF cells: a two-pass NeRF render of single
rays, written from the model's equations in plain PyTorch.

What it computes, per ray (NeRF, arXiv:2003.08934, as the ICARUS PLCore
pipeline runs it, arXiv:2203.01414):

* the camera ray of one pixel of a spherical-orbit pose (the pixel centre,
  focal length 0.9 x the view's side, the camera looking at the origin);
* PEU: gamma(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x),
  cos(2^(L-1) x)], each octave's three sines before its three cosines,
  L = ``pos_freqs`` for the sample position, ``dir_freqs`` for the unit
  direction;
* the NeRF MLP: a ReLU trunk of ``trunk_layers`` x ``trunk_width`` with the
  encoded position joined again before each layer of ``skip_at`` (hidden
  state first), a density head on the last hidden state, a feature layer,
  a ReLU colour layer of ``color_width`` on [feature, encoded direction]
  and a sigmoid RGB head;
* the coarse pass at the ``n_coarse`` bin midpoints of [near, far];
* the importance resample: ``n_fine`` positions by inverse CDF over the
  interior coarse weights (+1e-5), at the fixed grid u_k = k (1 - 1e-6) /
  (n_fine - 1), with the coarse positions as the bin edges;
* the fine pass over the sorted union of both sets, and the VRU:
  w_i = T_i (1 - exp(-max(sigma_i, 0) delta_i)), the last delta 1e10,
  rgb = sum w_i c_i + (1 - sum w_i) (a white background).

Two departures from the NeRF paper, both the repository's own definition
of the pipeline: the resample's bin edges are the coarse positions
themselves, not the midpoints between them, and the positions are not
jittered (view serving renders deterministically).

With the RMCM weight format the matrices of the trunk, the feature layer
and the colour layer are quantized here from the same float32 weights, by
this module's own copy of the rule (paper section 4.3): a per-column scale
absmax / 255, 8-bit magnitudes whose two nibbles snap to {0} + {o << s : o
odd < 8} (9, 11, 13, 15 round down), and a sign. The two heads stay exact.

``render`` computes in float64 (``precision="f64"``). The lower precisions
round every matrix product's operands first: ``"tf32"`` to 10 mantissa
bits, ``"bf16"`` to 7, the products then exact and summed in float32;
``"f32"`` is plain float32. Those are the controls: the reference computed
a step below the precision the configuration states.

The counts of the work (``flops_per_ray``, ``samples_per_ray``,
``launch_bytes``) follow from the configuration alone, whatever kernel
does the work: model FLOPs per ray are 2 x (one network's weights) x
(sample evaluations: ``n_coarse`` by the coarse network, ``n_coarse +
n_fine`` by the fine one); biases, encodings, the resample and the VRU are
left out, and so are the padding and any product an implementation
splits or repeats. Bytes per launch: each ray's inputs (origin,
direction) and outputs (rgb, coarse rgb, acc, coarse acc, depth) once,
and the launch's weights once: 4 bytes per float32 weight, 2 per RMCM
weight (the two exact heads and the biases at 4).

The scenes' weights, the benchmark's input, are drawn here (``draw``):
every weight matrix is normal with standard deviation sqrt(2 / fan-in)
where a ReLU follows it (the trunk, the colour layer) and 1 / sqrt(fan-in)
elsewhere; every bias is normal with standard deviation ``BIAS_STD``
around 0, the density head's around ``DENSITY_BIAS``, so that most draws
hold opaque matter and few render as an empty, white view. A distinct
draw stands in for a distinct trained scene.

This module imports torch, numpy and the benchmark's ``scenes`` only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import scenes

#: the resample's CDF floor and grid end, and the last sample's delta
PDF_EPS = 1e-5
U_END = 1.0 - 1e-6
FAR_DELTA = 1e10
#: the layers that the RMCM format quantizes (the heads stay exact)
RMCM_LAYERS = ("trunk", "feat", "color0")
_NIBBLE = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 10, 10, 12, 12, 14, 14])

PRECISIONS = ("f64", "f32", "tf32", "bf16")
#: the drawn biases' spread, and the density head's mean
BIAS_STD = 0.1
DENSITY_BIAS = 1.0
#: the layers whose weights a ReLU follows
RELU_LAYERS = ("trunk", "color0")
#: a ray's inputs (origin, direction) and outputs (rgb, coarse rgb, acc,
#: coarse acc, depth) in float32
RAY_IN_BYTES = 6 * 4
RAY_OUT_BYTES = 9 * 4


def layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, inputs, outputs) of one network's layers, in order; the trunk
    layers are ``trunk.<i>``."""
    W, C = cfg["trunk_width"], cfg["color_width"]
    pe, de = enc_dim(cfg["pos_freqs"]), enc_dim(cfg["dir_freqs"])
    out, din = [], pe
    for i in range(cfg["trunk_layers"]):
        if i in cfg["skip_at"]:
            din = W + pe
        out.append((f"trunk.{i}", din, W))
        din = W
    return out + [("sigma", W, 1), ("feat", W, W), ("color0", W + de, C),
                  ("rgb", C, 3)]


def enc_dim(n_freqs: int) -> int:
    return 3 + 6 * n_freqs


def weight_count(cfg: dict) -> int:
    """Weights of one network, biases left out: its multiply-adds per
    sample evaluation."""
    return sum(i * o for _, i, o in layers(cfg))


def param_count(cfg: dict) -> int:
    """Weights and biases of one network."""
    return sum(i * o + o for _, i, o in layers(cfg))


# ------------------------------------------------------------------ work --
def samples_per_ray(cfg: dict) -> int:
    """Sample evaluations per ray: the coarse set by the coarse network,
    then the coarse and fine sets by the fine one (``serve`` counts energy
    per sample so)."""
    return 2 * cfg["n_coarse"] + cfg["n_fine"]


def flops_per_ray(cfg: dict) -> int:
    return 2 * weight_count(cfg) * samples_per_ray(cfg)


def weight_bytes(cfg: dict) -> int:
    """Both networks' weights and biases as one launch reads them once."""
    total = 0
    for name, i, o in layers(cfg):
        quantized = (cfg["weights"] == "rmcm"
                     and name.split(".")[0] in RMCM_LAYERS)
        total += i * o * (2 if quantized else 4) + 4 * o
    return 2 * total


def launch_bytes(cfg: dict, rays: int) -> int:
    return rays * (RAY_IN_BYTES + RAY_OUT_BYTES) + weight_bytes(cfg)


# ------------------------------------------------------------------ rays --
def pose(theta_deg: float, phi_deg: float, radius: float):
    """(rotation (3, 3), origin (3,)) of a camera on a sphere looking at the
    origin, in float64: its columns are right, up and backward."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    eye = np.array([radius * math.cos(ph) * math.sin(th),
                    radius * math.sin(ph),
                    radius * math.cos(ph) * math.cos(th)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= max(np.linalg.norm(right), 1e-8)
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd], axis=1), eye


def pixel_rays(theta: float, phi: float, radius: float, hw: int,
               pixels: np.ndarray):
    """Rays (origins, unit directions), each (n, 3) float64, of the pixels
    ``pixels`` (row-major indices into an hw x hw view)."""
    rot, eye = pose(theta, phi, radius)
    row, col = np.divmod(np.asarray(pixels, np.int64), hw)
    f = 0.9 * hw
    cam = np.stack([(col + 0.5 - hw / 2) / f, -(row + 0.5 - hw / 2) / f,
                    -np.ones(len(row))], axis=-1)
    d = cam @ rot.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(eye, d.shape).copy(), d


# --------------------------------------------------------------- weights --
def draw(cfg: dict, seed: int, scene: int, device) -> dict:
    """The scene's networks, in one ``torch.randn`` call on ``device``:
    {"coarse", "fine"} -> {layer name: (w (in, out), b (out,))}."""
    gen = scenes.generator(seed, scene, device)
    z = torch.randn(2 * param_count(cfg), generator=gen, device=device)
    nets, off = {}, 0
    for net in ("coarse", "fine"):
        lay = {}
        for name, i, o in layers(cfg):
            gain = 2.0 if name.split(".")[0] in RELU_LAYERS else 1.0
            w = z[off:off + i * o].view(i, o) * (gain / i) ** 0.5
            off += i * o
            b = z[off:off + o] * BIAS_STD
            lay[name] = (w, b + DENSITY_BIAS if name == "sigma" else b)
            off += o
        nets[net] = lay
    return nets


def rmcm_dequantize(w: torch.Tensor) -> torch.Tensor:
    """The RMCM value of each float32 weight of a (K, N) matrix, float32."""
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 255.0), min=1e-20)
    m = torch.clamp(torch.round(w.abs() / scale), 0, 255).to(torch.int64)
    nib = _NIBBLE.to(w.device)
    mag = (nib[(m >> 4) & 15] << 4) | nib[m & 15]
    return torch.where(w < 0, -1.0, 1.0) * mag.to(torch.float32) * scale


def served_weights(cfg: dict, nets: Dict[str, dict]) -> Dict[str, dict]:
    """The weights the configuration serves: ``nets`` as drawn (float32),
    or, for the RMCM format, with its quantized layers dequantized."""
    if cfg["weights"] == "f32":
        return nets
    if cfg["weights"] != "rmcm":
        raise ValueError(f"unknown weight format {cfg['weights']!r}")
    out = {}
    for net, lay in nets.items():
        out[net] = {name: ((rmcm_dequantize(w), b)
                           if name.split(".")[0] in RMCM_LAYERS else (w, b))
                    for name, (w, b) in lay.items()}
    return out


# ----------------------------------------------------------------- maths --
def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to ``bits`` explicit mantissa bits, to the
    nearest, ties away from zero (the conversion to TF32 rounds so)."""
    i = x.contiguous().view(torch.int32)
    drop = 23 - bits
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


class _Maths:
    """The precision of one render: the dtype of its values and what a
    matrix product does to its operands."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.bits = {"tf32": 10, "bf16": 7}.get(precision)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.bits is not None:
            x, w = _round_mantissa(x, self.bits), _round_mantissa(w, self.bits)
        return x @ w


def _encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    feats = [x]
    for k in range(n_freqs):
        xk = x * (2.0 ** k)
        feats += [torch.sin(xk), torch.cos(xk)]
    return torch.cat(feats, dim=-1)


def _mlp(cfg: dict, net: dict, mx: _Maths, pe: torch.Tensor,
         ped: torch.Tensor):
    """Raw density (rays, n) and colour (rays, n, 3) of the samples whose
    encoded positions are ``pe`` (rays, n, P); ``ped`` (rays, D) is each
    ray's encoded direction."""
    rays, n, _ = pe.shape
    pe = pe.reshape(rays * n, -1)
    h = pe
    for i in range(cfg["trunk_layers"]):
        w, b = net[f"trunk.{i}"]
        x = torch.cat([h, pe], dim=-1) if i in cfg["skip_at"] else h
        h = torch.relu(mx.mm(x, w) + b)
    w, b = net["sigma"]
    sigma = (mx.mm(h, w) + b)[:, 0]
    w, b = net["feat"]
    feat = mx.mm(h, w) + b
    ped = ped[:, None, :].expand(rays, n, ped.shape[-1]).reshape(rays * n, -1)
    w, b = net["color0"]
    hc = torch.relu(mx.mm(torch.cat([feat, ped], dim=-1), w) + b)
    w, b = net["rgb"]
    rgb = torch.sigmoid(mx.mm(hc, w) + b)
    return sigma.reshape(rays, n), rgb.reshape(rays, n, 3)


def _composite(sigma, rgb, t):
    delta = torch.cat([t[:, 1:] - t[:, :-1],
                       torch.full_like(t[:, :1], FAR_DELTA)], dim=-1)
    alpha = 1.0 - torch.exp(-torch.clamp(sigma, min=0.0) * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha[:, :-1]], dim=-1), dim=-1)
    w = trans * alpha
    return (w[..., None] * rgb).sum(dim=1), w


def _resample(t_c, w_c, n_fine: int):
    """``n_fine`` positions by inverse CDF over the interior coarse
    weights, the coarse positions as bin edges."""
    pdf = w_c[:, 1:-1] + PDF_EPS
    pdf = pdf / pdf.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    dim=-1)
    u = torch.arange(n_fine, dtype=t_c.dtype, device=t_c.device)
    u = (u * (U_END / max(n_fine - 1, 1))).expand(t_c.shape[0], n_fine)
    last = cdf.shape[-1] - 2
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                         right=True) - 1, 0, last)
    c0, c1 = cdf.gather(1, idx), cdf.gather(1, idx + 1)
    t0, t1 = t_c.gather(1, idx), t_c.gather(1, idx + 1)
    span = torch.where(c1 - c0 < 1e-8, torch.ones_like(c0), c1 - c0)
    return t0 + (u - c0) / span * (t1 - t0)


def render(cfg: dict, nets: Dict[str, dict], rays_o, rays_d, *,
           precision: str = "f64", block: int = 1024) -> torch.Tensor:
    """White-background RGB (n, 3) of the rays (n, 3) each, ``block`` rays
    at a time, on the device that ``nets`` lies on. ``nets``: {"coarse",
    "fine"} -> {layer name: (w, b)}, as ``served_weights`` gives them."""
    mx = _Maths(precision)
    dev = next(iter(nets["coarse"].values()))[0].device
    cast = {net: {k: (w.to(dev, mx.dtype), b.to(dev, mx.dtype))
                  for k, (w, b) in lay.items()} for net, lay in nets.items()}
    o_all = torch.as_tensor(np.asarray(rays_o), dtype=mx.dtype, device=dev)
    d_all = torch.as_tensor(np.asarray(rays_d), dtype=mx.dtype, device=dev)
    nc, nf = cfg["n_coarse"], cfg["n_fine"]
    near, far = cfg["near"], cfg["far"]
    mids = (torch.arange(nc, dtype=mx.dtype, device=dev) + 0.5) / nc
    out = []
    for s in range(0, o_all.shape[0], block):
        o, d = o_all[s:s + block], d_all[s:s + block]
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        ped = _encode(d, cfg["dir_freqs"])
        t_c = (near + (far - near) * mids).expand(o.shape[0], nc)

        def shade(net, t):
            pts = o[:, None, :] + t[..., None] * d[:, None, :]
            sigma, rgb = _mlp(cfg, cast[net], mx, _encode(pts,
                                                         cfg["pos_freqs"]),
                              ped)
            return _composite(sigma, rgb, t)

        _, w_c = shade("coarse", t_c)
        t_f = _resample(t_c, w_c, nf)
        t_all = torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
        rgb, w = shade("fine", t_all)
        out.append(rgb + (1.0 - w.sum(dim=-1, keepdim=True)))
    return torch.cat(out)
