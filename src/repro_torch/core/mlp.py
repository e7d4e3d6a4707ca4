"""MLP engine — the NeRF MLP and a generic coordinate MLP (paper §4.3),
plain PyTorch.

The NeRF MLP: 8x256 trunk with a skip connection re-injecting the encoded
position at layer 4; density head sigma (1), a 256-d feature, then a
128-wide view-dependent color branch. The hidden (MONB) matmuls may read
RMCM weights (``quant``); the sigma and rgb heads (SONB) stay exact f32.

``mlp_decls`` / ``mlp_apply``: the generic coordinate MLP (ReLU between
layers, an optional final activation) that the SDF and SLF workloads use;
each layer's matmul may read RMCM weights. ``pack_quant`` packs a generic
MLP's quant tree once at load (``rmcm.pack`` per layer: signs 8 per byte
along K); ``mlp_apply`` sends a packed layer on the card through K3
(``kernels.ops.rmcm_matmul``) and on the CPU through the plain product of
the unpacked weight, the reference's ``rmcm_matmul_ref``. The NeRF MLP
keeps the plain product: it is the in-package oracle of K1 and K2.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import rmcm
from repro_torch.models.params import Decl


def _linear(din: int, dout: int) -> dict:
    return {"w": Decl((din, dout), (None, None)),
            "b": Decl((dout,), (None,), init="zeros")}


def nerf_mlp_decls(cfg: NerfConfig) -> dict:
    W = cfg.trunk_width
    pe, de = cfg.pos_enc_dim, cfg.dir_enc_dim
    trunk = {}
    din = pe
    for i in range(cfg.trunk_layers):
        if i in cfg.skip_at:
            din = W + pe
        trunk[f"l{i}"] = _linear(din, W)
        din = W
    return {
        "trunk": trunk,
        "sigma": _linear(W, 1),            # SONB: density head
        "feat": _linear(W, W),             # bottleneck feature
        "color0": _linear(W + de, cfg.color_width),
        "rgb": _linear(cfg.color_width, 3),  # SONB: color head
    }


def _matmul(x, layer, quant_layer):
    """One linear. quant_layer: RMCM dict for w (MONB path) or None."""
    if quant_layer is not None:
        y = rmcm.rmcm_matmul_ref(x, quant_layer["w"])
    else:
        y = x @ layer["w"]
    return y + layer["b"]


def _slice_q(qw, lo, hi):
    """Row-slice an RMCM weight dict (scale is per output column)."""
    return {"mag": qw["mag"][lo:hi], "sign": qw["sign"][lo:hi],
            "scale": qw["scale"]}


def _matmul_split(parts, layer, quant_layer):
    """y = sum_i x_i @ W[rows_i] + b: the concat matmul without building the
    concat buffer; a broadcasting part such as a per-ray (R,1,de) direction
    encoding stays un-broadcast."""
    lo = 0
    y = None
    for x in parts:
        hi = lo + x.shape[-1]
        if quant_layer is not None:
            t = rmcm.rmcm_matmul_ref(x, _slice_q(quant_layer["w"], lo, hi))
        else:
            t = x @ layer["w"][lo:hi]
        y = t if y is None else y + t
        lo = hi
    return y + layer["b"]


def nerf_trunk_apply(cfg: NerfConfig, params: dict, pe_pos,
                     quant: Optional[dict] = None):
    """(pe_pos (..., pos_enc_dim)) -> (sigma_raw (...,), feat (..., W))."""
    qt = (quant or {}).get("trunk", {})
    h = pe_pos
    for i in range(cfg.trunk_layers):
        if i in cfg.skip_at:
            h = torch.relu(_matmul_split([h, pe_pos], params["trunk"][f"l{i}"],
                                         qt.get(f"l{i}")))
        else:
            h = torch.relu(_matmul(h, params["trunk"][f"l{i}"],
                                   qt.get(f"l{i}")))
    sigma = _matmul(h, params["sigma"], None)[..., 0]        # SONB (exact)
    feat = _matmul(h, params["feat"], (quant or {}).get("feat"))
    return sigma, feat


def nerf_color_apply(cfg: NerfConfig, params: dict, feat, pe_dir,
                     quant: Optional[dict] = None):
    """View-dependent color branch: (feat (..., W), pe_dir) -> rgb in [0,1]."""
    x = _matmul_split([feat, pe_dir], params["color0"],
                      (quant or {}).get("color0"))
    hc = torch.relu(x)
    return torch.sigmoid(_matmul(hc, params["rgb"], None))   # SONB (exact)


def nerf_mlp_apply(cfg: NerfConfig, params: dict, pe_pos, pe_dir,
                   quant: Optional[dict] = None):
    """(pe_pos (..., pos_enc_dim), pe_dir (..., de) or per-ray (R,1,de))
    -> (sigma_raw (...,), rgb (..., 3))."""
    sigma, feat = nerf_trunk_apply(cfg, params, pe_pos, quant)
    return sigma, nerf_color_apply(cfg, params, feat, pe_dir, quant)


# ----------------------------------------------------- generic coordinate MLP
def pack_quant(quant: dict) -> dict:
    """A generic MLP's RMCM quant tree (``rmcm.quantize_tree`` of its
    params) -> the same tree with every layer's weight in ``rmcm.pack``'s
    storage form (uint8 magnitudes, signs 8 per byte along K, per-column
    scales): the load-time pack of the K3 route, done once."""
    return {name: {**layer, "w": rmcm.pack(layer["w"])}
            for name, layer in quant.items()}


def _mlp_matmul(x, layer, quant_layer):
    """One linear of the generic MLP. A packed RMCM weight runs through
    K3 on the card and through the plain product of its unpacked weight on
    the CPU; an unpacked one takes the plain product everywhere."""
    qw = None if quant_layer is None else quant_layer["w"]
    if qw is None or "sign_bits" not in qw:
        return _matmul(x, layer, quant_layer)
    if x.device.type == "cuda":
        from repro_torch.kernels import ops
        y = ops.rmcm_matmul(x, qw)
    else:
        y = rmcm.rmcm_matmul_ref(x, rmcm.unpack(qw))
    return y + layer["b"]


def mlp_decls(in_dim: int, widths: Sequence[int], out_dim: int) -> dict:
    dims = [in_dim, *widths, out_dim]
    return {f"l{i}": _linear(dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def mlp_apply(params: dict, x, quant: Optional[dict] = None,
              final_activation=None):
    """x (..., in_dim) -> (..., out_dim): every layer a linear (RMCM where
    ``quant`` has the layer; a ``pack_quant`` layer through K3 on the
    card), ReLU between them, ``final_activation`` (a callable) after the
    last."""
    n = len(params)
    for i in range(n):
        x = _mlp_matmul(x, params[f"l{i}"], (quant or {}).get(f"l{i}"))
        if i < n - 1:
            x = torch.relu(x)
    return final_activation(x) if final_activation else x
