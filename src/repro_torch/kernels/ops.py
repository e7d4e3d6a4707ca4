"""Dispatch layer over the port's kernels.

* ``rmcm_matmul`` — y = x @ W for a weight in the 9-bit RMCM storage
  format, leading dims of ``x`` flattened, through K3
  (``kernels.rmcm_matmul``): the deploy-side product of weights kept in
  ``core.rmcm.pack``'s 1.125-byte form.
* ``stack_plcore_weights`` packs one network into the layout both kernels
  read: the trunk stacked (L, P, W) with per-layer row semantics (layer 0:
  PE rows; skip layer: [h | PE] rows; else h rows), color0 row-padded to
  P2, P and P2 128-aligned. With ``quant`` the MONB matrices become uint8
  magnitudes + bit-packed signs + (1, out) scales; sigma and rgb stay f32.
* ``fused_render`` (one sample set, K1) and ``fused_render_two_pass``
  (the whole two-pass render, K2) pick the ray tile and call the kernel
  wrappers. Both kernels and their plain versions handle a ragged last
  tile themselves, so no ray is padded here. K2's ray-independent sample
  grids come from ``sample_rows``, built once per config and device.
* ``pack_count`` and ``dispatch_count`` are plain counters: packs at load
  and kernel dispatches. The fused chain dispatches once per render call,
  the two-dispatch chain twice.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.core import rmcm, sampling
from repro_torch.kernels import fused_plcore as _fp
from repro_torch.kernels import rmcm_matmul as _rm
from repro_torch.kernels.ref import packed_rows

_COUNTS = {"packs": 0, "dispatches": 0}

# rays per tile of the plain (CPU) versions: the tensor-code batch size
PLAIN_TILE = 64
# resident blocks per SM: the kernels' launch bound; at full width one
# block takes ~95 KB of the SM's 227 KB shared memory and <= 128 registers
# per thread, so two fit
BLOCKS_PER_SM = 2
# grid waves to aim for, so the last partial wave is a small share
WAVES = 8


def pack_count() -> int:
    return _COUNTS["packs"]


def dispatch_count() -> int:
    return _COUNTS["dispatches"]


def rmcm_matmul(x: torch.Tensor, packed: dict, *, bm: int = 128,
                bn: int = 128, bk: int = 256) -> torch.Tensor:
    """y = x @ W_rmcm for (..., K) inputs (leading dims flattened).
    ``bm``/``bn``/``bk`` are accepted for parity with the reference and do
    not change the result."""
    lead = x.shape[:-1]
    y = _rm.rmcm_matmul(x.reshape(-1, x.shape[-1]), packed, bm=bm, bn=bn,
                        bk=bk)
    return y.reshape(*lead, y.shape[-1])


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


def _place_rows(src: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad a (k, n) matrix to (rows, n)."""
    out = src.new_zeros((rows,) + tuple(src.shape[1:]))
    out[:src.shape[0]] = src
    return out


def stack_plcore_weights(cfg: NerfConfig, params: dict,
                         quant: Optional[dict] = None) -> dict:
    """One network's params (and optional RMCM quant tree) -> the kernel
    weight layout."""
    _COUNTS["packs"] += 1
    W, L = cfg.trunk_width, cfg.trunk_layers
    P, P2 = packed_rows(cfg)
    f32 = torch.float32
    out = {
        "trunk_b": torch.stack([params["trunk"][f"l{i}"]["b"]
                                for i in range(L)]).to(f32),
        "sigma_w": params["sigma"]["w"].to(f32),
        "sigma_b": params["sigma"]["b"].to(f32),
        "feat_b": params["feat"]["b"].to(f32),
        "color0_b": params["color0"]["b"].to(f32),
        "rgb_w": params["rgb"]["w"].to(f32),
        "rgb_b": params["rgb"]["b"].to(f32),
    }
    if quant is None:
        out["trunk_w"] = torch.stack(
            [_place_rows(params["trunk"][f"l{i}"]["w"].to(f32), P)
             for i in range(L)])
        out["feat_w"] = params["feat"]["w"].to(f32).contiguous()
        out["color0_w"] = _place_rows(params["color0"]["w"].to(f32), P2)
        return out

    def q3(qd, rows):
        return (_place_rows(qd["mag"], rows),
                rmcm.pack_signs(_place_rows(qd["sign"], rows)),
                qd["scale"].to(f32))

    mags, sgns, scls = zip(*(q3(quant["trunk"][f"l{i}"]["w"], P)
                             for i in range(L)))
    out["trunk_mag"] = torch.stack(mags)
    out["trunk_sgn"] = torch.stack(sgns)
    out["trunk_scl"] = torch.stack(scls)
    out["feat_mag"], out["feat_sgn"], out["feat_scl"] = q3(
        quant["feat"]["w"], _rup(W, 8))
    out["color0_mag"], out["color0_sgn"], out["color0_scl"] = q3(
        quant["color0"]["w"], P2)
    return out


def trunk_rows(cfg: NerfConfig, i: int) -> int:
    """Un-padded input rows of trunk layer i in the stacked layout."""
    if i == 0:
        return cfg.pos_enc_dim
    if i in cfg.skip_at:
        return cfg.trunk_width + cfg.pos_enc_dim
    return cfg.trunk_width


def unstack_trunk_params(cfg: NerfConfig, packed: dict):
    """Inverse of ``stack_plcore_weights`` for the trunk: the packed layout
    -> ``(trunk_params, trunk_quant | None)`` holding exactly the stacked
    arrays (row padding and sign packing are lossless). Under RMCM the raw
    f32 trunk weights were never stacked, so layers carry {"b"} only."""
    P, _ = packed_rows(cfg)
    quantized = "trunk_mag" in packed
    params_t: dict = {}
    quant_t: Optional[dict] = {} if quantized else None
    for i in range(cfg.trunk_layers):
        rows = trunk_rows(cfg, i)
        b = packed["trunk_b"][i]
        if quantized:
            sign = rmcm.unpack_signs(packed["trunk_sgn"][i], P)[:rows]
            quant_t[f"l{i}"] = {"w": {"mag": packed["trunk_mag"][i][:rows],
                                      "sign": sign.to(torch.bool),
                                      "scale": packed["trunk_scl"][i]}}
            params_t[f"l{i}"] = {"b": b}
        else:
            params_t[f"l{i}"] = {"w": packed["trunk_w"][i][:rows], "b": b}
    return params_t, quant_t


def pick_ray_tile(n_rays: int, device: torch.device) -> int:
    """Rays per tile. On the card a tile is the rays one block walks, one
    after another: outputs do not depend on it, so it is sized to give
    about ``WAVES`` waves of resident blocks. On the CPU it is the plain
    version's tensor batch."""
    if device.type != "cuda":
        return PLAIN_TILE
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, n_rays // (WAVES * BLOCKS_PER_SM * n_sm))


def fused_render(cfg: NerfConfig, params: Optional[dict], rays_o, rays_d, t,
                 deltas, *, quant: Optional[dict] = None,
                 packed: Optional[dict] = None, alive=None,
                 rt: Optional[int] = None):
    """One sample set through K1: (rgb (R,3), {weights, acc}). ``packed``:
    a pre-built layout (``params``/``quant`` are then ignored); ``alive``:
    optional (R,) mask, dead rays come back as zeros."""
    _COUNTS["dispatches"] += 1
    if packed is None:
        packed = stack_plcore_weights(cfg, params, quant)
    rt = rt or pick_ray_tile(rays_o.shape[0], rays_o.device)
    rgb, w, acc = _fp.fused_plcore_call(
        cfg, packed, rays_o.contiguous(), rays_d.contiguous(),
        t.contiguous(), deltas.contiguous(), rt=rt,
        alive=None if alive is None else alive.to(torch.float32).contiguous())
    return rgb, {"weights": w, "acc": acc}


@functools.lru_cache(maxsize=None)
def _sample_rows(near: float, far: float, n_coarse: int, n_fine: int,
                 device: torch.device):
    t_row = sampling.stratified(near, far, n_coarse, (1,), device=device)
    return t_row.contiguous(), sampling.det_u(n_fine, device)


def sample_rows(cfg: NerfConfig, device) -> tuple:
    """K2's two ray-independent grids, built once per config and device:
    ``t_row`` (1, n_coarse), the coarse bin midpoints, and ``u_row``
    (n_fine,), the deterministic resample grid. Read-only."""
    return _sample_rows(float(cfg.near), float(cfg.far), cfg.n_coarse,
                        cfg.n_fine, torch.device(device))


def fused_render_two_pass(cfg: NerfConfig, packed: dict, rays_o, rays_d, *,
                          ert_eps: float = 0.0, rt: Optional[int] = None,
                          alive=None) -> dict:
    """The whole coarse -> importance -> fine render through K2, one
    launch. ``packed``: {"coarse", "fine"} layouts. Returns {rgb,
    rgb_coarse, acc, acc_coarse, depth}; white background is the caller's
    composite."""
    _COUNTS["dispatches"] += 1
    rt = rt or pick_ray_tile(rays_o.shape[0], rays_o.device)
    t_row, u_row = sample_rows(cfg, rays_o.device)
    rgb, rgb_c, acc, acc_c, depth = _fp.two_pass_plcore_call(
        cfg, packed["coarse"], packed["fine"], rays_o.contiguous(),
        rays_d.contiguous(), t_row, u_row, rt=rt,
        ert_eps=float(ert_eps),
        alive=None if alive is None else alive.to(torch.float32).contiguous())
    return {"rgb": rgb, "rgb_coarse": rgb_c, "acc": acc,
            "acc_coarse": acc_c, "depth": depth}
