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
  It equals the reference's layout key for key and bit for bit.
* ``kernel_weights`` is that layout plus ``mma_stream``: the copy of the
  MLP matrices that the kernels' tensor cores read, built once at pack
  time beside the reference layout: one flat stream in reading order, PE
  rows K-padded with zeros to a multiple of 16, in wgmma's K-major layout:
  bf16 signed magnitudes under RMCM (exact), TF32 hi/lo pairs
  (``tf32_split``) for f32 weights.
* ``fused_render`` (one sample set, K1) and ``fused_render_two_pass``
  (the whole two-pass render, K2) pick the ray tile (from the kernel's
  resident blocks per SM on the card) and call the kernel wrappers. Both
  kernels and their plain versions handle a ragged last
  tile themselves, so no ray is padded here. K2's ray-independent sample
  grids come from ``sample_rows``, built once per config and device.
* ``fused_render_mip`` — Mip-NeRF's two levels through K2's Mip-NeRF
  instance, its grids from ``mip_sample_rows``; one network packs with
  ``kernel_weights`` as a NeRF network does.
* ``plcore_resident_weight_bytes``: one network's per-cell bytes of that
  layout when its trunk is layer-sharded over a cell list.
* ``pack_count`` and ``dispatch_count`` read two counters of the
  process-wide metrics registry (``obs.metrics.global_registry``, so the
  exporters see them): packs at load and kernel dispatches. The fused
  chain dispatches once per render call, the two-dispatch chain twice.
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
from repro_torch.obs.metrics import global_registry

_PACKS = global_registry().counter(
    "plcore_weight_packs_total", "stack_plcore_weights invocations")
_DISPATCHES = global_registry().counter(
    "plcore_kernel_dispatches_total", "fused PLCore render dispatches")

# rays per tile of the plain (CPU) versions: the tensor-code batch size
PLAIN_TILE = 64
# grid waves to aim for, so the last partial wave is a small share
WAVES = 8


def pack_count() -> int:
    return int(_PACKS.value)


def dispatch_count() -> int:
    return int(_DISPATCHES.value)


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
    _PACKS.inc()
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


def tf32_split(w: torch.Tensor):
    """f32 -> (hi, lo), both TF32 values (the low 13 mantissa bits clear),
    each rounded to nearest with ties away from zero as
    ``cvt.rna.tf32.f32`` does: hi = tf32(w), lo = tf32(w - hi), so
    |w - hi - lo| <= 2^-22 |w|."""
    def rna(v):
        b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = (b + 0x1000) & 0xFFFFE000
        b = torch.where(b >= 1 << 31, b - (1 << 32), b)
        return b.to(torch.int32).view(torch.float32)
    hi = rna(w.to(torch.float32))
    return hi, rna(w - hi)


def _steps_bf16(m: torch.Tensor) -> torch.Tensor:
    """(Kp, N) -> flat, per k step of 16 rows and 8-column group the two
    K-major core matrices of wgmma: [k step][N / 8][K half][column][8 k]."""
    Kp, N = m.shape
    v = m.reshape(Kp // 16, 2, 8, N // 8, 8)           # kb, half, e, ng, r
    return v.permute(0, 3, 1, 4, 2).reshape(-1)


def _steps_tf32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(Kp, N) twice -> flat, per k step of 8 rows the hi block then the lo
    block, each [N / 8][K half][column][4 k]."""
    Kp, N = hi.shape
    v = torch.stack([hi, lo]).reshape(2, Kp // 8, 2, 4, N // 8, 8)
    return v.permute(1, 0, 4, 2, 5, 3).reshape(-1)


def _unsteps(flat: torch.Tensor, rows: int, ncols: int):
    """Inverse of ``_steps_bf16`` (a bf16 segment -> its (rows, N) matrix)
    and of ``_steps_tf32`` (an f32 segment -> (hi, lo))."""
    if flat.dtype == torch.bfloat16:
        v = flat.reshape(rows // 16, ncols // 8, 2, 8, 8)  # kb, ng, half, r, e
        return v.permute(0, 2, 4, 1, 3).reshape(rows, ncols)
    v = flat.reshape(rows // 8, 2, ncols // 8, 2, 8, 4)     # kb, which, ng, half, r, e
    hi, lo = v.permute(1, 0, 3, 5, 2, 4).reshape(2, rows, ncols)
    return hi, lo


def mma_matrix(cfg: NerfConfig, stream: torch.Tensor, key: str,
               layer: Optional[int] = None):
    """Inverse of ``mma_stream`` for one matrix: trunk layer ``layer``
    (``key`` "trunk") as (KH + KPE, W), its h rows first, absent segments
    zero; "feat" (W, W); "color0" its W feature rows (W, C). A bf16 stream
    gives the matrix, an f32 stream (hi, lo)."""
    KH, KPE = _fp.mma_rows(cfg)
    W = cfg.trunk_width
    name = key if layer is None else f"trunk{layer}"
    parts = {}
    for (seg, rows, ncols), (lo, hi) in zip(_fp.mma_segments(cfg),
                                            _fp.mma_offsets(cfg, stream.dtype
                                                            == torch.bfloat16)):
        base, _, kind = seg.partition(".")
        if base == name:
            parts[kind] = _unsteps(stream[lo:hi], rows, ncols)
    if layer is None:
        return parts[""]

    def assemble(pick):
        m = torch.zeros(KH + KPE, W, dtype=torch.float32)
        if "h" in parts:
            m[:KH] = pick(parts["h"]).float()
        if "pe" in parts:
            m[KH:] = pick(parts["pe"]).float()
        return m
    if stream.dtype == torch.bfloat16:
        return assemble(lambda p: p).to(torch.bfloat16)
    return assemble(lambda p: p[0]), assemble(lambda p: p[1])


def mma_stream(cfg: NerfConfig, packed: dict) -> torch.Tensor:
    """The tensor-core copy of one network's MLP matrices, from its
    ``stack_plcore_weights`` layout: one flat stream in the order the
    kernels read it (``fused_plcore.mma_segments``: trunk layer 0's PE
    rows, each later layer's h rows and a skip layer's PE rows, the feature
    head, color0's W feature rows), PE rows zero-padded to a multiple of
    16, each segment in wgmma's K-major layout: bf16 signed magnitudes under
    RMCM (exact), TF32 hi/lo (``tf32_split``) for f32 weights."""
    W, pe = cfg.trunk_width, cfg.pos_enc_dim
    quantized = "trunk_mag" in packed

    def dense(key, i=None):
        """One matrix of the layout, f32 or signed magnitudes."""
        sel = (lambda t: t) if i is None else (lambda t: t[i])
        if not quantized:
            return sel(packed[f"{key}_w"])
        sgn = sel(packed[f"{key}_sgn"])
        sg = rmcm.unpack_signs(sgn, sgn.shape[0] * 8).to(torch.float32)
        return sel(packed[f"{key}_mag"]).to(torch.float32) * (1.0 - 2.0 * sg)

    out = []
    for seg, rows, _ in _fp.mma_segments(cfg):
        base, _, kind = seg.partition(".")
        if base.startswith("trunk"):
            tw = dense("trunk", int(base[5:]))
            m = tw[:W] if kind == "h" else (tw[:pe] if base == "trunk0"
                                            else tw[W:W + pe])
        else:
            m = dense(base)[:W]
        m = _place_rows(m.to(torch.float32), rows)
        out.append(_steps_bf16(m.to(torch.bfloat16)) if quantized
                   else _steps_tf32(*tf32_split(m)))
    return torch.cat(out).contiguous()


def kernel_weights(cfg: NerfConfig, params: dict,
                   quant: Optional[dict] = None) -> dict:
    """What the kernels read, packed once at load: the
    ``stack_plcore_weights`` layout plus its tensor-core copy under
    ``"mma"`` (``mma_stream``; one pack)."""
    packed = stack_plcore_weights(cfg, params, quant)
    packed["mma"] = mma_stream(cfg, packed)
    return packed


def plcore_resident_weight_bytes(cfg: NerfConfig, n_shards: int = 1) -> int:
    """Per-cell bytes of one network's f32 ``kernel_weights`` layout when
    its trunk is layer-sharded ``n_shards`` ways (``runtime.sharding``: a
    count that does not divide the layers replicates): the cell holding
    the most of the trunk stacks (``trunk_w``, ``trunk_b`` and the trunk
    layers' segments of the tensor-core stream, TF32 hi/lo pairs) plus the
    heads, which every cell keeps. ``n_shards=1`` is the replicated
    layout. This is what the scene cache budgets a sharded resident at."""
    W, C, L = cfg.trunk_width, cfg.color_width, cfg.trunk_layers
    P, P2 = packed_rows(cfg)
    n = n_shards if n_shards >= 1 and L % n_shards == 0 else 1
    per = L // n
    layer = [4 * (P * W + W) for _ in range(L)]      # trunk_w + trunk_b
    heads = 4 * (W + 1 + W + C + 3 * C + 3 + W * W + P2 * C)
    for (name, rows, ncols), (lo, hi) in zip(_fp.mma_segments(cfg),
                                             _fp.mma_offsets(cfg, False)):
        base = name.partition(".")[0]
        if base.startswith("trunk"):
            layer[int(base[5:])] += 4 * (hi - lo)
        else:
            heads += 4 * (hi - lo)
    return max(sum(layer[c * per:(c + 1) * per]) for c in range(n)) + heads


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


def ray_tile(n_rays: int, slots: int, pairs: bool = False) -> int:
    """Rays one block walks, for ``n_rays`` over ``slots`` resident
    blocks (the SMs times the kernel's blocks per SM): about ``WAVES``
    waves of blocks. With ``pairs`` (K2 taking its rays two at a time,
    ``fused_plcore.k2_pairs``) the count is even, so no block ends on a
    lone ray: of the two even neighbours of an odd count, the one whose
    grid takes fewer ray walks in whole waves, the smaller on a tie."""
    rt = max(1, n_rays // (WAVES * slots))
    if not pairs or rt % 2 == 0:
        return rt

    def walks(t):   # waves of the grid, each t ray walks long
        return -(-(-(-n_rays // t)) // slots) * t
    lo, hi = rt - 1, rt + 1
    return hi if lo < 2 or walks(hi) < walks(lo) else lo


def pick_ray_tile(n_rays: int, device: torch.device,
                  blocks_per_sm: int = 0, pairs: bool = False) -> int:
    """Rays per tile. On the card a tile is the rays one block walks, one
    after another or two at a time (``pairs``): outputs do not depend on
    it, so it is sized by ``ray_tile`` over the card's SMs and the
    kernel's resident blocks per SM (``fused_plcore.blocks_per_sm``). On
    the CPU it is the plain version's tensor batch."""
    if device.type != "cuda":
        return PLAIN_TILE
    if blocks_per_sm < 1:
        raise ValueError("pick_ray_tile on the card needs the kernel's "
                         "resident blocks per SM")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return ray_tile(n_rays, blocks_per_sm * n_sm, pairs)


def _quantized(packed: dict) -> int:
    return int("trunk_mag" in packed)


def fused_render(cfg: NerfConfig, params: Optional[dict], rays_o, rays_d, t,
                 deltas, *, quant: Optional[dict] = None,
                 packed: Optional[dict] = None, alive=None,
                 rt: Optional[int] = None):
    """One sample set through K1: (rgb (R,3), {weights, acc}). ``packed``:
    a pre-built layout (``params``/``quant`` are then ignored); ``alive``:
    optional (R,) mask, dead rays come back as zeros."""
    _DISPATCHES.inc()
    if packed is None:
        packed = kernel_weights(cfg, params, quant)
    dev = rays_o.device
    if rt is None:
        per_sm = (_fp.blocks_per_sm(cfg, "k1", (t.shape[-1],),
                                    (_quantized(packed),), dev)
                  if dev.type == "cuda" else 0)
        rt = pick_ray_tile(rays_o.shape[0], dev, per_sm)
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
                          alive=None, phase_cycles=None,
                          white_bkgd: bool = False) -> dict:
    """The whole coarse -> importance -> fine render through K2, one
    launch. ``packed``: {"coarse", "fine"} layouts; ``phase_cycles`` and
    ``white_bkgd`` (K2 composites both rgb outputs onto white) as
    ``two_pass_plcore_call``'s. Returns {rgb, rgb_coarse, acc, acc_coarse,
    depth}."""
    _DISPATCHES.inc()
    dev = rays_o.device
    if rt is None:
        per_sm = (_fp.blocks_per_sm(
            cfg, "k2", (cfg.n_coarse, cfg.n_fine),
            (_quantized(packed["coarse"]), _quantized(packed["fine"])), dev)
            if dev.type == "cuda" else 0)
        rt = pick_ray_tile(rays_o.shape[0], dev, per_sm,
                           pairs=_fp.k2_pairs(cfg.n_coarse, cfg.n_fine))
    t_row, u_row = sample_rows(cfg, dev)
    rgb, rgb_c, acc, acc_c, depth = _fp.two_pass_plcore_call(
        cfg, packed["coarse"], packed["fine"], rays_o.contiguous(),
        rays_d.contiguous(), t_row, u_row, rt=rt,
        ert_eps=float(ert_eps),
        alive=None if alive is None else alive.to(torch.float32).contiguous(),
        phase_cycles=phase_cycles, white_bkgd=white_bkgd)
    return {"rgb": rgb, "rgb_coarse": rgb_c, "acc": acc,
            "acc_coarse": acc_c, "depth": depth}


@functools.lru_cache(maxsize=None)
def _mip_sample_rows(near: float, far: float, n_edges: int,
                     device: torch.device):
    return (sampling.mip_edges(near, far, n_edges, device).contiguous(),
            sampling.mip_u(n_edges, device).contiguous())


def mip_sample_rows(cfg, device) -> tuple:
    """The two ray-independent grids of K2's Mip-NeRF instance, built once
    per config and device: ``t_row`` (N + 1,), the coarse edges, and
    ``u_row`` (N + 1,), the resample grid. Read-only."""
    return _mip_sample_rows(float(cfg.near), float(cfg.far), cfg.n_edges,
                            torch.device(device))


def fused_render_mip(cfg, packed: dict, rays, *, phase_cycles=None,
                     white_bkgd: bool = False) -> dict:
    """Both levels of Mip-NeRF through K2's Mip-NeRF instance, one launch.
    ``rays`` (R, 7): origin, direction (camera z = -1), cone radius;
    ``packed`` the one network's ``kernel_weights``; ``phase_cycles`` and
    ``white_bkgd`` as ``fused_plcore.mip_two_pass_call``'s. Returns {rgb,
    rgb_coarse, acc, acc_coarse, depth}."""
    _DISPATCHES.inc()
    dev = rays.device
    per_sm = _fp.mip_blocks_per_sm(cfg, dev) if dev.type == "cuda" else 0
    rt = pick_ray_tile(rays.shape[0], dev, per_sm)
    t_row, u_row = mip_sample_rows(cfg, dev)
    rgb, rgb_c, acc, acc_c, depth = _fp.mip_two_pass_call(
        cfg, packed, rays.contiguous(), t_row, u_row, rt=rt,
        phase_cycles=phase_cycles, white_bkgd=white_bkgd)
    return {"rgb": rgb, "rgb_coarse": rgb_c, "acc": acc,
            "acc_coarse": acc_c, "depth": depth}
