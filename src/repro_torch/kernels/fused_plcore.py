"""Wrappers of the fused PLCore CUDA kernels (``csrc/fused_plcore.cu``,
the templates in ``csrc/plcore_kernels.cuh`` instantiated per width pair
in ``csrc/plcore_w*.cu``).

* ``fused_plcore_call`` (K1) — one sample set per ray: rays, ``t`` and
  ``deltas`` (R, N) in; rgb (R,3), weights (R,N), acc (R,) out. Two of
  these with the host resample between them make the two-dispatch chain.
* ``two_pass_plcore_call`` (K2) — the whole coarse -> importance -> fine
  render of every ray in ONE launch; coarse weights and sample positions
  never leave the block. Given ``phase_cycles`` rows it runs K2's traced
  instance, which writes where each block spent its cycles
  (``obs.metrics.K2_PHASES``), how many of its MMA rows were real
  samples and how many of its k steps ran with the previous one in
  flight (``K2_ROW_COUNTS``) to the block's row, in pinned host memory,
  so a traced launch adds no operation on the device. A block renders
  its rays two at a time in a pass whose rows then fill every chunk
  (``pairs``), so K2 wants an even ray tile there (``k2_pairs``).
* ``mip_two_pass_call`` — K2's Mip-NeRF instance (``csrc/plcore_mip.cuh``):
  both levels of Mip-NeRF through ONE network in one launch, the rays as
  (R, 7) rows of origin, direction (camera z = -1) and cone radius. Its
  traced instance writes a row of ``obs.metrics.K2_MIP_ROW_STATS``: K2's
  nine slots and the integrated encoding's cycles.

Both run their MLP layers on the tensor cores with wgmma (bf16x3 under
RMCM, 3xTF32 for f32 weights) and read the ``ops.kernel_weights`` layout:
the reference's ``stack_plcore_weights`` layout plus its tensor-core
stream under ``"mma"`` (``mma_segments``, in wgmma's layout). The layer
widths are compiled in: the card takes the (trunk, color) width pairs of
``KERNEL_WIDTHS`` and raises ``ValueError`` for any other. Depth, skip
layers, encoding frequencies and sample counts are runtime values. K2's
coarse and fine networks may have different weight formats (RMCM or
f32). ``blocks_per_sm`` asks the library how many blocks of a kernel fit
on one SM.

A CUDA tensor launches the kernel on the current stream (outputs allocated
here with ``torch.empty``); a CPU tensor takes the plain version in
``kernels.ref``. Nothing else: no fallback from one to the other.
``LAUNCHES`` counts kernel launches per wrapper, ``K2_LAUNCHES_BY_NF``
K2's by fine-sample count and ``INSTANCE_LAUNCHES`` both kernels' by
compiled instance (``instance_name``); all three are touched nowhere but
at a launch, and back onto labeled counters of the process-wide metrics
registry (``obs.metrics.global_registry``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.configs.nerf_icarus import NerfConfig
from repro_torch.kernels import ref
from repro_torch.obs.metrics import (K2_MIP_ROW_STATS, K2_ROW_STATS,
                                     CountsView, global_registry)

LAUNCHES = CountsView(global_registry().counter(
    "plcore_kernel_launches_total", "fused PLCore kernel launches"),
    "kernel", ("fused_plcore_call", "two_pass_plcore_call"))
# K2's launches by fine-sample count (adaptive budgets run Nf < n_fine),
# counted at the same place as LAUNCHES
K2_LAUNCHES_BY_NF = CountsView(global_registry().counter(
    "plcore_k2_launches_by_n_fine_total",
    "two-pass kernel launches per fine-sample count"), "n_fine")
# launches per compiled instance: width pair and weight format(s)
INSTANCE_LAUNCHES = CountsView(global_registry().counter(
    "plcore_instance_launches_total",
    "fused PLCore kernel launches per compiled instance"), "instance")
# (trunk width, color width) pairs the kernels are compiled for: the full
# NerfConfig, tiny() and the reference kernel tests' 5-layer config, their
# 2-layer config (csrc/fused_plcore.cu PLCORE_WIDTHS)
KERNEL_WIDTHS = ((256, 128), (64, 32), (32, 16))
# the (trunk, color) width pairs of K2's Mip-NeRF instance: the published
# MipNerfConfig and its tiny() (csrc/fused_plcore.cu PLCORE_MIP_WIDTHS)
MIP_KERNEL_WIDTHS = ((256, 128), (64, 32))
# mip-NeRF's constants that the Mip-NeRF instance compiles in
# (csrc/plcore_mip.cuh): density bias, rgb padding, resample padding
MIP_CONSTANTS = {"density_bias": -1.0, "rgb_padding": 0.001,
                 "resample_padding": 0.01}

# sample rows of a chunk of the kernels' MMA pipeline, half of them a
# warpgroup's (csrc/plcore_kernels.cuh S)
CHUNK_ROWS = 128


def pairs(n_samples: int) -> bool:
    """Whether K2 walks a pass of ``n_samples`` per ray two rays at once
    (``csrc/plcore_kernels.cuh`` ``pairs``): the rays fill whole half
    chunks and two rays' rows fill fewer chunks than two walks of one."""
    half, n = CHUNK_ROWS // 2, n_samples
    return n % half == 0 and -(-2 * n // CHUNK_ROWS) < 2 * -(-n // CHUNK_ROWS)


def k2_pairs(n_coarse: int, n_fine: int) -> bool:
    """Whether K2 takes its rays in pairs: its coarse or its fine pass
    (``n_coarse + n_fine`` merged samples) pairs."""
    return pairs(n_coarse) or pairs(n_coarse + n_fine)


# one network's pointer order at the C interface: the MLP layers come from
# the tensor-core stream; of the reference layout the kernels read the
# biases, the exact heads, the RMCM scales and color0's direction rows
_NET_KEYS = ["trunk_b", "sigma_w", "sigma_b", "feat_b", "color0_w",
             "color0_b", "rgb_w", "rgb_b", "trunk_scl", "feat_scl",
             "color0_mag", "color0_sgn", "color0_scl", "mma"]


def mma_rows(cfg: NerfConfig):
    """(KH, KPE): rows of h input and of (zero-padded) PE input in a trunk
    layer's tensor-core copy."""
    return cfg.trunk_width, -(-cfg.pos_enc_dim // 16) * 16


def mma_segments(cfg: NerfConfig) -> list:
    """(name, rows, columns) of each matrix in a network's tensor-core
    stream, in the order the kernels read it: "trunk0.pe", then per later
    layer i "trunk{i}.h" and, at a skip layer, "trunk{i}.pe"; "feat" and
    "color0" (its W feature rows)."""
    W, C = cfg.trunk_width, cfg.color_width
    KH, KPE = mma_rows(cfg)
    segs = [("trunk0.pe", KPE, W)]
    for i in range(1, cfg.trunk_layers):
        segs.append((f"trunk{i}.h", KH, W))
        if i in cfg.skip_at:
            segs.append((f"trunk{i}.pe", KPE, W))
    return segs + [("feat", KH, W), ("color0", KH, C)]


def mma_offsets(cfg: NerfConfig, quantized: bool) -> list:
    """(first, end) element of each ``mma_segments`` entry in the stream:
    bf16 elements under RMCM, f32 (TF32 hi and lo) otherwise."""
    per = 1 if quantized else 2
    out, at = [], 0
    for _, rows, ncols in mma_segments(cfg):
        out.append((at, at + per * rows * ncols))
        at += per * rows * ncols
    return out


def mma_shapes(cfg: NerfConfig, quantized: bool) -> dict:
    """Shape of the tensor-core stream: {"mma": (elements,)}."""
    return {"mma": (mma_offsets(cfg, quantized)[-1][1],)}


def _weight_shapes(cfg: NerfConfig, quantized: bool) -> dict:
    W, C, L = cfg.trunk_width, cfg.color_width, cfg.trunk_layers
    _, P2 = ref.packed_rows(cfg)
    shapes = {"trunk_b": (L, W), "sigma_w": (W, 1), "sigma_b": (1,),
              "feat_b": (W,), "color0_b": (C,), "rgb_w": (C, 3),
              "rgb_b": (3,)}
    if quantized:
        shapes.update({"trunk_scl": (L, 1, W), "feat_scl": (1, W),
                       "color0_mag": (P2, C), "color0_sgn": (P2 // 8, C),
                       "color0_scl": (1, C)})
    else:
        shapes["color0_w"] = (P2, C)
    return shapes


def _check(name: str, x: torch.Tensor, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _net_ptrs(cfg: NerfConfig, weights: dict, device) -> list:
    """The pointers of ``_NET_KEYS``, each array checked that the kernels
    read (the reference layout's MLP matrices they do not read are not)."""
    quantized = "trunk_mag" in weights
    if "mma" not in weights:
        raise ValueError("the kernels read the ops.kernel_weights layout; "
                         "this one has no tensor-core stream ('mma')")
    shapes = {**_weight_shapes(cfg, quantized), **mma_shapes(cfg, quantized)}
    ptrs = []
    for k in _NET_KEYS:
        if k not in shapes:
            ptrs.append(None)
            continue
        dt = (torch.uint8 if k.endswith(("_mag", "_sgn")) else
              torch.bfloat16 if k == "mma" and quantized else torch.float32)
        _check(k, weights[k], shapes[k], dt, device)
        ptrs.append(weights[k].data_ptr())
    return ptrs


def check_widths(cfg: NerfConfig) -> None:
    """Raise ``ValueError`` unless the kernels are built for the config's
    (trunk, color) width pair."""
    W, C = cfg.trunk_width, cfg.color_width
    if (W, C) not in KERNEL_WIDTHS:
        raise ValueError(f"the PLCore kernels are built for the (trunk, "
                         f"color) widths {list(KERNEL_WIDTHS)}; got "
                         f"({W}, {C})")


def instance_name(cfg: NerfConfig, kernel: str, quantized: tuple) -> str:
    """The compiled instance a launch runs: e.g.
    ``two_pass_plcore_call[w64c32,rmcm/f32]`` (coarse/fine formats)."""
    fmts = "/".join("rmcm" if q else "f32" for q in quantized)
    return f"{kernel}[w{cfg.trunk_width}c{cfg.color_width},{fmts}]"


def _dims(cfg: NerfConfig, R: int, rt: int) -> list:
    check_widths(cfg)
    P, P2 = ref.packed_rows(cfg)
    skip = sum(1 << i for i in cfg.skip_at)
    return [R, rt, cfg.trunk_width, cfg.trunk_layers, skip, cfg.color_width,
            cfg.pos_freqs, cfg.dir_freqs, P, P2]


def _launch(fn, ptrs: list, dims: list, *extra):
    lib_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib_dims = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(ctypes.cast(lib_ptrs, ctypes.c_void_p),
            ctypes.cast(lib_dims, ctypes.c_void_p), *extra,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(dims: tuple, kernel: int, device: torch.device) -> int:
    from repro_torch.kernels import build
    lib_dims = (ctypes.c_int * len(dims))(*dims)
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device):
        rc = build.load().plcore_blocks_per_sm(
            ctypes.cast(lib_dims, ctypes.c_void_p), kernel,
            ctypes.cast(out, ctypes.c_void_p))
    if rc != 0 or out[0] < 1:
        raise RuntimeError(f"plcore_blocks_per_sm failed: CUDA error {rc}, "
                           f"{out[0]} blocks")
    return out[0]


def blocks_per_sm(cfg: NerfConfig, kernel: str, samples: tuple,
                  quantized: tuple, device) -> int:
    """Blocks of K1 (``kernel`` "k1", ``samples`` (N,), ``quantized``
    (q,)) or K2 ("k2", (n_coarse, n_fine), (qc, qf)) resident on one SM of
    ``device``, from the occupancy calculator at the launch's shared
    memory."""
    dims = _dims(cfg, 1, 1) + [*samples, *map(int, quantized)]
    if kernel == "k2":
        dims.append(0)
    return _blocks_per_sm(tuple(dims), {"k1": 0, "k2": 1}[kernel],
                          torch.device(device))


def _device_of(rays_o: torch.Tensor) -> torch.device:
    if rays_o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no PLCore kernel for device {rays_o.device}")
    return rays_o.device


def fused_plcore_call(cfg: NerfConfig, weights: dict, rays_o, rays_d, t,
                      deltas, *, rt: int, alive: Optional[torch.Tensor] = None):
    """K1. rays (R, 3); t/deltas (R, N); ``weights`` the
    ``ops.stack_plcore_weights`` layout; ``alive`` optional (R,) float mask
    (dead rays output zeros). Returns (rgb (R,3), w (R,N), acc (R,))."""
    dev = _device_of(rays_o)
    if dev.type == "cpu":
        return ref.fused_plcore_ref(cfg, weights, rays_o, rays_d, t, deltas,
                                    rt=rt, alive=alive)
    from repro_torch.kernels import build
    R, N = t.shape
    f32 = torch.float32
    for name, x, shape in (("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
                           ("t", t, (R, N)), ("deltas", deltas, (R, N))):
        _check(name, x, shape, f32, dev)
    if alive is not None:
        _check("alive", alive, (R,), f32, dev)
    ptrs = _net_ptrs(cfg, weights, dev)
    rgb = torch.empty((R, 3), dtype=f32, device=dev)
    w = torch.empty((R, N), dtype=f32, device=dev)
    acc = torch.empty((R,), dtype=f32, device=dev)
    io = [rays_o.data_ptr(), rays_d.data_ptr(), t.data_ptr(),
          deltas.data_ptr(), None if alive is None else alive.data_ptr(),
          rgb.data_ptr(), w.data_ptr(), acc.data_ptr()]
    q = "trunk_mag" in weights
    dims = _dims(cfg, R, rt) + [N, int(q)]
    _launch(build.load().plcore_fused, io + ptrs, dims)
    LAUNCHES["fused_plcore_call"] += 1
    name = instance_name(cfg, "fused_plcore_call", (q,))
    INSTANCE_LAUNCHES[name] = INSTANCE_LAUNCHES.get(name, 0) + 1
    return rgb, w, acc


def two_pass_plcore_call(cfg: NerfConfig, packed_c: dict, packed_f: dict,
                         rays_o, rays_d, t_row, u_row, *, rt: int,
                         ert_eps: float, alive: Optional[torch.Tensor] = None,
                         phase_cycles: Optional[torch.Tensor] = None,
                         white_bkgd: bool = False):
    """K2. rays (R, 3); ``t_row`` (1, n_coarse) coarse positions and
    ``u_row`` (n_fine,) resample grid, both shared by every ray
    (``ops.sample_rows``); ``ert_eps`` > 0 lets rays with acc_c >= 1 - eps
    skip their fine pass; ``alive`` optional (R,) float mask, 0 = dead;
    ``phase_cycles`` optional zeroed (R, 7) int64 tensor in pinned host
    memory: the traced instance writes block b's cycles and row counts per
    ``obs.metrics.K2_ROW_STATS`` slot to row b (R rows hold every block;
    the sum over rows is the launch's), readable once the launch has
    completed; the plain version on the CPU ignores it. Returns (rgb
    (R,3), rgb_coarse (R,3), acc (R,), acc_coarse (R,), depth (R,)); with
    ``white_bkgd`` both rgb outputs composited onto a white background
    (``volume.white_background`` of each with its acc, the same bits),
    else the caller composites."""
    dev = _device_of(rays_o)
    if dev.type == "cpu":
        return ref.two_pass_ref(cfg, packed_c, packed_f, rays_o, rays_d,
                                t_row, u_row, rt=rt, ert_eps=ert_eps,
                                alive=alive, white_bkgd=white_bkgd)
    from repro_torch.kernels import build
    R = rays_o.shape[0]
    Nc, Nf = t_row.shape[-1], cfg.n_fine
    f32 = torch.float32
    _check("rays_o", rays_o, (R, 3), f32, dev)
    _check("rays_d", rays_d, (R, 3), f32, dev)
    _check("t_row", t_row, (1, Nc), f32, dev)
    _check("u_row", u_row, (Nf,), f32, dev)
    if alive is not None:
        _check("alive", alive, (R,), f32, dev)
    if phase_cycles is not None:
        if not phase_cycles.is_pinned():
            raise ValueError("phase_cycles must lie in pinned host memory")
        _check("phase_cycles", phase_cycles, (R, len(K2_ROW_STATS)),
               torch.int64, torch.device("cpu"))
    qc, qf = "trunk_mag" in packed_c, "trunk_mag" in packed_f
    ptrs = _net_ptrs(cfg, packed_c, dev) + _net_ptrs(cfg, packed_f, dev)
    ptrs.append(None if phase_cycles is None else phase_cycles.data_ptr())
    outs = [torch.empty(s, dtype=f32, device=dev)
            for s in ((R, 3), (R, 3), (R,), (R,), (R,))]
    io = [rays_o.data_ptr(), rays_d.data_ptr(), t_row.data_ptr(),
          u_row.data_ptr(), None if alive is None else alive.data_ptr()]
    io += [o.data_ptr() for o in outs]
    dims = _dims(cfg, R, rt) + [Nc, Nf, int(qc), int(qf),
                                int(ert_eps > 0.0), int(white_bkgd)]
    _launch(build.load().plcore_two_pass, io + ptrs, dims,
            ctypes.c_float(ref.ert_threshold(ert_eps)))
    LAUNCHES["two_pass_plcore_call"] += 1
    K2_LAUNCHES_BY_NF[Nf] = K2_LAUNCHES_BY_NF.get(Nf, 0) + 1
    name = instance_name(cfg, "two_pass_plcore_call", (qc, qf))
    INSTANCE_LAUNCHES[name] = INSTANCE_LAUNCHES.get(name, 0) + 1
    return tuple(outs)


def check_mip(cfg) -> None:
    """Raise ``ValueError`` unless K2's Mip-NeRF instance is built for the
    config: its width pair, mip-NeRF's constants, IPE degrees from 0 in a
    multiple of 8 (96 or 48 features, whole k steps)."""
    W, C = cfg.trunk_width, cfg.color_width
    if (W, C) not in MIP_KERNEL_WIDTHS:
        raise ValueError(f"K2's Mip-NeRF instance is built for the (trunk, "
                         f"color) widths {list(MIP_KERNEL_WIDTHS)}; got "
                         f"({W}, {C})")
    for k, v in MIP_CONSTANTS.items():
        if getattr(cfg, k) != v:
            raise ValueError(f"K2's Mip-NeRF instance compiles in {k} = {v}; "
                             f"the config has {getattr(cfg, k)}")
    if cfg.min_deg_point != 0 or cfg.pos_freqs % 8:
        raise ValueError("K2's Mip-NeRF instance encodes degrees 0 to L - 1 "
                         "with L a multiple of 8")


def mip_blocks_per_sm(cfg, device) -> int:
    """Blocks of K2's Mip-NeRF instance resident on one SM of ``device``,
    from the occupancy calculator at the launch's shared memory."""
    check_mip(cfg)
    return _mip_blocks_per_sm(tuple(_dims(cfg, 1, 1) + [cfg.n_samples, 0]),
                              torch.device(device))


@functools.lru_cache(maxsize=None)
def _mip_blocks_per_sm(dims: tuple, device: torch.device) -> int:
    from repro_torch.kernels import build
    lib_dims = (ctypes.c_int * len(dims))(*dims)
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device):
        rc = build.load().plcore_mip_blocks_per_sm(
            ctypes.cast(lib_dims, ctypes.c_void_p),
            ctypes.cast(out, ctypes.c_void_p))
    if rc != 0 or out[0] < 1:
        raise RuntimeError(f"plcore_mip_blocks_per_sm failed: CUDA error "
                           f"{rc}, {out[0]} blocks")
    return out[0]


def mip_two_pass_call(cfg, packed: dict, rays, t_row, u_row, *, rt: int,
                      phase_cycles: Optional[torch.Tensor] = None,
                      white_bkgd: bool = False):
    """K2's Mip-NeRF instance. ``rays`` (R, 7): origin, direction (camera z
    = -1, unnormalised) and cone radius per row; ``t_row`` (N + 1,) the
    coarse edges and ``u_row`` (N + 1,) the resample grid, shared by every
    ray (``ops.mip_sample_rows``); ``packed`` the one network's
    ``ops.kernel_weights`` layout, read by both levels; ``phase_cycles``
    optional zeroed (R, 8) int64 tensor in pinned host memory for the
    traced instance (``obs.metrics.K2_MIP_ROW_STATS`` a row). Returns (rgb
    (R,3), rgb_coarse (R,3), acc (R,), acc_coarse (R,), depth (R,)); with
    ``white_bkgd`` both rgb outputs composited onto white. A CPU tensor
    takes the plain version (``ref.mip_two_pass_ref``)."""
    dev = _device_of(rays)
    if dev.type == "cpu":
        return ref.mip_two_pass_ref(cfg, packed, rays, t_row, u_row, rt=rt,
                                    white_bkgd=white_bkgd)
    from repro_torch.kernels import build
    check_mip(cfg)
    R, N = rays.shape[0], cfg.n_samples
    f32 = torch.float32
    _check("rays", rays, (R, 7), f32, dev)
    _check("t_row", t_row, (N + 1,), f32, dev)
    _check("u_row", u_row, (N + 1,), f32, dev)
    if phase_cycles is not None:
        if not phase_cycles.is_pinned():
            raise ValueError("phase_cycles must lie in pinned host memory")
        _check("phase_cycles", phase_cycles, (R, len(K2_MIP_ROW_STATS)),
               torch.int64, torch.device("cpu"))
    if "trunk_mag" in packed:
        raise ValueError("K2's Mip-NeRF instance reads float32 weights")
    outs = [torch.empty(s, dtype=f32, device=dev)
            for s in ((R, 3), (R, 3), (R,), (R,), (R,))]
    ptrs = [rays.data_ptr(), t_row.data_ptr(), u_row.data_ptr()]
    ptrs += [o.data_ptr() for o in outs] + _net_ptrs(cfg, packed, dev)
    ptrs.append(None if phase_cycles is None else phase_cycles.data_ptr())
    dims = _dims(cfg, R, rt) + [N, int(white_bkgd)]
    _launch(build.load().plcore_mip_two_pass, ptrs, dims)
    LAUNCHES["mip_two_pass_call"] = LAUNCHES.get("mip_two_pass_call", 0) + 1
    name = instance_name(cfg, "mip_two_pass_call", (False,))
    INSTANCE_LAUNCHES[name] = INSTANCE_LAUNCHES.get(name, 0) + 1
    return tuple(outs)
