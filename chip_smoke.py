"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):
1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version at the full
   ``NerfConfig()`` width and the main path's shape: one 128x128 camera
   view (16384 rays) at the main path's ray tile, which must be above 1
   and leave a ragged last tile. K1 (``fused_plcore_call``) at N=64 and
   N=192, f32 and RMCM, with an alive mask; K2 (``two_pass_plcore_call``)
   f32, RMCM, ERT at 0.01 and at an eps where some rays terminate and
   some do not, and an alive mask. Tolerances: rgb/acc/weights 1e-3,
   depth 1e-2, 5e-3 with RMCM, ERT or a mask. K1 at N=192 and K2 in f32,
   unmasked, are timed with CUDA events, their timed outputs checked, beside
   the least time the card could take (fp32 operations over SMs x 128
   FMA/clk x 2 x max SM clock, or bytes over 3.35 TB/s, whichever is
   larger).
3. The main path through the serve entry point: full config,
   ``--kernel --fuse-two-pass``, 3 views at 128x128, then one view with
   ``--rmcm --ert 0.01``. Launch counters are zeroed just before and read
   just after: K2 must have launched, no weights re-packed, images finite
   with pixel std > 0.
4. The oracle path: one view-sized tile through ``render_tile_oracle`` (K1
   twice, counters zeroed before and read after) against ``render_tile``
   at 1e-3.

Prints the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``. Exits nonzero with no
result when CUDA is absent or the repository's sources are not beside it.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.nerf_icarus import CONFIG  # noqa: E402
from repro_torch.core import rmcm, sampling  # noqa: E402
from repro_torch.core.pipeline import PackedPlcore  # noqa: E402
from repro_torch.core.plcore import plcore_decls  # noqa: E402
from repro_torch.data import rays  # noqa: E402
from repro_torch.kernels import build, fused_plcore, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

DEV = torch.device("cuda")
HW = 128
PLAIN_RT = 1024          # rays per tensor batch of the plain versions
HBM_BYTES_PER_S = 3.35e12
SOURCE = "src/repro_torch/kernels/csrc/fused_plcore.cu"
REPLACES = {"fused_plcore_call": "src/repro/kernels/fused_plcore.py:239",
            "two_pass_plcore_call": "src/repro/kernels/fused_plcore.py:432"}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def fp32_peak_flops() -> float:
    """SMs x 128 FP32 lanes x 2 FLOP per FMA x the max SM clock."""
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return n_sm * 128 * 2 * mhz * 1e6


def macs_per_sample(cfg) -> int:
    W, C, pe = cfg.trunk_width, cfg.color_width, cfg.pos_enc_dim
    trunk = pe * W + (cfg.trunk_layers - 1) * W * W + len(cfg.skip_at) * pe * W
    return trunk + W * (1 + W) + W * C + C * 3


def macs_per_ray_pass(cfg) -> int:
    return cfg.dir_enc_dim * cfg.color_width        # direction part of color0


def nbytes(*ts) -> int:
    total = 0
    for t in ts:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def bound_ms(flops: float, n_bytes: int, peak: float):
    t_ops, t_bytes = flops / peak, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cuda_ms(fn, reps: int):
    """Mean ms of ``reps`` calls after one warm-up, and the last output."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def check(name: str, got, want, tols) -> float:
    torch.cuda.synchronize()
    errs = []
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape and bool(torch.isfinite(x).all()), (name, i)
        e = float((x - y).abs().max())
        assert e <= tols[i], f"{name}: output {i} off by {e} > {tols[i]}"
        errs.append(e)
    print(f"check {name}: max_abs_err per output {errs}", flush=True)
    return max(errs)


def packed_nets(cfg, params, quantized: bool) -> dict:
    out = {}
    for n in ("coarse", "fine"):
        q = rmcm.quantize_tree(params[n]) if quantized else None
        out[n] = bridge.to_device(ops.stack_plcore_weights(cfg, params[n], q),
                                  DEV)
    return out


def view_rays(theta: float):
    ro, rd = rays.camera_rays(rays.pose_spherical(theta, -25.0, 4.0),
                              HW, HW, 0.9 * HW)
    return ro.reshape(-1, 3).to(DEV), rd.reshape(-1, 3).to(DEV)


def kernel_phase(cfg, params, peak: float) -> dict:
    """Each kernel against its plain version at the main path's shape: one
    128x128 view (16384 rays) at the main path's ray tile, so every block
    walks several rays and the last tile is ragged. The timed calls'
    outputs are checked too."""
    o, d = view_rays(45.0)
    R = o.shape[0]
    rt = ops.pick_ray_tile(R, DEV)
    assert rt > 1 and R % rt != 0, ("no multi-ray ragged tiling", R, rt)
    alive = (torch.arange(R, device=DEV) % 3 != 0).to(torch.float32)
    rows = ops.sample_rows(cfg, DEV)
    nets = {q: packed_nets(cfg, params, q) for q in (False, True)}
    errs, times = {}, {}

    def hold(name, label, kern, plain, tols, timed=False):
        """Run the kernel and its plain version on the same inputs, check
        the kernel's output; with ``timed``, time both and check the
        output of the last timed call."""
        if timed:
            ms, got = cuda_ms(kern, 3)
            plain_ms, want = cuda_ms(plain, 3)
            times[name] = (ms, plain_ms)
        else:
            got, want = kern(), plain()
        errs[name] = max(errs.get(name, 0.0), check(label, got, want, tols))
        return want

    # ---- K1: coarse (N=64) and fine-shaped (N=192) sample sets ----------
    K1 = "fused_plcore_call"
    g = torch.Generator(device=DEV).manual_seed(1)
    Nt = cfg.n_coarse + cfg.n_fine
    for quantized in (False, True):
        tol = 5e-3 if quantized else 1e-3
        for N in (cfg.n_coarse, Nt):
            t = sampling.stratified(cfg.near, cfg.far, N, (R,), g, device=DEV)
            dl = sampling.deltas_from_t(t)
            k1 = (cfg, nets[quantized]["fine"], o, d, t, dl)
            masks = (None, alive) if (N == Nt and not quantized) else (alive,)
            for mask in masks:
                hold(K1, f"K1 N={N} rmcm={quantized} alive-mask="
                     f"{mask is not None}",
                     lambda: fused_plcore.fused_plcore_call(
                         *k1, rt=rt, alive=mask),
                     lambda: ref.fused_plcore_ref(*k1, rt=PLAIN_RT,
                                                  alive=mask),
                     (tol, tol, tol), timed=mask is None)
                if mask is None:
                    k1_in = (o, d, t, dl, k1[1])

    # ---- K2: f32 (timed), RMCM, ERT, alive mask ---------------------------
    K2 = "two_pass_plcore_call"

    def k2_hold(quantized, eps, mask=None, timed=False):
        k2 = (cfg, nets[quantized]["coarse"], nets[quantized]["fine"], o, d,
              *rows)
        tol = 5e-3 if (quantized or eps or mask is not None) else 1e-3
        return hold(K2, f"K2 rmcm={quantized} ert={eps} alive-mask="
                    f"{mask is not None}",
                    lambda: fused_plcore.two_pass_plcore_call(
                        *k2, rt=rt, ert_eps=eps, alive=mask),
                    lambda: ref.two_pass_ref(*k2, rt=PLAIN_RT, ert_eps=eps,
                                             alive=mask),
                    (tol, tol, tol, tol, 1e-2), timed=timed)

    acc_c = k2_hold(False, 0.0, timed=True)[3]
    k2_hold(True, 0.0)
    # ERT at the serve eps, then at the median of the distinct coarse acc
    # values below 1, where some rays terminate and others go on to their
    # fine pass
    below = torch.unique(acc_c[acc_c < 1.0])
    eps_mix = 1.0 - float(below[below.numel() // 2]) if below.numel() else 0.0
    for eps in (0.01, eps_mix):
        dead = int((acc_c >= ref.ert_threshold(eps)).sum())
        print(f"ERT eps {eps}: {dead} of {R} rays skip the fine pass",
              flush=True)
        k2_hold(False, eps)
    assert eps_mix > 0.0 and 0 < dead < R, ("no live/dead mix", eps_mix, dead)
    k2_hold(False, 0.0, alive)

    # the least time for the timed calls' work: every ray alive
    k1_flops = 2 * R * (Nt * macs_per_sample(cfg) + macs_per_ray_pass(cfg))
    k1_bytes = nbytes(*k1_in) + 4 * R * (3 + Nt + 1)
    k2_flops = 2 * R * ((cfg.n_coarse + Nt) * macs_per_sample(cfg)
                        + 2 * macs_per_ray_pass(cfg))
    k2_bytes = nbytes(o, d, rows, nets[False]) + 4 * R * 9
    bounds = {K1: bound_ms(k1_flops, k1_bytes, peak),
              K2: bound_ms(k2_flops, k2_bytes, peak)}
    print(f"checked and timed at {R} rays (one {HW}x{HW} view), ray tile "
          f"{rt} (last tile {R % rt} rays), K1 timed at N={Nt}; fp32 peak "
          f"{peak / 1e12:.2f} TFLOP/s", flush=True)
    return {k: {"max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1]} for k in (K1, K2)}


def serve_phase(out_dir: str, extra: list, views: int) -> dict:
    """Main path through the serve entry point; launch counts zeroed just
    before and read just after."""
    for k in fused_plcore.LAUNCHES:
        fused_plcore.LAUNCHES[k] = 0
    stats = serve.main(["--mode", "nerf", "--full", "--kernel",
                        "--fuse-two-pass", "--views", str(views), "--hw",
                        str(HW), "--out", out_dir, *extra])
    launches = dict(fused_plcore.LAUNCHES)
    assert stats["device"].startswith("cuda"), stats["device"]
    assert stats["weight_packs_since_load"] == 0, stats
    assert launches["two_pass_plcore_call"] >= views, launches
    for v in stats["views"]:
        assert v["finite"] and v["pixel_std"] > 0, v
    print(f"main path {extra or ['f32']}: launches {launches}, per-view "
          f"wall_s {[v['wall_s'] for v in stats['views']]}", flush=True)
    return launches


def oracle_phase(cfg, params) -> int:
    model = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                         device=DEV)
    o, d = view_rays(120.0)
    fused = model.render_tile(o, d)
    for k in fused_plcore.LAUNCHES:
        fused_plcore.LAUNCHES[k] = 0
    oracle = model.render_tile_oracle(o, d)
    torch.cuda.synchronize()
    launches = fused_plcore.LAUNCHES["fused_plcore_call"]
    assert launches == 2, fused_plcore.LAUNCHES
    e = check("oracle (K1 twice) vs fused tile", (oracle,), (fused,), (1e-3,))
    print(f"oracle path: K1 launches {launches}, max_abs_err {e}", flush=True)
    return launches


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    print(f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    lib = build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    cfg = CONFIG
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0))
    peak = fp32_peak_flops()
    rows = kernel_phase(cfg, params, peak)

    out_dir = str(ROOT / "chiprun_out" / "smoke_views")
    main_launches = serve_phase(out_dir, [], 3)
    rmcm_launches = serve_phase(out_dir, ["--rmcm", "--ert", "0.01"], 1)
    oracle_launches = oracle_phase(cfg, params)

    kernels = []
    for k in ("fused_plcore_call", "two_pass_plcore_call"):
        launches = (main_launches[k] + rmcm_launches[k]
                    if k == "two_pass_plcore_call" else oracle_launches)
        kernels.append({"name": k, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[k], "launches": launches,
                        "launches_on": ("main path" if k == "two_pass_plcore_call"
                                        else "oracle path"),
                        **rows[k], "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
