"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):
1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all at once.
2. Hold K1 and K2 against their plain PyTorch versions at the full
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
3. K3 (``rmcm_matmul``) against its plain version at the NeRF trunk layer
   of one 512-ray tile's fine pass (131072 x 256 x 256), a decode-sized
   product at qwen2-1.5b's MLP width (16 x 1536 x 8960) and a ragged
   (33 x 512 x 65), f32 inputs at atol 2e-4 / rtol 1e-4 and bf16 inputs at
   atol 0.3 / rtol 0.05 (the reference test's tolerances). The first two
   are timed in f32 (cycling through weight copies that exceed the L2
   cache) beside their bound and one ``torch.matmul`` on the dequantized
   f32 weight (TF32 off; the dequantization is not counted in it). Then
   its entry point ``ops.rmcm_matmul`` with leading dims, counted alone.
4. The main path through the serve entry point: full config,
   ``--kernel --fuse-two-pass``, 3 views at 128x128, then one view with
   ``--rmcm --ert 0.01``. Launch counters are zeroed just before and read
   just after: K2 must have launched, no weights re-packed, images finite
   with pixel std > 0.
5. The oracle path: one view-sized tile through ``render_tile_oracle`` (K1
   twice, counters zeroed before and read after) against ``render_tile``
   at 1e-3.
6. The serving engine, ``serve --mode engine`` at full width (3 scenes, 12
   requests at 64x64 and 128x128, closed loop at concurrency 4, 4096-ray
   tiles, pipeline depth 2, ``--check``), clean and then with
   ``--inject-faults``. Counters are zeroed before each run and read after
   it: K2 launches must equal the dispatch attempts that did not raise and
   K1 launches twice the oracle fallbacks; the clean run has no retry and
   no fallback, and in the chaos run every dispatch error, corrupt tile
   and scene-load error traces back to an injected fault (straggler
   redispatches, timed on the host's clock, are reported). Each ok image
   equals a direct
   ``PackedPlcore.render_image`` of its pose bit for bit (within 1e-3
   where the oracle rung rendered one of its tiles).

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

import numpy as np
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
from repro_torch.kernels import rmcm_matmul as k3  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

DEV = torch.device("cuda")
HW = 128
PLAIN_RT = 1024          # rays per tensor batch of the plain versions
HBM_BYTES_PER_S = 3.35e12
SOURCE = {"fused_plcore_call": "src/repro_torch/kernels/csrc/fused_plcore.cu",
           "two_pass_plcore_call":
               "src/repro_torch/kernels/csrc/fused_plcore.cu",
           "rmcm_matmul": "src/repro_torch/kernels/csrc/rmcm_matmul.cu"}
REPLACES = {"fused_plcore_call": "src/repro/kernels/fused_plcore.py:239",
            "two_pass_plcore_call": "src/repro/kernels/fused_plcore.py:432",
            "rmcm_matmul": "src/repro/kernels/rmcm_matmul.py:58"}
# K3's shapes (M, K, N): the NeRF trunk layer at one 512-ray tile's fine
# pass (512 rays x 256 samples), a decode-sized product at qwen2-1.5b's MLP
# width (src/repro/configs/qwen2_1_5b.py: d_model 1536, d_ff 8960, 16
# rows), and a ragged shape of the reference's kernel test
K3_SHAPES = {"nerf_trunk": (512 * 256, 256, 256),
             "qwen2_1_5b_mlp_decode": (16, 1536, 8960),
             "ragged": (33, 512, 65)}
K3_TIMED = ("nerf_trunk", "qwen2_1_5b_mlp_decode")
K3_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (0.3, 0.05)}
L2_BYTES = 50 * 2 ** 20


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


def cuda_ms_cycled(fns, reps: int):
    """``cuda_ms`` over calls that cycle through ``fns`` (the same work on
    separate copies of the inputs), so that inputs smaller than the L2
    cache are read from device memory, as a caller with many such
    operands would find them."""
    calls = iter(range(reps + 1))
    ms, out = cuda_ms(lambda: fns[next(calls) % len(fns)](), reps)
    return ms, out, reps % len(fns)


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


def k3_weights(k: int, n: int, gen, copies: int = 1) -> list:
    """``copies`` RMCM-packed (k, n) weights drawn on the card."""
    return [rmcm.pack(rmcm.quantize(torch.randn(k, n, generator=gen,
                                                device=DEV)))
            for _ in range(copies)]


def k3_bytes(x, packed, y) -> int:
    """Bytes K3 must move: x, 1.125 B per weight, the scales and y."""
    return nbytes(x, packed["mag"], packed["sign_bits"], packed["scale"], y)


def k3_phase(peak: float) -> dict:
    """K3 against its plain version on the card at ``K3_SHAPES``, f32 and
    bf16 inputs at the reference test's tolerances; the timed shapes (f32)
    beside their bound and one PyTorch matmul on the dequantized weight.
    Then the entry point a user calls, ``ops.rmcm_matmul`` with leading
    dims, counts zeroed just before and read just after."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    errs, shapes = {torch.float32: [], torch.bfloat16: []}, {}
    for label, (M, K, N) in K3_SHAPES.items():
        timed = label in K3_TIMED
        # enough weight copies that one cycle of calls moves twice the L2
        io_bytes = 4 * (M * K + M * N)
        copies = (-(-2 * L2_BYTES // (K * N + (-(-K // 8)) * N + io_bytes))
                  if timed else 1)
        packs = k3_weights(K, N, gen, copies)
        x32 = torch.randn(M, K, generator=gen, device=DEV)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            atol, rtol = K3_TOL[dt]
            got = k3.rmcm_matmul(x, packs[0])
            want = ref.rmcm_matmul_ref(x, packs[0])
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == (M, N), (got.dtype,
                                                             got.shape)
            assert bool(torch.isfinite(got).all()), label
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
            e = float((got.float() - want.float()).abs().max())
            errs[dt].append(e)
            print(f"check K3 {label} {tuple((M, K, N))} {dt}: max_abs_err "
                  f"{e} (atol {atol}, rtol {rtol})", flush=True)
            if not (timed and dt == torch.float32):
                continue
            ms, got, last = cuda_ms_cycled(
                [lambda p=p: k3.rmcm_matmul(x, p) for p in packs], 20)
            torch.testing.assert_close(
                got, ref.rmcm_matmul_ref(x, packs[last]), atol=atol,
                rtol=rtol)
            plain_ms, _, _ = cuda_ms_cycled(
                [lambda p=p: ref.rmcm_matmul_ref(x, p) for p in packs], 5)
            dense = [rmcm.dequantize(rmcm.unpack(p), torch.float32)
                     for p in packs[:-(-2 * L2_BYTES // (4 * K * N + io_bytes))]]
            lib_ms, _, _ = cuda_ms_cycled(
                [lambda w=w: torch.matmul(x, w) for w in dense], 20)
            del dense
            b_ms, b_by = bound_ms(2.0 * M * K * N,
                                  k3_bytes(x, packs[0], got), peak)
            shapes[label] = {"shape_mkn": [M, K, N], "dtype": "float32",
                             "ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "weight_copies": len(packs)}
            print(f"K3 {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
                  f"plain {plain_ms:.4f} ms; torch.matmul on the dequantized "
                  f"f32 weight, dequantization not counted, {lib_ms:.4f} ms)",
                  flush=True)
    # the entry point with leading dims, counted on its own
    M, K, N = K3_SHAPES["qwen2_1_5b_mlp_decode"]
    packed = k3_weights(K, N, gen)[0]
    x = torch.randn(2, M // 2, K, generator=gen, device=DEV)
    for c in k3.LAUNCHES:
        k3.LAUNCHES[c] = 0
    y = ops.rmcm_matmul(x, packed, bm=8, bn=8, bk=8)
    torch.cuda.synchronize()
    launches = k3.LAUNCHES["rmcm_matmul"]
    assert launches == 1 and y.shape == (2, M // 2, N), (launches, y.shape)
    torch.testing.assert_close(
        y, ref.rmcm_matmul_ref(x.reshape(M, K), packed).reshape(y.shape),
        atol=2e-4, rtol=1e-4)
    row = shapes["nerf_trunk"]
    return {"max_abs_err": max(errs[torch.float32]),
            "max_abs_err_bf16": max(errs[torch.bfloat16]), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_call": "torch.matmul(x, W_dequantized_f32), TF32 off, "
                            "dequantization not counted",
            "timed_shape": "nerf_trunk", "shapes": shapes,
            "launches": launches}


def serve_phase(out_dir: str, extra: list, views: int) -> dict:
    """Main path through the serve entry point; launch counts zeroed just
    before and read just after."""
    zero_launches()
    stats = serve.main(["--mode", "nerf", "--full", "--kernel",
                        "--fuse-two-pass", "--views", str(views), "--hw",
                        str(HW), "--out", out_dir, *extra])
    launches = read_launches()
    assert stats["device"].startswith("cuda"), stats["device"]
    assert stats["weight_packs_since_load"] == 0, stats
    assert launches["two_pass_plcore_call"] >= views, launches
    for v in stats["views"]:
        assert v["finite"] and v["pixel_std"] > 0, v
    print(f"main path {extra or ['f32']}: launches {launches}, per-view "
          f"wall_s {[v['wall_s'] for v in stats['views']]}", flush=True)
    return launches


ENGINE_ARGV = ["--mode", "engine", "--full", "--kernel", "--fuse-two-pass",
               "--scenes", "3", "--requests", "12", "--hw-mix", "64,128",
               "--loop", "closed", "--concurrency", "4",
               "--pipeline-depth", "2", "--tile-rays", "4096", "--check"]


def zero_launches() -> None:
    for counts in (fused_plcore.LAUNCHES, k3.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {**fused_plcore.LAUNCHES, **k3.LAUNCHES}


def engine_phase(extra: list) -> dict:
    """The serving engine through ``serve --mode engine`` (its run, then
    its ``--check`` gates): launch counts zeroed just before the run and
    read just after it, before the check's reruns. Every launch must be
    accounted for by the engine's own counters, so the retry ladder cannot
    hide a broken kernel; every request's image is held against a direct
    ``PackedPlcore.render_image`` of its pose."""
    args = serve.build_parser().parse_args(ENGINE_ARGV + extra)
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args)
    launches = read_launches()
    st, rb = report["engine"], report["robustness"]
    assert report["device"].startswith("cuda"), report["device"]
    label = "chaos" if args.inject_faults else "clean"
    if args.inject_faults:
        inj = rb["faults_injected"]["injected"]
        # every recovery that a raised dispatch, a non-finite tile or a
        # failed load set off traces back to an injected fault; straggler
        # redispatches are timed on the host's clock and only reported
        assert rb["dispatch_errors"] == inj["dispatch_error"], (rb, inj)
        assert rb["corrupt_tiles"] <= inj["corrupt"], (rb, inj)
        assert rb["scene_load_errors"] == inj["loader_error"], (rb, inj)
    else:
        assert (rb["dispatch_errors"], rb["tile_retries"],
                rb["oracle_fallbacks"]) == (0, 0, 0), rb
    # K2 runs once per dispatch attempt that did not raise; the oracle
    # rung runs K1 twice
    assert launches["two_pass_plcore_call"] == (
        st["dispatches"] + st["tile_retries"] - st["dispatch_errors"]), (
        launches, st)
    assert launches["fused_plcore_call"] == 2 * st["oracle_fallbacks"], (
        launches, st)
    assert launches["two_pass_plcore_call"] >= 1, launches
    n_exact = n_close = 0
    direct_models = {}
    for rid, item in enumerate(trace):
        res = engine.completed[rid]
        if res.status != "ok":
            continue
        req = item.request
        ro, rd = rays.camera_rays(
            rays.pose_spherical(req.theta, req.phi, req.radius), req.hw,
            req.hw, 0.9 * req.hw)
        if req.scene_id not in direct_models:
            direct_models[req.scene_id] = serve.load_plcore(
                serve.model_config(args), args,
                args.seed + int(req.scene_id.removeprefix("scene")))
        direct = direct_models[req.scene_id].render_image(
            ro, rd, rays_per_batch=args.tile_rays).cpu().numpy()
        if res.fallbacks:
            assert np.allclose(res.image, direct, rtol=0,
                               atol=serve.ORACLE_ATOL), rid
            n_close += 1
        else:
            assert np.array_equal(res.image, direct), (
                rid, float(np.abs(res.image - direct).max()))
            n_exact += 1
    assert n_exact >= 1 and n_exact + n_close == \
        rb["status_counts"].get("ok", 0), (n_exact, n_close, rb)
    compared = serve.check_engine(args, report, engine, rerun)
    extra_summary = {}
    if not args.inject_faults:
        # the same trace at depth 1 (synchronous), timed the same way
        t0 = time.perf_counter()
        sync = rerun(1)
        wall = time.perf_counter() - t0
        extra_summary = {"depth1_wall_s": wall, "depth1_rays_per_s":
                         sync.stats["rays_rendered"] / wall}
    summary = {
        "run": label, "rays_per_s": report["rays_per_s"],
        "req_per_s": report["req_per_s"], "wall_s": report["wall_s"],
        "latency_ms": report["latency_ms"],
        "queueing_ms": report["queueing_ms"],
        "service_ms": report["service_ms"],
        "max_in_flight": st["max_in_flight"],
        "dispatches": st["dispatches"],
        "dispatch_baseline": st["dispatch_baseline"],
        "padded_rays": st["padded_rays"], "goodput": rb["goodput"],
        "status_counts": rb["status_counts"],
        "tile_retries": rb["tile_retries"],
        "oracle_fallbacks": rb["oracle_fallbacks"],
        "straggler_redispatches": rb["straggler_redispatches"],
        "cache_hit_rate": report["cache"]["hit_rate"],
        "launches": launches, "images_exact_vs_direct": n_exact,
        "images_within_oracle_atol": n_close, "check_compared": compared,
        **extra_summary}
    if args.inject_faults:
        summary["faults_injected"] = rb["faults_injected"]["injected"]
    print(f"engine {label}: {json.dumps(summary)}", flush=True)
    return summary


def oracle_phase(cfg, params) -> int:
    model = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                         device=DEV)
    o, d = view_rays(120.0)
    fused = model.render_tile(o, d)
    zero_launches()
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

    k3_row = k3_phase(peak)

    out_dir = str(ROOT / "chiprun_out" / "smoke_views")
    main_launches = serve_phase(out_dir, [], 3)
    rmcm_launches = serve_phase(out_dir, ["--rmcm", "--ert", "0.01"], 1)
    oracle_launches = oracle_phase(cfg, params)
    clean = engine_phase([])
    chaos = engine_phase(["--inject-faults"])

    main_path = {k: main_launches[k] + rmcm_launches[k]
                 + clean["launches"][k] for k in main_launches}
    kernels = []
    for k in ("fused_plcore_call", "two_pass_plcore_call"):
        launches = (main_path[k] if k == "two_pass_plcore_call"
                    else oracle_launches)
        kernels.append({"name": k, "route": "cuda", "source": SOURCE[k],
                        "replaces": REPLACES[k], "launches": launches,
                        "launches_on": ("main path" if k == "two_pass_plcore_call"
                                        else "oracle path"),
                        **rows[k], "library_ms": None})
    kernels.append({"name": "rmcm_matmul", "route": "cuda",
                    "source": SOURCE["rmcm_matmul"],
                    "replaces": REPLACES["rmcm_matmul"],
                    "launches_on": "rmcm_matmul entry point",
                    "main_path_launches": main_path["rmcm_matmul"],
                    **k3_row})
    print(json.dumps({"engine": {"clean": clean, "chaos": chaos}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
