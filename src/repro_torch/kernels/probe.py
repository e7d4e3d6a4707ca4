"""Split the time of K2 and K3 on the card by switching parts of them off,
and time K3's f32 tile alternatives.

    python -m repro_torch.kernels.probe [variant ...]

Each variant is a copy of ``kernels/csrc`` with a few text edits
(``VARIANTS``), built into a library of its own under ``build/kernels``
and timed in a process of its own: K2 on one 128x128 view in f32 and
RMCM, K3 at the NeRF trunk shape and a decode shape in f32 and bf16,
with CUDA events; and K3's f32 error against a float64 product at the
decode shape, as a multiple of the plain f32 version's. The variants
that switch parts off compute wrong outputs on purpose; only their times
mean anything. Prints one line per variant.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import build

_FP, _RM = "plcore_kernels.cuh", "rmcm_matmul.cu"
_SKIP_MMA = (r"(\n\s*)(wgmma_(?:bf16|tf32)<[^;]*;)", r"\1if (0) \2")
_WIDE = (_RM, r"BN = F32 \? 64 : 128;", "BN = 128;")
VARIANTS = {
    "base": [],
    # every wgmma skipped (both kernels)
    "no_mma": [(_FP, *_SKIP_MMA), (_RM, *_SKIP_MMA)],
    # K2: the weight ring's bulk copies skipped (the slots' barriers still
    # complete); K3: the decode of the weight tiles skipped
    "no_ring_no_decode": [
        (_FP, r"mbar_expect_tx\(full \+ slot, bytes\);\s*bulk_copy\([^;]*;",
         "mbar_expect_tx(full + slot, 0);"),
        (_RM, r"\n\s*decode<T>\(stage\(slot\)[^;]*;", "")],
    # K3: neither decode nor MMAs, only staging, barriers and stores
    "k3_staging_only": [
        (_RM, r"\n\s*decode<T>\(stage\(slot\)[^;]*;", ""),
        (_RM, r"\n\s*mma_chunk<T>\([^;]*;", "")],
    # K3 f32: 128-column tiles with the small pieces in the large
    # accumulator (fits two blocks per SM)
    "k3_f32_wide_one_acc": [_WIDE,
        (_RM, r"wgmma_bf16<BN>\(lo, a\[0\]", "wgmma_bf16<BN>(acc, a[0]"),
        (_RM, r"wgmma_bf16<BN>\(lo, a\[4\]", "wgmma_bf16<BN>(acc, a[4]")],
    # K3 f32: 128-column tiles with both accumulators, one block per SM
    "k3_f32_wide_one_block": [_WIDE,
        (_RM, r"__launch_bounds__\(NT, 2\)",
         "__launch_bounds__(NT, Tile<T>::F32 ? 1 : 2)")],
}


def _variant_sources(name: str) -> Path:
    out = build.BUILD_DIR / "probe" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(build._CSRC, out)
    for fname, pattern, repl in VARIANTS[name]:
        path = out / fname
        text, n = re.subn(pattern, repl, path.read_text())
        if n == 0:
            raise RuntimeError(f"variant {name}: no match for {pattern!r}")
        path.write_text(text)
    return out


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels() -> dict:
    """K2 and K3 times (ms) with the library ``build`` loads."""
    import torch

    from repro_torch import bridge
    from repro_torch.configs.nerf_icarus import CONFIG as cfg
    from repro_torch.core import rmcm
    from repro_torch.core.plcore import plcore_decls
    from repro_torch.data import rays
    from repro_torch.kernels import fused_plcore, ops, ref
    from repro_torch.kernels import rmcm_matmul as k3
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0))
    ro, rd = rays.camera_rays(rays.pose_spherical(45.0, -25.0, 4.0), 128,
                              128, 0.9 * 128)
    o, d = ro.reshape(-1, 3).to(dev), rd.reshape(-1, 3).to(dev)
    grids = ops.sample_rows(cfg, dev)
    out = {}
    for q in (False, True):
        nets = {n: bridge.to_device(ops.kernel_weights(
            cfg, params[n], rmcm.quantize_tree(params[n]) if q else None), dev)
            for n in ("coarse", "fine")}
        per_sm = fused_plcore.blocks_per_sm(
            cfg, "k2", (cfg.n_coarse, cfg.n_fine), (q, q), dev)
        rt = ops.pick_ray_tile(o.shape[0], dev, per_sm,
                               pairs=fused_plcore.k2_pairs(cfg.n_coarse,
                                                           cfg.n_fine))
        out[f"k2.{'rmcm' if q else 'f32'}"] = _cuda_ms(
            lambda: fused_plcore.two_pass_plcore_call(
                cfg, nets["coarse"], nets["fine"], o, d, *grids, rt=rt,
                ert_eps=0.0), 3)
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (M, K, N) in (("trunk", (131072, 256, 256)),
                             ("decode", (16, 1536, 8960))):
        packs = [rmcm.pack(rmcm.quantize(torch.randn(K, N, generator=gen,
                                                     device=dev)))
                 for _ in range(4)]
        x32 = torch.randn(M, K, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            calls = iter(range(10 ** 6))
            out[f"k3.{label}.{str(dt)[6:]}"] = _cuda_ms(
                lambda: k3.rmcm_matmul(x, packs[next(calls) % 4]), 20)
    # the f32 route's error against float64, over the plain version's
    p = packs[0]
    sg = rmcm.unpack_signs(p["sign_bits"], p["sign_bits"].shape[0] * 8)[:K]
    exact = (x32.double() @ (p["mag"].double() * (1 - 2 * sg.double()))
             ) * p["scale"].double().reshape(1, -1)
    err = [float((y.double() - exact).abs().max())
           for y in (k3.rmcm_matmul(x32, p), ref.rmcm_matmul_ref(x32, p))]
    out["k3.decode.float32.err_ratio"] = err[0] / err[1]
    return out


def main(argv=None) -> None:
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    for name in names:
        src = _variant_sources(name)
        code = ("import json; from pathlib import Path; "
                "from repro_torch.kernels import build, probe; "
                f"build._CSRC = Path({str(src)!r}); "
                "print(json.dumps(probe.time_kernels()))")
        res = subprocess.run([sys.executable, "-c", code], text=True,
                             capture_output=True)
        if res.returncode != 0:
            raise RuntimeError(f"variant {name} failed:\n{res.stderr[-2000:]}")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"probe {name}: " + ", ".join(
            f"{k} {v:.4f}" + ("" if k.endswith("ratio") else " ms")
            for k, v in times.items()), flush=True)


if __name__ == "__main__":
    main()
