"""Where Mip-NeRF's ``err_ratio`` comes from, on the CPU.

The benchmark's ``correct`` compares the program's pixels with the plain
reference (``bench/reference/mipnerf.py``) in float64 and divides the mean
gap by that of the reference in float32. This script renders the same
kind of pixels (an 800 x 800 view of a drawn scene, at the published
widths) through K2's plain tile body (``kernels.ref.mip_two_pass_ref``)
three ways: with plain f32 products, and with the products K2 forms on the
tensor cores modelled by ``kernels.ref.tf32x3_matmul``, rounded to nearest
and rounded toward zero. It prints each one's ``err_ratio`` and the
float32 floor (``err_mean_f32``).

    PYTHONPATH=src python scripts/mip_err_emulation.py --seeds 1,2,3 \\
        --pixels 256

Minutes a seed: the model of the tensor cores forms each k step's sums
one by one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from repro_torch.kernels import ops, ref  # noqa: E402

WAYS = {"f32": torch.matmul,
        "3xtf32_nearest": lambda a, b: ref.tf32x3_matmul(a, b,
                                                         truncate=False),
        "3xtf32_truncate": ref.tf32x3_matmul}


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def one_seed(cfg: dict, bref, system, seed: int, n_pixels: int) -> dict:
    rng = np.random.default_rng(seed)
    hw = 800
    theta = float(rng.uniform(0.0, 360.0))
    phi = float(rng.uniform(-35.0, -15.0))
    pixels = rng.choice(hw * hw, n_pixels, replace=False)
    o, d, r = bref.pixel_rays(theta, phi, 4.0, hw, pixels)
    net = bref.draw(cfg, seed, 0, "cpu")
    want = bref.render(cfg, net, o, d, r, precision="f64").numpy()
    floor = bref.render(cfg, net, o, d, r, precision="f32").double().numpy()
    f32 = float(np.abs(floor - want).mean())
    mc = system.mip_config(cfg)
    packed = ops.kernel_weights(mc, system.port_params(cfg, net))
    t_row, u_row = ops.mip_sample_rows(mc, "cpu")
    rays = torch.from_numpy(np.concatenate([o, d, r[:, None]], 1)).float()
    out = {"seed": seed, "theta": theta, "phi": phi, "pixels": n_pixels,
           "err_mean_f32": f32}
    for name, mm in WAYS.items():
        with torch.no_grad():
            got = ref.mip_two_pass_ref(mc, packed, rays, t_row, u_row, rt=16,
                                       white_bkgd=True, mm=mm)[0]
        err = float(np.abs(got.double().numpy() - want).mean())
        out[name] = {"err_mean": err, "err_ratio": err / f32}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--pixels", type=int, default=256)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = json.loads((ROOT / "bench/configs/mipnerf-icarus-f32.json")
                     .read_text())
    bref = _module(ROOT / cfg["reference"], "mip_reference")
    system = _module(ROOT / cfg["system"], "mip_system")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(one_seed(cfg, bref, system, seed, args.pixels)),
              flush=True)


if __name__ == "__main__":
    main()
