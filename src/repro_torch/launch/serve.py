"""Serving driver, ``--mode nerf``: the ICARUS use case on the card.

Loads the model into a ``PackedPlcore`` (weights RMCM-quantized and packed
ONCE at load), then serves ``--views`` requests, one camera pose each,
rendering each image in one render call and writing it as a PPM under
``runs/``. Prints per-view wall times, rays/s, samples/s and
``weight_packs_since_load`` (0: no request re-packed weights) as JSON.

Flags: ``--kernel`` routes each pass through the fused kernel (K1,
two dispatches per render); ``--fuse-two-pass`` (with ``--kernel``) runs the
whole coarse -> importance -> fine chain as ONE kernel launch (K2);
``--rmcm`` serves 9-bit RMCM weights; ``--ert EPS`` lets rays whose
transmittance after the coarse pass is below EPS skip the fine pass;
``--full`` is the full ``NerfConfig()`` (else ``tiny()``); ``--device``
defaults to ``cuda``.

    python -m repro_torch.launch.serve --mode nerf --full --kernel \\
        --fuse-two-pass --views 3
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.nerf_icarus import CONFIG as NERF_FULL, tiny as nerf_tiny
from repro_torch.core import rmcm
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.data import rays as R
from repro_torch.kernels import ops as kops
from repro_torch.models.params import init_params


def write_ppm(path: str, img: torch.Tensor) -> None:
    """Dependency-free image writer (P6 PPM)."""
    arr = (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_model(args):
    """(cfg, PackedPlcore) for the flags: weights drawn from ``--seed``."""
    cfg = NERF_FULL if args.full else nerf_tiny()
    if args.ert > 0.0:
        cfg = replace(cfg, ert_eps=args.ert)
    if args.fuse_two_pass and not args.kernel:
        raise SystemExit("--fuse-two-pass runs the whole chain in one kernel; "
                         "it requires --kernel")
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(plcore_decls(cfg), gen, "float32")
    quant = None
    if args.rmcm:
        quant = {net: rmcm.quantize_tree(params[net])
                 for net in ("coarse", "fine")}
    engine = PackedPlcore(cfg, params, quant=quant, use_kernel=args.kernel,
                          fuse_two_pass=args.fuse_two_pass,
                          device=args.device)
    return cfg, engine


def serve_nerf(args) -> dict:
    cfg, engine = load_model(args)
    packs_at_load = kops.pack_count()
    scene = R.SCENES[args.scene]()
    H = W = args.hw
    n_rays = H * W
    n_samples = n_rays * (cfg.n_coarse + cfg.n_coarse + cfg.n_fine)
    views = []
    for v in range(args.views):
        theta = args.theta + 360.0 * v / args.views
        ro, rd = R.camera_rays(R.pose_spherical(theta, -25.0, scene.radius),
                               H, W, 0.9 * W)
        _sync(engine.device)
        t0 = time.perf_counter()
        img = engine.render_image(ro, rd, rays_per_batch=args.rays_per_batch)
        _sync(engine.device)
        dt = time.perf_counter() - t0
        out = Path(args.out or "runs") / f"serve_nerf_{args.scene}_v{v}.ppm"
        out.parent.mkdir(parents=True, exist_ok=True)
        write_ppm(str(out), img)
        views.append({"image": str(out), "theta": theta, "wall_s": dt,
                      "rays_per_s": n_rays / dt,
                      "samples_per_s": n_samples / dt,
                      "finite": bool(torch.isfinite(img).all()),
                      "pixel_std": float(img.std())})
    stats = {
        "device": str(engine.device),
        "device_name": (torch.cuda.get_device_name(engine.device)
                        if engine.device.type == "cuda" else "cpu"),
        "config": "full" if args.full else "tiny",
        "hw": H, "rays": n_rays, "samples": n_samples,
        "views": views,
        "rmcm": bool(args.rmcm), "kernel": bool(args.kernel),
        "pipeline": ("two_pass_fused" if args.fuse_two_pass else
                     "two_dispatch" if args.kernel else "plain"),
        "ert_eps": cfg.ert_eps,
        "weight_packs_since_load": kops.pack_count() - packs_at_load,
    }
    print(json.dumps(stats, indent=2))
    return stats


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["nerf"], default="nerf")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="blobs", choices=sorted(R.SCENES))
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--theta", type=float, default=45.0)
    ap.add_argument("--views", type=int, default=1,
                    help="requests to serve, one camera pose each")
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--rmcm", action="store_true")
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--ert", type=float, default=0.0,
                    help="early-ray-termination transmittance threshold")
    ap.add_argument("--fuse-two-pass", action="store_true",
                    help="with --kernel: the whole two-pass render in one "
                         "kernel launch")
    ap.add_argument("--out", default=None,
                    help="directory for the PPMs (default runs/)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    return serve_nerf(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
