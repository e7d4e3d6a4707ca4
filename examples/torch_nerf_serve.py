"""End-to-end NeRF serving on the PyTorch port, the paper's deployment
scenario.

The multi-display serving modes of Fig. 1 / §1: monocular, stereo (two
eyes, HMD) and a small light-field sweep (multi-view autostereoscopic
display). The model loads once into a ``PackedPlcore`` (weights packed
once); each frame is then one render call, through K2 with ``--kernel``.
Writes PPM images under runs/serve_demo/. Runs on the card by default;
``--device cpu`` runs the plain versions.

    PYTHONPATH=src python examples/torch_nerf_serve.py --mode stereo --hw 32
"""
import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.data import rays as R
from repro_torch.launch.serve import write_ppm
from repro_torch.models.params import init_params


def eye_offset(c2w: torch.Tensor, dx: float) -> torch.Tensor:
    """Shift the camera along its right axis (stereo baseline)."""
    c2w = c2w.clone()
    c2w[:3, 3] += c2w[:3, 0] * dx
    return c2w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["mono", "stereo", "lightfield"],
                    default="stereo")
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--views", type=int, default=5)   # lightfield sweep
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--kernel", action="store_true",
                    help="render through the fused two-pass kernel (K2)")
    ap.add_argument("--ert", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_nerf_serve")

    cfg = tiny()
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0),
                         "float32")
    if args.ckpt:
        from repro_torch.checkpoint import Checkpointer
        state, _ = Checkpointer(args.ckpt).restore(device=dev)
        params = state["params"]
    engine = PackedPlcore(cfg, params, use_kernel=args.kernel,
                          fuse_two_pass=args.kernel, ert_eps=args.ert,
                          device=dev)

    scene = R.blob_scene()
    base = R.pose_spherical(30.0, -20.0, scene.radius)
    poses = {"mono": [("center", base)],
             "stereo": [("left", eye_offset(base, -0.05)),
                        ("right", eye_offset(base, +0.05))],
             "lightfield": [(f"view{i}", R.pose_spherical(
                 30.0 + 4.0 * (i - args.views // 2), -20.0, scene.radius))
                            for i in range(args.views)]}[args.mode]

    outdir = Path("runs/serve_demo")
    outdir.mkdir(parents=True, exist_ok=True)
    H = W = args.hw
    stats = []
    for name, c2w in poses:
        ro, rd = R.camera_rays(c2w, H, W, 0.9 * W)
        t0 = time.time()
        img = engine.render_image(ro, rd, rays_per_batch=4096)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        path = outdir / f"torch_{args.mode}_{name}.ppm"
        write_ppm(str(path), img)
        stats.append({"view": name, "s": round(dt, 4),
                      "rays_per_s": round(H * W / dt)})
        print(f"  {name}: {dt:.4f}s -> {path}")
    print(json.dumps({"mode": args.mode, "device": str(dev),
                      "frames": stats}))


if __name__ == "__main__":
    main()
