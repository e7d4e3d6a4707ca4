"""Quickstart of the PyTorch port: the ICARUS PLCore pipeline in ~70 lines.

Train a tiny NeRF on a procedural scene for a couple hundred steps (with
RMCM quantization-aware training), then render a held-out view three ways
(full-precision plain path, RMCM 9-bit weights, and the fused two-pass
PLCore kernel, K2) and print the PSNRs between them. Runs on the card by
default; ``--device cpu`` runs every route's plain version.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 200] [--hw 24]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import rmcm
from repro_torch.core.nerf_train import init_nerf_state, make_nerf_train_step
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.data import rays as R
from repro_torch.optim.adam import AdamConfig


def psnr(a, b):
    return float(-10 * torch.log10(torch.clamp(torch.mean((a - b) ** 2),
                                               min=1e-12)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hw", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_quickstart")

    cfg = tiny()
    opt_cfg = AdamConfig(lr=5e-3, warmup_steps=20, total_steps=args.steps,
                         weight_decay=0.0)
    params, opt_state = init_nerf_state(
        cfg, opt_cfg, torch.Generator().manual_seed(0), device=dev)

    print("== building procedural scene + GT rays ==")
    scene = R.blob_scene()
    ds = R.make_dataset(scene, n_views=5, H=args.hw, W=args.hw,
                        focal=2.4 * args.hw, device=dev)

    print(f"== QAT training {args.steps} steps ==")
    step = make_nerf_train_step(cfg, opt_cfg, qat=True)
    batches = R.ray_batches(ds, 1024,
                            torch.Generator(device=dev).manual_seed(1))
    jitter = torch.Generator(device=dev).manual_seed(2)
    t0 = time.time()
    for i in range(args.steps):
        params, opt_state, m = step(params, opt_state, next(batches), jitter)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"  step {i:4d}  loss {float(m['loss']):.4f} "
                  f"psnr {float(m['psnr']):5.2f} dB")
    print(f"  ({time.time() - t0:.0f}s)")

    print("== rendering a held-out view 3 ways ==")
    ro, rd, gt = R.holdout_view(scene, args.hw, args.hw,
                                focal=2.4 * args.hw, device=dev)
    quant = {n: rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
    img_plain = PackedPlcore(cfg, params, device=dev).render_image(ro, rd)
    img_rmcm = PackedPlcore(cfg, params, quant=quant,
                            device=dev).render_image(ro, rd)
    img_kern = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                            device=dev).render_image(ro, rd)

    print(f"  PSNR vs GT          : {psnr(img_plain, gt):6.2f} dB")
    print(f"  PSNR exact vs RMCM  : {psnr(img_plain, img_rmcm):6.2f} dB "
          f"(paper Fig. 8: 48.24 dB at full scale)")
    print(f"  PSNR exact vs kernel: {psnr(img_plain, img_kern):6.2f} dB "
          f"(fused two-pass PLCore, K2 on {dev.type})")
    assert psnr(img_plain, img_kern) > 40.0
    print("OK")


if __name__ == "__main__":
    main()
