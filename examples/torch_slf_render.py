"""Surface light field on the PLCore (paper §5.1, Fig. 13), PyTorch port.

Fits an SLF network (anisotropic-RFF PEU + MLP engine, no VRU) to the
radiance leaving an analytic sphere with plain autograd and the port's
Adam, then renders a view by intersecting camera rays with the sphere and
querying the SLF at (hit point, direction): with the exact weights, and
with RMCM 9-bit weights packed once and run through K3 (the RMCM matmul
kernel) on the card. Runs on the card by default; ``--device cpu`` runs
the plain versions.

    PYTHONPATH=src python examples/torch_slf_render.py [--steps 400]
"""
import argparse
import time
from pathlib import Path

import torch

from repro_torch.bridge import resolve_device, to_device
from repro_torch.core import mlp, rmcm, slf
from repro_torch.data import rays as R
from repro_torch.kernels import rmcm_matmul as k3
from repro_torch.launch.serve import write_ppm
from repro_torch.models.params import init_params
from repro_torch.optim.adam import AdamConfig, adam_update, opt_state_decls

RADIUS = 0.6


def surface_radiance(p, d):
    """Analytic 'photographed object': lambert + specular-ish lobes."""
    n = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-8)
    light = torch.tensor([0.57, 0.57, 0.57], device=p.device)
    lam = torch.clamp(torch.sum(n * light, -1), 0, 1)
    spec = torch.clamp(torch.sum(-d * light, -1), 0, 1) ** 8
    base = torch.stack([0.7 + 0.3 * p[..., 0], 0.4 + 0.3 * p[..., 1],
                        0.5 - 0.2 * p[..., 2]], -1)
    return torch.clamp(base * (0.25 + 0.75 * lam[..., None])
                       + 0.3 * spec[..., None], 0, 1)


def ray_sphere(ro, rd, r=RADIUS):
    b = torch.sum(ro * rd, -1)
    disc = b * b - (torch.sum(ro * ro, -1) - r * r)
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return t, disc > 0


def surface_batch(n: int, gen: torch.Generator):
    """n points on the sphere and inward-facing directions."""
    dev = gen.device
    p = torch.randn((n, 3), generator=gen, device=dev)
    p = RADIUS * p / torch.linalg.norm(p, dim=-1, keepdim=True)
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = torch.where(torch.sum(d * p, -1, keepdim=True) > 0, -d, d)
    return {"points": p, "dirs": d, "rgb": surface_radiance(p, d)}


def fit_slf(peu, decls, steps: int, gen: torch.Generator, lr: float = 3e-3,
            batch: int = 2048, log_every: int = 100):
    """Fit the SLF with plain autograd and the port's Adam; returns the
    params on the generator's device."""
    dev = gen.device
    params = to_device(init_params(decls, torch.Generator().manual_seed(0),
                                   "float32"), dev)
    opt_cfg = AdamConfig(lr=lr, warmup_steps=20, total_steps=steps,
                         weight_decay=0.0)
    opt = to_device(init_params(opt_state_decls(decls, opt_cfg),
                                torch.Generator(), "float32"), dev)
    for i in range(steps):
        leaves = {k: {n: t.requires_grad_(True) for n, t in v.items()}
                  for k, v in params.items()}
        flat = [t for v in leaves.values() for t in v.values()]
        loss = slf.slf_loss(peu, leaves, surface_batch(batch, gen))
        it = iter(torch.autograd.grad(loss, flat))
        grads = {k: {n: next(it) for n in v} for k, v in leaves.items()}
        params = {k: {n: t.detach() for n, t in v.items()}
                  for k, v in leaves.items()}
        params, opt, _ = adam_update(opt_cfg, params, grads, opt)
        if log_every and i % log_every == 0:
            print(f"  step {i:4d} loss {float(loss.detach()):.5f}")
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--hw", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_slf_render")

    gen = torch.Generator(device=dev).manual_seed(0)
    peu = slf.make_slf_peu(gen, n_features=96, device=dev)
    decls = slf.slf_decls(peu, widths=(128, 128))
    t0 = time.time()
    params = fit_slf(peu, decls, args.steps, gen)
    print(f"  trained in {time.time() - t0:.0f}s")

    # render: intersect rays, query the SLF at the hits
    c2w = R.pose_spherical(40.0, -15.0, 3.0)
    H = W = args.hw
    ro, rd = R.camera_rays(c2w, H, W, 1.4 * W)
    ro, rd = ro.reshape(-1, 3).to(dev), rd.reshape(-1, 3).to(dev)
    t, hit = ray_sphere(ro, rd)
    p = ro + t[..., None] * rd
    gt = surface_radiance(p, rd)
    quant = mlp.pack_quant(rmcm.quantize_tree(params))   # packed once
    n0 = k3.LAUNCHES["rmcm_matmul"]
    preds = {"exact": slf.slf_eval(peu, params, p, rd),
             "rmcm": slf.slf_eval(peu, params, p, rd, quant=quant)}
    k3_launches = k3.LAUNCHES["rmcm_matmul"] - n0
    Path("runs").mkdir(exist_ok=True)
    white = torch.ones_like(gt)
    write_ppm("runs/torch_slf_gt.ppm",
              torch.where(hit[:, None], gt, white).reshape(H, W, 3))
    psnr = {}
    for name, pred in preds.items():
        write_ppm(f"runs/torch_slf_{name}.ppm",
                  torch.where(hit[:, None], pred, white).reshape(H, W, 3))
        mse = float(torch.sum(torch.square(pred - gt) * hit[:, None])
                    / max(int(hit.sum()) * 3, 1))
        psnr[name] = -10 * torch.log10(torch.tensor(max(mse, 1e-12)))
        print(f"  SLF {name} hit-pixel PSNR vs analytic: "
              f"{float(psnr[name]):.2f} dB -> runs/torch_slf_{name}.ppm")
    print(f"  K3 launches for the RMCM view: {k3_launches} "
          f"({'the card' if dev.type == 'cuda' else 'none on the CPU'})")
    assert float(psnr["exact"]) > 25.0
    assert float(psnr["rmcm"]) > 25.0
    print("OK")


if __name__ == "__main__":
    main()
