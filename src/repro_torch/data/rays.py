"""Cameras, rays, the procedural analytic scenes and their ray datasets.

Conventions: OpenGL-style camera (looks down -z), c2w 4x4 pose matrices,
rays returned as origins + unit directions. Scenes are analytic volumes
(Gaussian emission blobs, a solid sphere) with density and color fields;
``render_gt`` ray-marches them densely through the same VRU math as the
model, so a NeRF trained on ``make_dataset``'s rays fits a known
plenoptic function and its PSNR against ground truth means something.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.core import sampling, volume


def pose_spherical(theta_deg: float, phi_deg: float, radius: float,
                   dtype=np.float32) -> torch.Tensor:
    """c2w for a camera on a sphere looking at the origin, computed in
    ``dtype``."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    cam_pos = np.array([radius * math.cos(ph) * math.sin(th),
                        radius * math.sin(ph),
                        radius * math.cos(ph) * math.cos(th)], dtype)
    fwd = -cam_pos / np.linalg.norm(cam_pos)               # look at origin
    up = np.array([0.0, 1.0, 0.0], dtype)
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-8)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=dtype)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, cam_pos
    return torch.from_numpy(c2w)


def camera_rays(c2w: torch.Tensor, H: int, W: int, focal: float,
                unit: bool = True):
    """Pixel-center rays in ``c2w``'s dtype. Returns (rays_o (H,W,3),
    rays_d (H,W,3)): unit directions, or with ``unit=False`` the camera's
    z = -1 directions unnormalised."""
    i, j = torch.meshgrid(torch.arange(W, dtype=c2w.dtype) + 0.5,
                          torch.arange(H, dtype=c2w.dtype) + 0.5,
                          indexing="xy")
    dirs = torch.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                        -torch.ones_like(i)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    if unit:
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape).contiguous()
    return rays_o, rays_d


def nerf_view_rays(theta: float, phi: float, radius: float, hw: int):
    """A served view's per-ray columns for NeRF: (origins, unit
    directions), each (hw * hw, 3) float32, row-major pixels, focal 0.9 x
    the view's side."""
    ro, rd = camera_rays(pose_spherical(theta, phi, radius), hw, hw,
                         0.9 * hw)
    return (ro.numpy().astype(np.float32).reshape(-1, 3),
            rd.numpy().astype(np.float32).reshape(-1, 3))


def mip_view_rays(theta: float, phi: float, radius: float, hw: int):
    """A served view's per-ray columns for Mip-NeRF's cones: (origins (n,
    3), directions with camera z = -1, unnormalised (n, 3), base radii (n,
    1)), float32, row-major pixel centres, focal f = 0.9 x the view's side,
    ``pose_spherical``'s camera. A cone's base radius is 2 / (sqrt(12) f):
    the spacing of neighbouring pixels' directions, 1 / f, times
    2 / sqrt(12), which mip-NeRF's Blender loader computes from the
    directions themselves. The camera is evaluated in float64 and rounded
    once: the encoding's highest degrees turn a last-ulp error of a
    direction into a visible phase error."""
    f = 0.9 * hw
    ro, rd = camera_rays(pose_spherical(theta, phi, radius, np.float64), hw,
                         hw, f, unit=False)
    n = hw * hw
    return (ro.reshape(n, 3).float().numpy(), rd.reshape(n, 3).float().numpy(),
            np.full((n, 1), 2.0 / (math.sqrt(12.0) * f), np.float32))


@dataclass(frozen=True)
class Scene:
    name: str
    density: Callable  # pts (..., 3) -> sigma (...,)
    color: Callable    # (pts (..., 3), dirs (..., 3)) -> rgb (..., 3)
    near: float = 2.0
    far: float = 6.0
    radius: float = 4.0


def blob_scene(n_blobs: int = 5, seed: int = 0, view_dep: float = 0.15) -> Scene:
    """Gaussian emission blobs with mildly view-dependent colors."""
    rng = np.random.RandomState(seed)
    centers = torch.as_tensor(rng.uniform(-0.7, 0.7, (n_blobs, 3)), dtype=torch.float32)
    colors = torch.as_tensor(rng.uniform(0.2, 1.0, (n_blobs, 3)), dtype=torch.float32)
    scales = torch.as_tensor(rng.uniform(0.12, 0.3, (n_blobs,)), dtype=torch.float32)
    amps = torch.as_tensor(rng.uniform(8.0, 20.0, (n_blobs,)), dtype=torch.float32)

    def density(pts):
        c, a, s = (x.to(pts.device) for x in (centers, amps, scales))
        d2 = torch.sum((pts[..., None, :] - c) ** 2, dim=-1)
        return torch.sum(a * torch.exp(-0.5 * d2 / s ** 2), dim=-1)

    def color(pts, dirs):
        c, a, s = (x.to(pts.device) for x in (centers, amps, scales))
        d2 = torch.sum((pts[..., None, :] - c) ** 2, dim=-1)
        w = a * torch.exp(-0.5 * d2 / s ** 2) + 1e-8
        base = ((w[..., None] * colors.to(pts.device)).sum(-2)
                / w.sum(-1, keepdim=True))
        tint = 0.5 * (dirs + 1.0)
        return torch.clamp(base * (1 - view_dep) + tint * view_dep, 0.0, 1.0)

    return Scene("blobs", density, color)


def sphere_scene(radius: float = 0.6, sharp: float = 40.0) -> Scene:
    """Solid matte sphere (hard surface — stresses importance sampling)."""
    def density(pts):
        r = torch.linalg.norm(pts, dim=-1)
        return 50.0 * torch.sigmoid(sharp * (radius - r))

    def color(pts, dirs):
        n = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), min=1e-8)
        lam = torch.clamp((n * torch.tensor([0.57, 0.57, 0.57],
                                            device=pts.device)).sum(-1), 0, 1)
        base = torch.tensor([0.8, 0.3, 0.2], device=pts.device)
        return torch.clamp(base * (0.3 + 0.7 * lam[..., None]), 0.0, 1.0)

    return Scene("sphere", density, color, near=2.5, far=5.5)


SCENES = {"blobs": blob_scene, "sphere": sphere_scene}


# ------------------------------------------------------- GT ray-marching ----
def render_gt(scene: Scene, rays_o, rays_d, n_samples: int = 256,
              white_bkgd: bool = True) -> torch.Tensor:
    """Dense-march the analytic fields at the bin midpoints (no
    generator, so deterministic): the ground-truth 'photograph'."""
    t = sampling.stratified(scene.near, scene.far, n_samples,
                            rays_o.shape[:-1], device=rays_o.device)
    pts = rays_o[..., None, :] + t[..., None] * rays_d[..., None, :]
    sig = scene.density(pts)
    dirs = torch.broadcast_to(rays_d[..., None, :], pts.shape)
    rgb = scene.color(pts, dirs)
    out, aux = volume.render_parallel(sig, rgb, sampling.deltas_from_t(t))
    if white_bkgd:
        out = volume.white_background(out, aux["acc"])
    return out


def make_dataset(scene: Scene, n_views: int, H: int, W: int,
                 focal: float | None = None, chunk: int = 8192,
                 device=None) -> dict:
    """Render ``n_views`` ground-truth images on a camera orbit, in chunks
    of ``chunk`` rays on ``device`` (default the card), and flatten them
    to a ray dataset {rays_o, rays_d, rgb} with leading dim n_views*H*W."""
    dev = resolve_device(device, "make_dataset")
    focal = focal or 0.9 * W
    oL, dL, cL = [], [], []
    for v in range(n_views):
        theta = 360.0 * v / n_views
        phi = -25.0 + 15.0 * math.sin(2 * math.pi * v / n_views)
        ro, rd = camera_rays(pose_spherical(theta, phi, scene.radius), H, W,
                             focal)
        ro, rd = ro.reshape(-1, 3).to(dev), rd.reshape(-1, 3).to(dev)
        rgb = torch.cat([render_gt(scene, ro[i:i + chunk], rd[i:i + chunk])
                         for i in range(0, ro.shape[0], chunk)])
        oL.append(ro), dL.append(rd), cL.append(rgb)
    return {"rays_o": torch.cat(oL), "rays_d": torch.cat(dL),
            "rgb": torch.cat(cL)}


def ray_batches(dataset: dict, batch_size: int,
                generator: torch.Generator) -> Iterator[dict]:
    """Infinite ray batches, indices drawn uniformly with replacement from
    ``generator`` (on the generator's device, then moved to the data's)."""
    n = dataset["rays_o"].shape[0]
    dev = dataset["rays_o"].device
    while True:
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=generator.device).to(dev)
        yield {k: v[idx] for k, v in dataset.items()}


def holdout_view(scene: Scene, H: int, W: int, focal: float | None = None,
                 theta: float = 33.0, phi: float = -20.0, device=None):
    """A view NOT on the training orbit, for eval PSNR: (rays_o, rays_d,
    gt), each (H, W, 3) on ``device`` (default the card)."""
    dev = resolve_device(device, "holdout_view")
    focal = focal or 0.9 * W
    ro, rd = camera_rays(pose_spherical(theta, phi, scene.radius), H, W,
                         focal)
    ro, rd = ro.to(dev), rd.to(dev)
    gt = render_gt(scene, ro.reshape(-1, 3), rd.reshape(-1, 3))
    return ro, rd, gt.reshape(H, W, 3)
