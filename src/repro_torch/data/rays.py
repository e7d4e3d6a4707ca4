"""Cameras, rays and the procedural analytic scenes.

Conventions: OpenGL-style camera (looks down -z), c2w 4x4 pose matrices,
rays returned as origins + unit directions. Scenes are analytic volumes
(Gaussian emission blobs, a solid sphere) with density and color fields.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> torch.Tensor:
    """c2w for a camera on a sphere looking at the origin."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    cam_pos = np.array([radius * math.cos(ph) * math.sin(th),
                        radius * math.sin(ph),
                        radius * math.cos(ph) * math.cos(th)], np.float32)
    fwd = -cam_pos / np.linalg.norm(cam_pos)               # look at origin
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-8)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, cam_pos
    return torch.from_numpy(c2w)


def camera_rays(c2w: torch.Tensor, H: int, W: int, focal: float):
    """Pixel-center rays. Returns (rays_o (H,W,3), rays_d (H,W,3) unit)."""
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32) + 0.5,
                          torch.arange(H, dtype=torch.float32) + 0.5,
                          indexing="xy")
    dirs = torch.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                        -torch.ones_like(i)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape).contiguous()
    return rays_o, rays_d


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
        d2 = torch.sum((pts[..., None, :] - centers) ** 2, dim=-1)
        return torch.sum(amps * torch.exp(-0.5 * d2 / scales ** 2), dim=-1)

    def color(pts, dirs):
        d2 = torch.sum((pts[..., None, :] - centers) ** 2, dim=-1)
        w = amps * torch.exp(-0.5 * d2 / scales ** 2) + 1e-8
        base = (w[..., None] * colors).sum(-2) / w.sum(-1, keepdim=True)
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
        lam = torch.clamp((n * torch.tensor([0.57, 0.57, 0.57])).sum(-1), 0, 1)
        base = torch.tensor([0.8, 0.3, 0.2])
        return torch.clamp(base * (0.3 + 0.7 * lam[..., None]), 0.0, 1.0)

    return Scene("sphere", density, color, near=2.5, far=5.5)


SCENES = {"blobs": blob_scene, "sphere": sphere_scene}
