"""The scenes' weights, the benchmark's input: drawn from the run's seed and
the scene's index on the device, in one call per scene.

Every weight matrix is normal with standard deviation sqrt(2 / fan-in)
where a ReLU follows it (the trunk, the colour layer) and 1 / sqrt(fan-in)
elsewhere; every bias is normal with standard deviation ``BIAS_STD``
around 0, the density head's around ``DENSITY_BIAS``, so that most draws
hold opaque matter and few render as an empty, white view. A distinct
draw stands in for a distinct trained scene. The program and the
reference get the same float32 values.
"""
from __future__ import annotations

import hashlib

import torch

from bench.reference import nerf as ref

BIAS_STD = 0.1
DENSITY_BIAS = 1.0
RELU_LAYERS = ("trunk", "color0")


def scene_seed(seed: int, scene: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{int(scene)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw(cfg: dict, seed: int, scene: int, device) -> dict:
    """{"coarse", "fine"} -> {layer name: (w (in, out), b (out,))}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(scene_seed(seed, scene))
    z = torch.randn(2 * ref.param_count(cfg), generator=gen, device=device)
    nets, off = {}, 0
    for net in ("coarse", "fine"):
        lay = {}
        for name, i, o in ref.layers(cfg):
            gain = 2.0 if name.split(".")[0] in RELU_LAYERS else 1.0
            w = z[off:off + i * o].view(i, o) * (gain / i) ** 0.5
            off += i * o
            b = z[off:off + o] * BIAS_STD
            lay[name] = (w, b + DENSITY_BIAS if name == "sigma" else b)
            off += o
        nets[net] = lay
    return nets
