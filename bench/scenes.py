"""The seed of each scene's input. A configuration's reference module
draws the scene (``draw(cfg, seed, scene, device)``) from the generator
given here, on the device, so the program and the reference get the same
values; a distinct draw stands in for a distinct trained scene."""
from __future__ import annotations

import hashlib

import torch


def generator(seed: int, scene: int, device) -> torch.Generator:
    """A generator on ``device`` seeded for the scene ``scene`` of the run
    seeded ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{int(scene)}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen
