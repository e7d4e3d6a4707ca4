"""The work the model asks for, counted from the configuration alone, and the
card's published peaks.

Model FLOPs per ray: 2 x (one network's weights) x (sample evaluations:
``n_coarse`` by the coarse network, ``n_coarse + n_fine`` by the fine one).
Biases, encodings, the resample and the VRU are left out, and so are the
padding and any product an implementation splits or repeats: the count is
the same whatever kernel does the work.

Bytes per launch: each ray's inputs (origin, direction) and outputs (rgb,
coarse rgb, acc, coarse acc, depth) once, and the launch's weights once:
4 bytes per float32 weight, 2 per RMCM weight (the two exact heads and the
biases at 4).
"""
from __future__ import annotations

import json
from pathlib import Path

from bench.reference import nerf as ref

RAY_IN_BYTES = 6 * 4
RAY_OUT_BYTES = 9 * 4
PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def samples_per_ray(cfg: dict) -> int:
    """Sample evaluations per ray: the coarse set by the coarse network,
    then the coarse and fine sets by the fine one (``serve`` counts energy
    per sample so)."""
    return 2 * cfg["n_coarse"] + cfg["n_fine"]


def flops_per_ray(cfg: dict) -> int:
    return 2 * ref.weight_count(cfg) * samples_per_ray(cfg)


def weight_bytes(cfg: dict) -> int:
    """Both networks' weights and biases as one launch reads them once."""
    total = 0
    for name, i, o in ref.layers(cfg):
        quantized = (cfg["weights"] == "rmcm"
                     and name.split(".")[0] in ref.RMCM_LAYERS)
        total += i * o * (2 if quantized else 4) + 4 * o
    return 2 * total


def launch_bytes(cfg: dict, rays: int) -> int:
    return rays * (RAY_IN_BYTES + RAY_OUT_BYTES) + weight_bytes(cfg)


def peaks(kind: str):
    """The published dense peaks of the card named ``kind``, or None."""
    for entry in json.loads(PEAKS_FILE.read_text())["cards"]:
        if entry["match"] in kind:
            return entry
    return None


def least_seconds(cfg: dict, rays: int, peak: dict) -> float:
    """The least time a launch over ``rays`` real rays could take: the
    larger of its FLOPs at the peak rate and its bytes at the memory's."""
    return max(flops_per_ray(cfg) * rays / peak["flops_per_s"],
               launch_bytes(cfg, rays) / peak["bytes_per_s"])
