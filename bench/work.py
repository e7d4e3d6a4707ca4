"""The card's published peaks, and the least time a launch could take for
the work that the configuration's reference counts (``flops_per_ray``,
``launch_bytes``): the counts are the model's, the same whatever kernel
does the work."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str):
    """The published dense peaks of the card named ``kind``, or None."""
    for entry in json.loads(PEAKS_FILE.read_text())["cards"]:
        if entry["match"] in kind:
            return entry
    return None


def least_seconds(ref, cfg: dict, rays: int, peak: dict) -> float:
    """The least time a launch over ``rays`` real rays could take: the
    larger of its FLOPs at the peak rate and its bytes at the memory's,
    as the reference module ``ref`` counts them for ``cfg``."""
    return max(ref.flops_per_ray(cfg) * rays / peak["flops_per_s"],
               ref.launch_bytes(cfg, rays) / peak["bytes_per_s"])
