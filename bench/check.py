"""What decides ``correct``: the views the window delivered, held to the
plain reference that the configuration names (``ref``, its module).

Every view sent in the window has to come back delivered
(``undelivered``, limit 0). Of each delivered view a sample of its
pixels, drawn from the seed, is kept before the program's state is freed:
at least ``MIN_PER_VIEW`` pixels of every view (all of a smaller one) and
about ``SAMPLE_RAYS`` in all, so the largest view is always in it. The
reference renders each sampled pixel from its own view's pose and scene
twice: in float64, the answer, and in plain float32, the floor that any
float32 render of that scene stands on. The compared number is
``err_ratio``: the program's mean absolute gap to the float64 pixels
over the float32 reference's. A scene's float32 floor moves from seed to
seed by more than ten times (the resample turns the rounding of the
coarse weights into moved fine samples, more in some scenes than in
others); the ratio does not. A pixel scattered into another view or to
another place, a tile rendered wrong, or a lower precision in the
program raise it; its limit is in the configuration's file, under
``correct``. The gaps themselves (``err_mean``, ``err_max``) are
reported beside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

SAMPLE_RAYS = 131072
MIN_PER_VIEW = 64
REF_BLOCK = 2048
#: the float32 floor below which a scene counts as rendering exactly
FLOOR = 1e-8


@dataclass
class Pick:
    view: object          # traffic.View
    pixels: np.ndarray    # row-major pixel indices
    got: np.ndarray       # (k, 3) float32, the program's pixels


def pick(sent: list, completed: Dict[int, object], seed: int,
         budget: int = SAMPLE_RAYS):
    """(picks, undelivered): the sampled pixels of every delivered view
    sent in the window, and how many views sent in it were not
    delivered."""
    done = [(s, completed[s.rid]) for s in sent
            if s.rid in completed and completed[s.rid].delivered]
    per = max(MIN_PER_VIEW, budget // max(1, len(done)))
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    picks = []
    for s, res in done:
        n = s.view.hw * s.view.hw
        pixels = np.sort(rng.choice(n, min(n, per), replace=False))
        picks.append(Pick(s.view, pixels,
                          np.asarray(res.image).reshape(n, 3)[pixels].copy()))
    return picks, len(sent) - len(done)


def render_picks(ref, cfg: dict, picks: List[Pick],
                 weights: Dict[int, dict],
                 precision: str = "f64") -> np.ndarray:
    """The reference's pixels (sum of k, 3) for the picks, in their order;
    ``ref``: the reference module; ``weights``: scene index -> the drawn
    input. The rays of one scene's picks go to ``ref.render`` together,
    each of ``ref.pixel_rays``' arrays joined over the views."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = [None] * len(picks)
    for scene in sorted({p.view.scene for p in picks}):
        mine = [i for i, p in enumerate(picks) if p.view.scene == scene]
        rays = [ref.pixel_rays(picks[i].view.theta, picks[i].view.phi,
                               picks[i].view.radius, picks[i].view.hw,
                               picks[i].pixels) for i in mine]
        served = ref.served_weights(cfg, weights[scene])
        rgb = ref.render(cfg, served,
                         *[np.concatenate(parts) for parts in zip(*rays)],
                         precision=precision, block=REF_BLOCK)
        rgb = rgb.double().cpu().numpy()
        off = 0
        for i in mine:
            k = len(picks[i].pixels)
            out[i] = rgb[off:off + k]
            off += k
    return np.concatenate(out) if out else np.zeros((0, 3))


def gaps(got: np.ndarray, want: np.ndarray) -> dict:
    e = np.abs(np.asarray(got, np.float64) - want)
    return {"err_mean": float(e.mean()) if e.size else 0.0,
            "err_max": float(e.max()) if e.size else 0.0}


def judge(ref, cfg: dict, picks: List[Pick], weights: Dict[int, dict],
          got: np.ndarray = None, want: np.ndarray = None) -> dict:
    """The gaps of ``got`` (default: the program's picked pixels) and of
    the float32 reference to the float64 one (``want``, rendered here if
    not given), and their ratio."""
    if got is None:
        got = (np.concatenate([p.got for p in picks]) if picks
               else np.zeros((0, 3)))
    if want is None:
        want = render_picks(ref, cfg, picks, weights)
    floor = gaps(render_picks(ref, cfg, picks, weights, precision="f32"),
                 want)
    mine = gaps(got, want)
    return {**mine, "err_mean_f32": floor["err_mean"],
            "err_ratio": mine["err_mean"] / max(floor["err_mean"], FLOOR)}


def compared(cfg: dict, undelivered: int, numbers: dict) -> dict:
    """Each compared number beside its limit: ``undelivered`` must be 0,
    ``err_ratio`` at most the configuration's limit."""
    return {"undelivered": {"value": undelivered, "limit": 0},
            "err_ratio": {"value": numbers["err_ratio"],
                          "limit": cfg["correct"]["err_ratio"]}}


def verdict(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
