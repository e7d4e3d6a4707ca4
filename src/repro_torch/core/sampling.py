"""Ray sampling — the paper's two-pass strategy (§5.1).

``stratified`` places the coarse samples (bin midpoints in inference mode,
jittered with a ``torch.Generator`` in training mode); ``importance``
resamples the fine set by inverse CDF over the coarse weights. The
deterministic forms ``importance_det`` and ``merge_sorted_ranks`` are the
ones the fused two-pass kernel computes per ray (a binary search and a
merge of two sorted lists); here they are written with ``searchsorted``,
which gives the same values as the reference's comparison counts.

Both grids are ``_linspace0``, which reproduces the reference's float32
grid bit for bit (``torch.linspace`` rounds some points differently).

The ASDR host layer (adaptive per-ray sample budgets and the cross-ray
trunk memo) closes the module: ``default_budget_classes``,
``SampleStats``, ``build_sample_stats``, ``TrunkMemo`` and ``SceneAux``.
It is numpy bookkeeping, a copy of the reference's that gives the same
bits on the same inputs; the device side is ``core.pipeline``'s.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _linspace0(stop: float, n: int, device=None) -> torch.Tensor:
    """``n`` evenly spaced float32 points from 0 to ``stop``, rounded as
    the reference's compiled ``jnp.linspace(0.0, stop, n)`` rounds them:
    its compiler turns ``stop * (i / (n - 1))`` into
    ``i * (stop * f32(1 / (n - 1)))``, each product rounded to float32,
    and the last point is ``stop`` itself."""
    f32 = torch.float32
    if n < 2:
        return torch.zeros(n, dtype=f32, device=device)
    one = torch.ones((), dtype=f32, device=device)
    step = torch.tensor(stop, dtype=f32, device=device) * (one / (n - 1))
    i = torch.arange(n - 1, dtype=f32, device=device)
    return torch.cat([i * step, torch.tensor([stop], dtype=f32,
                                             device=device)])


def stratified(near: float, far: float, n: int, shape=(),
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """Jittered-uniform samples (bin midpoints without a generator).
    Returns t: (*shape, n), sorted ascending."""
    edges = _linspace0(1.0, n + 1, device)
    lo, hi = edges[:-1], edges[1:]
    if generator is not None:
        u = torch.rand(tuple(shape) + (n,), generator=generator,
                       device=device)
    else:
        u = 0.5
    s = torch.broadcast_to(lo + (hi - lo) * u, tuple(shape) + (n,))
    return near + (far - near) * s


def det_u(n: int, device=None) -> torch.Tensor:
    """The deterministic (inference-mode) u-grid, shared by the host sampler
    and the fused kernel's in-block resampler."""
    return _linspace0(1.0 - 1e-6, n, device)


def _weights_to_cdf(weights, eps: float = 1e-5):
    """Coarse weights (..., M) -> CDF over the M-1 interior bins (..., M-1);
    the edge weights are dropped, as NeRF does."""
    w = weights[..., 1:-1] + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def _invert_cdf(t_mid, cdf, u):
    # searchsorted(side="right") is the count of CDF entries <= u
    M1 = cdf.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                         right=True) - 1, 0, M1 - 2)
    cdf_lo = torch.gather(cdf, -1, idx)
    cdf_hi = torch.gather(cdf, -1, idx + 1)
    t_lo = torch.gather(t_mid[..., :-1], -1, idx)
    t_hi = torch.gather(t_mid[..., 1:], -1, idx)
    denom = torch.where(cdf_hi - cdf_lo < 1e-8, torch.ones_like(cdf_lo),
                        cdf_hi - cdf_lo)
    frac = (u - cdf_lo) / denom
    return t_lo + frac * (t_hi - t_lo)


def importance(t_mid, weights, n: int,
               generator: Optional[torch.Generator] = None,
               eps: float = 1e-5):
    """Inverse-CDF sampling from the piecewise-constant pdf over the gaps
    between the coarse positions ``t_mid`` (..., M). Returns (..., n)."""
    cdf = _weights_to_cdf(weights, eps)
    shape = cdf.shape[:-1] + (n,)
    if generator is not None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    else:
        u = torch.broadcast_to(det_u(n, cdf.device), shape)
    return _invert_cdf(t_mid, cdf, u)


def importance_det(t_mid, weights, n: int, eps: float = 1e-5,
                   u_row: Optional[torch.Tensor] = None):
    """The deterministic inverse CDF the fused kernel runs: the u-grid is
    ``det_u`` (or a prebuilt ``u_row`` of it, (n,)) and the bin is found by
    binary search (the count of CDF entries <= u), clipped to [0, M-3].
    Equal to ``importance`` without a generator, value for value."""
    cdf = _weights_to_cdf(weights, eps)
    if u_row is None:
        u_row = det_u(n, cdf.device)
    u = torch.broadcast_to(u_row, cdf.shape[:-1] + (n,))
    return _invert_cdf(t_mid, cdf, u)


def merge_sorted(t_a, t_b):
    """Union of two sample sets along a ray, sorted (coarse + fine pass)."""
    return torch.sort(torch.cat([t_a, t_b], dim=-1), dim=-1).values


def merge_sorted_ranks(t_a, t_b):
    """Merge of two already-sorted sets: each element lands at its own index
    plus the count of the OTHER set's elements before it, ties going to
    ``t_a`` (the coarse sample). Same values as ``merge_sorted``."""
    na, nb = t_a.shape[-1], t_b.shape[-1]
    t_a, t_b = t_a.contiguous(), t_b.contiguous()
    ia = torch.arange(na, device=t_a.device)
    ib = torch.arange(nb, device=t_b.device)
    rank_a = ia + torch.searchsorted(t_b, t_a, right=False)   # b <  a
    rank_b = ib + torch.searchsorted(t_a, t_b, right=True)    # a <= b
    out = torch.empty(t_a.shape[:-1] + (na + nb,), dtype=t_a.dtype,
                      device=t_a.device)
    out.scatter_(-1, rank_a, t_a)
    out.scatter_(-1, rank_b, t_b)
    return out


def deltas_from_t(t, far_cap: float = 1e10):
    """delta_i = t_{i+1} - t_i, the last one capped (paper eq. (4) note)."""
    d = t[..., 1:] - t[..., :-1]
    return torch.cat([d, torch.full_like(t[..., :1], far_cap)], dim=-1)



# ------------------------------------------------------ Mip-NeRF resample --
#: the last point of Mip-NeRF's deterministic CDF grid: 1 - float32 eps
MIP_U_END = 1.0 - 2.0 ** -23


def mip_u(n: int, device=None) -> torch.Tensor:
    """Mip-NeRF's deterministic resample grid, ``linspace(0, 1 - 2^-23,
    n)`` in float32 (rounded as ``_linspace0``)."""
    return _linspace0(MIP_U_END, n, device)


def mip_edges(near: float, far: float, n: int, device=None) -> torch.Tensor:
    """Mip-NeRF's ``n`` coarse edges (``sample_along_rays``, not jittered,
    not in disparity): near (1 - s) + far s at s = linspace(0, 1, n), in
    float32 (s rounded as ``_linspace0``)."""
    s = _linspace0(1.0, n, device)
    return near * (1.0 - s) + far * s


def mip_resample(t_edges, weights, padding: float,
                 u_row: Optional[torch.Tensor] = None):
    """Mip-NeRF's fine edges (``internal/mip.py`` ``resample_along_rays``
    and ``sorted_piecewise_constant_pdf``, deterministic): the coarse
    weights (..., N) blurred by neighbour maxima (each weight the mean of
    the maxima with its two neighbours, the ends repeated), plus
    ``padding``; a pdf over the N intervals of ``t_edges`` (..., N + 1)
    and its CDF (0, the cumulative sums of the first N - 1, 1), inverted at
    the N + 1 points of ``u_row`` (default ``mip_u``). Each point falls in
    the last interval whose CDF start is <= it (``find_interval``); the
    sums run left to right, as the fused kernel adds them. No union with
    the coarse edges. Returns (..., N + 1)."""
    w_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    w_max = torch.maximum(w_pad[..., :-1], w_pad[..., 1:])
    w = 0.5 * (w_max[..., :-1] + w_max[..., 1:]) + padding
    n = w.shape[-1]
    w_sum = torch.cumsum(w, dim=-1)[..., -1:]
    pad = torch.clamp(1e-5 - w_sum, min=0.0)
    w = w + pad / n
    w_sum = w_sum + pad
    cdf = torch.clamp(torch.cumsum((w / w_sum)[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)
    if u_row is None:
        u_row = mip_u(n + 1, cdf.device).to(cdf.dtype)
    u = torch.broadcast_to(u_row, cdf.shape[:-1] + (u_row.shape[-1],))
    t_edges = torch.broadcast_to(t_edges, cdf.shape)
    i0 = torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                        right=True) - 1, 0, n)
    i1 = torch.clamp(i0 + 1, max=n)
    c0, c1 = cdf.gather(-1, i0), cdf.gather(-1, i1)
    b0, b1 = t_edges.gather(-1, i0), t_edges.gather(-1, i1)
    frac = torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0)
    return b0 + torch.clamp(frac, 0.0, 1.0) * (b1 - b0)


# ===================================================================== ASDR =
# Adaptive per-ray sample budgets + cross-ray trunk memoization. A cheap
# coarse-only probe at scene load calibrates a quantized-voxel density
# grid (``SampleStats``); at serve time each ray is classified into a
# fine-sample budget class from the stats along its frustum, and trunk
# outputs (sigma|feat — the position-only, view-independent half of the
# MLP engine) are memoized per voxel in a scene-keyed LRU (``TrunkMemo``)
# so rays from ANY viewpoint crossing already-probed voxels reuse them.
# Everything here is host-side bookkeeping (numpy); the device-side use
# lives in core.pipeline (AdaptiveRenderer) and kernels/ (dead-row mask).

def default_budget_classes(n_fine: int) -> Tuple[int, ...]:
    """The canonical budget ladder for a config: e.g. Nf=128 -> (8, 32, 64),
    the tiny Nf=16 test config -> (4, 8, 16). Sorted ascending, capped at
    n_fine, the top class always present so dense rays keep a real budget."""
    raw = (max(4, n_fine // 16), max(8, n_fine // 4), max(16, n_fine // 2))
    return tuple(sorted({min(n_fine, b) for b in raw}))


@dataclass
class SampleStats:
    """Per-scene quantized-voxel density statistics from the load-time
    coarse probe. ``grid`` holds the max coarse-trunk sigma observed per
    voxel (dense (G,G,G) f32 — a few hundred KB at G=48); ``edges`` are
    the per-scene score quantiles that split rays into budget classes.

    Rays are scored by the max grid value along their coarse frustum
    samples; empty-space rays score ~0 and land in the smallest budget
    class. ``empty_tau``: below this sigma a voxel is considered empty —
    a ray whose frustum is fully memo-resident AND fully empty can skip
    the fine pass entirely (it becomes a dead row in the fused kernel).
    """
    lo: np.ndarray                  # (3,) grid lower corner
    vsize: float                    # cubic voxel edge length
    grid: np.ndarray                # (G, G, G) f32, max sigma per voxel
    edges: np.ndarray               # (n_classes - 1,) score thresholds
    probed: np.ndarray              # (G, G, G) bool, voxel seen by probe
    empty_tau: float = 1e-2

    @property
    def res(self) -> int:
        return self.grid.shape[0]

    @property
    def nbytes(self) -> int:
        return int(self.grid.nbytes + self.probed.nbytes
                   + self.edges.nbytes + self.lo.nbytes)

    def voxel_ids(self, pts: np.ndarray) -> np.ndarray:
        """Points (..., 3) -> flat voxel ids (...,). Out-of-grid points
        clamp to the boundary shell (conservative: boundary voxels carry
        whatever the probe saw there)."""
        G = self.res
        ijk = np.floor((pts - self.lo) / self.vsize).astype(np.int64)
        ijk = np.clip(ijk, 0, G - 1)
        return (ijk[..., 0] * G + ijk[..., 1]) * G + ijk[..., 2]

    def voxel_centers(self, vox: np.ndarray) -> np.ndarray:
        """Flat voxel ids (...,) -> center positions (..., 3) — the
        quantized coarse sample positions the trunk memo is keyed on."""
        G = self.res
        k = vox % G
        j = (vox // G) % G
        i = vox // (G * G)
        ijk = np.stack([i, j, k], axis=-1).astype(np.float32)
        return self.lo + (ijk + 0.5) * self.vsize

    def ray_scores(self, pts: np.ndarray) -> np.ndarray:
        """Coarse sample points (R, N, 3) -> per-ray density score (R,):
        max calibrated sigma over the frustum's voxels."""
        flat = self.grid.reshape(-1)[self.voxel_ids(pts)]
        return flat.max(axis=-1)

    def classify(self, pts: np.ndarray,
                 budgets: Sequence[int]) -> np.ndarray:
        """Coarse sample points (R, N, 3) -> budget-class index (R,) into
        ``budgets`` (ascending). Scores past the last edge take the top
        class; with k classes only the first k-1 edges apply."""
        n = len(budgets)
        if n == 1:
            return np.zeros(pts.shape[0], dtype=np.int64)
        edges = self.edges[:n - 1]
        return np.minimum(np.digitize(self.ray_scores(pts), edges), n - 1)

    def empty_mask(self, vox: np.ndarray) -> np.ndarray:
        """Per-ray (R, N) voxel ids -> (R,) bool: every frustum voxel was
        probed AND reads below empty_tau (provably-empty ray)."""
        flat_g = self.grid.reshape(-1)[vox]
        flat_p = self.probed.reshape(-1)[vox]
        return (flat_p & (flat_g < self.empty_tau)).all(axis=-1)


def build_sample_stats(pts: np.ndarray, sigma: np.ndarray, *,
                       grid_res: int = 48, n_classes: int = 3,
                       empty_tau: float = 1e-2,
                       margin: float = 0.5) -> SampleStats:
    """Accumulate probe samples into a SampleStats record.

    pts: (M, N, 3) coarse sample positions of the probe rays; sigma:
    (M, N) raw trunk densities at those points. The grid bounds cover the
    probe cloud plus ``margin`` so serve-time rays from unseen viewpoints
    still land inside. The first budget-class edge is anchored at
    ``empty_tau`` so the smallest class is exactly the empty-space band
    (where the memo's dead-row machinery applies); the remaining edges
    are quantiles of the NON-empty probe scores — on a scene with both
    empty and dense regions every class is exercised by construction
    (plain all-score quantiles collapse to 0 on mostly-empty scenes,
    which would make the middle classes unreachable)."""
    flat = pts.reshape(-1, 3)
    lo = flat.min(axis=0) - margin
    hi = flat.max(axis=0) + margin
    vsize = float((hi - lo).max() / grid_res)
    stats = SampleStats(lo=lo.astype(np.float32), vsize=vsize,
                        grid=np.zeros((grid_res,) * 3, np.float32),
                        edges=np.zeros(max(0, n_classes - 1), np.float32),
                        probed=np.zeros((grid_res,) * 3, bool),
                        empty_tau=empty_tau)
    vox = stats.voxel_ids(flat)
    sig = np.maximum(np.asarray(sigma, np.float32).reshape(-1), 0.0)
    np.maximum.at(stats.grid.reshape(-1), vox, sig)
    stats.probed.reshape(-1)[vox] = True
    scores = stats.ray_scores(pts)
    if n_classes > 1:
        dense = scores[scores >= empty_tau]
        # mid edges sit in the BOTTOM half of the dense-score
        # distribution: only the faintest non-empty rays take reduced
        # budgets, everything from the median up renders at full n_fine.
        # Accuracy-first classing — a median split costs ~0.2 dB on a
        # dense trained scene, past the fig8 adaptive PSNR gate (0.1 dB)
        qs = np.linspace(0.0, 1.0, n_classes)[1:-1] * 0.5
        mid = (np.quantile(dense, qs) if dense.size
               else np.full(max(0, n_classes - 2), empty_tau))
        stats.edges = np.concatenate(
            [[empty_tau], np.maximum(np.atleast_1d(mid), empty_tau)]
        ).astype(np.float32)
    return stats


class TrunkMemo:
    """Scene-keyed LRU memo of trunk-MLP outputs.

    key: (namespace, voxel_id) — namespace separates the coarse and fine
    networks; value: one f32 row ``sigma|feat`` (1 + trunk_width,)
    evaluated at the voxel center. Capacity is byte-accounted against
    ``capacity_mb`` with LRU eviction; rows pinned by in-flight tiles are
    skipped by the evictor (a tile that resolved its lookups must not
    lose them mid-dispatch)."""

    def __init__(self, capacity_mb: float = 32.0):
        self.capacity_bytes = int(capacity_mb * 2 ** 20)
        # LRU bookkeeping: key -> storage slot. Row PAYLOADS live in the
        # per-net slot table ``_data`` so the hot serving-path lookup is
        # one vectorized gather (``_data[_slot[vox]]``), never a per-id
        # dict probe; the OrderedDict only orders keys for eviction.
        self._rows: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        self._resident: Dict[str, np.ndarray] = {}   # voxel id -> bool
        self._slot: Dict[str, np.ndarray] = {}       # voxel id -> slot|-1
        self._data: Dict[str, np.ndarray] = {}       # slot -> row (D,)
        self._free: Dict[str, List[int]] = {}        # reusable slots
        self._hiwater: Dict[str, int] = {}           # slots ever allocated
        self._pincnt: Dict[str, np.ndarray] = {}     # voxel id -> pin count
        self._rowbytes: Dict[str, int] = {}
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def _grow(self, net: str, need: int) -> None:
        """Grow the net's id-indexed arrays to cover voxel id ``need``."""
        bm = self._resident.get(net)
        if bm is None or bm.size <= need:
            size = max(need + 1, 1024, 2 * (bm.size if bm is not None else 0))
            grown = np.zeros(size, bool)
            slots = np.full(size, -1, np.int64)
            pins = np.zeros(size, np.int64)
            if bm is not None:
                grown[:bm.size] = bm
                slots[:bm.size] = self._slot[net]
                pins[:bm.size] = self._pincnt[net]
            self._resident[net] = grown
            self._slot[net] = slots
            self._pincnt[net] = pins

    def lookup(self, net: str, vox: np.ndarray):
        """Vectorized lookup. vox: (K,) int64 voxel ids -> (mask (K,) bool,
        rows (K, D) with zeros at misses; D=0 array if the memo is empty).
        Hits are counted; the LRU refresh (a per-unique-id pass) only runs
        once the memo is past half capacity — below that eviction order is
        never consulted, so the refresh would be pure overhead."""
        vox = np.asarray(vox, np.int64)
        mask = self.contains(net, vox)
        out = None
        if mask.any():
            data = self._data[net]
            idx = np.nonzero(mask)[0]
            out = np.zeros((len(vox), data.shape[1]), np.float32)
            out[idx] = data[self._slot[net][vox[idx]]]
            if 2 * self.nbytes >= self.capacity_bytes:
                for v in np.unique(vox[idx]):
                    self._rows.move_to_end((net, int(v)))
        self.hits += int(mask.sum())
        self.misses += int(len(vox) - mask.sum())
        if out is None:
            out = np.zeros((len(vox), 0), np.float32)
        return mask, out

    def contains(self, net: str, vox: np.ndarray) -> np.ndarray:
        """Residency test without LRU refresh or hit/miss accounting."""
        vox = np.asarray(vox, np.int64)
        bm = self._resident.get(net)
        if bm is None or not vox.size:
            return np.zeros(len(vox), bool)
        out = np.zeros(len(vox), bool)
        in_range = vox < bm.size
        out[in_range] = bm[vox[in_range]]
        return out

    def insert(self, net: str, vox: np.ndarray, rows: np.ndarray) -> None:
        """Insert rows (K, D) for voxel ids (K,); evicts LRU (unpinned)
        rows past capacity. O(new ids) — each voxel pays the Python-level
        slot assignment once per residency lifetime."""
        vox = np.asarray(vox, np.int64)
        rows = np.asarray(rows, np.float32)
        if not vox.size:
            return
        self._grow(net, int(vox.max()))
        bm, slots = self._resident[net], self._slot[net]
        rb = self._rowbytes.setdefault(net, int(rows[0].nbytes) + 64)
        data = self._data.get(net)
        if data is None or data.shape[1] != rows.shape[1]:
            data = self._data[net] = np.zeros((1024, rows.shape[1]),
                                              np.float32)
        free = self._free.setdefault(net, [])
        for k, v in enumerate(vox):
            key = (net, int(v))
            if key in self._rows:
                self._rows.move_to_end(key)
                continue
            if free:
                slot = free.pop()
            else:
                slot = self._hiwater[net] = self._hiwater.get(net, 0) + 1
                slot -= 1
                while slot >= data.shape[0]:
                    data = np.concatenate(
                        [data, np.zeros_like(data)], axis=0)
                    self._data[net] = data
            data[slot] = rows[k]
            slots[int(v)] = slot
            bm[int(v)] = True
            self._rows[key] = slot
            self.nbytes += rb
            self.inserts += 1
        while self.nbytes > self.capacity_bytes and self._rows:
            victim = next(
                (k for k in self._rows
                 if not self._pincnt[k[0]][k[1]]), None)
            if victim is None:
                break                         # everything pinned: overshoot
            vnet, vid = victim
            self._free[vnet].append(self._rows.pop(victim))
            self._slot[vnet][vid] = -1
            self._resident[vnet][vid] = False
            self.nbytes -= self._rowbytes[vnet]
            self.evictions += 1

    def pin(self, net: str, vox: np.ndarray) -> None:
        vox = np.asarray(vox, np.int64)
        if vox.size:
            self._grow(net, int(vox.max()))
            np.add.at(self._pincnt[net], vox, 1)

    def unpin(self, net: str, vox: np.ndarray) -> None:
        vox = np.asarray(vox, np.int64)
        if vox.size:
            cnt = self._pincnt[net]
            np.add.at(cnt, vox, -1)
            np.maximum(cnt, 0, out=cnt)

    @property
    def pinned_rows(self) -> int:
        return int(sum((c > 0).sum() for c in self._pincnt.values()))

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"rows": len(self._rows), "resident_mb":
                round(self.nbytes / 2 ** 20, 3),
                "capacity_mb": round(self.capacity_bytes / 2 ** 20, 3),
                "hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "pinned_rows": self.pinned_rows,
                "hit_rate": round(self.hits / total, 4) if total else None}


@dataclass
class SceneAux:
    """The auxiliary per-scene residents that ride alongside the
    PackedPlcore in a SceneCache entry: calibration stats + trunk memo.
    ``nbytes`` is LIVE (the memo grows during serving) — the cache's
    capacity accounting reads it per eviction decision, not at insert."""
    stats: SampleStats
    memo: TrunkMemo
    t_row: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    @property
    def nbytes(self) -> int:
        return int(self.stats.nbytes + self.memo.nbytes + self.t_row.nbytes)
