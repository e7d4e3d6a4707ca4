"""mipnerf — Mip-NeRF (Barron et al., ICCV 2021, arXiv:2103.13415) as its
published Blender configuration sets it (github.com/google/mip-nerf,
``configs/blender.gin``, ``internal/models.py``, ``internal/mip.py``).

Each pixel casts a cone of base radius ``2 / (sqrt(12) focal)``; each of
its ``n_samples`` intervals per level is a conical frustum, encoded by the
integrated positional encoding (IPE) over degrees ``min_deg_point`` to
``max_deg_point - 1`` (no identity term). ONE MLP serves both levels: an
8 x 256 ReLU trunk that joins the encoding again after its 5th layer
(``skip_at`` (5,): the repository's before-layer convention), a density
head, a 256-wide bottleneck, one 128-wide ReLU layer on [bottleneck,
viewdir encoding (degrees 0 to ``deg_view - 1`` with the identity)] and
an RGB head. Density ``softplus(raw + density_bias)``, colour
``sigmoid(raw) (1 + 2 rgb_padding) - rgb_padding``. The fine level's
``n_samples + 1`` edges come from the coarse weights, blurred by
neighbour maxima and padded by ``resample_padding``, at fixed points of
the CDF; there is no union with the coarse edges.

612,740 parameters (610,304 weights). The field names the kernels' weight
layout shares with ``NerfConfig`` (``trunk_*``, ``color_width``,
``pos_enc_dim``, ``dir_enc_dim``, ``dir_freqs``) mean the same here, so one
network packs as a NeRF network does.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MipNerfConfig:
    name: str = "mipnerf"
    # the MLP, one network for both levels
    trunk_layers: int = 8
    trunk_width: int = 256
    skip_at: Tuple[int, ...] = (5,)
    color_width: int = 128
    # encodings
    min_deg_point: int = 0
    max_deg_point: int = 16
    deg_view: int = 4
    # sampling: n_samples intervals (n_samples + 1 edges) at each level
    n_samples: int = 128
    near: float = 2.0
    far: float = 6.0
    resample_padding: float = 0.01
    # heads
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    compute_dtype: str = "float32"

    @property
    def pos_freqs(self) -> int:
        """Degrees of the IPE."""
        return self.max_deg_point - self.min_deg_point

    @property
    def pos_enc_dim(self) -> int:
        return 2 * 3 * self.pos_freqs          # sines, then cosines

    @property
    def dir_freqs(self) -> int:
        return self.deg_view

    @property
    def dir_enc_dim(self) -> int:
        return 3 + 2 * 3 * self.deg_view       # identity, sines, cosines

    @property
    def n_edges(self) -> int:
        return self.n_samples + 1


CONFIG = MipNerfConfig()


def tiny() -> MipNerfConfig:
    """Reduced config for CPU tests (the kernels' (64, 32) width pair)."""
    return MipNerfConfig(trunk_layers=4, trunk_width=64, skip_at=(2,),
                         color_width=32, max_deg_point=8, deg_view=2,
                         n_samples=16)
