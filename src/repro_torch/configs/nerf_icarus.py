"""nerf-icarus — the paper's own workload: the original NeRF MLP run through
the ICARUS PLCore pipeline (PEU -> MLP engine -> VRU).

Original NeRF: 8x256 trunk, skip at layer 4, density head + 128-wide
view-dependent color branch; positional encoding L=10 (position) / L=4
(direction); 595,844 parameters per network, two networks (coarse, fine).
Two-pass sampling: 64 uniform + 128 importance (paper §5.1).

The port's own copy of the reference configuration: same fields and
defaults, so a config built on either side describes the same network.
The TPU-only fields (``kernel_vmem_budget_mb``) are kept for equality of
the field set; the port's Hopper tile choice does not read them.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class NerfConfig:
    name: str = "nerf-icarus"
    # MLP engine
    trunk_layers: int = 8
    trunk_width: int = 256
    skip_at: Tuple[int, ...] = (4,)
    color_width: int = 128
    # PEU
    pos_freqs: int = 10         # L=10 -> 3 + 60 dims
    dir_freqs: int = 4          # L=4  -> 3 + 24 dims
    encoding_mode: str = "nerf_fixed"
    rff_features: int = 128
    rff_sigma: float = 10.0
    # sampling (paper §5.1 two-pass strategy)
    n_coarse: int = 64
    n_fine: int = 128
    near: float = 2.0
    far: float = 6.0
    # RMCM quantization (paper §4.3)
    rmcm_bits: int = 9
    rmcm_enabled: bool = True
    rays_per_tile: int = 128
    kernel_vmem_budget_mb: float = 16.0
    # early ray termination: rays whose transmittance after the coarse
    # pass is < ert_eps keep the coarse color and skip the fine pass
    ert_eps: float = 0.0
    ert_chunk_rows: int = 64
    image_hw: Tuple[int, int] = (800, 800)
    dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def pos_enc_dim(self) -> int:
        return 3 + 2 * 3 * self.pos_freqs     # identity + sin/cos

    @property
    def dir_enc_dim(self) -> int:
        return 3 + 2 * 3 * self.dir_freqs

    @property
    def n_samples(self) -> int:
        return self.n_coarse + self.n_fine


CONFIG = NerfConfig()


def tiny() -> NerfConfig:
    """Reduced config for CPU tests/examples."""
    return NerfConfig(
        trunk_layers=4, trunk_width=64, skip_at=(2,), color_width=32,
        pos_freqs=6, dir_freqs=3, n_coarse=16, n_fine=16,
        rays_per_tile=32, image_hw=(64, 64),
    )
