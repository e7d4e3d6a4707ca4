"""The width pairs and weight formats the fused PLCore kernels are built
for, checked on the CPU: the table of built (trunk, color) widths and the
``ValueError`` for any other pair (raised before the library is touched,
never a quiet plain version), the instance names the launch counts use,
and the tensor-core weight stream at (64, 32) and (32, 16) against the
plain version's rows: every segment holds exactly the matrix the plain
version multiplies by, at the offsets the kernel's ring walks
(``stream_steps`` in ``csrc/plcore_kernels.cuh``). Also the RMCM scale as
a true division (the card's product with a reciprocal changed QAT)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.nerf_icarus import CONFIG, tiny
from repro_torch.core import rmcm
from repro_torch.core.plcore import plcore_decls
from repro_torch.kernels import fused_plcore, ops, ref
from repro_torch.models.params import init_params

# tiny() and the reference kernel tests' sweep (tests/test_kernels.py)
SWEEP5 = dataclasses.replace(CONFIG, trunk_layers=5, trunk_width=64,
                             skip_at=(2, 4), color_width=32, pos_freqs=6,
                             dir_freqs=3, n_coarse=16, n_fine=16)
SWEEP2 = dataclasses.replace(CONFIG, trunk_layers=2, trunk_width=32,
                             skip_at=(1,), color_width=16, pos_freqs=4,
                             dir_freqs=2, n_coarse=8, n_fine=8)
CONFIGS = {"full": CONFIG, "tiny": tiny(), "sweep5": SWEEP5,
           "sweep2": SWEEP2}


def test_built_width_pairs():
    assert fused_plcore.KERNEL_WIDTHS == ((256, 128), (64, 32), (32, 16))
    for cfg in CONFIGS.values():
        fused_plcore.check_widths(cfg)     # no raise


@pytest.mark.parametrize("wc", [(128, 64), (64, 16), (256, 64)])
def test_unbuilt_width_pair_raises_naming_the_built(wc):
    cfg = dataclasses.replace(tiny(), trunk_width=wc[0], color_width=wc[1])
    msg = r"\(256, 128\), \(64, 32\), \(32, 16\)"
    with pytest.raises(ValueError, match=msg):
        fused_plcore.check_widths(cfg)
    # the occupancy query, the first thing a launch on the card asks,
    # raises before it loads or builds the library
    with pytest.raises(ValueError, match=msg):
        fused_plcore.blocks_per_sm(cfg, "k2", (16, 16), (0, 1), "cuda")


def test_instance_names():
    assert fused_plcore.instance_name(
        tiny(), "two_pass_plcore_call", (False, True)) == \
        "two_pass_plcore_call[w64c32,f32/rmcm]"
    assert fused_plcore.instance_name(
        SWEEP2, "fused_plcore_call", (True,)) == \
        "fused_plcore_call[w32c16,rmcm]"


def _kernel_steps(cfg, quantized):
    """The ring's walk of one chunk as ``stream_steps`` computes it: the
    first k step of color0 and the steps per chunk."""
    ks = 16 if quantized else 8
    _, kpe = fused_plcore.mma_rows(cfg)
    nkh, nkp = cfg.trunk_width // ks, kpe // ks
    nskip = sum(1 for i in cfg.skip_at if 0 < i < cfg.trunk_layers)
    color_from = nkp + (cfg.trunk_layers - 1) * nkh + nskip * nkp + nkh
    return color_from, color_from + nkh


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("quantized", [False, True])
def test_stream_offsets_are_the_rings_walk(name, quantized):
    """Each k step of the stream is W (C for color0) columns of 32 bytes
    (bf16) or 64 (TF32 hi and lo), in the order the ring reads them: the
    color0 segment starts at the kernel's ``color_from`` step and the
    stream holds ``per_chunk`` steps."""
    cfg = CONFIGS[name]
    W, C = cfg.trunk_width, cfg.color_width
    col_bytes = 32 if quantized else 64
    el = 2 if quantized else 4
    color_from, per_chunk = _kernel_steps(cfg, quantized)
    offs = fused_plcore.mma_offsets(cfg, quantized)
    segs = fused_plcore.mma_segments(cfg)
    assert segs[-1][0] == "color0" and segs[-2][0] == "feat"
    assert offs[-1][0] * el == color_from * W * col_bytes
    n_color = per_chunk - color_from
    assert (offs[-1][1] - offs[-1][0]) * el == n_color * C * col_bytes
    for (_, rows, ncols), (lo, hi) in zip(segs, offs):
        ks = 16 if quantized else 8
        assert rows % ks == 0 and ncols % 8 == 0
        assert (lo * el) % 16 == 0          # a bulk copy's alignment
        assert (hi - lo) * el == (rows // ks) * ncols * col_bytes


@pytest.mark.parametrize("name", ["tiny", "sweep5", "sweep2"])
@pytest.mark.parametrize("quantized", [False, True])
def test_stream_holds_the_plain_versions_rows(name, quantized):
    """At the small widths the stream rebuilt into matrices
    (``ops.mma_matrix``) holds the plain version's rows: under RMCM the
    signed magnitudes exactly (the plain version's weight divided by its
    column scale), in f32 hi + lo within 2^-21 of each weight; the PE
    rows K-padded with zeros (pe 39 -> 48, 27 -> 32)."""
    cfg = CONFIGS[name]
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(3))
    p = params["fine"]
    q = rmcm.quantize_tree(p) if quantized else None
    packed = ops.kernel_weights(cfg, p, q)
    tw, _, _, _, fw, _, cw, *_ = ref.net_arrays(cfg, packed)
    W, pe = cfg.trunk_width, cfg.pos_enc_dim
    KH, KPE = fused_plcore.mma_rows(cfg)
    assert KPE == -(-pe // 16) * 16 and KPE > pe
    if quantized:
        scl = {"trunk": packed["trunk_scl"], "feat": packed["feat_scl"],
               "color0": packed["color0_scl"]}

    def check(got, want, scale=None):
        if quantized:
            assert torch.equal(got.float() * scale.reshape(1, -1), want)
        else:
            hi, lo = got
            err = (want.double() - hi.double() - lo.double()).abs()
            assert bool((err <= 2.0 ** -21 * want.double().abs()).all())

    for i in range(cfg.trunk_layers):
        got = ops.mma_matrix(cfg, packed["mma"], "trunk", i)
        parts = got if not quantized else (got,)
        want = torch.zeros(KH + KPE, W)
        if i == 0:
            want[KH:KH + pe] = tw[0][:pe]
        else:
            want[:W] = tw[i][:W]
            if i in cfg.skip_at:
                want[KH:KH + pe] = tw[i][W:W + pe]
        check(got, want, scl["trunk"][i] if quantized else None)
        for part in parts:      # the K padding is zero
            assert not part[KH + pe:].float().any()
    check(ops.mma_matrix(cfg, packed["mma"], "feat"), fw[:W],
          scl["feat"] if quantized else None)
    check(ops.mma_matrix(cfg, packed["mma"], "color0"), cw[:W],
          scl["color0"] if quantized else None)


def test_rmcm_scale_is_a_true_division():
    """The scale is max|w| / 255 divided, not multiplied by 1/255 (which
    PyTorch does for a Python divisor on a CUDA tensor): the two differ in
    most columns, and where a magnitude sits on a rounding tie they give
    different magnitudes."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (256, 512)).astype(np.float32))
    amax = w.abs().amax(dim=-2, keepdim=True)
    q = rmcm.quantize(w)
    assert torch.equal(q["scale"], amax / 255.0)
    recip = amax * (1.0 / 255.0)
    assert int((recip != q["scale"]).sum()) > 0
