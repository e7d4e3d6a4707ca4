"""K2's Mip-NeRF instance on the card: at the published width and at tiny()
against the port's plain Mip-NeRF path (``core.mipnerf.render_rays``,
TF32 off) and against its own plain tile body (``kernels/ref.py``), on a
ragged multi-ray tile; its traced instance against the untraced one (the
same bits, every counter positive but the overlapped k steps, of which
f32's loop has none, the encoding inside the scalar phase, every MMA row
real at 128 intervals a level); a traced ``dispatch_tile``
bringing the row back; the oracle rung relaunching the instance.

Imports neither JAX nor the reference package, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_mipnerf_gpu.py

Without a CUDA device the tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import mipnerf as mcfg
from repro_torch.core import mipnerf
from repro_torch.data import rays as R_
from repro_torch.kernels import fused_plcore, ops, ref
from repro_torch.models.params import init_params

pytestmark = pytest.mark.gpu

# 4,099 cones in tiles of 16: every block walks several rays, the last
# tile is ragged (3 rays)
N_RAYS, RT = 4099, 16
#: K2's f32 tolerances against a plain version (chip_smoke.py): rgb and
#: acc 1e-3 (3xTF32 products against float32 ones, then the resample,
#: which moves a fine edge by a last-ulp change of a coarse weight); depth
#: 1e-2 (a moved edge moves it by its own length's share)
TOLS = (1e-3, 1e-3, 1e-3, 1e-3, 1e-2)


def _cones(n, seed=3):
    """n cones of the orbit's 64x64 views at random poses, (n, 7) f32."""
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(x) for x in out) < n:
        o, d, r = R_.mip_view_rays(float(rng.uniform(0, 360)),
                                   float(rng.uniform(-35, -15)), 4.0, 64)
        out.append(np.concatenate([o, d, r], axis=1))
    return torch.from_numpy(np.concatenate(out)[:n])


def _resident(cfg, seed=2):
    dev = torch.device("cuda")
    params = init_params(mipnerf.mip_decls(cfg),
                         torch.Generator().manual_seed(seed))
    return mipnerf.PackedMipNerf(cfg, params, use_kernel=True, device=dev)


@pytest.mark.parametrize("which", ["full", "tiny"])
def test_mip_k2_matches_the_plain_path_on_card(which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mcfg.CONFIG if which == "full" else mcfg.tiny()
    pp = _resident(cfg)
    cones = _cones(N_RAYS).cuda()
    t_row, u_row = ops.mip_sample_rows(cfg, cones.device)
    got = fused_plcore.mip_two_pass_call(cfg, pp.packed, cones, t_row, u_row,
                                         rt=RT, white_bkgd=True)
    body = ref.mip_two_pass_ref(cfg, pp.packed, cones, t_row, u_row, rt=256,
                                white_bkgd=True)
    plain = mipnerf.render_rays(cfg, pp.params, cones[:, :3], cones[:, 3:6],
                                cones[:, 6])
    keys = ("rgb", "rgb_coarse", "acc", "acc_coarse", "depth")
    for i, key in enumerate(keys):
        assert bool(torch.isfinite(got[i]).all()), key
        assert float((got[i] - body[i]).abs().max()) <= TOLS[i], key
        assert float((got[i] - plain[key]).abs().max()) <= TOLS[i], key


def test_mip_k2_traced_instance_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.obs import K2_MIP_ROW_STATS, K2_PHASES, SpanTracer
    cfg = mcfg.CONFIG
    pp = _resident(cfg)
    cones = _cones(4096, seed=7).cuda()
    untraced = ops.fused_render_mip(cfg, pp.packed, cones)
    phase = torch.zeros((len(cones), len(K2_MIP_ROW_STATS)),
                        dtype=torch.int64, pin_memory=True)
    traced = ops.fused_render_mip(cfg, pp.packed, cones, phase_cycles=phase)
    torch.cuda.synchronize()
    for key, v in untraced.items():
        assert torch.equal(v, traced[key]), key
    c = dict(zip(K2_MIP_ROW_STATS, phase.sum(0).tolist()))
    # f32's k loop waits for each step: none issued with one in flight
    assert c.pop("plcore_two_pass_steps_overlapped") == 0, c
    assert all(v > 0 for v in c.values()), c
    assert sum(c[f"plcore_two_pass_cycles_{p}"]
               for p in K2_PHASES[:-1]) <= c["plcore_two_pass_cycles_total"]
    assert c["plcore_two_pass_cycles_encode"] \
        <= c["plcore_two_pass_cycles_scalar"], c
    assert c["plcore_two_pass_rows_real"] == c["plcore_two_pass_rows_mma"]

    host = cones.cpu().numpy()
    cols = (host[:, :3], host[:, 3:6], host[:, 6:])
    tracer = SpanTracer()
    handle, cost = pp.dispatch_tile(*cols, tracer=tracer)
    rgb = handle.result()
    row = handle.phase_cycles()
    assert row is not None and len(row) == len(K2_MIP_ROW_STATS)
    assert cost == {"layers": 0, "bytes": 0}
    plain_handle, _ = pp.dispatch_tile(*cols)
    assert np.array_equal(rgb, plain_handle.result())
    assert plain_handle.phase_cycles() is None


def test_mip_oracle_and_degradation_on_card():
    """On the card the retry ladder's last rung relaunches K2's Mip-NeRF
    instance (one launch, the dispatched tile's bits), never the plain
    path; the coarse-only degradation is refused, not rendered."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pp = _resident(mcfg.CONFIG)
    host = _cones(512, seed=11).numpy()
    cols = (host[:, :3], host[:, 3:6], host[:, 6:])
    handle, _ = pp.dispatch_tile(*cols)
    rgb = handle.result()
    n0 = fused_plcore.LAUNCHES.get("mip_two_pass_call", 0)
    oracle = pp.render_tile_oracle(*cols)
    assert oracle.device.type == "cuda"
    assert fused_plcore.LAUNCHES["mip_two_pass_call"] == n0 + 1
    assert np.array_equal(oracle.cpu().numpy(), rgb)
    with pytest.raises(ValueError, match="coarse-only"):
        pp.render_tile(*cols, coarse_only=True)
    with pytest.raises(ValueError, match="coarse-only"):
        pp.dispatch_tile(*cols, coarse_only=True)
    assert fused_plcore.LAUNCHES["mip_two_pass_call"] == n0 + 1
