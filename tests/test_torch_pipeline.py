"""The port's serving pipeline against the reference's, and its own
invariants: pack once, tile = image pixels bit for bit, the two-dispatch
oracle tracks the fused path, padding never reaches a real ray, entry
points run on the card unless asked for the CPU, and no module of the port
imports JAX or the reference package."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import rmcm as jr
from repro.core.pipeline import PackedPlcore as JaxPackedPlcore
from repro.core.plcore import plcore_decls
from repro.data import rays as jax_rays
from repro.models.params import init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.data import rays
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parent.parent
HW, RPB = 16, 64


@pytest.fixture(scope="module")
def model():
    params = init_params(plcore_decls(jax_tiny()), jax.random.PRNGKey(0),
                         "float32")
    quant = {n: jr.quantize_tree(params[n]) for n in ("coarse", "fine")}
    c2w = rays.pose_spherical(30.0, -20.0, 4.0)
    ro, rd = rays.camera_rays(c2w, HW, HW, 14.4)
    return params, quant, ro, rd


def _port(params, quant=None, **kw):
    kw.setdefault("use_kernel", True)
    kw.setdefault("fuse_two_pass", True)
    to_t = lambda t: bridge.to_torch(jax.tree.map(np.asarray, t))  # noqa
    return PackedPlcore(tiny(), to_t(params),
                        quant=None if quant is None else to_t(quant),
                        device="cpu", **kw)


def test_camera_rays_match_reference():
    c2w_j = jax_rays.pose_spherical(30.0, -20.0, 4.0)
    c2w_t = rays.pose_spherical(30.0, -20.0, 4.0)
    np.testing.assert_array_equal(np.asarray(c2w_j), c2w_t.numpy())
    for a, b in zip(jax_rays.camera_rays(c2w_j, 8, 8, 7.2),
                    rays.camera_rays(c2w_t, 8, 8, 7.2)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_render_image_matches_reference(model, quantized):
    params, quant, ro, rd = model
    q = quant if quantized else None
    ref = JaxPackedPlcore(jax_tiny(), params, quant=q, use_kernel=True,
                          fuse_two_pass=True).render_image(
        ro.numpy(), rd.numpy(), rays_per_batch=RPB)
    got = _port(params, q).render_image(ro, rd, rays_per_batch=RPB)
    assert got.shape == (HW, HW, 3)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0,
                               atol=1e-3)


def test_oracle_tracks_fused_tile(model):
    params, _, ro, rd = model
    m = _port(params)
    o, d = ro.reshape(-1, 3)[:RPB], rd.reshape(-1, 3)[:RPB]
    torch.testing.assert_close(m.render_tile_oracle(o, d), m.render_tile(o, d),
                               rtol=0, atol=1e-3)


def test_tiles_equal_image_bit_for_bit_and_pack_once(model):
    params, _, ro, rd = model
    m = _port(params)
    packs = ops.pack_count()
    img = m.render_image(ro, rd, rays_per_batch=RPB).reshape(-1, 3)
    flat_o, flat_d = ro.reshape(-1, 3), rd.reshape(-1, 3)
    for s in range(0, HW * HW, RPB):
        handle, cost = m.dispatch_tile(flat_o[s:s + RPB], flat_d[s:s + RPB])
        assert cost == {"layers": 0, "bytes": 0} == m.tile_gather_cost()
        assert torch.equal(torch.from_numpy(handle.result()), img[s:s + RPB])
    m.render_tile(flat_o[:RPB], flat_d[:RPB], coarse_only=True)
    m.render_tile_oracle(flat_o[:RPB], flat_d[:RPB])
    assert ops.pack_count() == packs


@settings(max_examples=8, deadline=None)
@given(n_real=st.integers(min_value=1, max_value=RPB - 1),
       scale=st.floats(min_value=0.125, max_value=4.0, width=32))
def test_tail_padding_cannot_change_real_rays(model, n_real, scale):
    """Two renders of the same real rays with different tails (float32-exact
    bounds): the real rows are bit-identical."""
    m = _port(model[0])
    ro, rd = rays.camera_rays(rays.pose_spherical(10.0, -30.0, 4.0), 8, 8, 7.2)
    o, d = ro.reshape(-1, 3), rd.reshape(-1, 3)
    outs = []
    for tail in (scale, -2.0 * scale):
        o_pad = torch.cat([o[:n_real], torch.full((RPB - n_real, 3), tail)])
        d_pad = torch.cat([d[:n_real], torch.full((RPB - n_real, 3), 1.0)])
        outs.append(m.render_tile(o_pad, d_pad)[:n_real])
    assert torch.equal(outs[0], outs[1])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    params = {"coarse": {}, "fine": {}}
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedPlcore(tiny(), params, use_kernel=True, fuse_two_pass=True)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
