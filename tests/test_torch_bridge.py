"""The weight bridge and the packed kernel layout of the PyTorch port.

The reference's param/quant trees cross as numpy arrays and must arrive
bit for bit under the same key paths; the port's ``stack_plcore_weights``
must build the same f32 and RMCM layouts as the reference from them, and
``unstack_trunk_params`` must give back exactly what was stacked.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import rmcm as jax_rmcm
from repro.core.plcore import plcore_decls
from repro.kernels import ops as jax_ops
from repro.models.params import init_params

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import CONFIG, tiny
from repro_torch.core.plcore import plcore_decls as torch_decls
from repro_torch.kernels import ops
from repro_torch.models.params import init_params as torch_init, param_count


@pytest.fixture(scope="module")
def trees():
    params = init_params(plcore_decls(jax_tiny()), jax.random.PRNGKey(0),
                         "float32")
    quant = {n: jax_rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
    return params, quant


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_round_trip_is_bit_exact(trees):
    for tree in trees:
        np_tree = jax.tree.map(np.asarray, tree)
        back = bridge.to_numpy(bridge.to_torch(np_tree))
        a, b = dict(_leaves(np_tree)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("quantized", [False, True])
def test_stack_matches_reference_layout(trees, quantized):
    params, quant = trees
    cfg_j, cfg_t = jax_tiny(), tiny()
    for net in ("coarse", "fine"):
        ref = jax_ops.stack_plcore_weights(
            cfg_j, params[net], quant[net] if quantized else None)
        got = ops.stack_plcore_weights(
            cfg_t, bridge.to_torch(jax.tree.map(np.asarray, params[net])),
            bridge.to_torch(jax.tree.map(np.asarray, quant[net]))
            if quantized else None)
        assert sorted(ref) == sorted(got)
        for k in ref:
            r, g = np.asarray(ref[k]), got[k].numpy()
            assert r.dtype == g.dtype and r.shape == g.shape, k
            np.testing.assert_array_equal(r, g, err_msg=k)


@pytest.mark.parametrize("quantized", [False, True])
def test_unstack_is_lossless(trees, quantized):
    params, quant = trees
    cfg = tiny()
    p = bridge.to_torch(jax.tree.map(np.asarray, params["fine"]))
    q = bridge.to_torch(jax.tree.map(np.asarray, quant["fine"]))
    packed = ops.stack_plcore_weights(cfg, p, q if quantized else None)
    tp, tq = ops.unstack_trunk_params(cfg, packed)
    for i in range(cfg.trunk_layers):
        assert torch.equal(tp[f"l{i}"]["b"], p["trunk"][f"l{i}"]["b"])
        if quantized:
            for k in ("mag", "sign", "scale"):
                assert torch.equal(tq[f"l{i}"]["w"][k],
                                   q["trunk"][f"l{i}"]["w"][k])
        else:
            assert tq is None
            assert torch.equal(tp[f"l{i}"]["w"], p["trunk"][f"l{i}"]["w"])


def test_full_width_parameter_count():
    """595,844 parameters per network at the full NerfConfig()."""
    decls = torch_decls(CONFIG)
    assert param_count(decls["coarse"]) == param_count(decls["fine"]) == 595_844
    params = torch_init(decls, torch.Generator().manual_seed(0))
    assert params["fine"]["trunk"]["l4"]["w"].shape == (256 + 63, 256)
