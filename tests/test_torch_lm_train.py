"""One LM train step of the port against the reference, for every arch's
smoke config (f32) on the reference's ``init_params(PRNGKey(0))`` weights
and a numpy-seeded batch: the loss and its gradient, then AdamW fed the
reference's gradients (crossed as numpy) with f32 and with int8 moments.
Then per-layer activation checkpointing (remat) on against off.

Tolerances: loss rtol 1e-5; every gradient leaf within 1e-4 of the whole
gradient's largest |g| (the worst leaf named); AdamW's params and f32
moments within 1e-6; int8 moments' ``q`` equal except rounding ties one
apart (counted, at most 1 in 10^4 entries: ``round(x / scale)`` can land
on .5 one ulp apart in the two frameworks), their scales within 1e-6
relative. Gradients are
compared directly and AdamW on the same gradients: at step 1 AdamW moves
each param by about ``lr * sign(g)``, so a near-zero gradient element
whose sign differs between the frameworks would move its param by 2 lr.
Remat on against off: loss and gradients within 1e-6 of the largest |g|.
"""
import jax
import numpy as np
import pytest
import torch

from repro.optim import adam as ja
from repro.models.params import init_params as jax_init

from _torch_lm_common import (GRAD_TOL, LOSS_RTOL, as_np, batch, grad_gap,
                              jax_batch, leaves_with_path, models,
                              one_torch_thread, torch_batch)  # noqa: F401
from repro_torch import bridge
from repro_torch.configs import list_archs, smoke_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import init_params
from repro_torch.models.transformer import tree_unbind
from repro_torch.optim import adam as ta

ADAM_TOL = 1e-6


def _opt_cfgs(moment_dtype: str):
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              moment_dtype=moment_dtype)
    return ja.AdamConfig(**kw), ta.AdamConfig(**kw)


def _check_int8(ref, port, where: str) -> tuple:
    """int8 moment leaves: scales within 1e-6 relative, ``q`` equal except
    entries one apart (rounding ties); returns (entries that differ,
    entries)."""
    ties = total = 0
    for (k, r), (_, t) in zip(leaves_with_path(ref), leaves_with_path(port)):
        r, t = as_np(r), as_np(t)
        if k.endswith("/q") or k == "q":
            assert r.dtype == t.dtype == np.int8, k
            d = np.abs(r.astype(np.int32) - t.astype(np.int32))
            assert d.max(initial=0) <= 1, (where, k)
            ties += int((d > 0).sum())
            total += d.size
        else:
            np.testing.assert_allclose(t, r, rtol=ADAM_TOL, atol=0,
                                       err_msg=f"{where} {k}")
    return ties, total


def _adam_pair(jm, jp, jg, moment_dtype: str) -> tuple:
    """Two AdamW updates fed the reference's gradients; before each, the
    reference's params and state cross to the port (``bridge``), so each
    update starts from the same state. Returns (int8 ``q`` entries that
    differ, ``q`` entries compared); (0, 0) with f32 moments."""
    jcfg, tcfg = _opt_cfgs(moment_dtype)
    jo = jax_init(ja.opt_state_decls(jm.param_decls(), jcfg),
                  jax.random.PRNGKey(0), "float32")
    tg = bridge.to_torch(jax.tree.map(np.asarray, jg))
    update = jax.jit(lambda q, g, o: ja.adam_update(jcfg, q, g, o))
    ties = total = 0
    for i in range(2):
        p = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp))
        to = bridge.lm_opt_state_from_numpy(jax.tree.map(np.asarray, jo))
        jp, jo, jmet = update(jp, jg, jo)
        p, to, tmet = ta.adam_update(tcfg, p, tg, to)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        assert to["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        got = dict(leaves_with_path(p))
        for k, r in leaves_with_path(jp):
            np.testing.assert_allclose(as_np(got[k]), as_np(r), rtol=0,
                                       atol=ADAM_TOL,
                                       err_msg=f"param {k}, update {i}")
        for mom in ("m", "v"):
            if moment_dtype == "int8":
                t, n = _check_int8(jo[mom], to[mom], f"{mom} update {i}")
                ties, total = ties + t, total + n
            else:
                for (k, r), (_, t) in zip(leaves_with_path(jo[mom]),
                                          leaves_with_path(to[mom])):
                    np.testing.assert_allclose(as_np(t), as_np(r), rtol=0,
                                               atol=ADAM_TOL,
                                               err_msg=f"{mom} {k}")
    return ties, total


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_parity(arch):
    jm, jp, m, p = models(arch)
    b = batch(m.cfg, 2, 17)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jax_batch(b))
    tl, tg = loss_and_grads(m.loss, p, torch_batch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    worst, gap = grad_gap(jg, tg)
    print(f"{arch}: loss {float(tl):.6f}, worst leaf {worst} at {gap:.2e} "
          "of the largest |g|")
    assert gap <= GRAD_TOL, (arch, worst, gap)

    assert _adam_pair(jm, jp, jg, "float32") == (0, 0)
    ties, total = _adam_pair(jm, jp, jg, "int8")
    print(f"{arch}: int8 moments, {ties} of {total} q entries one apart")
    assert ties <= 1e-4 * total, (arch, ties, total)


def test_global_norm_and_leaf_order_on_lm_tree():
    """global_norm over a nested LM tree and the sorted-key leaf order
    equal the reference's."""
    jm, jp, m, p = models("kimi-k2-1t-a32b")
    jkeys = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [k for k, _ in leaves_with_path(p)] == jkeys
    np.testing.assert_allclose(float(ta.global_norm(p)),
                               float(ja.global_norm(jp)), rtol=1e-6)


REMAT_ARCHS = ["qwen2-1.5b", "moonshot-v1-16b-a3b", "recurrentgemma-9b",
               "whisper-large-v3", "mamba2-2.7b"]


def _saved_bytes(fn) -> int:
    """Bytes of the tensors autograd keeps for backward while ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("arch,policy",
                         [(a, "nothing") for a in REMAT_ARCHS]
                         + [("qwen2-1.5b", "dots")])
def test_remat_changes_memory_not_values(arch, policy):
    """Each of the reference's remat call sites (transformer, moe, rglru,
    encdec's encoder and decoder; ssm through the dense backbone): loss
    and gradients with remat on equal remat off within 1e-6 of the
    largest |g|, and backward keeps fewer bytes."""
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = init_params(model.param_decls(), torch.Generator().manual_seed(0))
    b = torch_batch(batch(cfg, 2, 33))
    on = build_model(cfg.replace(remat=True, remat_policy=policy))
    l0, g0 = loss_and_grads(model.loss, params, b)
    l1, g1 = loss_and_grads(on.loss, params, b)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    worst, gap = grad_gap(g0, g1)
    assert gap <= 1e-6, (worst, gap)
    leaves = ta.tree_unflatten(params, [x.detach().requires_grad_(True)
                                        for x in ta.tree_leaves(params)])
    off_bytes = _saved_bytes(lambda: model.loss(leaves, b))
    on_bytes = _saved_bytes(lambda: on.loss(leaves, b))
    assert on_bytes < off_bytes, (on_bytes, off_bytes)


def test_tree_unbind_gives_each_layer():
    """tree_unbind's per-layer trees equal indexing the stack layer by
    layer, and are views (no copy)."""
    stack = {"a": torch.arange(24.).reshape(3, 2, 4),
             "b": {"c": torch.arange(6.).reshape(3, 2)}}
    layers = tree_unbind((stack, torch.arange(3)))
    assert len(layers) == 3
    for i, (lp, t) in enumerate(layers):
        assert torch.equal(lp["a"], stack["a"][i])
        assert torch.equal(lp["b"]["c"], stack["b"]["c"][i])
        assert int(t) == i
        assert lp["a"].data_ptr() == stack["a"][i].data_ptr()


def test_tree_unflatten_keeps_no_leaves_alive():
    """Dropping an unflattened tree frees its leaves at once, with the
    cyclic garbage collector off (a reference cycle would hold a whole
    gradient set, 6.2 GB at qwen2-1.5b's full width, until it ran)."""
    import gc
    import weakref
    leaf = torch.ones(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        tree = ta.tree_unflatten({"a": {"b": 0}, "c": 0}, [leaf, torch.ones(1)])
        assert tree["a"]["b"] is leaf
        del tree, leaf
        assert ref() is None
    finally:
        gc.enable()


def test_stack_probe_variants_agree():
    """models.stack_probe's layer loop (every stacked leaf indexed once per
    layer) gives the loss and gradients of maybe_scan's (unbound once),
    and the probe refuses to measure without the card."""
    from repro_torch.models import stack_probe, transformer
    cfg = smoke_config("qwen2-1.5b")
    model = build_model(cfg)
    params = init_params(model.param_decls(), torch.Generator().manual_seed(0))
    b = torch_batch(batch(cfg, 2, 17))
    l0, g0 = loss_and_grads(model.loss, params, b)
    scan = transformer.maybe_scan
    try:
        transformer.maybe_scan = stack_probe._scan_with(
            stack_probe.per_layer_index)
        l1, g1 = loss_and_grads(model.loss, params, b)
    finally:
        transformer.maybe_scan = scan
    assert float(l1) == float(l0)
    assert grad_gap(g0, g1)[1] == 0.0
    with pytest.raises(RuntimeError):
        stack_probe.run(stack_probe.build_parser().parse_args(
            ["--device", "cpu"]))
