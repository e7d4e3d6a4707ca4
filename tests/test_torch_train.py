"""NeRF training of the PyTorch port against the reference package: the
RMCM fake-quantizer, AdamW, the QAT wrappers, the ray dataset and one
train step, on the reference's weights (through ``bridge``) at ``tiny()``.

Tolerances, stated per test:
* exact (bit for bit) for the fake-quantizer's forward values, the QAT
  wrappers and the int8 moments' structure;
* 1e-6 for AdamW (params, moments, step) and its schedule;
* 1e-5 relative for one train step's loss and metrics; 3e-4 of each
  gradient leaf's largest |g| for its gradients: the fine pass samples
  where the importance resampler puts them, and the resampler amplifies
  last-ulp differences of the coarse weights (the reference's own jitted
  and eager gradients differ at that level too);
* 1e-6 for the ground-truth renders and the dataset.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core import nerf_train as jnt, rmcm as jr
from repro.core.plcore import plcore_decls as jax_plcore_decls
from repro.data import rays as JR
from repro.models.params import Decl as JDecl, init_params as jax_init
from repro.optim import adam as ja, qat as jq

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import nerf_train as tnt, plcore, rmcm, sampling
from repro_torch.data import rays as TR
from repro_torch.models.params import Decl, init_params
from repro_torch.optim import adam as ta, qat as tq

RNG = np.random.default_rng(2024)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test keeps the
    test workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return bridge.to_torch(_np(tree))


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_trees(ref, port, exact=False, atol=0.0, rtol=0.0):
    """Every leaf of the reference tree against the port's at its path."""
    ref = _np(ref)
    paths = [p for p, _ in _leaves_with_path(ref)]
    assert paths == [p for p, _ in _leaves_with_path(port)]
    for path, want in _leaves_with_path(ref):
        got = _at(port, path).detach().cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        else:
            np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                       err_msg=str(path))


# ------------------------------------------------------------ fake-quant ----
@pytest.mark.parametrize("shape", [(16, 8), (3, 40, 24), (64, 1)])
def test_fake_quant_forward_bit_for_bit_and_gradient_identity(shape):
    """Forward values equal the reference's exactly; the gradient is the
    identity (any upstream cotangent passes through unchanged)."""
    w = (RNG.normal(size=shape) * 2.5).astype(np.float32)
    got = rmcm.fake_quant(torch.from_numpy(w))
    # the reference run eagerly: jitted, its compiler rewrites the
    # expression and values move by an ulp from dequantize(quantize(w)),
    # which the eager form and the port equal
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jr.fake_quant(jnp.asarray(w))))
    np.testing.assert_array_equal(got.numpy(), rmcm.dequantize(
        rmcm.quantize(torch.from_numpy(w))).numpy())
    wt = torch.from_numpy(w).requires_grad_(True)
    cot = torch.from_numpy(RNG.normal(size=shape).astype(np.float32))
    (g,) = torch.autograd.grad((rmcm.fake_quant(wt) * cot).sum(), wt)
    assert torch.equal(g, cot)
    gj = jax.grad(lambda x: jnp.sum(jr.fake_quant(x) * jnp.asarray(
        cot.numpy())))(jnp.asarray(w))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))


def test_fake_quant_tree_matches_reference_bit_for_bit():
    """Matrices fake-quantized, biases passed through, exactly, on a tree
    shaped like part of the tiny NeRF's (the reference runs eagerly and
    compiles each op once per shape, so every shape costs)."""
    cfg = jax_tiny()
    p = _f32({"trunk": {"l0": {"w": RNG.normal(size=(cfg.pos_enc_dim, 64)),
                               "b": RNG.normal(size=(64,))}},
              "rgb": {"w": RNG.normal(size=(32, 3)) * 0.1,
                      "b": RNG.normal(size=(3,))}})
    _assert_trees(jr.fake_quant_tree(jax.tree.map(jnp.asarray, p)),
                  rmcm.fake_quant_tree(bridge.to_torch(p)), exact=True)


# ------------------------------------------------------------------ adam ----
_SHAPES = {"a": {"w": (8, 4), "b": (4,)}, "c": (3, 5, 6)}


def _decls(mk):
    return {"a": {"w": mk(_SHAPES["a"]["w"]), "b": mk(_SHAPES["a"]["b"])},
            "c": mk(_SHAPES["c"])}


def _random_tree(scale):
    return {"a": {"w": RNG.normal(size=(8, 4)) * scale,
                  "b": RNG.normal(size=(4,)) * scale},
            "c": RNG.normal(size=(3, 5, 6)) * scale}


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adam_update_matches_reference(moment_dtype, clip, weight_decay,
                                       n_steps):
    """Params, moments and step within 1e-6 of the reference after 1 and
    3 steps from the same params, grads and state; the metrics too."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                  weight_decay=weight_decay, moment_dtype=moment_dtype,
                  clip_norm=1.0 if clip == "active" else 1e4)
    jcfg, tcfg = ja.AdamConfig(**cfg_kw), ta.AdamConfig(**cfg_kw)
    jdecls = _decls(lambda s: JDecl(s, (None,) * len(s)))
    params = _f32(_random_tree(0.5))
    jp = jax.tree.map(jnp.asarray, params)
    jo = jax_init(ja.opt_state_decls(jdecls, jcfg), jax.random.PRNGKey(0),
                  "float32")
    tp = bridge.to_torch(params)
    to = init_params(ta.opt_state_decls(_decls(Decl), tcfg),
                     torch.Generator().manual_seed(0))
    _assert_trees(jo, to, exact=True)
    for _ in range(n_steps):
        grads = _f32(_random_tree(10.0))
        jp, jo, jm = ja.adam_update(jcfg, jp, jax.tree.map(jnp.asarray,
                                                          grads), jo)
        tp, to, tm = ta.adam_update(tcfg, tp, bridge.to_torch(grads), to)
    assert (float(jm["grad_norm"]) > jcfg.clip_norm) == (clip == "active")
    _assert_trees(jp, tp, atol=1e-6, rtol=1e-6)
    _assert_trees(jo, to, atol=1e-6, rtol=1e-6)
    assert int(to["step"]) == int(jo["step"]) == n_steps
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_schedule_and_global_norm_match_reference():
    """schedule at warmup, peak, decay and past the end, and global_norm,
    within 1e-6 (relative)."""
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100)
    jcfg, tcfg = ja.AdamConfig(**kw), ta.AdamConfig(**kw)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        np.testing.assert_allclose(
            float(ta.schedule(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(ja.schedule(jcfg, jnp.asarray(s, jnp.int32))),
            rtol=1e-6, atol=1e-12)
    tree = _f32(_random_tree(3.0))
    np.testing.assert_allclose(float(ta.global_norm(bridge.to_torch(tree))),
                               float(ja.global_norm(tree)), rtol=1e-6)


def test_bf16_neighbours_match_reference_nextafter():
    """The int16 step of a bf16 value gives jax.lax.nextafter's neighbour
    on the bf16 lattice, in both directions, through zero, subnormals and
    sign changes."""
    vals = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 3.0e38, -2.5,
                     1.0 + 2 ** -10, 7.1e-3, -6.5e4], np.float32)
    near = torch.from_numpy(vals).to(torch.bfloat16)
    jnear = jnp.asarray(vals).astype(jnp.bfloat16)
    for up, lim in ((True, jnp.inf), (False, -jnp.inf)):
        got = ta.bf16_neighbour(near, torch.full(vals.shape, up)).to(
            torch.float32).numpy()
        want = np.asarray(jax.lax.nextafter(
            jnear, jnp.full(vals.shape, lim, jnp.bfloat16)), np.float32)
        np.testing.assert_array_equal(got, want)


def test_stochastic_rounding_unbiased_and_seeded():
    """As the reference's test: rounding a value between two bf16 points
    lands on one of them, unbiased in expectation; the same generator
    seed gives the same bits."""
    x = torch.full((20000,), 1.0 + 2 ** -10)
    r = ta._sround(x, torch.Generator().manual_seed(0), torch.bfloat16)
    assert r.dtype == torch.bfloat16
    assert abs(float(r.float().mean()) - float(x[0])) < 1e-4
    assert set(np.unique(r.float().numpy())) <= {1.0, 1.0078125}
    r2 = ta._sround(x, torch.Generator().manual_seed(0), torch.bfloat16)
    assert torch.equal(r.view(torch.int16), r2.view(torch.int16))
    # through adam_update: bf16 params stay bf16 and move
    cfg = ta.AdamConfig(lr=1e-3, warmup_steps=1, stochastic_round=True)
    p = {"w": torch.ones(64, 8, dtype=torch.bfloat16)}
    o = init_params(ta.opt_state_decls({"w": Decl((64, 8))}, cfg),
                    torch.Generator())
    p1, _, _ = ta.adam_update(cfg, p, {"w": torch.ones(64, 8)}, o,
                              generator=torch.Generator().manual_seed(1))
    assert p1["w"].dtype == torch.bfloat16
    assert float(p1["w"].float().mean()) < 1.0


# ------------------------------------------------------------------- qat ----
def _qat_tree():
    return {"embed": RNG.normal(size=(10, 4)),
            "layers": {"ffn": {"w1": RNG.normal(size=(4, 8)) * 3},
                       "attn": {"wq": RNG.normal(size=(2, 4, 6))}},
            "pos_table": RNG.normal(size=(5, 4)),
            "final_norm": {"w": RNG.normal(size=(4,))}}


def test_qat_filter_and_fake_quant_selected_match_reference():
    """The filter selects the same leaves from the same key paths, and
    fake_quant_selected equals the reference bit for bit (unselected
    leaves untouched)."""
    tree = _f32(_qat_tree())
    jtree = jax.tree.map(jnp.asarray, tree)
    jsel = {tuple(p.key for p in path): jq.default_filter(path, leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tsel = {path: tq.default_filter(path, leaf)
            for path, leaf in _leaves_with_path(bridge.to_torch(tree))}
    assert tsel == jsel
    assert tsel[("layers", "ffn", "w1")] and not tsel[("embed",)]
    _assert_trees(jq.fake_quant_selected(jtree),
                  tq.fake_quant_selected(bridge.to_torch(tree)), exact=True)


def test_qat_loss_and_quantize_for_deploy_match_reference():
    """qat_loss sees the fake-quantized weights: its value equals the
    loss of the port's fake_quant applied by hand bit for bit, and the
    reference's wrapper within 1e-6 (relative; the product sums in another
    order); its gradient is finite and non-zero. quantize_for_deploy gives
    the reference's {mag, sign, scale} leaves exactly and passes the rest
    through."""
    tree = _f32(_qat_tree())
    x = RNG.normal(size=(2, 4)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(x @ p["layers"]["ffn"]["w1"])

    def tloss(p, x):
        return torch.sum(x @ p["layers"]["ffn"]["w1"])

    jv = jq.qat_loss(jloss)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = bridge.to_torch(tree)
    w1 = tp["layers"]["ffn"]["w1"].requires_grad_(True)
    tv = tq.qat_loss(tloss)(tp, torch.from_numpy(x))
    by_hand = tloss({"layers": {"ffn": {"w1": rmcm.fake_quant(w1)}}},
                    torch.from_numpy(x))
    assert float(tv.detach()) == float(by_hand.detach())
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    (g,) = torch.autograd.grad(tv, w1)
    assert bool(torch.isfinite(g).all()) and float(g.norm()) > 0
    _assert_trees(jq.quantize_for_deploy(jax.tree.map(jnp.asarray, tree)),
                  tq.quantize_for_deploy(bridge.to_torch(tree)), exact=True)


# ----------------------------------------------------------- one step -------
def _dataset_batch(n_rays=256):
    ds = TR.make_dataset(TR.blob_scene(), 2, 16, 16, device="cpu")
    idx = np.random.default_rng(0).integers(0, ds["rgb"].shape[0], n_rays)
    return {k: v.numpy()[idx] for k, v in ds.items()}


@pytest.mark.parametrize("qat", [False, True])
def test_one_train_step_matches_reference(qat):
    """The deterministic route on both sides (key=None / no generator),
    the reference's weights and the same batch: loss and metrics within
    1e-5 relative; every gradient leaf within 3e-4 of that leaf's largest
    |g| (see the module docstring); then the params and moments after the
    Adam step of each side's own train step."""
    cfg_j, cfg_t = jax_tiny(), tiny()
    p = jax.jit(lambda k: jax_init(jax_plcore_decls(cfg_j), k, "float32"))(
        jax.random.PRNGKey(0))
    batch = _dataset_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = bridge.to_torch(batch)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jnt.make_nerf_loss(cfg_j, qat=qat), has_aux=True))(p, jb, None)
    (tl, taux), tg = tnt.value_and_grad(tnt.make_nerf_loss(cfg_t, qat=qat))(
        _t(p), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("mse", "psnr"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)
    for path, want in _leaves_with_path(_np(jg)):
        got = _at(tg, path).numpy()
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 3e-4 * scale, (
            path, float(np.abs(got - want).max()) / scale)

    # the reference's train step is exactly this value_and_grad followed
    # by adam_update (core/nerf_train.py), so its update is taken from the
    # gradients above rather than from a second compile of the whole step
    ocfg = dict(lr=5e-3, warmup_steps=20, total_steps=300, weight_decay=0.0)
    jcfg, tcfg = ja.AdamConfig(**ocfg), ta.AdamConfig(**ocfg)
    jo = jax_init(ja.opt_state_decls(jax.tree.map(
        lambda a: JDecl(a.shape, (None,) * a.ndim), p), jcfg),
        jax.random.PRNGKey(0), "float32")
    jp1, jo1, jom = jax.jit(functools.partial(ja.adam_update, jcfg))(
        p, jg, jo)
    jm = {**jaux, **jom, "loss": jl}
    tp1, to1, tm = tnt.make_nerf_train_step(cfg_t, tcfg, qat=qat)(
        _t(p), _t(jo), tb)
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr", "mse",
                                        "psnr"]
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    # the first Adam step moves every weight by lr * g / (|g| + eps), a
    # full lr step whatever |g| is, so a weight whose gradient is
    # near zero (where the two sides' gradients differ in sign) moves
    # differently; every weight whose |g| exceeds 1e-3 of its leaf's
    # largest agrees within 1e-6, and those are at least 80% of a leaf
    for path, want in _leaves_with_path(_np(jp1)):
        got = _at(tp1, path).numpy()
        g = _at(_np(jg), path)
        settled = np.abs(g) > 1e-3 * np.abs(g).max()
        assert settled.mean() >= 0.8, (path, settled.mean())
        np.testing.assert_allclose(got[settled], want[settled], atol=1e-6,
                                   rtol=1e-6, err_msg=str(path))
    assert int(to1["step"]) == int(jo1["step"]) == 1


def test_keyed_step_properties():
    """The keyed route cannot reproduce jax.random, so it is held to its
    properties: jittered coarse samples sorted inside [near, far], the
    merged set sorted and inside it, finite loss and gradients, and the
    same generator seed gives the same step bit for bit."""
    cfg = tiny()
    g = torch.Generator().manual_seed(7)
    t_c = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse, (64,), g)
    w = torch.rand(64, cfg.n_coarse, generator=g)
    t_f = sampling.importance(t_c, w, cfg.n_fine, g)
    t_all = sampling.merge_sorted(t_c, t_f)
    for t in (t_c, t_all):
        assert bool((t[:, 1:] >= t[:, :-1]).all())
        assert float(t.min()) >= cfg.near and float(t.max()) <= cfg.far
    assert not torch.equal(t_c[0], t_c[1])           # jittered per ray

    ocfg = ta.AdamConfig(lr=5e-3, warmup_steps=20, total_steps=300,
                         weight_decay=0.0)
    p, o = tnt.init_nerf_state(cfg, ocfg, torch.Generator().manual_seed(0),
                               device="cpu")
    batch = bridge.to_torch(_dataset_batch(128))
    step = tnt.make_nerf_train_step(cfg, ocfg, qat=True)
    (loss, _), grads = tnt.value_and_grad(tnt.make_nerf_loss(cfg, qat=True))(
        p, batch, torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(x).all()) for x in ta.tree_leaves(grads))
    outs = [step(p, o, batch, torch.Generator().manual_seed(3))
            for _ in range(2)]
    for a, b in zip(ta.tree_leaves(outs[0][0]), ta.tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    other = step(p, o, batch, torch.Generator().manual_seed(4))
    assert float(other[2]["loss"]) != float(outs[0][2]["loss"])


# --------------------------------------------------------------- dataset ----
def test_render_gt_dataset_and_holdout_match_reference():
    """render_gt (midpoint marching), make_dataset and holdout_view equal
    the reference's to 1e-6, on both scenes."""
    for name in ("blobs", "sphere"):
        js, ts = JR.SCENES[name](), TR.SCENES[name]()
        jd = JR.make_dataset(js, 3, 12, 10, focal=2.4 * 10)
        td = TR.make_dataset(ts, 3, 12, 10, focal=2.4 * 10, chunk=64,
                             device="cpu")
        for k in ("rays_o", "rays_d", "rgb"):
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       atol=1e-6, rtol=0, err_msg=(name, k))
        jh = jax.jit(JR.holdout_view, static_argnums=(0, 1, 2, 3))(
            js, 9, 11, 20.0)
        th = TR.holdout_view(ts, 9, 11, focal=20.0, device="cpu")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0, err_msg=name)
    gt = td["rgb"].numpy()
    assert gt.std() > 0 and np.isfinite(gt).all()


def test_ray_batches_in_range_and_seeded():
    """Indices lie in range (every row comes from the dataset), a seed
    reproduces the stream, another seed does not."""
    n = 300
    ds = {"i": torch.arange(n), "rays_o": torch.rand(n, 3)}

    def take(seed, k=4):
        it = TR.ray_batches(ds, 64, torch.Generator().manual_seed(seed))
        return [next(it) for _ in range(k)]

    a, b, c = take(1), take(1), take(2)
    for x, y in zip(a, b):
        assert torch.equal(x["i"], y["i"])
    assert not all(torch.equal(x["i"], y["i"]) for x, y in zip(a, c))
    for x in a:
        assert int(x["i"].min()) >= 0 and int(x["i"].max()) < n
        assert torch.equal(x["rays_o"], ds["rays_o"][x["i"]])


def test_short_qat_run_improves_psnr():
    """The reference's QAT convergence test on the port (tiny(), 4 views
    at 24x24, lr 5e-3; 80 steps of 256 rays where the reference takes 120
    of 512, to stay at a few seconds on one CPU thread): the training PSNR
    rises by more than 3 dB, and after QAT the RMCM render of 256 dataset
    rays stays above 20 dB against the exact one."""
    cfg = tiny()
    ocfg = ta.AdamConfig(lr=5e-3, warmup_steps=20, total_steps=300,
                         weight_decay=0.0)
    params, opt = tnt.init_nerf_state(cfg, ocfg,
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
    ds = TR.make_dataset(TR.blob_scene(), 4, 24, 24, device="cpu")
    it = TR.ray_batches(ds, 256, torch.Generator().manual_seed(1))
    jitter = torch.Generator().manual_seed(2)
    step = tnt.make_nerf_train_step(cfg, ocfg, qat=True)
    psnrs = []
    for _ in range(80):
        params, opt, m = step(params, opt, next(it), jitter)
        psnrs.append(float(m["psnr"]))
    assert all(np.isfinite(psnrs))
    assert psnrs[-1] > psnrs[0] + 3.0, (psnrs[0], psnrs[-1])
    quant = {n: rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
    o, d = ds["rays_o"][:256], ds["rays_d"][:256]
    exact = plcore.render_rays(cfg, params, o, d)["rgb"]
    q = plcore.render_rays(cfg, params, o, d, quant=quant)["rgb"]
    assert float(tnt.psnr(torch.mean(torch.square(exact - q)))) > 20.0


def test_training_entry_points_need_a_card_by_default():
    """init_nerf_state, make_dataset and holdout_view default to cuda and
    raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        tnt.init_nerf_state(cfg, ta.AdamConfig(), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.make_dataset(TR.blob_scene(), 1, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.holdout_view(TR.blob_scene(), 4, 4)
