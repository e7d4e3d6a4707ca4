"""The port's CUDA kernels (K1, K2, K3) against their plain versions on
the card: K1 and K2 at a ragged multi-ray tile in f32 (3xTF32) and RMCM
(bf16x3), at every built width pair and with a coarse and a fine network
of different formats, K2 also at the adaptive budgets Nf = 8, 32, 64 with
dead rows; an unbuilt width pair raising; K3 in both its routes (M <= 64 splits K) at ragged K and N, in
f32 and bf16, two calls giving the same bits, and its f32 error against a
float64 product within twice the plain f32 version's. Then NeRF training
on the card: one QAT train step at the full width against the same step
on the CPU, and the training entry points' default device.

Imports neither JAX nor the reference package, so it runs on a machine
with a card and no JAX (``--noconftest`` skips the suite's JAX-based
conftest there):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Without a CUDA device the test skips.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import nerf_train
from repro_torch.data import rays as R_
from repro_torch.optim import adam
from repro_torch.configs.nerf_icarus import CONFIG
from repro_torch.core import plcore, rmcm, sampling
from repro_torch.kernels import fused_plcore, ops, ref
from repro_torch.kernels import rmcm_matmul as k3
from repro_torch.models.params import init_params as torch_init

# 67 rays in tiles of 4: every block walks several rays and the last tile
# is ragged (3 rays)
R, RT = 67, 4


def _ert_eps_between(acc_c):
    """An ERT eps whose threshold lies midway between two neighbouring
    distinct coarse acc values (the widest gap of the middle half), so
    that some rays die, others do not, and no ray sits on the threshold."""
    below = torch.unique(acc_c[acc_c < 1.0]).double()
    n = below.numel()
    assert n >= 4, below
    lo, hi = n // 4, max(n // 4 + 1, 3 * n // 4)
    i = lo + int(torch.argmax(below[lo + 1:hi + 1] - below[lo:hi]))
    return 1.0 - float((below[i] + below[i + 1]) / 2)


def _rays(n, seed=5):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    o[:, :2] = rng.uniform(-0.3, 0.3, (n, 2))
    d = rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    d[:, 2] -= 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """Full-width K1 and K2 on CUDA tensors against their plain versions
    on the same tensors (what ``chip_smoke.py`` checks at scale): f32 and
    RMCM; K2 without ERT, with an ERT eps that kills some rays and not
    others, and with an alive mask; K1 with an alive mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = CONFIG
    params = torch_init(plcore.plcore_decls(cfg),
                        torch.Generator().manual_seed(0))
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(R))
    alive = (torch.arange(R, device=dev) % 3 != 0).to(torch.float32)
    rows = ops.sample_rows(cfg, dev)
    assert R % RT != 0 and RT > 1
    for quantized in (False, True):
        packed = {}
        for n in ("coarse", "fine"):
            q = rmcm.quantize_tree(params[n]) if quantized else None
            packed[n] = bridge.to_device(
                ops.kernel_weights(cfg, params[n], q), dev)
        tol = 5e-3 if quantized else 1e-3
        args = (cfg, packed["coarse"], packed["fine"], o, d, *rows)

        def both(eps, mask):
            k = fused_plcore.two_pass_plcore_call(*args, rt=RT, ert_eps=eps,
                                                  alive=mask)
            p = ref.two_pass_ref(*args, rt=R, ert_eps=eps, alive=mask)
            torch.cuda.synchronize()
            t = 5e-3 if (eps or mask is not None) else tol
            for i, (a, b) in enumerate(zip(k, p)):
                torch.testing.assert_close(a, b, rtol=0,
                                           atol=1e-2 if i == 4 else t)
            return p

        acc_c = both(0.0, None)[3]
        eps = _ert_eps_between(acc_c)
        dead = int((acc_c >= ref.ert_threshold(eps)).sum())
        assert eps > 0.0 and 0 < dead < R, (eps, dead)
        both(eps, None)
        both(0.0, alive)

        t = sampling.stratified(cfg.near, cfg.far, cfg.n_coarse, (R,),
                                device=dev)
        dl = sampling.deltas_from_t(t)
        k = fused_plcore.fused_plcore_call(cfg, packed["fine"], o, d, t, dl,
                                           rt=RT, alive=alive)
        p = ref.fused_plcore_ref(cfg, packed["fine"], o, d, t, dl, rt=R,
                                 alive=alive)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            torch.testing.assert_close(a, b, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n_fine", [8, 32, 64])
@pytest.mark.parametrize("quantized", [False, True])
def test_k2_at_adaptive_budgets_on_card(n_fine, quantized):
    """K2 at the adaptive budgets of n_fine = 128 (its fine pass ragged
    inside the 128-sample chunk: 72, 96 or 128 samples) with a third of the
    rays dead, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CONFIG, n_fine=n_fine)
    params = torch_init(plcore.plcore_decls(cfg),
                        torch.Generator().manual_seed(1))
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(R, seed=6))
    alive = (torch.arange(R, device=dev) % 3 != 0).to(torch.float32)
    packed = {}
    for n in ("coarse", "fine"):
        q = rmcm.quantize_tree(params[n]) if quantized else None
        packed[n] = bridge.to_device(ops.kernel_weights(cfg, params[n], q),
                                     dev)
    args = (cfg, packed["coarse"], packed["fine"], o, d,
            *ops.sample_rows(cfg, dev))
    k = fused_plcore.two_pass_plcore_call(*args, rt=RT, ert_eps=0.0,
                                          alive=alive)
    p = ref.two_pass_ref(*args, rt=R, ert_eps=0.0, alive=alive)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(k, p)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-2 if i == 4 else 5e-3)

# the width pairs the kernels are built for beyond the full NerfConfig:
# tiny() and the reference kernel tests' sweep (tests/test_kernels.py)
WIDTH_CONFIGS = {
    "tiny": dict(trunk_layers=4, trunk_width=64, skip_at=(2,),
                 color_width=32, pos_freqs=6, dir_freqs=3, n_coarse=16,
                 n_fine=16),
    "sweep5": dict(trunk_layers=5, trunk_width=64, skip_at=(2, 4),
                   color_width=32, pos_freqs=6, dir_freqs=3, n_coarse=16,
                   n_fine=16),
    "sweep2": dict(trunk_layers=2, trunk_width=32, skip_at=(1,),
                   color_width=16, pos_freqs=4, dir_freqs=2, n_coarse=8,
                   n_fine=8),
    "full": {},
}


@pytest.mark.gpu
@pytest.mark.parametrize("formats", ["f32/f32", "rmcm/rmcm", "f32/rmcm",
                                     "rmcm/f32"])
@pytest.mark.parametrize("name", sorted(WIDTH_CONFIGS))
def test_kernels_at_every_width_and_format_on_card(name, formats):
    """K2 at each built width pair with every (coarse, fine) weight
    format pair, and K1 in the fine network's format, against their plain
    versions on the same CUDA tensors: 1e-3 when every network is f32,
    5e-3 with RMCM, ERT or an alive mask (depth 1e-2, as at full width).
    The full width runs the mixed pairs only (the same-format pairs are
    ``test_kernels_match_plain_versions_on_card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qc, qf = (f == "rmcm" for f in formats.split("/"))
    if name == "full" and qc == qf:
        pytest.skip("same-format full width: the full-width test")
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CONFIG, **WIDTH_CONFIGS[name])
    params = torch_init(plcore.plcore_decls(cfg),
                        torch.Generator().manual_seed(2))
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(R, seed=7))
    alive = (torch.arange(R, device=dev) % 3 != 0).to(torch.float32)
    packed = {}
    for n, q in (("coarse", qc), ("fine", qf)):
        packed[n] = bridge.to_device(ops.kernel_weights(
            cfg, params[n], rmcm.quantize_tree(params[n]) if q else None),
            dev)
    args = (cfg, packed["coarse"], packed["fine"], o, d,
            *ops.sample_rows(cfg, dev))
    tol = 5e-3 if (qc or qf) else 1e-3
    key = fused_plcore.instance_name(cfg, "two_pass_plcore_call", (qc, qf))
    n0 = fused_plcore.INSTANCE_LAUNCHES.get(key, 0)

    def both(eps, mask):
        k = fused_plcore.two_pass_plcore_call(*args, rt=RT, ert_eps=eps,
                                              alive=mask)
        p = ref.two_pass_ref(*args, rt=R, ert_eps=eps, alive=mask)
        torch.cuda.synchronize()
        t = 5e-3 if (eps or mask is not None) else tol
        for i, (a, b) in enumerate(zip(k, p)):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-2 if i == 4 else t)
        return p

    acc_c = both(0.0, None)[3]
    eps = _ert_eps_between(acc_c)
    dead = int((acc_c >= ref.ert_threshold(eps)).sum())
    assert eps > 0.0 and 0 < dead < R, (eps, dead)
    both(eps, None)
    both(0.0, alive)
    assert fused_plcore.INSTANCE_LAUNCHES[key] == n0 + 3

    t = sampling.stratified(cfg.near, cfg.far, cfg.n_samples, (R,),
                            device=dev)
    dl = sampling.deltas_from_t(t)
    k = fused_plcore.fused_plcore_call(cfg, packed["fine"], o, d, t, dl,
                                       rt=RT, alive=alive)
    p = ref.fused_plcore_ref(cfg, packed["fine"], o, d, t, dl, rt=R,
                             alive=alive)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=5e-3 if qf else 1e-3)


@pytest.mark.gpu
def test_unbuilt_width_pair_raises_on_card():
    """A width pair the kernels are not built for raises ValueError on the
    card, naming the built pairs; it never runs the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CONFIG, trunk_width=128, color_width=64)
    params = torch_init(plcore.plcore_decls(cfg),
                        torch.Generator().manual_seed(0))
    packed = {n: bridge.to_device(ops.kernel_weights(cfg, params[n]), dev)
              for n in ("coarse", "fine")}
    o, d = (torch.from_numpy(x).to(dev) for x in _rays(8))
    n0 = dict(fused_plcore.LAUNCHES)
    with pytest.raises(ValueError, match=r"\(256, 128\), \(64, 32\)"):
        ops.fused_render_two_pass(cfg, packed, o, d)
    with pytest.raises(ValueError, match="built for"):
        fused_plcore.two_pass_plcore_call(
            cfg, packed["coarse"], packed["fine"], o, d,
            *ops.sample_rows(cfg, dev), rt=2, ert_eps=0.0)
    assert dict(fused_plcore.LAUNCHES) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (7, 13, 5), (128, 256, 128),
                                   (64, 300, 96), (33, 512, 65),
                                   (512, 256, 256), (16, 1536, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmcm_matmul_matches_plain_version_on_card(m, k, n, dtype):
    """K3 against its plain version on the same CUDA tensors, at the
    reference test's tolerances (f32 2e-4/1e-4, bf16 0.3/0.05): ragged
    M, N and K, a trunk-layer and a decode-shaped product, and the entry
    point with leading dims and the reference's block sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    packed = bridge.to_device(rmcm.pack(rmcm.quantize(w)), dev)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, dt)
    atol, rtol = (2e-4, 1e-4) if dtype == "float32" else (0.3, 0.05)
    n0 = k3.LAUNCHES["rmcm_matmul"]
    got = k3.rmcm_matmul(x, packed)
    want = ref.rmcm_matmul_ref(x, packed)
    torch.cuda.synchronize()
    assert k3.LAUNCHES["rmcm_matmul"] == n0 + 1
    assert got.dtype == dt and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    y = ops.rmcm_matmul(x.reshape(1, m, k), packed, bm=8, bn=16, bk=32)
    torch.cuda.synchronize()
    assert torch.equal(y.reshape(m, n), got)


# K not a multiple of 16 and N not of 8 (plain staging), and a shape whose
# rows are 16-byte aligned (cp.async staging); M on both sides of the
# route switch at 64
@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16, 63, 64, 65, 4103])
@pytest.mark.parametrize("k,n", [(300, 90), (512, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmcm_matmul_routes_on_card(m, k, n, dtype):
    """Each route of K3 against its plain version, counted by route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(m + k + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    packed = bridge.to_device(rmcm.pack(rmcm.quantize(w)), dev)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, dt)
    route = k3.route(m)
    assert route == ("small_m" if m <= 64 else "large_m")
    n0 = k3.ROUTE_LAUNCHES[route]
    got = k3.rmcm_matmul(x, packed)
    want = ref.rmcm_matmul_ref(x, packed)
    torch.cuda.synchronize()
    assert k3.ROUTE_LAUNCHES[route] == n0 + 1
    atol, rtol = (2e-4, 1e-4) if dtype == "float32" else (0.3, 0.05)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 1536, 8960), (65, 1536, 8960),
                                   (64, 300, 90), (4103, 512, 256)])
def test_rmcm_matmul_f32_error_within_plain_versions_on_card(m, k, n):
    """At a long K the f32 sum's rounding shows: against a float64 product,
    the kernel's largest error is at most twice the plain f32 version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(m + 3 * k + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    packed = bridge.to_device(rmcm.pack(rmcm.quantize(w)), dev)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    sg = rmcm.unpack_signs(packed["sign_bits"],
                           packed["sign_bits"].shape[0] * 8)[:k]
    exact = (x.double() @ (packed["mag"].double() * (1.0 - 2.0 * sg.double()))
             ) * packed["scale"].double().reshape(1, -1)
    got = k3.rmcm_matmul(x, packed)
    plain = ref.rmcm_matmul_ref(x, packed)
    e_k = float((got.double() - exact).abs().max())
    e_p = float((plain.double() - exact).abs().max())
    assert e_k <= 2.0 * e_p, (e_k, e_p)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 1536, 8960), (64, 1536, 896),
                                   (4103, 512, 256)])
def test_rmcm_matmul_repeats_bit_for_bit_on_card(m, k, n):
    """Two calls on the same inputs give the same bits: the split-K route
    adds its partial sums in a fixed order, with no float atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(m)
    packed = rmcm.pack(rmcm.quantize(torch.randn(k, n, generator=gen,
                                                 device=dev)))
    x = torch.randn(m, k, generator=gen, device=dev)
    first = k3.rmcm_matmul(x, packed)
    for _ in range(3):
        assert torch.equal(k3.rmcm_matmul(x, packed), first)


def _leaf_paths(tree, prefix=""):
    """'/'-joined key paths of a nested dict, in ``adam.tree_leaves``'s
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                     else k)]
    return [prefix]


def _train_step_on_both(round_resample: bool):
    """One deterministic QAT train step at the full ``NerfConfig()`` width
    on 128 dataset rays, on the CPU and on the card from the same weights,
    state and batch, TF32 off. ``round_resample`` rounds the resampler's
    input (the detached coarse weights) to bf16 on both sides first, so
    that last-ulp differences between the two devices' coarse passes do
    not move fine samples. Returns (cpu, card) tuples of (loss, metrics,
    grads, params after the step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CONFIG
    ocfg = adam.AdamConfig(lr=5e-4, warmup_steps=100, total_steps=1000,
                           weight_decay=0.0)
    params, opt = nerf_train.init_nerf_state(
        cfg, ocfg, torch.Generator().manual_seed(0), device="cpu")
    ds = R_.make_dataset(R_.blob_scene(), 2, 32, 32, focal=2.4 * 32,
                         device="cpu")
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, ds["rgb"].shape[0], 128))
    batch = {k: v[idx] for k, v in ds.items()}
    dev = torch.device("cuda")
    importance = sampling.importance

    def rounded(t_mid, weights, n, generator=None):
        w = weights.to(torch.bfloat16).to(torch.float32)
        return importance(t_mid, w, n, generator)

    out = {}
    try:
        if round_resample:
            sampling.importance = rounded
        for where, to in (("cpu", lambda t: t),
                          ("cuda", lambda t: bridge.to_device(t, dev))):
            grad_fn = nerf_train.value_and_grad(
                nerf_train.make_nerf_loss(cfg, qat=True))
            (loss, aux), grads = grad_fn(to(params), to(batch))
            p1, o1, m = nerf_train.make_nerf_train_step(cfg, ocfg, qat=True)(
                to(params), to(opt), to(batch))
            out[where] = (loss, m, bridge.to_device(grads, "cpu"),
                          bridge.to_device(p1, "cpu"))
    finally:
        sampling.importance = importance
    return out["cpu"], out["cuda"]


def _leaf_gaps(gc, gg) -> list:
    """(path, max |g_card - g_cpu|, largest |g_cpu| of the leaf) per
    gradient leaf."""
    return [(path, float((b - a).abs().max()), float(a.abs().max()))
            for path, a, b in zip(_leaf_paths(gc), adam.tree_leaves(gc),
                                  adam.tree_leaves(gg))]


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One deterministic QAT train step (no generator) at the full
    ``NerfConfig()`` width on 128 dataset rays, on the card and on the
    CPU from the same weights, state and batch, TF32 off: loss and
    metrics within 1e-5 relative; every gradient leaf within 1e-3 of the
    largest |g| of the whole gradient (each leaf against its own:
    ``test_train_step_leaf_gaps_do_not_come_from_the_resampler``); the
    params after the step within 1e-6 (1e-5 relative) wherever |g|
    exceeds 1e-3 of the largest, since a first Adam step moves a weight
    by lr * sign(g). Prints each leaf's gap against its own largest |g|,
    the worst first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (lc, mc, gc, pc), (lg, mg, gg, pg) = _train_step_on_both(False)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for k in mc:
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-5)
    gaps = _leaf_gaps(gc, gg)
    for path, gap, own in sorted(gaps, key=lambda g: -g[1] / max(g[2], 1e-30)):
        print(f"leaf {path}: gap {gap:.3e}, own max |g| {own:.3e}, "
              f"ratio {gap / max(own, 1e-30):.3e}")
    scale = max(own for _, _, own in gaps)
    for (path, gap, _), pcpu, pcard, gcpu in zip(
            gaps, adam.tree_leaves(pc), adam.tree_leaves(pg),
            adam.tree_leaves(gc)):
        assert gap <= 1e-3 * scale, (path, gap, scale)
        settled = gcpu.abs() > 1e-3 * scale
        np.testing.assert_allclose(pcard[settled].numpy(),
                                   pcpu[settled].numpy(), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.gpu
def test_train_step_leaf_gaps_do_not_come_from_the_resampler():
    """The step twice more, with the resampler's input as it is and
    rounded to bf16 on both sides (so that no last-ulp difference of the
    coarse weights moves a fine sample): each leaf's gap against its own
    largest |g| is printed for both, and the rounding leaves them where
    they were (the worst leaf the same, its ratio within 20%), so the
    resampler does not explain them. They sit in the fine trunk, whose
    own gradients are one to two orders below the largest; before
    ``rmcm.quantize`` divided exactly on the card they were about twice
    as large (the RMCM scales differed:
    ``test_rmcm_quantize_on_card_equals_cpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    worst = {}
    for resample in ("as_is", "rounded_bf16"):
        (lc, _, gc, _), (lg, _, gg, _) = _train_step_on_both(
            resample == "rounded_bf16")
        np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
        ratios = sorted(((gap / max(own, 1e-30), path, gap, own)
                         for path, gap, own in _leaf_gaps(gc, gg)),
                        reverse=True)
        for ratio, path, gap, own in ratios:
            print(f"{resample} leaf {path}: gap {gap:.3e}, own max |g| "
                  f"{own:.3e}, ratio {ratio:.3e}")
        worst[resample] = ratios[0][:2]
    (r0, p0), (r1, p1) = worst["as_is"], worst["rounded_bf16"]
    assert p0 == p1 and abs(r1 - r0) <= 0.2 * r0, worst


@pytest.mark.gpu
def test_rmcm_quantize_on_card_equals_cpu():
    """RMCM quantization of the same weights on the card and on the CPU,
    bit for bit: scale, magnitudes, signs, and QAT's fake-quant values
    (the scale is a true division on both; a product with the reciprocal
    of 255 rounds most scales differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((283, 256)).astype(np.float32))
    wc = w.to("cuda")
    q, qc = rmcm.quantize(w), rmcm.quantize(wc)
    for k in ("scale", "mag", "sign"):
        assert torch.equal(qc[k].cpu(), q[k]), k
    assert torch.equal(rmcm.fake_quant(wc).cpu(), rmcm.fake_quant(w))


@pytest.mark.gpu
def test_training_entry_points_default_to_the_card(tmp_path):
    """init_nerf_state, make_dataset, holdout_view and Checkpointer.restore
    put every tensor on cuda when no device is given."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.nerf_icarus import tiny
    params, opt = nerf_train.init_nerf_state(tiny(), adam.AdamConfig(),
                                             torch.Generator().manual_seed(0))
    ds = R_.make_dataset(R_.blob_scene(), 1, 8, 8)
    ro, rd, gt = R_.holdout_view(R_.blob_scene(), 8, 8)
    c = Checkpointer(str(tmp_path))
    c.save(1, {"params": params, "opt_state": opt})
    c.wait()
    restored, _ = c.restore()
    leaves = (adam.tree_leaves(params) + adam.tree_leaves(opt)
              + list(ds.values()) + [ro, rd, gt]
              + adam.tree_leaves(restored))
    assert all(t.device.type == "cuda" for t in leaves)


# ------------------------------------------------- SDF / SLF through K3 --
# the SDF's and SLF's RMCM layers at full width: K = PEU.out_dim (259,
# 262; not multiples of 8), the hidden widths, and the heads' N = 1 and 3
_WORKLOAD_SHAPES = [(4096, 259, 256), (4096, 256, 256), (4096, 256, 1),
                    (4096, 262, 256), (4096, 256, 128), (4096, 128, 3),
                    (37, 259, 256), (37, 256, 1), (37, 128, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", _WORKLOAD_SHAPES)
def test_rmcm_matmul_at_sdf_and_slf_shapes_on_card(m, k, n):
    """K3 at the SDF and SLF layer shapes (f32 x, both routes) against its
    plain version at the reference test's tolerances; the ragged edges at
    N < 8 masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(m + 5 * k + 11 * n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    packed = bridge.to_device(rmcm.pack(rmcm.quantize(w)), dev)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev)
    n0 = k3.LAUNCHES["rmcm_matmul"]
    got = k3.rmcm_matmul(x, packed)
    want = ref.rmcm_matmul_ref(x, packed)
    torch.cuda.synchronize()
    assert k3.LAUNCHES["rmcm_matmul"] == n0 + 1
    assert got.shape == (m, n)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.gpu
def test_sdf_and_slf_route_rmcm_layers_through_k3_on_card():
    """The generic MLP on the card: a ``pack_quant`` tree sends every layer
    through K3 (one launch per layer and call), within 5e-3 of the plain
    route (the unpacked tree) for the SDF's distances, its sphere trace and
    the SLF's colours."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import encoding, mlp, sdf, slf
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    peu = encoding.PEU("rff_iso", 3, n_features=128, sigma=2.0,
                       generator=gen, device=dev)
    p = bridge.to_device(torch_init(sdf.sdf_decls(peu),
                                    torch.Generator().manual_seed(1)), dev)
    q = rmcm.quantize_tree(p)
    qp = mlp.pack_quant(q)
    pts = torch.rand((1000, 3), generator=gen, device=dev) * 2 - 1
    n0 = k3.LAUNCHES["rmcm_matmul"]
    d_k3 = sdf.sdf_eval(peu, p, pts, quant=qp)
    assert k3.LAUNCHES["rmcm_matmul"] == n0 + 5
    d_plain = sdf.sdf_eval(peu, p, pts, quant=q)
    assert k3.LAUNCHES["rmcm_matmul"] == n0 + 5
    torch.testing.assert_close(d_k3, d_plain, atol=5e-3, rtol=0)
    speu = slf.make_slf_peu(gen, device=dev)
    sp = bridge.to_device(torch_init(slf.slf_decls(speu),
                                     torch.Generator().manual_seed(2)), dev)
    sq = rmcm.quantize_tree(sp)
    dirs = torch.nn.functional.normalize(
        torch.randn((1000, 3), generator=gen, device=dev), dim=-1)
    torch.testing.assert_close(
        slf.slf_eval(speu, sp, pts, dirs, quant=mlp.pack_quant(sq)),
        slf.slf_eval(speu, sp, pts, dirs, quant=sq), atol=5e-3, rtol=0)


@pytest.mark.gpu
def test_percell_dispatch_on_one_card_with_eight_cells():
    """The single-card stand-in: 8 cells on cuda:0, each with its own
    stream; K2 per-cell tiles equal the replicated render bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.nerf_icarus import tiny
    from repro_torch.core.pipeline import PackedPlcore
    from repro_torch.runtime import sharding as rsh
    import dataclasses
    cfg = dataclasses.replace(tiny(), trunk_layers=8, skip_at=(4,))
    params = torch_init(plcore.plcore_decls(cfg),
                        torch.Generator().manual_seed(0))
    mesh = rsh.plcore_mesh(devices=["cuda:0"] * 8)
    base = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True)
    pp = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                      shard_mesh=mesh)
    o, d = _rays(300)
    want = base.render_tile(o, d).cpu().numpy()
    streams = set()
    for cell in range(8):
        h, cost = pp.dispatch_tile(o, d, home_cell=cell, percell=True)
        assert cost["cell"] == cell
        assert np.array_equal(h.result(), want)
        streams.add(rsh.cell_stream(mesh, cell))
    assert len(streams) == 8 and None not in streams
    assert np.array_equal(pp.render_tile(o, d).cpu().numpy(), want)
