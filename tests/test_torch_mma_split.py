"""Operand preparation of the port's tensor-core kernels, on the CPU.

The kernels keep f32 results on the tensor cores with exact split
products (``kernels/csrc/mma_split.cuh``): RMCM weights as bf16 signed
magnitudes times bf16x3 pieces of the activations, f32 weights as TF32
hi/lo pairs (3xTF32). What the CUDA code cannot show here, these tests
hold in plain PyTorch:
* the stream ``ops.mma_stream`` makes at pack time: bf16 signed
  magnitudes equal mag * (1 - 2 s) exactly for every magnitude the nibble
  table gives, TF32 hi has its low 13 mantissa bits clear and
  |w - hi - lo| <= 2^-21 |w|, the K-padding rows are zero, ``ops.mma_matrix``
  undoes the layout, and each element sits where wgmma's K-major,
  unswizzled B descriptor (core matrices of 8 columns x 16 bytes, the K
  half at +128 bytes, the next 8 columns at +256) reads it;
* the bf16x3 split (``ref.split_bf16x3``) rebuilds f32 exactly from 1e-30 to
  1e30, both signs and zero;
* the RMCM route's product emulated in f32 (split x exact weight, f32 sum,
  scale last) agrees with the plain K3 and the reference's at K3's f32
  tolerance (atol 2e-4, rtol 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmcm as jr
from repro.kernels.ref import rmcm_matmul_ref as jax_rmcm_ref

from repro_torch import bridge
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core import rmcm
from repro_torch.core.plcore import plcore_decls
from repro_torch.kernels import fused_plcore, ops, ref
from repro_torch.models.params import init_params

K3_F32_TOL = dict(atol=2e-4, rtol=1e-4)
# every magnitude the nibble table gives: 12 x 12 values, 0 to 238
MAGNITUDES = torch.unique(rmcm.approx_magnitude(torch.arange(256)))
MATRICES = ["trunk0", "trunk1", "trunk_skip", "feat", "color0"]


@pytest.fixture(scope="module")
def net():
    cfg = tiny()
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0))
    return cfg, params["fine"]


def _nibble_quant(cfg, params):
    """The RMCM tree of ``params`` with its magnitudes and signs replaced
    by a seeded draw over every magnitude and both signs."""
    q = rmcm.quantize_tree(params)
    rng = np.random.default_rng(11)
    for leaf in _qleaves(q):
        shape = tuple(leaf["mag"].shape)
        idx = torch.from_numpy(rng.integers(0, len(MAGNITUDES), shape))
        n = min(idx.numel(), len(MAGNITUDES))   # every one, where room
        idx.view(-1)[:n] = torch.arange(n)
        leaf["mag"] = MAGNITUDES[idx].to(torch.uint8)
        leaf["sign"] = torch.from_numpy(rng.integers(0, 2, shape)).bool()
    return q


def _qleaves(tree):
    if isinstance(tree, dict) and "mag" in tree:
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qleaves(v)


def _logical(cfg, name: str, dense: dict):
    """(copy key, layer, the (K rows, N) matrix the copy must hold) from
    the dense source matrices ``dense`` (trunk layers, feat, color0)."""
    W, pe = cfg.trunk_width, cfg.pos_enc_dim
    KH, KPE = fused_plcore.mma_rows(cfg)
    if name == "feat":
        return "feat", None, dense["feat"]
    if name == "color0":
        return "color0", None, dense["color0"][:W]
    i = {"trunk0": 0, "trunk1": 1, "trunk_skip": cfg.skip_at[0]}[name]
    w = dense["trunk"][i]
    m = torch.zeros(KH + KPE, W)
    if i == 0:
        m[KH:KH + pe] = w
    else:
        m[:W] = w[:W]
        if i in cfg.skip_at:
            m[KH:KH + pe] = w[W:]
    return "trunk", i, m


def _copy(cfg, packed, key, layer, quantized):
    c = packed["mma"]
    assert tuple(c.shape) == fused_plcore.mma_shapes(cfg, quantized)["mma"]
    assert c.dtype == (torch.bfloat16 if quantized else torch.float32)
    return ops.mma_matrix(cfg, c, key, layer)


@pytest.mark.parametrize("name", MATRICES)
def test_bf16_copies_are_exact_signed_magnitudes(net, name):
    cfg, params = net
    quant = _nibble_quant(cfg, params)
    packed = ops.kernel_weights(cfg, params, quant)

    def signed(leaf):
        return leaf["mag"].float() * (1.0 - 2.0 * leaf["sign"].float())

    dense = {"trunk": [signed(quant["trunk"][f"l{i}"]["w"])
                       for i in range(cfg.trunk_layers)],
             "feat": signed(quant["feat"]["w"]),
             "color0": signed(quant["color0"]["w"])}
    key, layer, want = _logical(cfg, name, dense)
    got = _copy(cfg, packed, key, layer, True)
    # the copy holds exactly mag * (1 - 2 s); K padding and absent
    # segments are zero rows
    assert torch.equal(got.float(), want)
    assert int(got.float().abs().max()) == 238
    assert set(torch.unique(got.float().abs()).tolist()) <= set(
        MAGNITUDES.float().tolist())


@pytest.mark.parametrize("name", MATRICES)
def test_tf32_copies_split_exactly_enough(net, name):
    cfg, params = net
    packed = ops.kernel_weights(cfg, params)
    dense = {"trunk": [params["trunk"][f"l{i}"]["w"]
                       for i in range(cfg.trunk_layers)],
             "feat": params["feat"]["w"], "color0": params["color0"]["w"]}
    key, layer, want = _logical(cfg, name, dense)
    hi, lo = _copy(cfg, packed, key, layer, False)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    w = want.double()
    err = (w - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * w.abs()).all())
    assert not hi[want == 0].any() and not lo[want == 0].any()
    assert (hi != 0).any()


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("seg", [0, 4, -1])
def test_stream_places_elements_where_wgmma_reads_them(net, quantized, seg):
    """Element (k, n) of a segment lies at the byte the kernels' B
    descriptor names: k step k // ks (ks = 16 bf16 or 8 TF32), then 8-column
    group n // 8 (+256 B), K half (+128 B), column n % 8 (+16 B), k within
    the half (2 or 4 B); a TF32 step holds all hi, then all lo."""
    cfg, params = net
    quant = rmcm.quantize_tree(params) if quantized else None
    packed = ops.kernel_weights(cfg, params, quant)
    _, rows, ncols = fused_plcore.mma_segments(cfg)[seg]
    first, end = fused_plcore.mma_offsets(cfg, quantized)[seg]
    flat = packed["mma"][first:end]
    per = 1 if quantized else 2
    assert end - first == per * rows * ncols
    m = ops._unsteps(flat, rows, ncols)
    hi = m if quantized else m[0]
    ks, esz = (16, 2) if quantized else (8, 4)
    rng = np.random.default_rng(seg + 7)
    for k, n in zip(rng.integers(0, rows, 64), rng.integers(0, ncols, 64)):
        byte = ((k // ks) * ncols * 32 * per + (n // 8) * 256
                + ((k % ks) // (ks // 2)) * 128 + (n % 8) * 16
                + (k % (ks // 2)) * esz)
        assert byte % esz == 0
        assert flat[byte // esz] == hi[k, n]
        if not quantized:
            assert flat[byte // esz + ncols * 8] == m[1][k, n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_bound_over_magnitudes(seed):
    rng = np.random.default_rng(seed)
    w = (rng.choice([-1.0, 1.0], 4096)
         * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    w[:4] = 0.0
    hi, lo = ops.tf32_split(torch.from_numpy(w))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = np.abs(w.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert bool((err <= 2.0 ** -21 * np.abs(w)).all())


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("decades", [(-30, -10), (-10, 10), (10, 30)])
def test_bf16x3_split_rebuilds_f32_exactly(sign, decades):
    rng = np.random.default_rng(int(decades[0]) + 100)
    x = (sign * 10.0 ** rng.uniform(*decades, 20000)).astype(np.float32)
    x[:8] = 0.0
    # random mantissas, all 24 bits in play
    x = torch.from_numpy(x)
    x = (x.view(torch.int32) ^ torch.from_numpy(
        rng.integers(0, 1 << 23, x.shape, dtype=np.int64)).to(torch.int32)
         ).view(torch.float32)
    x[:8] = 0.0
    h, m, low = ref.split_bf16x3(x)
    for p in (h, m, low):
        assert torch.equal(p, p.to(torch.bfloat16).float())
    assert torch.equal(h.double() + m.double() + low.double(), x.double())
    assert torch.equal((h + m) + low, x)


def _weights(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    jp = jr.pack(jr.quantize(jnp.asarray(w)))
    tp = bridge.to_torch({key: np.asarray(v) for key, v in jp.items()
                          if key != "k"})
    tp["k"] = jp["k"]
    return jp, tp


def _emulated_rmcm_route(x, packed):
    """The K3 and K2 RMCM route's arithmetic in f32: each bf16 piece of x
    times the exact signed magnitudes, the pieces' sums added small first,
    the column scale last."""
    K = packed["k"]
    sg = rmcm.unpack_signs(packed["sign_bits"],
                           packed["sign_bits"].shape[0] * 8)[:K]
    w = packed["mag"].float() * (1.0 - 2.0 * sg.float())
    h, m, low = ref.split_bf16x3(x)
    acc = (low @ w + m @ w) + h @ w
    return acc * packed["scale"].reshape(1, -1)


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (7, 13, 5), (16, 1536, 96),
                                   (64, 300, 96), (33, 512, 65),
                                   (65, 256, 256)])
def test_emulated_rmcm_route_matches_plain_k3(m, k, n):
    jp, tp = _weights(k, n, m + k + n)
    x = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32)
    got = _emulated_rmcm_route(torch.from_numpy(x), tp)
    torch.testing.assert_close(got, ref.rmcm_matmul_ref(torch.from_numpy(x),
                                                        tp), **K3_F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_rmcm_ref(jnp.asarray(x), jp)),
                               **K3_F32_TOL)


@pytest.mark.parametrize("m,k,n", [(128, 63, 256), (128, 256, 128)])
def test_emulated_3xtf32_matches_f32_product(m, k, n):
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) / 16)
    xh, xl = ops.tf32_split(x)
    wh, wl = ops.tf32_split(w)
    got = (xl.double() @ wh.double() + xh.double() @ wl.double()) \
        + xh.double() @ wh.double()
    want = x.double() @ w.double()
    # the dropped lo x lo term and the lo roundings: ~2^-21 of |x| |w|
    scale = x.double().abs() @ w.double().abs()
    assert bool(((got - want).abs() <= 2.0 ** -20 * scale).all())


def test_kernel_weights_is_one_pack_beside_the_reference_layout(net):
    cfg, params = net
    n0 = ops.pack_count()
    packed = ops.kernel_weights(cfg, params)
    assert ops.pack_count() - n0 == 1
    plain = ops.stack_plcore_weights(cfg, params)
    assert sorted(packed) == sorted([*plain, "mma"])
    for key in plain:
        assert torch.equal(packed[key], plain[key]), key
