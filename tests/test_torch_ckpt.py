"""Checkpoints of the PyTorch port against the reference package's
``Checkpointer``: the same on-disk format both ways, bit for bit (params
and an int8 Adam state), the crash-safety behaviour (``keep_last``, the
LATEST fallback, missing keys), and ``serve --ckpt``.
"""
import functools
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.configs.nerf_icarus import tiny as jax_tiny
from repro.core.plcore import plcore_decls as jax_plcore_decls
from repro.models.params import init_params as jax_init
from repro.optim import adam as ja

from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.nerf_icarus import tiny
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls
from repro_torch.data import rays as TR
from repro_torch.launch import serve
from repro_torch.models.params import init_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test keeps the
    test workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(moment_dtype="int8"):
    """The reference's tiny params and the Adam state after one update
    (non-zero moments; int8 ones are {q, scale} dicts)."""
    cfg = ja.AdamConfig(moment_dtype=moment_dtype)
    p = jax.jit(lambda k: jax_init(jax_plcore_decls(jax_tiny()), k,
                                   "float32"))(jax.random.PRNGKey(0))
    decls = jax.tree.map(lambda a: ja.Decl(a.shape, (None,) * a.ndim), p)
    o = jax_init(ja.opt_state_decls(decls, cfg), jax.random.PRNGKey(1),
                 "float32")
    g = jax.tree.map(lambda a: jnp.full_like(a, 0.01), p)
    p, o, _ = jax.jit(functools.partial(ja.adam_update, cfg))(p, g, o)
    return {"params": p, "opt_state": o}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x = fa[k].numpy() if isinstance(fa[k], torch.Tensor) else \
            np.asarray(fa[k])
        y = fb[k].numpy() if isinstance(fb[k], torch.Tensor) else \
            np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("async_save", [True, False])
@pytest.mark.parametrize("moment_dtype", ["int8", "float32"])
def test_checkpoints_cross_both_packages_bit_for_bit(tmp_path, async_save,
                                                     moment_dtype):
    """A checkpoint the reference wrote restores in the port bit for bit
    (dtypes included: f32 params, int8 q, f32 scales, int32 step), with
    its metadata; one the port wrote restores in the reference bit for
    bit; the two manifests agree."""
    state = _jax_state(moment_dtype)
    meta = {"steps": 1, "note": "cross"}
    jc = JaxCheckpointer(str(tmp_path / "jax"), async_save=async_save)
    jc.save(1, state, meta)
    jc.wait()
    got, got_meta = Checkpointer(str(tmp_path / "jax")).restore(device="cpu")
    assert got_meta == meta
    _assert_same(got, jax.tree.map(np.asarray, state))
    if moment_dtype == "int8":
        assert got["opt_state"]["m"]["fine"]["trunk"]["l0"]["w"]["q"].dtype \
            == torch.int8
    assert got["opt_state"]["step"].dtype == torch.int32

    tc = Checkpointer(str(tmp_path / "torch"), async_save=async_save)
    tc.save(1, bridge.to_torch(jax.tree.map(np.asarray, state)), meta)
    tc.wait()
    back, back_meta = JaxCheckpointer(str(tmp_path / "torch")).restore()
    assert back_meta == meta
    _assert_same(back, jax.tree.map(np.asarray, state))
    mj = json.loads((tmp_path / "jax" / "step_00000001" /
                     "manifest.json").read_text())
    mt = json.loads((tmp_path / "torch" / "step_00000001" /
                     "manifest.json").read_text())
    assert mj == mt
    assert sorted(p.name for p in (tmp_path / "torch" /
                                   "step_00000001").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax" / "step_00000001").iterdir())


def test_save_copies_before_returning(tmp_path):
    """An async save holds the values of the call: an in-place update of
    the tensors after ``save`` returns does not reach the files."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    c = Checkpointer(str(tmp_path))
    c.save(5, {"w": w})
    w.add_(100.0)
    c.wait()
    got, _ = c.restore(device="cpu")
    assert torch.equal(got["w"], torch.arange(12.0).reshape(3, 4))


def test_keep_last_latest_fallback_and_template(tmp_path):
    """keep_last garbage-collects older steps; a LATEST naming a missing
    step dir (a crash between the rename and the pointer) falls back to
    the newest on disk; a template restores its own keys and refuses a
    key or a shape the checkpoint lacks."""
    c = Checkpointer(str(tmp_path), keep_last=2, n_shards=3)
    for s in range(1, 6):
        c.save(s, {"a": {"w": torch.full((2, 3), float(s))},
                   "b": torch.tensor(s)})
    c.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000004", "step_00000005"]
    assert c.latest_step() == 5
    (tmp_path / "LATEST").write_text("step_00000009")
    assert c.latest_step() == 5
    state, _ = c.restore(device="cpu")
    assert float(state["a"]["w"][0, 0]) == 5.0
    old, _ = c.restore(4, device="cpu",
                       template={"a": {"w": torch.zeros(2, 3)}})
    assert list(old) == ["a"] and float(old["a"]["w"][1, 2]) == 4.0
    with pytest.raises(KeyError, match="c/w"):
        c.restore(device="cpu", template={"c": {"w": torch.zeros(2, 3)}})
    with pytest.raises(ValueError, match="a/w"):
        c.restore(device="cpu", template={"a": {"w": torch.zeros(3, 2)}})


def test_missing_keys_and_no_checkpoint_raise(tmp_path):
    """A shard lost from a step dir (its keys are in the manifest) raises;
    so does restoring from an empty directory."""
    c = Checkpointer(str(tmp_path / "a"), n_shards=2, async_save=False)
    c.save(3, {"x": torch.ones(2), "y": torch.zeros(3)})
    (tmp_path / "a" / "step_00000003" / "shard_1.npz").unlink()
    with pytest.raises(IOError, match="missing keys"):
        c.restore(device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_serve_ckpt_renders_the_checkpoint(tmp_path, writer):
    """``serve --mode nerf --device cpu --hw 16 --kernel --fuse-two-pass
    --ckpt DIR`` serves the checkpoint's params: its float pixels equal a
    direct ``PackedPlcore`` render of those params bit for bit, and differ
    from the seeded weights' render. A checkpoint the reference wrote
    serves the same way."""
    cfg = tiny()
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(7))
    state = {"params": params, "opt_state": {"step": torch.tensor(
        3, dtype=torch.int32)}}
    ckpt = tmp_path / "ckpt"
    if writer == "port":
        Checkpointer(str(ckpt), async_save=False).save(3, state)
    else:
        JaxCheckpointer(str(ckpt), async_save=False).save(
            3, jax.tree.map(lambda t: jnp.asarray(t.numpy()), state))
    argv = ["--mode", "nerf", "--device", "cpu", "--hw", "16", "--kernel",
            "--fuse-two-pass", "--theta", "33", "--phi", "-20", "--focal",
            "38.4"]
    stats = serve.main(argv + ["--ckpt", str(ckpt), "--out",
                               str(tmp_path / "a")])
    seeded = serve.main(argv + ["--out", str(tmp_path / "b")])
    assert stats["weight_packs_since_load"] == 0
    assert stats["ckpt"] == str(ckpt)
    img = np.load(stats["views"][0]["pixels"])
    ro, rd = TR.camera_rays(TR.pose_spherical(33.0, -20.0, 4.0), 16, 16, 38.4)
    direct = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                          device="cpu").render_image(ro, rd)
    np.testing.assert_array_equal(img, direct.numpy())
    assert not np.array_equal(img, np.load(seeded["views"][0]["pixels"]))


def test_restore_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    c = Checkpointer(str(tmp_path), async_save=False)
    c.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        c.restore()


def _bf16_state():
    """A JAX bf16 leaf (a 3D stack, as an LM's layers), an f32 one and an
    int32 step."""
    w = jax.random.normal(jax.random.PRNGKey(3), (2, 5, 3)).astype(jnp.bfloat16)
    return {"layers": {"w": w}, "norm": jnp.linspace(-1, 1, 7),
            "step": jnp.asarray(4, jnp.int32)}


def _npz_members(d, step):
    out = {}
    for f in sorted((d / f"step_{step:08d}").glob("shard_*.npz")):
        with zipfile.ZipFile(f) as z:
            out.update({n: z.read(n) for n in z.namelist()})
    return out


def test_bf16_leaf_from_reference_restores_bit_for_bit(tmp_path):
    """The reference writes a bf16 leaf (|V2 entry, manifest "bfloat16");
    the port restores it as torch.bfloat16 with the same bits, and the
    same tree writes back byte for byte what the reference wrote."""
    state = _bf16_state()
    JaxCheckpointer(str(tmp_path / "ref"), async_save=False).save(2, state)
    got, _ = Checkpointer(str(tmp_path / "ref")).restore(device="cpu")
    w = got["layers"]["w"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (2, 5, 3)
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        np.asarray(state["layers"]["w"]).view(np.int16))
    assert got["norm"].dtype == torch.float32
    Checkpointer(str(tmp_path / "port"), async_save=False).save(2, got)
    assert _npz_members(tmp_path / "port", 2) == _npz_members(tmp_path / "ref", 2)
    man = [json.loads((tmp_path / d / "step_00000002" / "manifest.json"
                       ).read_text()) for d in ("ref", "port")]
    assert man[0] == man[1]
    assert man[1]["dtypes"]["layers/w"] == "bfloat16"


@pytest.mark.parametrize("async_save", [False, True])
def test_bf16_leaf_from_port_restores_in_reference(tmp_path, async_save):
    """The port writes a torch.bfloat16 leaf; the reference restores the
    same |V2 bytes under the same manifest dtype."""
    w = torch.randn((4, 6), generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    c = Checkpointer(str(tmp_path), async_save=async_save)
    c.save(1, {"w": w, "b": torch.ones(3)})
    c.wait()
    got, _ = JaxCheckpointer(str(tmp_path)).restore()
    assert got["w"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(got["w"].view(np.int16),
                                  w.view(torch.int16).numpy())
    man = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert man["dtypes"] == {"b": "float32", "w": "bfloat16"}
    back, _ = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))


def test_bridge_round_trips_a_jax_bf16_array():
    """``np.asarray`` of a JAX bf16 array (an ml_dtypes array) -> a
    torch.bfloat16 tensor with its bits -> |V2 voids with the same bytes,
    which the bridge reads again."""
    a = np.asarray(_bf16_state()["layers"]["w"])
    t = bridge.to_torch({"w": a})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    back = bridge.to_numpy({"w": t})["w"]
    assert back.dtype == np.dtype("V2") and back.tobytes() == a.tobytes()
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(back.view(a.dtype)), np.float32),
        np.asarray(a, np.float32))
    assert torch.equal(bridge.to_torch(back).view(torch.int16),
                       t.view(torch.int16))
