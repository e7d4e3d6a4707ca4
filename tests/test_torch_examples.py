"""The port's examples (``examples/torch_*.py``) on the CPU at small
sizes: each runs to its ``OK`` / JSON line with ``--device cpu``, and none
imports JAX or the reference package (they run on the card machine, which
has neither)."""
import ast
import pathlib
import runpy
import sys

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
PORT_EXAMPLES = ("torch_quickstart.py", "torch_nerf_serve.py",
                 "torch_slf_render.py", "torch_lm_train_e2e.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the test
    workers that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_example_imports_neither_jax_nor_reference(name):
    tree = ast.parse((EXAMPLES / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert "jax" not in mods and "repro" not in mods, mods
    assert "repro_torch" in mods


def _run(monkeypatch, tmp_path, name, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu", *argv])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")


@pytest.mark.parametrize("name, argv, last, images", [
    ("torch_quickstart.py", ["--steps", "30", "--hw", "12"], "OK", False),
    ("torch_nerf_serve.py", ["--mode", "mono", "--hw", "8", "--kernel"],
     '"frames"', True),
    ("torch_slf_render.py", ["--steps", "200", "--hw", "24"], "OK", True),
])
def test_example_runs_on_cpu(monkeypatch, tmp_path, capsys, name, argv,
                             last, images):
    _run(monkeypatch, tmp_path, name, argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert last in out[-1], out[-5:]
    assert any(tmp_path.joinpath("runs").rglob("*.ppm")) == images


def test_lm_train_e2e_resumes_on_cpu(monkeypatch, tmp_path, capsys):
    """The e2e LM example at --tiny with 40 steps: phase 2 restores phase
    1's last checkpoint (step 24, 60% of 40) from the port's own
    directory, and the final loss is finite. The unigram-entropy gate is
    held at full size on the card."""
    import math

    _run(monkeypatch, tmp_path, "torch_lm_train_e2e.py",
         ["--tiny", "--steps", "40"])
    out = capsys.readouterr().out
    ckpt = tmp_path / "runs" / "lm_e2e_ckpt_torch"
    assert ckpt.is_dir() and not (tmp_path / "runs" / "lm_e2e_ckpt").exists()
    assert "[train] restored step=24 from runs/lm_e2e_ckpt_torch" in out
    final = [ln for ln in out.splitlines() if ln.startswith("[e2e] final loss")]
    assert final and math.isfinite(float(final[0].split()[3]))

