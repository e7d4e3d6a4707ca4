"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see 1 device (the dry-run sets its own 512);
multi-device tests go through the ``fake_devices`` subprocess fixture."""
import os
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _hypothesis_shim

# no-op when the real hypothesis package is importable (it wins);
# otherwise property tests degrade to the shim's fixed-seed sweep
_hypothesis_shim.install()

import jax
import pytest

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def fake_devices():
    """Run a python snippet on an N-fake-CPU-device mesh, out of process.

    The XLA device count must be fixed BEFORE jax initializes, and this
    process's jax is already up (1 device, see module docstring) — so
    every multi-device test ships its body as a subprocess snippet. This
    fixture owns the single env-setup path (XLA_FLAGS + PYTHONPATH=src,
    cwd at the repo root) and the pass convention: the snippet prints
    ``ALL OK`` as its final line; a nonzero exit or a missing marker
    fails with the captured output attached.
    """
    def run(snippet: str, *, n_devices: int = 8, timeout: int = 560):
        env = dict(os.environ)
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{n_devices}")
        env["PYTHONPATH"] = "src"
        out = subprocess.run([sys.executable, "-c", snippet], env=env,
                             cwd=_REPO_ROOT, capture_output=True,
                             text=True, timeout=timeout)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "ALL OK" in out.stdout, out.stdout[-2000:]
        return out
    return run


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips without one")
