"""The kernel probe's variants (``kernels/probe.py``) edit the CUDA sources
by pattern; each edit must still find its place in the sources, so a
variant cannot silently time the unedited kernels."""
import pytest

from repro_torch.kernels import build, probe


@pytest.mark.parametrize("name", sorted(probe.VARIANTS))
def test_probe_variant_edits_apply(tmp_path, monkeypatch, name):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    out = probe._variant_sources(name)
    for src in build._CSRC.glob("*.cu*"):
        edited = (out / src.name).read_text()
        touched = any(f == src.name for f, _, _ in probe.VARIANTS[name])
        assert (edited != src.read_text()) == touched, (name, src.name)
