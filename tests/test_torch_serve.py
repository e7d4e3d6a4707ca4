"""The port's serve CLI, ``--mode nerf``, on the CPU at tiny size."""
import numpy as np

from repro_torch.launch import serve


def _read_ppm(path):
    magic, size, maxval, body = open(path, "rb").read().split(b"\n", 3)
    assert magic == b"P6" and maxval == b"255"
    w, h = map(int, size.split())
    return np.frombuffer(body, np.uint8).reshape(h, w, 3)


def test_serve_views_through_fused_path(tmp_path):
    stats = serve.main(["--mode", "nerf", "--device", "cpu", "--views", "2",
                        "--kernel", "--fuse-two-pass", "--hw", "12",
                        "--out", str(tmp_path)])
    assert stats["weight_packs_since_load"] == 0
    assert stats["pipeline"] == "two_pass_fused"
    assert len(stats["views"]) == 2
    for v in stats["views"]:
        img = _read_ppm(v["image"])
        assert img.shape == (12, 12, 3)
        assert img.std() > 0 and v["finite"]
