"""The port's meshes: the production ("data", "model") and ("pod", "data",
"model") DeviceMeshes over a fake process group, the one-rank host mesh,
their lifetimes, and the roofline's card constants (an H100's, not the
reference's TPU figures)."""
import pytest
import torch
import torch.distributed as dist

from repro.launch import mesh as jmesh_mod

from repro_torch.launch import mesh as M


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_lifetime(multi_pod):
    shape, names = M.PRODUCTION_SHAPES[multi_pod]
    with M.make_production_mesh(multi_pod=multi_pod) as mesh:
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
        assert mesh.device_type == "cuda"
        assert dist.get_world_size() == M.mesh_chips(mesh) == \
            (512 if multi_pod else 256)
        # a second mesh refuses while this group lives
        with pytest.raises(RuntimeError, match="already exists"):
            with M.make_production_mesh():
                pass
    assert not dist.is_initialized()


def test_production_mesh_torn_down_on_error():
    with pytest.raises(ValueError):
        with M.make_production_mesh():
            raise ValueError("boom")
    assert not dist.is_initialized()


def test_host_mesh_on_the_cpu():
    with M.make_host_mesh(device="cpu") as mesh:
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_backend() == "gloo"
    assert not dist.is_initialized()
    # one process is a world of one: a model axis of 2 does not divide it
    # (the mesh over several ranks: tests/test_torch_mesh_paths.py)
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        with M.make_host_mesh(model_axis=2, device="cpu"):
            pass
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with M.make_host_mesh():
                pass
    assert not dist.is_initialized()


def test_card_constants_are_the_h100s():
    assert M.PEAK_FLOPS_BF16 == pytest.approx(1070.53e12, rel=1e-5)
    assert M.HBM_BW == 3.35e12 and M.INTERNODE_BW == 50e9
    # none of the reference's TPU v5e figures is carried over
    assert M.PEAK_FLOPS_BF16 != jmesh_mod.PEAK_FLOPS_BF16
    assert M.HBM_BW != jmesh_mod.HBM_BW
    assert not hasattr(M, "ICI_BW")
