"""Meshes for the LM sharding rules, and the roofline's card constants.

Production: 16 x 16 = 256 cards as ("data", "model"); two pods: 2 x 16 x
16 = 512 as ("pod", "data", "model"), the "pod" axis pure data
parallelism. ``make_production_mesh`` builds the ``DeviceMesh`` (device type
``cuda``) over a ``fake`` process group: it needs no card and no other
process, so the dry run (``launch.dryrun``) can lay out and trace the
production program on any machine. A process group is process-global, so
both meshes are context managers that tear their group down on exit, and
refuse to start while another default group exists.

``make_host_mesh(model_axis)`` spans the ranks of the process group the
launcher started: the processes of a ``torchrun``-style launch (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment), or
one rank alone without them. It is a ("data", "model") DeviceMesh of
shape (world // model_axis, model_axis), and refuses a world size the
model axis does not divide. The backend is ``nccl`` on the card and
``gloo`` for the CPU; ranks that share one card name ``gloo`` themselves
(NCCL refuses two ranks on one device).

Importing this module touches no device and starts no group.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch.distributed as dist

from repro_torch.bridge import resolve_device

# NVIDIA H100 80GB HBM3 (SXM), at its 700 W power limit, per card.
# bf16 dense tensor-core rate: 132 SMs x 4 tensor cores x 1024 FLOP per
# clock x the 1980 MHz SM clock the card reports (clocks.max.sm).
PEAK_FLOPS_BF16 = 132 * 4 * 1024 * 1980e6     # 1070.53e12 FLOP/s
# HBM3 rate from NVIDIA's H100 SXM data sheet.
HBM_BW = 3.35e12                               # B/s
# A card's share of the fabric between nodes: a 16-wide axis spans more
# than one 8-card NVLink node, so collectives over it cross one NDR
# InfiniBand link per card, 400 Gb/s = 50e9 B/s per direction (the
# ConnectX-7 rate of an 8-card H100 node). NVLink 4's 450 GB/s per
# direction holds only inside a node. Modelled: one card cannot measure it.
INTERNODE_BW = 50e9                            # B/s per card

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}

_FAKE_STORE = "torch.testing._internal.distributed.fake_pg"


@contextlib.contextmanager
def _group(who: str, backend: str, world_size: int, store):
    """This process as rank 0 of a new default group, destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError(f"{who}: a default process group already exists "
                           "in this process; destroy it first")
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False):
    """``with make_production_mesh(multi_pod=...) as mesh``: the (16, 16) or
    (2, 16, 16) ``cuda`` DeviceMesh, this process as rank 0 of a ``fake``
    group of 256 or 512. Collectives on it move nothing; tensors laid out
    on it are meant to be fake or meta (the dry run's)."""
    import importlib

    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    store = importlib.import_module(_FAKE_STORE).FakeStore()
    with _group("make_production_mesh", "fake", int(np.prod(shape)), store):
        yield init_device_mesh("cuda", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def make_host_mesh(model_axis: int = 1, device=None, backend=None):
    """``with make_host_mesh(model_axis) as mesh``: the ("data", "model")
    DeviceMesh over the launcher's ranks (one rank without a launcher),
    on the card unless ``device`` is "cpu"; ``backend`` overrides ``nccl``
    (card) / ``gloo`` (CPU). The group is destroyed on exit."""
    dev = resolve_device(device, "make_host_mesh")
    from torch.distributed.device_mesh import init_device_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if model_axis < 1 or world % model_axis:
        raise ValueError(
            f"make_host_mesh: a model axis of {model_axis} does not divide "
            f"the world size {world}; a mesh with a model axis needs a "
            "launch of a multiple of that many ranks")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if world == 1:
        group = _group("make_host_mesh", backend, 1, dist.HashStore())
    else:
        group = _env_group(backend)
    with group:
        yield init_device_mesh(dev.type, (world // model_axis, model_axis),
                               mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def _env_group(backend: str):
    """This process as rank ``RANK`` of the launcher's ``WORLD_SIZE``
    (rendezvous at ``MASTER_ADDR:MASTER_PORT``), destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("make_host_mesh: a default process group already "
                           "exists in this process; destroy it first")
    dist.init_process_group(backend, init_method="env://")
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_chips(mesh) -> int:
    return int(np.prod(mesh.shape))
