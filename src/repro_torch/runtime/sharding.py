"""Sharding: logical-axis rules for the LM models, and layer-sharded PLCore
weight residency over a list of cells.

**Logical axes -> mesh axes.** The mesh is ("data", "model") for one pod and
("pod", "data", "model") for two (``launch.mesh``). Every ``Decl`` names a
logical axis per dimension; ``Rules`` maps them to mesh axes, dropping an
axis (replicating) where it does not divide the dimension: this is how GQA
KV heads (2/8/16) degrade on a 16-wide model axis. A spec is a tuple of
per-dimension parts, each None (replicated), one mesh-axis name, or a tuple
of names: the parts of the reference's ``PartitionSpec``. ``Rules`` reads
only axis sizes (``mesh_axes``), so one object serves a ``DeviceMesh``, a
``{name: size}`` dict and any mesh whose ``shape`` is such a mapping.
``shardings`` turns specs into DTensor placements on a ``DeviceMesh``.
``constrain_logical`` redistributes a DTensor by logical axis names; it is
a no-op on a plain tensor or without an installed activation context.

**PLCore weights** (layer-sharded residency over a list of cells).
ICARUS keeps whole-model weights resident per PLCore; replicated over many
devices that residency is the binding constraint (weight bytes, not
FLOPs). The packed trunk stacks (``kernels.ops.stack_plcore_weights`` lays
every trunk tensor out as (L, ...), the layer axis leading, and the
tensor-core stream ``"mma"`` holds the trunk layers' segments in layer
order before the heads) shard LAYER-WISE over the cells: each cell holds
its own contiguous run of layers. A render re-materializes the full stacks
(``gather_plcore_packed``), or a cell stages them once
(``stage_plcore_packed_to_cell``). Sharding is placement only: values
never change, so a sharded render gives the replicated render's pixels bit
for bit.

This section takes no device mesh. A cell list takes its place: an ordered tuple
of ``torch.device``s, one per cell (``plcore_mesh``). It may name one
device several times (``[cuda:0] * 8``, or ``cpu`` cells in the tests):
each name is then a logical cell on that device, with its own CUDA stream
for per-cell dispatch (``cell_stream``). On one device a "remote" layer is
an on-device copy; the counters below model the traffic a deployment with
one device per cell would pay, as the reference's do.

The owner map (``plcore_owner_table``) is the ray dispatcher's view of
this residency (ICARUS §5): which trunk layers each cell holds. Routing
scores cells by it (``plcore_home_cell``), and the gather and staging
accounting prices only the layers a cell does not own.

Counters on the process-wide registry, under the reference's names:
``plcore_layer_gathers_total`` / ``plcore_layer_gather_bytes_total`` tick
once per layer per stacked array the first time a render program shape
materializes the stacks (the reference counts once per trace and its
cached programs re-run without ticking; the port gathers on every call
and ticks as that trace would), and ``plcore_cell_stage_layers_total`` /
``plcore_cell_stage_bytes_total`` once per remote layer staged into a
cell.
"""
from __future__ import annotations

import zlib
from collections.abc import Mapping
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.params import Decl, is_decl
from repro_torch.obs.metrics import global_registry

# ---------------------------------------------------- logical -> mesh axes --
# Default logical->mesh rules. Order inside the tuple = priority; all axes
# that divide the dim evenly are used together (e.g. ("data","model")).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),  # activations / caches: data parallel
    "seq": (),
    "embed": ("fsdp",),        # FSDP: shard d_model of weights over data axis
    "qheads": ("model",),      # tensor parallel over attention heads
    "kvheads": ("model",),     # sharded only when kv_heads % model == 0
    "headdim": (),
    "ffn": ("model",),         # Megatron-style FFN split
    "vocab": ("model",),       # embedding/logits vocab split
    "experts": ("model",),     # expert parallelism
    "ssm_inner": ("model",),   # mamba2 d_inner / heads split
    "ssm_heads": ("model",),
    "state": (),
    "lru": ("model",),         # RG-LRU width split
    "layers": (),              # scan axis, never sharded
    "window": (),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, of a mesh whose ``shape`` is
    such a mapping, or of the mapping itself."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", mesh)
    if isinstance(shape, Mapping):
        return dict(shape)
    raise TypeError(f"no named axes on {type(mesh).__name__}: pass a "
                    "DeviceMesh with mesh_dim_names or a {name: size} dict")


def _prod(axes, sizes: Dict[str, int]) -> int:
    return int(np.prod([sizes[a] for a in axes]))


@dataclass(frozen=True)
class Rules:
    table: Dict[str, Tuple[str, ...]] = field(default_factory=lambda: dict(DEFAULT_RULES))
    fsdp: bool = True                   # resolve "fsdp" pseudo-axis -> data axis
    fsdp_axes: Tuple[str, ...] = ("data",)
    dp_axes: Tuple[str, ...] = ("pod", "data")   # batch axes (filtered by mesh)

    def updated(self, **table_updates) -> "Rules":
        t = dict(self.table)
        t.update(table_updates)
        return replace(self, table=t)

    def resolve(self, logical: Optional[str], mesh, dim: int):
        """Mesh axes for one logical dim, dropping non-dividing axes."""
        if logical is None:
            return None
        sizes = mesh_axes(mesh)
        axes = []
        for a in self.table.get(logical, ()):  # unknown logical -> replicated
            if a == "fsdp":
                if not self.fsdp:
                    continue
                cand = [x for x in self.fsdp_axes if x in sizes]
            else:
                cand = [a] if a in sizes else []
            for c in cand:
                if c not in axes and dim % _prod(axes + [c], sizes) == 0:
                    axes.append(c)
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def spec_for(self, decl: Decl, mesh) -> tuple:
        used = set()
        parts = []
        for dim, logical in zip(decl.shape, decl.logical):
            r = self.resolve(logical, mesh, dim)
            # a mesh axis may appear at most once per spec
            if r is not None:
                rr = r if isinstance(r, tuple) else (r,)
                rr = tuple(a for a in rr if a not in used)
                used.update(rr)
                r = rr if len(rr) > 1 else (rr[0] if rr else None)
            parts.append(r)
        return tuple(parts)

    def batch_axes(self, mesh):
        sizes = mesh_axes(mesh)
        axes = tuple(a for a in self.dp_axes if a in sizes)
        return axes if axes else None

    def batch_spec(self, mesh, ndim: int, batch_dim: int = 0) -> tuple:
        parts = [None] * ndim
        axes = self.batch_axes(mesh)
        # a one-axis part is the name itself, as a PartitionSpec holds it
        parts[batch_dim] = axes[0] if axes and len(axes) == 1 else axes
        return tuple(parts)


def _map_decls(fn, decls):
    if is_decl(decls):
        return fn(decls)
    return {k: _map_decls(fn, v) for k, v in decls.items()}


def pspecs(decls, mesh, rules: Rules):
    """Spec tree matching a Decl tree."""
    return _map_decls(lambda d: rules.spec_for(d, mesh), decls)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of a spec on a ``DeviceMesh``: Shard(d) on every
    mesh axis that dimension d's part names, Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def shardings(decls, mesh, rules: Rules):
    """Placement-list tree matching a Decl tree, on a ``DeviceMesh``."""
    return _map_decls(lambda d: placements(rules.spec_for(d, mesh), mesh),
                      decls)


def constrain(x, mesh, spec: tuple):
    """``x`` redistributed to ``spec`` on ``mesh``; a plain tensor (off
    mesh) is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


# ------------------------------------------------- activation constraints --
# Launch-time context: when set, model code can pin activation shardings by
# logical axis name (vocab-sharded logits, joint-mesh attention resharding).
# Model code never imports mesh objects; it calls ``constrain_logical``,
# which is a no-op unless the launcher installed a context.
_ACT_CTX: dict = {"mesh": None, "rules": None}

ACT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "batch_joint": ("pod", "data", "model"),  # attention batch resharding
    "vocab": ("model",),
    "seq": (),
}


def set_activation_context(mesh, rules: Optional[Rules] = None):
    """Install (or clear, with None) the activation-sharding context."""
    _ACT_CTX["mesh"] = mesh
    _ACT_CTX["rules"] = rules or (Rules() if mesh is not None else None)


def activation_context_mesh():
    return _ACT_CTX["mesh"]


def logical_spec(shape, logical: Tuple[Optional[str], ...], mesh,
                 rules: Rules) -> tuple:
    """The spec ``constrain_logical`` resolves for an activation of
    ``shape``: ``ACT_RULES`` first, then the rules' table; non-dividing
    axes degrade to replicated."""
    sizes = mesh_axes(mesh)
    used = set()
    parts = []
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        axes = []
        for a in ACT_RULES.get(name, rules.table.get(name, ())):
            if a in sizes and a not in used and \
                    dim % _prod(axes + [a], sizes) == 0:
                axes.append(a)
        used.update(axes)
        parts.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(parts)


def constrain_logical(x, logical: Tuple[Optional[str], ...]):
    """``x`` redistributed by logical axis names on the installed context's
    mesh; a no-op without a context or on a plain tensor."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None:
        return x
    return constrain(x, mesh, logical_spec(x.shape, logical, mesh,
                                           _ACT_CTX["rules"]))


def attn_batch_split_ok(global_batch: int) -> bool:
    """The explicit batch-split attention needs the per-data-shard batch
    to divide the model axis."""
    mesh = _ACT_CTX["mesh"]
    sizes = mesh_axes(mesh) if mesh is not None else {}
    if "model" not in sizes:
        return False
    rules = _ACT_CTX["rules"]
    dp = _prod([a for a in rules.dp_axes if a in sizes], sizes)
    local = global_batch // dp
    return local % sizes["model"] == 0


def attn_needs_batch_reshard(n_heads: int) -> bool:
    """True when TP cannot split the heads on the installed mesh (the
    qwen2-1.5b 12-head / whisper 20-head / paligemma 8-head cases): then
    resharding the batch over the joint mesh recovers the lost parallelism."""
    mesh = _ACT_CTX["mesh"]
    sizes = mesh_axes(mesh) if mesh is not None else {}
    if sizes.get("model", 1) <= 1:
        return False
    return n_heads % sizes["model"] != 0


# ------------------------------------------------ PLCore weight sharding --

#: the axis the trunk stacks shard over: the cell list's only one
PLCORE_SHARD_AXES = ("data",)

_GATHERS = global_registry().counter(
    "plcore_layer_gathers_total",
    "per-layer gathers of the trunk stacks, once per render program shape")
_GATHER_BYTES = global_registry().counter(
    "plcore_layer_gather_bytes_total",
    "modeled replicated bytes of those layer gathers", unit="bytes")
_STAGES = global_registry().counter(
    "plcore_cell_stage_layers_total",
    "remote trunk layers staged into a home cell (once per scene+cell)")
_STAGE_BYTES = global_registry().counter(
    "plcore_cell_stage_bytes_total",
    "modeled bytes of trunk layers staged into home cells", unit="bytes")
# render program shapes whose gathers have been counted (see the module
# docstring): a program shape counts once per process, as a trace would
_COUNTED_PROGRAMS: set = set()
# (cells, cell) -> that cell's CUDA stream, made at first use
_STREAMS: dict = {}


def plcore_gather_count() -> int:
    return int(_GATHERS.value)


def plcore_gather_bytes() -> int:
    return int(_GATHER_BYTES.value)


def plcore_stage_count() -> int:
    return int(_STAGES.value)


def plcore_stage_bytes() -> int:
    return int(_STAGE_BYTES.value)


# ------------------------------------------------------------- cell lists --
def plcore_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> tuple:
    """The cell list: the first ``n_devices`` visible cards (default: all),
    or an explicit ``devices`` group, capped at its length. An explicit
    group may name one device several times (the single-card stand-in of
    a multi-device deployment). Raises when no card is visible and no
    group is named."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if not devs:
            raise RuntimeError("plcore_mesh: no CUDA device is visible; "
                               "name the cells, e.g. devices=['cpu'] * 8")
    if not devs:
        raise ValueError("plcore_mesh: an empty device group")
    n = len(devs) if n_devices is None else max(1, min(int(n_devices),
                                                       len(devs)))
    return tuple(devs[:n])


def plcore_stack_spec(mesh: tuple, n_layers: int) -> tuple:
    """The shard axes of one (L, ...) layer stack: ("data",) when the cell
    count divides L, else () (replicated), the reference's graceful
    degradation."""
    return PLCORE_SHARD_AXES if n_layers % len(mesh) == 0 else ()


def plcore_shard_count(mesh: tuple, n_layers: int) -> int:
    """How many ways the layer axis is split (1 = replicated)."""
    return len(mesh) if plcore_stack_spec(mesh, n_layers) else 1


def plcore_cell_mesh(mesh: tuple, cell: int) -> tuple:
    """The one-cell list of cell ``cell``: a per-cell program's target."""
    return (mesh[int(cell)],)


def cell_stream(mesh: tuple, cell: int):
    """Cell ``cell``'s own CUDA stream (made at first use), or None for a
    cell on the CPU."""
    dev = mesh[int(cell)]
    if dev.type != "cuda":
        return None
    key = (mesh, int(cell))
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.Stream(device=dev)
    return s


# --------------------------------------------------------------- owner map --
def plcore_owner_table(mesh: tuple, n_layers: int) -> np.ndarray:
    """(cells, n_layers) bool: entry [c, l] is True when cell ``c`` holds
    layer ``l`` of a sharded trunk stack: cell c the c-th contiguous run
    of L / cells layers, or every layer when the stacks replicate."""
    n = len(mesh)
    table = np.zeros((n, n_layers), bool)
    if not plcore_stack_spec(mesh, n_layers):
        table[:] = True
        return table
    per = n_layers // n
    for c in range(n):
        table[c, c * per:(c + 1) * per] = True
    return table


def plcore_locality_scores(mesh: tuple, n_layers: int) -> np.ndarray:
    """Per-cell routing score: how many trunk layers each cell owns."""
    return plcore_owner_table(mesh, n_layers).sum(axis=1)


def plcore_home_cell(mesh: tuple, n_layers: int, salt: str = "") -> int:
    """The home cell of one scene's tiles: a cell owning the most trunk
    layers, ties broken by ``zlib.crc32(salt)`` (the scene id), so scenes
    spread over the owning cells the same way on every run."""
    scores = plcore_locality_scores(mesh, n_layers)
    ties = np.flatnonzero(scores == scores.max())
    return int(ties[zlib.crc32(salt.encode()) % len(ties)])


def plcore_owned_layer_mask(mesh: tuple, n_layers: int,
                            cell: Optional[int] = None) -> np.ndarray:
    """(n_layers,) bool: the layers cell ``cell`` holds; ``None`` (no
    routing decision) owns nothing, the unrouted worst case."""
    if cell is None:
        return np.zeros(n_layers, bool)
    return plcore_owner_table(mesh, n_layers)[int(cell)]


# ---------------------------------------------------------- sharded stacks --
class LayerShards:
    """One layer-stacked array of the packed layout, split over the cells.

    ``layers`` are the per-layer pieces (views of one (L, ...) stack, or the
    flat trunk segments of the tensor-core stream) and ``tail`` the rest of
    a flat stream after the trunk (the heads' segments, replicated), or
    None. Cell c keeps its run of layers on its device; with a replicated
    spec every cell keeps all of them. ``materialize(device)`` rebuilds
    the full array there, bit for bit."""

    def __init__(self, layers: list, tail: Optional[torch.Tensor],
                 mesh: tuple, stacked: bool):
        self.mesh = mesh
        self.n_layers = len(layers)
        self.layer_nbytes = [t.numel() * t.element_size() for t in layers]
        self.owner = plcore_owner_table(mesh, self.n_layers)
        # one copy per (device, layer run): cells on one device that own
        # the same layers share it
        self.parts = []      # per cell: (first layer, end layer, tensor)
        copies: dict = {}
        for c, dev in enumerate(mesh):
            idx = np.flatnonzero(self.owner[c])
            lo, hi = int(idx[0]), int(idx[-1]) + 1
            key = (dev, lo, hi)
            if key not in copies:
                piece = (torch.stack(layers[lo:hi]) if stacked
                         else torch.cat(layers[lo:hi]))
                copies[key] = piece.to(dev).contiguous()
            self.parts.append((lo, hi, copies[key]))
        self.tail_by_dev = {}
        if tail is not None:
            for dev in dict.fromkeys(mesh):
                self.tail_by_dev[dev] = tail.to(dev).contiguous()
        self.tail_nbytes = 0 if tail is None else \
            tail.numel() * tail.element_size()

    def cell_nbytes(self, cell: int) -> int:
        """Bytes resident on cell ``cell``: its layers and the tail."""
        lo, hi, _ = self.parts[cell]
        return sum(self.layer_nbytes[lo:hi]) + self.tail_nbytes

    def nbytes(self) -> int:
        """Bytes of the full (gathered) array."""
        return sum(self.layer_nbytes) + self.tail_nbytes

    def materialize(self, device) -> torch.Tensor:
        """The full array on ``device``: every layer in order (each from
        the first cell that owns it), then the tail."""
        device = torch.device(device)
        pieces, at = [], 0
        for lo, hi, t in self.parts:
            if hi <= at:
                continue
            pieces.append(t.to(device))
            at = hi
        out = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
        if self.tail_by_dev:
            tail = next(iter(self.tail_by_dev.values()))
            out = torch.cat([out, tail.to(device)])
        return out


def _is_stacked(key: str) -> bool:
    """Keys of the packed layout whose leading axis is the trunk layer
    stack (trunk_w / trunk_b and the RMCM trunk_mag/sgn/scl), and the
    tensor-core stream, whose trunk segments come layer by layer."""
    return key.startswith("trunk") or key == "mma"


def _mma_layers(cfg, stream: torch.Tensor):
    """The tensor-core stream -> (per-layer flat pieces, tail): the trunk
    segments of layer i (``fused_plcore.mma_segments``) are contiguous and
    in layer order; the heads' segments follow."""
    from repro_torch.kernels import fused_plcore as fp
    segs = fp.mma_segments(cfg)
    offs = fp.mma_offsets(cfg, stream.dtype == torch.bfloat16)
    bounds = [None] * cfg.trunk_layers
    for (name, _, _), (lo, hi) in zip(segs, offs):
        base = name.partition(".")[0]
        if base.startswith("trunk"):
            i = int(base[5:])
            b = bounds[i]
            bounds[i] = (lo, hi) if b is None else (b[0], hi)
    layers = [stream[lo:hi] for lo, hi in bounds]
    return layers, stream[bounds[-1][1]:]


def shard_plcore_packed(packed: dict, mesh: tuple, cfg=None) -> dict:
    """One network's packed layout with its layer-stacked arrays split over
    the cells (``LayerShards``); the heads stay plain tensors (every cell
    reads them every pass). ``cfg`` is needed when the layout has a
    tensor-core stream (``"mma"``)."""
    out = {}
    for k, a in packed.items():
        if not _is_stacked(k):
            out[k] = a
        elif k == "mma":
            if cfg is None:
                raise ValueError("sharding the tensor-core stream needs the "
                                 "config (its segment layout)")
            layers, tail = _mma_layers(cfg, a)
            out[k] = LayerShards(layers, tail, mesh, stacked=False)
        else:
            out[k] = LayerShards(list(a.unbind(0)), None, mesh, stacked=True)
    return out


def note_program(key) -> bool:
    """True the first time a render program shape ``key`` materializes
    the stacks (its gathers are counted then), False after."""
    if key in _COUNTED_PROGRAMS:
        return False
    _COUNTED_PROGRAMS.add(key)
    return True


def gather_plcore_stack(stack: LayerShards, device, count: bool = True):
    """A sharded stack -> the full array on ``device``, one gather per
    layer (counted with its bytes when ``count``)."""
    if count:
        for nb in stack.layer_nbytes:
            _GATHERS.inc()
            _GATHER_BYTES.inc(nb)
    return stack.materialize(device)


def gather_plcore_packed(packed: dict, device, count: bool = True) -> dict:
    """One network's sharded layout materialized on ``device`` for compute:
    stacks gathered layer by layer, heads passed through. Bit-identical to
    the replicated layout."""
    return {k: gather_plcore_stack(a, device, count)
            if isinstance(a, LayerShards) else a.to(device)
            for k, a in packed.items()}


def stage_plcore_packed_to_cell(packed: dict, mesh: tuple, cell: int) -> dict:
    """One network's layout fully resident on cell ``cell``: every array on
    the cell's device, the stacks gathered there. Each layer the cell does
    not own is a remote fetch, counted once per stacked array with its
    bytes on the ``plcore_cell_stage_*`` counters (owned layers are local
    reads). Values equal the source layout's bit for bit."""
    cell = int(cell)
    dev = mesh[cell]
    out = {}
    for k, a in packed.items():
        if isinstance(a, LayerShards):
            remote = ~a.owner[cell]
            _STAGES.inc(int(remote.sum()))
            _STAGE_BYTES.inc(int(sum(nb for nb, r in zip(a.layer_nbytes,
                                                        remote) if r)))
            out[k] = a.materialize(dev)
        else:
            out[k] = a.to(dev)
    return out

