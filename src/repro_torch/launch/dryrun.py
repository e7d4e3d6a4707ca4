"""Multi-pod dry run: lay out and trace every (arch x shape) cell on the
production meshes, and take the roofline terms from the trace.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --opt --arch kimi-k2-1t-a32b --shape train_4k

Per cell this:
  1. builds the params, optimizer state, cache and batch as DTensors laid
     out by ``Rules`` on a ``cuda`` DeviceMesh over a ``fake`` process
     group (``launch.mesh``), their local shards fake tensors on the
     ``meta`` device: nothing is allocated and no card is needed;
  2. runs the port's own step on them (``launch.steps`` with AdamW,
     prefill or decode; ``PlcoreModel.render_step`` for nerf-icarus)
     under a counting dispatch mode that sees the ops DTensor runs on the
     local shards;
  3. writes the reference's JSON keys to ``<out>/<cell>.json``
     (``runs/dryrun_torch`` by default), with ``counted_by`` saying what
     produced each number.

What is counted, per device (this process is rank 0 of the mesh):
  * FLOPs of each op at its local shapes: the matrix products by
    ``torch.utils.flop_counter``'s formulas, one per output element for
    pointwise ops, one per input element for reductions. Redundant work
    (a replicated op every rank runs) counts on every rank, as XLA's
    per-device count does.
  * Bytes: each non-view op's local inputs read once and outputs written
    once. The trace is eager, op by op: nothing is fused, so this is an
    upper bound on what a fusing compiler would move.
  * Collectives: each collective DTensor issues, its local output bytes,
    wire bytes by the reference's ring factors.
  * Ops DTensor has no sharding rule for run as the ranks run them
    (``runtime.spmd.ShardingFallback``, the mode the counter extends):
    batch-only (``counted_by["relayout"]``) or on replicated operands,
    each sharded operand gathered by DTensor's own collectives, counted as
    such; their terms are listed under ``counted_by["analytic"]``.

``--opt`` (``optimized=True``) installs the activation context around the
traced step, as the reference's ``_compile_step`` does: the models take
their mesh paths (expert-parallel MoE with its all-reduce over "model",
batch-split attention with its all-gather, vocab-sharded logits), whose
explicit collectives are functional collectives and counted like
DTensor's. The nerf cells run their MLP engine in bf16 with the rays over
every mesh axis. The file tags are the baseline's, so ``--opt`` writes to
``runs/dryrun_torch_opt`` unless ``--out`` is given.

The local shards are fake tensors on ``meta`` rather than fake ``cuda``
tensors: a CPU-only build cannot run the fake all-to-all on a fake cuda
tensor. The mesh, and so every collective DTensor picks, is the card's.

An eager trace counts every layer, so the cell's numbers are the full
trace's. The reference's two reduced-depth probes (XLA counts a scan body
once) are kept as a linearity check: ``probe`` holds both probe counts
and their extrapolation to full depth.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import sys
import time
import weakref
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import (HBM_BW, INTERNODE_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh, mesh_chips)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import is_decl, param_count
from repro_torch.optim.adam import AdamConfig, opt_state_decls
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import (Rules, mesh_axes, placements,
                                          set_activation_context)

DEFAULT_OUT = "runs/dryrun_torch"
OPT_OUT = "runs/dryrun_torch_opt"      # --opt cells (the file tags are equal)

# ----------------------------------------------------------- HLO parsing ---
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLL_RE = re.compile(
    r"=\s*(.+?)\s+(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(-start)?\(")

# wire-bytes factor per collective (ring algorithms, (G-1)/G ~= 1)
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-op-kind result bytes + modeled wire bytes, from optimized HLO
    text (the reference's parser, kept for its artifacts)."""
    out = {k: 0 for k in _WIRE_FACTOR}
    counts = {k: 0 for k in _WIRE_FACTOR}
    for m in _COLL_RE.finditer(hlo_text):
        type_str, kind = m.group(1), m.group(2)
        out[kind] += _type_bytes(type_str)
        counts[kind] += 1
    wire = sum(out[k] * _WIRE_FACTOR[k] for k in out)
    return {"result_bytes": out, "op_counts": counts, "wire_bytes": int(wire)}


# ------------------------------------------------------- analytic terms ---
def _leaves(tree) -> list:
    if is_decl(tree) or not isinstance(tree, dict):
        return [tree]
    return [x for v in tree.values() for x in _leaves(v)]


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def sharded_bytes(decls, mesh, rules: Rules, dtype_default: str) -> int:
    """Analytic per-device bytes for a Decl tree under its sharding."""
    sizes = mesh_axes(mesh)
    total = 0
    for d in _leaves(decls):
        spec = rules.spec_for(d, mesh)
        shard = 1
        for part in spec:
            if part is None:
                continue
            for ax in (part if isinstance(part, tuple) else (part,)):
                shard *= sizes[ax]
        total += int(np.prod(d.shape)) * _itemsize(d.dtype or dtype_default) // shard
    return total


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N active for MoE."""
    n = cfg.param_count(active_only=cfg.family == "moe")
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# nerf-icarus joins the grid with its own shapes (rays per render step)
NERF_SHAPES = {"render_800": 800 * 800, "render_quarter": 400 * 400}


# --------------------------------------------- trip-count probes ----------
def _probe_cfg(cfg, k: int):
    """Unrolled config with k layer-units. Returns (cfg_k, units_k)."""
    kw = dict(scan_layers=False)
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        return cfg.replace(n_layers=fk + k, **kw), k
    if cfg.family == "hybrid":
        per = len(cfg.hybrid.pattern)
        return cfg.replace(n_layers=k * per, **kw), k
    if cfg.family == "encdec":
        e = dataclasses.replace(cfg.encdec, n_enc_layers=k)
        return cfg.replace(n_layers=k, encdec=e, **kw), k
    return cfg.replace(n_layers=k, **kw), k


def _full_units(cfg) -> float:
    if cfg.family == "moe":
        return cfg.n_layers - cfg.moe.first_k_dense
    if cfg.family == "hybrid":
        return cfg.n_layers / len(cfg.hybrid.pattern)
    return float(cfg.n_layers)


def _extrapolate(f1: dict, f2: dict, k1: float, k2: float, kf: float) -> dict:
    """Per-key linear extrapolation in layer-units."""
    out = {}
    for key in f1:
        slope = (f2[key] - f1[key]) / (k2 - k1)
        out[key] = max(0.0, f1[key] + (kf - k1) * slope)
    return out


# ------------------------------------------------------------- counting ---
# collective ops DTensor issues (functional collectives, and its own
# all-to-all), by the reference's kind names
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "_softmax", "_log_softmax", "cumsum", "var",
               "std", "norm", "linalg_vector_norm", "any", "all", "argmax",
               "argmin"}

# ops that move no bytes: views under another name, and the functional
# collectives' bookkeeping
_NO_TRAFFIC = {"_unsafe_view", "_reshape_alias", "alias", "detach",
               "lift_fresh", "_wrap_tensor_autograd", "wait_tensor"}


def _no_traffic(func) -> bool:
    return func.overloadpacket.__name__ in _NO_TRAFFIC


FLOPS_COUNTED_BY = ("matrix products by torch.utils.flop_counter's formulas, "
                    "pointwise ops one per output element, reductions one "
                    "per input element, at each op's local shapes")
BYTES_COUNTED_BY = ("each non-view op's local inputs read once and outputs "
                    "written once, eager and unfused")


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCounter(spmd.ShardingFallback):
    """Counts FLOPs, bytes, collectives and live bytes of the ops that run
    on the local shards of a DTensor program traced under ``fake_mode``.

    It is the ranks' own mode (``runtime.spmd.ShardingFallback``): a DTensor
    op is handed to DTensor, its redistributions and local op come back
    through ``local_op`` at local shapes and are counted there; an op
    DTensor refuses runs batch-only or on replicated operands as it does
    on the ranks, its gathers counted as the collectives they are, its
    own terms recorded per op in ``analytic``. The models' explicit
    collectives (the mesh paths') are functional collectives and are
    counted like DTensor's. Shape inference DTensor runs on its own fake
    tensors is not counted."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0 for k in _WIRE_FACTOR}
        self.coll_counts = {k: 0 for k in _WIRE_FACTOR}
        self.coll_log: list = []
        self.flops_by_op: dict = {}
        self.live = 0
        self.peak_live = 0
        self._tracked: set = set()

    # -- helpers --------------------------------------------------------
    def _foreign(self, ts) -> bool:
        """A tensor of another fake mode: DTensor's shape inference."""
        return any(getattr(t, "fake_mode", self.fake_mode) is not self.fake_mode
                   for t in ts)

    def _track(self, t: torch.Tensor):
        key = id(t)
        if key in self._tracked:
            return
        n = _nbytes(t)
        self._tracked.add(key)
        self.live += n
        self.peak_live = max(self.peak_live, self.live)

        def release(tracked=self._tracked, key=key, n=n, counter=weakref.ref(self)):
            tracked.discard(key)
            c = counter()
            if c is not None:
                c.live -= n
        weakref.finalize(t, release)

    def _op_flops(self, func, args, kwargs, out, ins, outs) -> float:
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            return float(flop_registry[packet](*args, **kwargs, out_val=out))
        name = packet.__name__.rstrip("_")
        if torch.Tag.pointwise in func.tags:
            return float(sum(t.numel() for t in outs))
        if name in _REDUCTIONS:
            return float(sum(t.numel() for t in ins))
        return 0.0

    def _snapshot(self):
        return (self.flops, self.bytes, dict(self.coll), dict(self.coll_counts),
                len(self.coll_log), dict(self.flops_by_op))

    def _restore(self, saved):
        self.flops, self.bytes = saved[0], saved[1]
        self.coll, self.coll_counts = dict(saved[2]), dict(saved[3])
        del self.coll_log[saved[4]:]
        self.flops_by_op = dict(saved[5])

    def _note_fallback(self, entry: dict, saved):
        entry["flops"] = entry.get("flops", 0.0) + self.flops - saved[0]
        entry["bytes"] = entry.get("bytes", 0.0) + self.bytes - saved[1]

    def _count_collective(self, kind: str, nbytes: int):
        self.coll[kind] += nbytes
        self.coll_counts[kind] += 1
        self.coll_log.append((kind, nbytes))

    # -- the ops on local shards ------------------------------------------
    def local_op(self, func, args, kwargs):
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._foreign(ins + outs):
            return out          # DTensor's shape inference, not the program
        kind = _COLLECTIVE_KINDS.get(func.overloadpacket.__name__.rstrip("_"))
        if kind is not None:
            self._count_collective(kind, sum(_nbytes(t) for t in outs))
            return out
        if func.is_view or not outs or _no_traffic(func):
            return out
        f = self._op_flops(func, args, kwargs, out, ins, outs)
        if f:
            name = func.overloadpacket.__name__
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        self.flops += f
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            if not any(t is i for i in ins):
                self._track(t)
        return out

    # -- results ----------------------------------------------------------
    def wire_bytes(self) -> int:
        return int(sum(self.coll[k] * _WIRE_FACTOR[k] for k in self.coll))

    def collectives(self) -> dict:
        return {"result_bytes": dict(self.coll),
                "op_counts": dict(self.coll_counts),
                "wire_bytes": self.wire_bytes()}

    def triple(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "wire_bytes": float(self.wire_bytes())}


# ----------------------------------------------------------- cell set-up ---
def _global_stride(shape) -> tuple:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _dtensor(shape, dtype, spec, mesh, fake_mode):
    """A DTensor of global ``shape`` laid out by ``spec``, its local shard a
    fake ``meta`` tensor."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_axes(mesh)
    local = list(shape)
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            local[d] //= sizes[a]
    with fake_mode:
        t = torch.empty(local, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False,
                              shape=tuple(shape), stride=_global_stride(shape))


def abstract_sharded(decls, mesh, rules: Rules, dtype_default: str, fake_mode):
    """Decl tree -> DTensor tree laid out by ``rules``."""
    if is_decl(decls):
        return _dtensor(decls.shape, getattr(torch, decls.dtype or dtype_default),
                        rules.spec_for(decls, mesh), mesh, fake_mode)
    return {k: abstract_sharded(v, mesh, rules, dtype_default, fake_mode)
            for k, v in decls.items()}


def input_spec_parts(rules: Rules, mesh, shape, logical) -> tuple:
    """The reference's input sharding: each logical axis resolved alone."""
    return tuple(rules.resolve(name, mesh, dim)
                 for dim, name in zip(shape, logical))


def sharded_inputs(specs: dict, logical: dict, mesh, rules: Rules, fake_mode):
    return {k: _dtensor(v.shape, v.dtype,
                        input_spec_parts(rules, mesh, v.shape, logical[k]),
                        mesh, fake_mode)
            for k, v in specs.items()}


def local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def all_fake_or_meta(tree) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    for t in _tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        if not (isinstance(t, FakeTensor) or t.device.type == "meta"):
            return False
    return True


@contextlib.contextmanager
def _no_kernels():
    """The nerf cells take the plain route: reaching a kernel entry point
    under the trace raises."""
    from repro_torch.kernels import ops as kops

    names = ("fused_render", "fused_render_two_pass", "rmcm_matmul")
    saved = {n: getattr(kops, n) for n in names}

    def refuse(*_, **__):
        raise AssertionError("a dry-run cell reached kernels.ops")
    try:
        for n in names:
            setattr(kops, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(kops, n, f)


def _trace(fn, fake_mode):
    """Run ``fn()`` under the counter, as the ranks run their programs
    (``spmd.sharded_program``); returns (counter, output, seconds)."""
    counter = LocalCounter(fake_mode)
    t0 = time.time()
    with spmd.sharded_program(counter):
        out = fn()
    return counter, out, time.time() - t0


def _relaid(tree, like):
    """``tree``'s DTensors redistributed to the layouts of ``like``'s: the
    reference's out_shardings (pending partial sums reduced)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(tree, dict):
        return {k: _relaid(v, like[k]) for k, v in tree.items()}
    if not isinstance(tree, DTensor):     # made by a factory: replicated
        tree = DTensor.from_local(tree, like.device_mesh,
                                  [Replicate()] * like.device_mesh.ndim,
                                  run_check=False)
    if list(tree.placements) == list(like.placements):
        return tree
    return tree.redistribute(like.device_mesh, like.placements)


def _step_fn(cfg, shape, mesh, rules, fake_mode):
    """(thunk running the step with its outputs laid out as the
    reference's out_shardings, argument tree, state bytes, decls)."""
    model = build_model(cfg)
    decls = model.param_decls()
    params = abstract_sharded(decls, mesh, rules, cfg.param_dtype, fake_mode)
    batch = sharded_inputs(model.input_specs(shape), model.input_logical(shape),
                           mesh, rules, fake_mode)
    if shape.kind == "train":
        opt_cfg = AdamConfig(moment_dtype=cfg.moment_dtype)
        o_decls = opt_state_decls(decls, opt_cfg)
        opt = abstract_sharded(o_decls, mesh, rules, "float32", fake_mode)
        step = make_train_step(spmd.FsdpLoss(model, mesh, rules), opt_cfg)
        state_bytes = sharded_bytes(o_decls, mesh, rules, "float32")

        def train():
            p, o, metrics = step(params, opt, batch)
            return _relaid(p, params), _relaid(o, opt), metrics
        return train, (params, opt, batch), state_bytes, decls
    c_decls = model.cache_decls(shape.global_batch, shape.seq_len)
    state_bytes = sharded_bytes(c_decls, mesh, rules, "bfloat16")
    cache = abstract_sharded(c_decls, mesh, rules, "bfloat16", fake_mode)
    B = shape.global_batch
    logits_like = _dtensor((B, 1, cfg.vocab_size), getattr(torch, cfg.dtype),
                           (rules.resolve("batch", mesh, B), None, None),
                           mesh, fake_mode)

    def out(c, logits):
        return _relaid(c, {k: cache[k] for k in c}), _relaid(logits, logits_like)
    if shape.kind == "prefill":
        step = make_prefill_step(model)
        return (lambda: out(*step(spmd.fsdp_gathered(params, mesh, rules), batch))), \
            (params, batch), state_bytes, decls
    step = make_decode_step(model)
    # the reference traces pos; the port's decode takes a Python int: the
    # last slot of the cache (the op count does not depend on it)
    pos = shape.seq_len - 1
    return (lambda: out(*step(spmd.fsdp_gathered(params, mesh, rules), cache,
                              batch["token"], pos))), \
        (params, cache, batch["token"]), state_bytes, decls


def _run_cell(cfg, shape, mesh, rules):
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    thunk, args, state_bytes, decls = _step_fn(cfg, shape, mesh, rules,
                                               fake_mode)
    t_setup = time.time() - t0
    counter, out, t_trace = _trace(thunk, fake_mode)
    if not all_fake_or_meta((args, out)):
        raise AssertionError("a dry-run cell built a tensor with storage")
    mem = {"argument_size_in_bytes": local_bytes(args),
           "output_size_in_bytes": local_bytes(out),
           "temp_size_in_bytes": int(counter.peak_live)}
    return counter, mem, t_setup, t_trace, state_bytes, decls


def _roofline(flops, nbytes, wire) -> dict:
    return {"compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": nbytes / HBM_BW,
            "collective_s": wire / INTERNODE_BW}


def _counted_by(counter: LocalCounter, setup: str, trace: str) -> dict:
    return {
        "hlo_flops_per_device": FLOPS_COUNTED_BY,
        "hlo_bytes_per_device": BYTES_COUNTED_BY,
        "collectives": "DTensor's collectives on the local shards, output "
                       "bytes; wire bytes by the reference's ring factors",
        "roofline": "modelled for a cluster of H100s: FLOPs at "
                    "PEAK_FLOPS_BF16, bytes at HBM_BW, wire bytes at "
                    "INTERNODE_BW (launch/mesh.py); not measured",
        "lower_s": setup, "compile_s": trace,
        "analytic": counter.analytic,
        "relayout": counter.relayout,
    }


def lower_nerf_cell(shape_name: str, *, multi_pod: bool,
                    verbose: bool = True, optimized: bool = False) -> dict:
    """Dry-run the paper's own workload: a two-pass PLCore render step,
    weights replicated, rays sharded over the data axes; ``optimized``:
    the MLP engine in bf16 (``compute_dtype``) and the rays sharded over
    every mesh axis (ray clusters dispatched to every PLCore)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.nerf_icarus import CONFIG as ncfg
    from repro_torch.core.plcore import PlcoreModel, ray_parallel

    if optimized:
        ncfg = dataclasses.replace(ncfg, compute_dtype="bfloat16")
    n_rays = NERF_SHAPES[shape_name]
    model = PlcoreModel(ncfg)
    decls = model.param_decls()
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        rules = Rules()
        if optimized:
            every = tuple(mesh.mesh_dim_names)
            rules = Rules(dp_axes=every).updated(batch=every)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        t0 = time.time()
        repl = Rules(table={})            # every weight replicated
        params = abstract_sharded(decls, mesh, repl, "float32", fake_mode)
        batch = sharded_inputs(model.input_specs(n_rays), model.input_logical(),
                               mesh, rules, fake_mode)
        step = ray_parallel(model.render_step, mesh, rules)
        t_setup = time.time() - t0
        with _no_kernels():
            counter, out, t_trace = _trace(lambda: step(params, batch),
                                           fake_mode)
        if not all_fake_or_meta((params, batch, out)):
            raise AssertionError("a dry-run cell built a tensor with storage")
        axes = mesh_axes(mesh)
        chips = mesh_chips(mesh)
    flops, bytes_acc = counter.flops, counter.bytes
    p_per_net = param_count(decls) / 2
    n_evals = n_rays * (ncfg.n_coarse + ncfg.n_coarse + ncfg.n_fine)
    mf = 2.0 * p_per_net * n_evals
    result = {
        "arch": "nerf-icarus", "shape": shape_name, "optimized": optimized,
        "mesh": axes, "chips": chips,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collectives": counter.collectives(),
        "param_count": param_count(decls),
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "roofline": _roofline(flops, bytes_acc, counter.wire_bytes()),
        "useful_flops_ratio": (mf / chips) / flops if flops else None,
        "lower_s": round(t_setup, 2), "compile_s": round(t_trace, 2),
        "counted_by": _counted_by(
            counter, "seconds to lay out the replicated weights and sharded "
            "rays", "seconds of the traced render step"),
    }
    result["dominant"] = max(result["roofline"], key=result["roofline"].get)
    if verbose:
        print(json.dumps(result, indent=2))
    return result


@contextlib.contextmanager
def _activation_context(mesh, rules: Rules):
    """The reference's ``_compile_step`` for ``optimized``: the activation
    context installed around the trace (``mesh`` None: none), cleared after."""
    set_activation_context(mesh, rules)
    try:
        yield
    finally:
        set_activation_context(None)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rules: Rules | None = None, verbose: bool = True,
               probes: bool = True, optimized: bool = False,
               remat_policy: str | None = None,
               param_dtype: str | None = None) -> dict:
    """One (arch, shape) cell on the production mesh; ``optimized``: the
    models' mesh paths on (expert-parallel MoE, batch-split attention,
    vocab-sharded logits), the activation context installed around every
    trace of the cell."""
    if arch == "nerf-icarus":
        return lower_nerf_cell(shape_name, multi_pod=multi_pod,
                               verbose=verbose, optimized=optimized)
    cfg = get_config(arch)
    if remat_policy:
        cfg = cfg.replace(remat_policy=remat_policy)
    if param_dtype:
        cfg = cfg.replace(param_dtype=param_dtype)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long:
        return {"arch": arch, "shape": shape_name, "skipped":
                "full-attention arch; long_500k requires sub-quadratic decode"}
    rules = rules or Rules()

    with make_production_mesh(multi_pod=multi_pod) as mesh, \
            _activation_context(mesh if optimized else None, rules):
        counter, mem_d, t_setup, t_trace, state_bytes, decls = _run_cell(
            cfg, shape, mesh, rules)
        full = counter.triple()
        probe_info = None
        if probes:
            k1, k2 = (1, 2) if cfg.family == "hybrid" else (2, 4)
            cfg1, u1 = _probe_cfg(cfg, k1)
            cfg2, u2 = _probe_cfg(cfg, k2)
            f1 = _run_cell(cfg1, shape, mesh, rules)[0].triple()
            f2 = _run_cell(cfg2, shape, mesh, rules)[0].triple()
            uf = _full_units(cfg)
            probe_info = {"k": [u1, u2], "units_full": uf, "f1": f1, "f2": f2,
                          "extrapolated": _extrapolate(f1, f2, u1, u2, uf)}
        param_bytes = sharded_bytes(decls, mesh, rules, cfg.param_dtype)
        axes = mesh_axes(mesh)
        chips = mesh_chips(mesh)

    flops, bytes_acc, wire = full["flops"], full["bytes"], full["wire_bytes"]
    mf = model_flops(cfg, shape)
    result = {
        "arch": arch, "shape": shape_name, "optimized": optimized,
        "mesh": axes, "chips": chips,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collective_wire_bytes": wire,
        "collectives": counter.collectives(),
        "scan_raw": full,
        "probe": probe_info,
        "memory_analysis": mem_d,
        "param_bytes_per_device": param_bytes,
        "state_bytes_per_device": state_bytes,
        "param_count": param_count(decls),
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "roofline": _roofline(flops, bytes_acc, wire),
        "useful_flops_ratio": (mf / chips) / flops if flops else None,
        "lower_s": round(t_setup, 2), "compile_s": round(t_trace, 2),
        "counted_by": {
            **_counted_by(counter, "seconds to lay out params, state and "
                          "batch as DTensors", "seconds of the traced step"),
            "scan_raw": "the full trace's own triple (an eager trace counts "
                        "every layer)",
            "probe": "two reduced-depth traces and their linear "
                     "extrapolation, a linearity check",
            "memory_analysis": "argument and output bytes of the local "
                               "shards; temp: the peak of the bytes of local "
                               "tensors the step created and held at once",
            "param_bytes_per_device": "sharded_bytes of the param decls",
            "state_bytes_per_device": "sharded_bytes of the optimizer or "
                                      "cache decls",
        },
    }
    r = result["roofline"]
    result["dominant"] = max(r, key=r.get)
    if verbose:
        print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--remat-policy", default=None,
                    choices=["nothing", "dots"])
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--opt", action="store_true",
                    help="the models' mesh paths (expert-parallel MoE, "
                         "batch-split attention, vocab-sharded logits; the "
                         "nerf cells in bf16 with rays over every axis)")
    ap.add_argument("--out", default=None,
                    help=f"default {DEFAULT_OUT}, {OPT_OUT} with --opt")
    args = ap.parse_args(argv)

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for a in archs:
        if a == "nerf-icarus":
            for s in ([args.shape] if args.shape else sorted(NERF_SHAPES)):
                cells.append((a, s))
            continue
        cfg = get_config(a)
        shapes = [s.name for s in cfg.shapes()] if (args.all or not args.shape) \
            else [args.shape]
        for s in shapes:
            cells.append((a, s))
    if args.all:
        cells += [("nerf-icarus", s) for s in sorted(NERF_SHAPES)]

    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    outdir = Path(args.out or (OPT_OUT if args.opt else DEFAULT_OUT))
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    t_all = time.time()
    for arch, shp in cells:
        for mp in pods:
            tag = f"{arch}_{shp}_{'2x16x16' if mp else '16x16'}"
            t0 = time.time()
            try:
                # probes (the linearity check) only on the single-pod pass
                res = lower_cell(arch, shp, multi_pod=mp, verbose=False,
                                 probes=not mp, optimized=args.opt,
                                 remat_policy=args.remat_policy,
                                 param_dtype=args.param_dtype)
                (outdir / f"{tag}.json").write_text(json.dumps(res, indent=2))
                dom = res.get("dominant", "-")
                status = "SKIP" if "skipped" in res else "OK"
                print(f"[{status}] {tag}  dominant={dom} "
                      f"wall={time.time() - t0:.2f}s", flush=True)
            except Exception as e:  # one cell's failure must not stop the sweep
                failures.append((tag, str(e)[:2000]))
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:500]}",
                      flush=True)
    print(f"sweep wall {time.time() - t_all:.2f}s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main(sys.argv[1:])
