"""Per-rank programs on a ``DeviceMesh``: the models' explicit-collective
regions, and the one fallback for the ops DTensor refuses.

**Regions.** The reference's mesh paths are ``shard_map`` bodies: per-rank
code with explicit collectives. Here a region takes each DTensor operand's
local shard at the layout the body needs (``local_view``: a DTensor
redistribution, so its collectives are DTensor's and autograd-aware), runs
plain tensor code, and wraps its result back (``from_local``). Inside,
``psum`` and ``all_gather`` are functional collectives (they reach a
dispatch mode such as the dry run's counter) with the cotangent
convention of a replicated output: every rank holds the whole gradient of
the collective's output, so ``psum``'s backward is the identity and
``all_gather``'s takes the rank's own slice. An operand a region uses
differently on each rank of an axis declares its gradient ``Partial``
there (``grad_placements``), and DTensor sums the ranks' parts.

**The fallback.** ``ShardingFallback`` is a dispatch mode under which a
DTensor op runs as DTensor runs it; where DTensor refuses it (no sharding
rule, or a layout its rule rejects) it runs again with every operand laid
out batch-only (``Shard(0)`` kept, other mesh dims gathered), and where
that is refused too, on replicated operands (each one gathered), its
output replicated and an in-place op's result written back into its
DTensor. The ops it meets in the models: the attention's head unflatten
where heads do not divide the model axis (relayout), the dense MoE
dispatch's ``searchsorted``/``index_put_``/``index_add_`` and the cross
entropy's masked ``sub`` after a vocab-sharded gather (replicated). Real
ranks (``sharded_program``) and the dry run's ``LocalCounter`` (a
subclass that counts what passes through) run the same mode, so the dry
run traces what the ranks run.

``fsdp_gathered`` / ``FsdpLoss``: the FSDP schedule both use (each weight
all-gathered over the FSDP axes where it is used, its gradient coming back
reduce-scattered); without it DTensor's op-by-op choice gathers the batch
instead and runs every product on the whole batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.runtime.sharding import Rules, placements

# ------------------------------------------------------- collectives ------


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _mesh_dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        from torch.distributed import _functional_collectives as funcol
        return _wait(funcol.all_reduce(x, "sum", (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, along):
        from torch.distributed import _functional_collectives as funcol
        ctx.coord, ctx.n, ctx.along = (mesh.get_local_rank(dim),
                                       mesh.size(dim), along)
        return _wait(funcol.all_gather_tensor(x.contiguous(), along,
                                              (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        part = g.chunk(ctx.n, dim=ctx.along)[ctx.coord]
        return part.contiguous(), None, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of mesh axis ``axis`` (the reference's
    ``lax.psum``); the gradient passes through unchanged."""
    return _Psum.apply(x, mesh, _mesh_dim(mesh, axis))


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of mesh axis ``axis`` concatenated along ``dim`` in
    coordinate order (``lax.all_gather(..., tiled=True)``); the gradient
    is the rank's own slice of the output's."""
    return _AllGather.apply(x, mesh, _mesh_dim(mesh, axis), dim)


def first_coordinate(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The value ``x`` has at coordinate 0 of each of ``axes`` (no
    gradient): one all-gather per axis."""
    from torch.distributed import _functional_collectives as funcol

    x = x.detach()
    for a in axes:
        x = _wait(funcol.all_gather_tensor(x[None].contiguous(), 0,
                                           (mesh, _mesh_dim(mesh, a))))[0]
    return x


# ------------------------------------------------------------- regions ----
def axis_placements(mesh, sharded: dict, other):
    """A placement per mesh dim: ``sharded[name]`` where given, ``other``
    elsewhere."""
    return [sharded.get(n, other) for n in mesh.mesh_dim_names]


def local_view(x, mesh, pl, grad_pl=None) -> torch.Tensor:
    """This rank's local tensor of ``x`` laid out by placements ``pl``
    (a plain tensor counts as replicated: every rank holds all of it);
    ``grad_pl``: the layout its gradient will have (default ``pl``)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if list(x.placements) != list(pl):
        x = x.redistribute(mesh, pl)
    return x.to_local(grad_placements=grad_pl)


def from_local(t: torch.Tensor, mesh, pl, like, shape=None):
    """``t`` (a rank's local tensor laid out by ``pl``) as a DTensor of
    global ``shape`` (default: ``like``'s), or as the full plain tensor
    when ``like`` was plain."""
    from torch.distributed.tensor import DTensor

    out = DTensor.from_local(t, mesh, pl, run_check=False,
                             shape=tuple(like.shape if shape is None
                                         else shape),
                             stride=_contiguous_stride(like.shape
                                                       if shape is None
                                                       else shape))
    return out if isinstance(like, DTensor) else out.full_tensor()


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


# -------------------------------------------------------- the fallback ----
_REFUSALS = ("sharding strategy", "Sharding propagation failed",
             "redistribute the tensor", "unevenly sharded")


# ops whose sharded strategies torch 2.11's DTensor gets wrong, found by
# checking every DTensor op of a train step against the same op on full
# tensors on the card machine: ``index_put`` with ``accumulate`` on a
# ``self`` sharded along the indexed dim runs on the local shard with the
# global indices (a device-side assert), ``index_select`` of a Partial
# input comes out Shard(0) with wrong values. Below torch 2.13 (whose
# DTensor runs these paths right: tests/test_torch_mesh_paths.py) they run
# on replicated operands.
_REPLICATED_OPS = ("index_put", "index_put_", "index_select") \
    if tuple(int(v) for v in torch.__version__.split(".")[:2]) < (2, 13) \
    else ()


def is_sharding_refusal(e: Exception) -> bool:
    """DTensor's words for an op it has no rule for or a layout its rule
    refuses, or an error raised inside DTensor's own redistribution (not a
    device error or an out-of-memory one, which are real)."""
    if isinstance(e, torch.OutOfMemoryError) or "CUDA error" in str(e):
        return False
    if isinstance(e, NotImplementedError) or \
            any(r in str(e) for r in _REFUSALS):
        return True
    tb = e.__traceback__
    while tb is not None:
        if "torch/distributed/tensor/" in tb.tb_frame.f_code.co_filename:
            return True
        tb = tb.tb_next
    return False


def why(e: Exception) -> str:
    first = (str(e).splitlines() or [""])[0]
    return f"{type(e).__name__}: {first[:160]}"


def batch_only(tree):
    """Every DTensor of ``tree`` with Shard(0) kept and its other mesh dims
    replicated (partial sums reduced, other shards gathered)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._pytree import tree_map

    def one(x):
        if not isinstance(x, DTensor):
            return x
        want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in x.placements]
        if list(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)
    return tree_map(one, tree)


def _written(func, args) -> list:
    """Positions of the tensor arguments ``func`` writes in place."""
    return [i for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write
            and i < len(args) and isinstance(args[i], torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardingFallback(TorchDispatchMode):
    """DTensor ops as DTensor runs them; a refused one again batch-only
    (``relayout``: calls and why, per op) and then on replicated operands
    (``analytic``: calls, gathered bytes and why, per op). Plain ops run
    as they are (``local_op``, the hook a counting subclass overrides)."""

    def __init__(self):
        super().__init__()
        self.analytic: dict = {}
        self.relayout: dict = {}
        self._to_dtensor = False

    # -- hooks for a counting subclass ---------------------------------
    def local_op(self, func, args, kwargs):
        return func(*args, **kwargs)

    def _snapshot(self):
        return None

    def _restore(self, saved):
        pass

    def _note_fallback(self, entry: dict, saved):
        pass

    # -- the mode ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._to_dtensor:
                self._to_dtensor = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        return self.local_op(func, args, kwargs)

    def _dtensor_op(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor

        saved = self._snapshot()
        first = None
        if func.overloadpacket.__name__ in _REPLICATED_OPS:
            return self._replicated(func, args, kwargs, NotImplementedError(
                "run on replicated operands (_REPLICATED_OPS)"))
        if any(not isinstance(args[i], DTensor) for i in _written(func, args)):
            # DTensor runs an in-place op on a plain tensor's storage and
            # then refuses it: it would be applied again below
            return self._replicated(func, args, kwargs, NotImplementedError(
                "an in-place op on a plain tensor with DTensor operands"))
        for relayout in (False, True):
            try:
                with self:
                    a, k = batch_only((args, kwargs)) if relayout \
                        else (args, kwargs)
                    self._to_dtensor = True
                    out = func(*a, **k)
                if relayout:
                    entry = self.relayout.setdefault(str(func), {
                        "calls": 0, "why": why(first)})
                    entry["calls"] += 1
                return out
            except (NotImplementedError, RuntimeError, IndexError,
                    AssertionError) as e:
                if not is_sharding_refusal(e):
                    raise
                self._restore(saved)
                first = first or e
            finally:
                self._to_dtensor = False
        return self._replicated(func, args, kwargs, first)

    def _replicated(self, func, args, kwargs, first: Exception):
        """``func`` on this rank's full copies of its operands."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map

        mesh = None
        gathered = 0

        def full(x):
            nonlocal mesh, gathered
            if not isinstance(x, DTensor):
                return x
            mesh = x.device_mesh
            if not all(isinstance(p, Replicate) for p in x.placements):
                gathered += _nbytes(x)
                x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
            return x.to_local()

        with self:
            local_args, local_kwargs = tree_map(full, (args, kwargs))
        saved = self._snapshot()
        with self:
            out = func(*local_args, **local_kwargs)
        entry = self.analytic.setdefault(str(func), {
            "calls": 0, "gathered_bytes": 0, "why": why(first)})
        entry["calls"] += 1
        entry["gathered_bytes"] += gathered
        self._note_fallback(entry, saved)

        # an in-place op: its result goes back into the DTensor it mutated
        for i in _written(func, args):
            if isinstance(args[i], DTensor) and \
                    local_args[i] is not args[i].to_local():
                with self:
                    back = DTensor.from_local(
                        local_args[i], mesh, [Replicate()] * mesh.ndim,
                        run_check=False).redistribute(mesh,
                                                      args[i].placements)
                    args[i].to_local().copy_(back.to_local())
        if isinstance(out, torch.Tensor) and \
                any(out is a for a in local_args):
            return args[[i for i, a in enumerate(local_args) if a is out][0]]

        def wrap(x):
            if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
                return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)
            return x
        return tree_map(wrap, out)


@contextlib.contextmanager
def sharded_program(mode: ShardingFallback | None = None):
    """``with sharded_program():`` DTensor model code runs on this rank:
    plain tensors (the models' factory tensors) mix in as replicated and
    refused ops fall back (``ShardingFallback``, or ``mode``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    mode = ShardingFallback() if mode is None else mode
    with implicit_replication(), mode:
        yield mode


# ------------------------------------------------------------- FSDP -------
def fsdp_gathered(tree, mesh, rules: Rules):
    """``tree``'s DTensors with their shards over the FSDP axes gathered
    (model-axis shards kept): the FSDP schedule, where a weight is
    all-gathered over the data axis to be used and its gradient, a
    partial sum over that axis, comes back reduce-scattered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    fsdp = set(rules.fsdp_axes) if rules.fsdp else set()
    names = mesh.mesh_dim_names

    def one(x):
        if not isinstance(x, DTensor):
            return x
        want = [Replicate() if names[i] in fsdp and isinstance(p, Shard)
                else p for i, p in enumerate(x.placements)]
        if want == list(x.placements):
            return x
        return x.redistribute(mesh, want)
    if isinstance(tree, dict):
        return {k: fsdp_gathered(v, mesh, rules) for k, v in tree.items()}
    return one(tree)


class FsdpLoss:
    """``model`` whose ``loss`` gathers the weights first (``fsdp_gathered``)."""

    def __init__(self, model, mesh, rules: Rules):
        self.model, self.mesh, self.rules = model, mesh, rules

    def loss(self, params, batch):
        return self.model.loss(fsdp_gathered(params, self.mesh, self.rules),
                               batch)


# ----------------------------------------------------------- state trees --
def distribute_tree(tree, decls, mesh, rules: Rules):
    """A full tensor tree laid out on ``mesh`` by its Decl tree's specs;
    every rank holds the same full tree and keeps its own shards (no
    collective)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute_tree(v, decls[k], mesh, rules)
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh,
                             placements(rules.spec_for(decls, mesh), mesh),
                             src_data_rank=None)


def full_tree(tree):
    """Every DTensor of ``tree`` gathered to its full tensor (a collective:
    every rank calls it); plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
