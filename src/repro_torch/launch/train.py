"""Training driver: any assigned architecture, fault-tolerant, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir runs/ck

* init-or-restore: if the checkpoint dir has a LATEST pointer, training
  resumes from it, the data-loader step and schedule step included; the
  checkpoint format is the reference's, so either package resumes what
  the other wrote;
* periodic async checkpoints (``Checkpointer``), joined at the end;
* deterministic data: batch(step) is a pure function, so a restart
  reproduces the uninterrupted run;
* straggler monitor fed with per-step wall times (on the card each time
  ends in a device synchronize; deadline events are logged);
* optional RMCM QAT (``--qat``), int8-compressed gradients with error
  feedback (``--compress``, over the ranks of the default process group,
  one card without one) and gradient accumulation (``--grad-accum N``)
  with a single deferred update.

``--model-axis N`` above 1 trains on a ("data", "model") host mesh over
the launcher's ranks (``launch.mesh.make_host_mesh``; ``torchrun
--nproc-per-node W``, W a multiple of N): params and optimizer state are
DTensors laid out by ``Rules`` (``pspecs``), the batch is sharded over the
data axes, the step runs the FSDP schedule under ``runtime.spmd``'s
fallback, and the activation context is installed, so the models take
their mesh paths (expert-parallel MoE, batch-split attention,
vocab-sharded logits). Checkpoints stay the reference's format: full
tensors, written by rank 0. ``--compress`` needs a pure data-parallel
mesh and is refused with a model axis, as the reference refuses it.

Params are drawn from a ``torch.Generator`` seeded ``--seed`` on the
device (the reference's ``jax.random`` draw cannot be repeated); on a
mesh every rank draws the same leaves in the same order and keeps its
shards, one leaf at a time.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.bridge import resolve_device, to_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokens import TokenStreamConfig, synthetic_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (make_dp_compressed_train_step,
                                      make_grad_accum_train_step,
                                      make_train_step)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import Decl, _init_one, init_params
from repro_torch.optim.adam import AdamConfig, opt_state_decls
from repro_torch.optim.qat import qat_loss
from repro_torch.runtime import spmd
from repro_torch.runtime.compression import group_size, init_error_state
from repro_torch.runtime.sharding import (Rules, placements,
                                          set_activation_context)
from repro_torch.runtime.straggler import StragglerMonitor


def extra_inputs(cfg, batch_size: int, device=None) -> dict:
    """Stub modality inputs for encdec/vlm families."""
    if cfg.family == "vlm":
        return {"patches": torch.ones((batch_size, cfg.vlm.n_patches,
                                       cfg.d_model), device=device)}
    if cfg.family == "encdec":
        return {"frames": torch.ones((batch_size, cfg.encdec.enc_seq,
                                      cfg.d_model), device=device)}
    return {}


class QatModel:
    """Model facade whose loss sees RMCM fake-quantized weights."""

    def __init__(self, model):
        self._m = model
        self.loss = qat_loss(model.loss)

    def __getattr__(self, k):
        return getattr(self._m, k)


def init_sharded(decls, gen: torch.Generator, param_dtype: str, mesh,
                 rules: Rules):
    """``init_params(decls, gen, param_dtype)`` laid out on ``mesh`` by
    ``rules``: the same draws in the same order, each leaf distributed
    (this rank keeps its shards) before the next is drawn."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(decls, Decl):
        return distribute_tensor(
            _init_one(decls, gen, param_dtype), mesh,
            placements(rules.spec_for(decls, mesh), mesh), src_data_rank=None)
    return {k: init_sharded(decls[k], gen, param_dtype, mesh, rules)
            for k in sorted(decls)}


def _mesh_step(step_fn, mesh, rules):
    """``step_fn`` run by every rank on its shards (``spmd.sharded_program``)
    with its scalar metrics gathered to plain tensors."""
    def step(params, opt_state, batch):
        with spmd.sharded_program():
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = spmd.full_tree(metrics)
        return params, opt_state, metrics
    return step


def _mesh_batch(batch: dict, mesh, rules: Rules) -> dict:
    """Every rank's same full batch, sharded over the data axes."""
    return spmd.distribute_tree(
        batch, {k: Decl(tuple(v.shape), ("batch",) + (None,) * (v.ndim - 1))
                for k, v in batch.items()}, mesh, rules)


def run(args) -> dict:
    """Train ``args.arch``; returns the reference's keys (``final_loss``,
    ``loss_first``, ``steps``, ``wall_s``, ``straggler``), every step's
    ``losses`` and wall seconds (``step_s``), and prints the first four as
    JSON (rank 0 on a mesh)."""
    dev = resolve_device(args.device, "train")
    if args.model_axis > 1:
        if args.compress:
            raise ValueError("--compress needs a pure data-parallel mesh: "
                             f"refused with --model-axis {args.model_axis}")
        with make_host_mesh(args.model_axis, device=dev,
                            backend=args.backend) as mesh:
            rules = Rules()
            set_activation_context(mesh, rules)
            try:
                return _run(args, dev, mesh, rules)
            finally:
                set_activation_context(None)
    return _run(args, dev, None, None)


def _run(args, dev, mesh, rules) -> dict:
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    if args.qat:
        model = QatModel(model)
    opt_cfg = AdamConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                         total_steps=args.steps,
                         moment_dtype=cfg.moment_dtype)

    decls = model.param_decls()
    o_decls = opt_state_decls(decls, opt_cfg)
    step_model = model if mesh is None else spmd.FsdpLoss(model, mesh, rules)
    if args.compress:
        step_fn = make_dp_compressed_train_step(model, opt_cfg)
    elif args.grad_accum > 1:
        step_fn = make_grad_accum_train_step(step_model, opt_cfg,
                                             args.grad_accum)
    else:
        step_fn = make_train_step(step_model, opt_cfg)
    if mesh is not None:
        step_fn = _mesh_step(step_fn, mesh, rules)
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    ckpt = Checkpointer(args.ckpt_dir, keep_last=2) if args.ckpt_dir else None
    start_step = 0
    params = opt_state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(device=dev)
        params, opt_state = state["params"], state["opt"]
        if mesh is not None:
            params = spmd.distribute_tree(params, decls, mesh, rules)
            opt_state = spmd.distribute_tree(opt_state, o_decls, mesh, rules)
        if args.compress and "err" not in opt_state:
            opt_state["err"] = init_error_state(params, group_size())
        start_step = int(meta["train_step"])
        say(f"[train] restored step={start_step} from {args.ckpt_dir}")
    if params is None:
        gen = torch.Generator(dev).manual_seed(args.seed)
        if mesh is None:
            params = init_params(decls, gen, cfg.param_dtype)
            opt_state = init_params(o_decls, gen, "float32")
        else:
            params = init_sharded(decls, gen, cfg.param_dtype, mesh, rules)
            opt_state = init_sharded(o_decls, gen, "float32", mesh, rules)
        if args.compress:
            opt_state["err"] = init_error_state(params, group_size())

    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seed=args.seed)
    extras = extra_inputs(cfg, args.batch, dev)
    monitor = StragglerMonitor()
    losses, step_s = [], []
    t_start = time.time()
    stop_at = args.stop_after if args.stop_after else args.steps
    for step in range(start_step, stop_at):
        batch = to_device(synthetic_batch(stream, step, args.batch, args.seq),
                          dev)
        batch.update(extras)
        if mesh is not None:
            batch = _mesh_batch(batch, mesh, rules)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        loss = float(metrics["loss"])
        verdict = monitor.record_step(dt)
        losses.append(loss)
        step_s.append(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms"
                  + (" DEADLINE" if verdict["deadline_exceeded"] else ""))
        if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                 or step == stop_at - 1):
            state = {"params": params, "opt": opt_state}
            if mesh is not None:
                state = spmd.full_tree(state)     # every rank gathers
            if lead:
                ckpt.save(step + 1, state,
                          {"train_step": step + 1, "arch": args.arch,
                           "losses_tail": losses[-5:]})
    if ckpt is not None:
        ckpt.wait()
    out = {"final_loss": losses[-1] if losses else None,
           "loss_first": losses[0] if losses else None,
           "steps": stop_at - start_step,
           "wall_s": time.time() - t_start,
           "straggler": monitor.summary()["events"], "losses": losses,
           "step_s": step_s}
    say(json.dumps({k: v for k, v in out.items()
                    if k not in ("straggler", "losses", "step_s")}))
    return out


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stop-after", type=int, default=None,
                    help="simulate failure: stop at this step but keep the "
                         "LR schedule derived from --steps (restart-safe)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="above 1: train on a (data, model) mesh over the "
                         "launcher's ranks")
    ap.add_argument("--backend", default=None,
                    help="process group backend of the --model-axis mesh "
                         "(default nccl on the card, gloo on the CPU; ranks "
                         "sharing one card need gloo)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain CPU run")
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
