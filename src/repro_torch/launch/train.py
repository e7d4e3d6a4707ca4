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

Params are drawn from a ``torch.Generator`` seeded ``--seed`` on the
device (the reference's ``jax.random`` draw cannot be repeated). One card
has no model axis: ``--model-axis`` above 1 raises.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.bridge import resolve_device, to_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokens import TokenStreamConfig, synthetic_batch
from repro_torch.launch.steps import (make_dp_compressed_train_step,
                                      make_grad_accum_train_step,
                                      make_train_step)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import init_params
from repro_torch.optim.adam import AdamConfig, opt_state_decls
from repro_torch.optim.qat import qat_loss
from repro_torch.runtime.compression import group_size, init_error_state
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


def run(args) -> dict:
    """Train ``args.arch``; returns the reference's keys (``final_loss``,
    ``loss_first``, ``steps``, ``wall_s``, ``straggler``) and every step's
    ``losses``, and prints the first four as JSON."""
    dev = resolve_device(args.device, "train")
    if args.model_axis > 1:
        raise ValueError(
            f"--model-axis {args.model_axis} needs a device mesh with a model "
            "axis (the reference's launch/mesh.py), which the port does not "
            "have yet; one card trains with --model-axis 1")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    if args.qat:
        model = QatModel(model)
    opt_cfg = AdamConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                         total_steps=args.steps,
                         moment_dtype=cfg.moment_dtype)

    decls = model.param_decls()
    o_decls = opt_state_decls(decls, opt_cfg)
    if args.compress:
        step_fn = make_dp_compressed_train_step(model, opt_cfg)
    elif args.grad_accum > 1:
        step_fn = make_grad_accum_train_step(model, opt_cfg, args.grad_accum)
    else:
        step_fn = make_train_step(model, opt_cfg)

    ckpt = Checkpointer(args.ckpt_dir, keep_last=2) if args.ckpt_dir else None
    start_step = 0
    params = opt_state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(device=dev)
        params, opt_state = state["params"], state["opt"]
        if args.compress and "err" not in opt_state:
            opt_state["err"] = init_error_state(params, group_size())
        start_step = int(meta["train_step"])
        print(f"[train] restored step={start_step} from {args.ckpt_dir}")
    if params is None:
        gen = torch.Generator(dev).manual_seed(args.seed)
        params = init_params(decls, gen, cfg.param_dtype)
        opt_state = init_params(o_decls, gen, "float32")
        if args.compress:
            opt_state["err"] = init_error_state(params, group_size())

    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seed=args.seed)
    extras = extra_inputs(cfg, args.batch, dev)
    monitor = StragglerMonitor()
    losses = []
    t_start = time.time()
    stop_at = args.stop_after if args.stop_after else args.steps
    for step in range(start_step, stop_at):
        batch = to_device(synthetic_batch(stream, step, args.batch, args.seq),
                          dev)
        batch.update(extras)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        loss = float(metrics["loss"])
        verdict = monitor.record_step(dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms"
                  + (" DEADLINE" if verdict["deadline_exceeded"] else ""))
        if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                 or step == stop_at - 1):
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      {"train_step": step + 1, "arch": args.arch,
                       "losses_tail": losses[-5:]})
    if ckpt is not None:
        ckpt.wait()
    out = {"final_loss": losses[-1] if losses else None,
           "loss_first": losses[0] if losses else None,
           "steps": stop_at - start_step,
           "wall_s": time.time() - t_start,
           "straggler": monitor.summary()["events"], "losses": losses}
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("straggler", "losses")}))
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
    ap.add_argument("--model-axis", type=int, default=1)
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
