"""Probe: the LM train step with its stacked layer leaves unbound once per
call (``transformer.tree_unbind``, what ``maybe_scan`` does) against
indexed one layer at a time (``leaf[i]`` per layer), in turns on one card:

    PYTHONPATH=src python -m repro_torch.models.stack_probe \
        [--arch qwen2-1.5b] [--batch 4] [--seq 512]

The arch's full config (a dense family: the probe swaps the layer loop of
``models.transformer``), weights from ``torch.Generator(cuda)
.manual_seed(0)``, f32 AdamW. Per variant and turn: the device ms and the
kernels of one profiled step (``torch.profiler``) and the forward and
backward peak memory above the resident state. Indexing one layer at a
time makes backward allocate, per layer, a zero tensor the size of the
whole stack (``SelectBackward``) and add it into the stack's gradient.
Prints one JSON line per turn.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.bridge import resolve_device, to_device
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStreamConfig, synthetic_batch
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import transformer
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import init_params
from repro_torch.optim.adam import AdamConfig, opt_state_decls


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


def per_layer_index(tree) -> list:
    """The per-layer trees by indexing every stacked leaf once per layer."""
    return [_index(tree, i) for i in range(len(transformer.tree_unbind(tree)))]


def _scan_with(split):
    """``transformer.maybe_scan`` over the per-layer trees ``split`` gives."""
    def scan(body, carry, xs, collect: bool = True):
        ys = []
        for x in split(xs):
            carry, y = body(carry, x)
            ys.append(y)
        if not collect or all(y is None for y in ys):
            return carry, None
        return carry, transformer.tree_stack(ys)
    return scan


def _profiled_step(step, state: dict, batch) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels_per_step": len(us), "kernel_ms_per_step": sum(us) / 1e3}


def run(args) -> list:
    dev = resolve_device(args.device, "stack_probe")
    if dev.type != "cuda":
        raise RuntimeError("stack_probe measures the card: it needs cuda")
    cfg = get_config(args.arch)
    model = build_model(cfg)
    decls = model.param_decls()
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    gen = torch.Generator(dev).manual_seed(0)
    state = {"params": init_params(decls, gen, cfg.param_dtype),
             "opt": init_params(opt_state_decls(decls, opt_cfg), gen,
                                "float32")}
    step = make_train_step(model, opt_cfg)
    batch = to_device(synthetic_batch(TokenStreamConfig(cfg.vocab_size), 0,
                                      args.batch, args.seq), dev)
    unbind = transformer.maybe_scan
    rows = []
    try:
        for name in ("unbind", "index", "index", "unbind"):
            transformer.maybe_scan = (unbind if name == "unbind"
                                      else _scan_with(per_layer_index))
            state["params"], state["opt"], _ = step(state["params"],
                                                    state["opt"], batch)
            row = {"variant": name, **_profiled_step(step, state, batch)}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss_and_grads(model.loss, state["params"], batch)
            torch.cuda.synchronize()
            row["loss_and_grads_peak_above_state_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
            row["card"] = torch.cuda.get_device_name(dev)
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        transformer.maybe_scan = unbind
    return rows


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
