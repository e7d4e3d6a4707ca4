"""Serving driver for the ICARUS use case on the card.

``--mode nerf`` loads the model into a ``PackedPlcore`` (weights
RMCM-quantized and packed ONCE at load), then serves ``--views`` requests,
one camera pose each (``--theta`` stepped around the orbit, ``--phi``,
focal ``--focal``), rendering each image in one render call and writing
it under ``runs/`` as a PPM and as the float32 pixels in ``.npy``. Prints
per-view wall times, rays/s, samples/s, ``weight_packs_since_load``
(0: no request re-packed weights) and, on the card,
``uj_per_sample_measured`` (the board's energy over the timed views, from
NVML's total-energy counter, per sample as the reference counts them) as
JSON. ``--ckpt DIR`` serves the
``params`` of the newest checkpoint in DIR (``checkpoint.Checkpointer``'s
format, written by either package) in place of the seeded weights.

``--mode engine`` serves many scenes through the multi-tenant
``serving.RenderEngine``: ``--scenes`` synthetic scenes (scene i's weights
drawn from a ``torch.Generator`` seeded ``--seed + i``) behind an LRU
``SceneCache`` of ``--cache-mb``, and a seeded Poisson trace of
``--requests`` requests (resolutions from ``--hw-mix``, priorities from
``--priority-mix``) driven open-loop at ``--rate`` or closed-loop at
``--concurrency``, coalesced into ``--tile-rays``-ray tiles with up to
``--pipeline-depth`` tiles in flight. ``--inject-faults`` arms the seeded
chaos mix (``--fault-seed``). ``--adaptive-sampling`` arms ASDR (per-scene
density probe, per-ray fine-sample budget classes ``--budget-classes``, a
trunk memo of ``--memo-mb`` per scene, memo-dead rows masked out of K2);
``--scene-bias`` shifts every scene's sigma-head bias, carving empty space
into the synthetic scenes (the adaptive gates need a mixed scene: -0.5 on
the tiny config; at full width, where the initial sigma spreads narrower,
-0.5 leaves no density at all and -0.1 is mixed).
``--shard-weights`` shards every resident's trunk weight stacks layer-wise
over a cell list (``runtime.sharding.plcore_mesh``: the first
``--shard-devices`` visible cards, or the CPU with ``--device cpu``; one
card gives one cell, as one device gives the reference one);
``--route-by-shard`` (with it) routes each scene's tiles to a home cell
by the owner map, and ``--percell-dispatch`` (with that) runs each routed
tile on its home cell against staged weights on the cell's own stream.
More cells than cards come through the Python API: ``run_engine(args,
shard_mesh=plcore_mesh(devices=[...]))``.
``--hosts N`` serves through the multi-host ``serving.ClusterEngine``: N
hosts, each with its own scene cache and executor (under
``--shard-weights`` each over its own group of the cells,
``serving.split_devices``), behind one global scheduler with heartbeats,
cross-host failover and per-host scene quarantine. ``--host-kill
HOST:AT`` kills a host AT seconds after the start, or at the engine's
dispatch count N with ``HOST:@N``; ``--host-slow HOST:AT`` adds
``--host-slow-extra-ms`` to each of its dispatches from then on; with
``--inject-faults`` the plan is the cluster chaos mix (host slow-downs
on top of the single-host classes). On one card every host renders on it.
Prints the loadgen report as JSON; ``--check`` gates it (see
``check_engine``). ``--trace-out PATH`` traces the primary engine's
request and tile lifecycle (1 request chain in ``--trace-sample``; tiles
always) and writes it as Chrome trace-event JSON, with the span-chain
validator's verdict and, on the card, the device busy share from the
tiles' ``tile.kernel`` spans (``device_busy``) and where K2 spent its
cycles (``plcore_two_pass_phase_share``: the MLP layers, the waits for
the weight ring, the resample and the fp32 scalar work, each in percent of
K2's cycles, from its traced instance; None on the CPU) in the report;
``--metrics-out PATH`` writes
the engine's and the process-wide registries as Prometheus text.

``--mode lm`` serves a batch of prompts on an LM arch (``--arch``, one
of ``configs.list_archs()``; its ``smoke_config`` unless ``--full``):
weights drawn from a ``torch.Generator`` seeded ``--seed`` on the device
and cast once to the config's dtype (``serving_params``), ``--batch``
prompts of ``--prompt-len`` random tokens (a generator seeded 1; the VLM's
patches and the enc-dec frames are ones), one prefill into a cache sized
for ``--decode-tokens`` more, then greedy decode. Prints the reference's
keys (``arch``, ``batch``, ``prompt_len``, ``prefill_s``,
``decode_tokens``, ``decode_tok_per_s``, ``sample_tokens``); both times
end in a device synchronize. The tokens come from a torch generator, so
``sample_tokens`` cannot equal the reference's.

``--model mipnerf`` (with ``--mode engine``) serves Mip-NeRF scenes
(``configs.mipnerf``: the published config with ``--full``, else its
tiny()) through the same engine: a ``core.mipnerf.PackedMipNerf`` resident
per scene (one network, its weights drawn like a NeRF scene's), the engine
building each view's cones (origin, direction with camera z = -1, radius),
K2's Mip-NeRF instance one launch a tile with ``--kernel --fuse-two-pass``
(else the plain path); ``--hosts`` > 1 puts the same residents behind the
cluster engine. It refuses ``--rmcm``, ``--ert``, ``--tiled``,
``--adaptive-sampling``, ``--degrade-on-overload``, ``--shard-weights``
and its routing flags: none of them is defined for the model here.

Flags: ``--kernel`` routes each pass through the fused kernel (K1,
two dispatches per render); ``--fuse-two-pass`` (with ``--kernel``) runs the
whole coarse -> importance -> fine chain as ONE kernel launch (K2);
``--rmcm`` serves 9-bit RMCM weights; ``--ert EPS`` lets rays whose
transmittance after the coarse pass is below EPS skip the fine pass;
``--full`` is the full ``NerfConfig()`` (else ``tiny()``); ``--device``
defaults to ``cuda``; ``--tiled`` (``--mode nerf``) renders through the
seed's per-tile loop (``core.plcore.render_image_tiled``: one render call
per ``--rays-per-batch`` tile, with ``--kernel`` K1 twice per tile and the
weights packed per call), and refuses ``--ert`` and ``--fuse-two-pass``.

    python -m repro_torch.launch.serve --mode nerf --full --kernel \\
        --fuse-two-pass --views 3
    python -m repro_torch.launch.serve --mode nerf --full --kernel \\
        --fuse-two-pass --ckpt runs/ckpt --theta 33 --phi -20 --focal 307.2
    python -m repro_torch.launch.serve --mode engine --full --kernel \\
        --fuse-two-pass --scenes 3 --requests 12 --hw-mix 64,128 \\
        --loop closed --pipeline-depth 2 --tile-rays 4096 --check
    python -m repro_torch.launch.serve --mode nerf --kernel --tiled
    python -m repro_torch.launch.serve --mode engine --full --kernel \\
        --fuse-two-pass --scenes 3 --requests 12 --hw-mix 64,128 \\
        --loop closed --pipeline-depth 2 --tile-rays 4096 --check \\
        --trace-out runs/engine_trace.json --metrics-out runs/engine.prom
    python -m repro_torch.launch.serve --mode engine --full --kernel \\
        --fuse-two-pass --scenes 3 --requests 12 --hw-mix 64,128 \\
        --loop closed --pipeline-depth 2 --tile-rays 4096 --hosts 2 \\
        --host-kill 1:@6 --check
    python -m repro_torch.launch.serve --mode engine --full --kernel \\
        --fuse-two-pass --adaptive-sampling --scene-bias -0.1 --scenes 3 \\
        --requests 12 --hw-mix 64,128 --loop closed --pipeline-depth 2 \\
        --tile-rays 4096 --check
    python -m repro_torch.launch.serve --mode engine --model mipnerf \
        --full --kernel --fuse-two-pass --scenes 3 --requests 12 \
        --hw-mix 64,128 --loop closed --pipeline-depth 2 --tile-rays 4096 \
        --check
    python -m repro_torch.launch.serve --mode lm --arch qwen2-1.5b --full
    python -m repro_torch.launch.serve --mode lm --arch mamba2-2.7b \\
        --device cpu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.configs import mipnerf as mip_configs
from repro_torch.configs.nerf_icarus import CONFIG as NERF_FULL, tiny as nerf_tiny
from repro_torch.core import mipnerf, rmcm
from repro_torch.core.pipeline import PackedPlcore
from repro_torch.core.plcore import plcore_decls, render_image_tiled
from repro_torch.data import rays as R
from repro_torch.kernels import ops as kops
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import init_params
from repro_torch.obs import (SpanTracer, device_busy, global_registry,
                             phase_share, prometheus_text,
                             validate_chrome_trace, validate_trace,
                             write_chrome_trace)


def write_ppm(path: str, img: torch.Tensor) -> None:
    """Dependency-free image writer (P6 PPM)."""
    arr = (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mip_guards(args) -> None:
    """The flags ``--model mipnerf`` refuses: each selects a feature that
    is not defined for Mip-NeRF here, and would otherwise render it with
    NeRF's maths or not at all."""
    if args.model != "mipnerf":
        return
    if args.mode != "engine":
        raise SystemExit("--model mipnerf serves through --mode engine")
    for flag, name in ((args.rmcm, "--rmcm"), (args.ert > 0.0, "--ert"),
                       (args.tiled, "--tiled"),
                       (args.adaptive_sampling, "--adaptive-sampling"),
                       (args.degrade_on_overload, "--degrade-on-overload"),
                       (args.shard_weights, "--shard-weights"),
                       (args.route_by_shard, "--route-by-shard"),
                       (args.percell_dispatch, "--percell-dispatch"),
                       (args.kernel != args.fuse_two_pass,
                        "--kernel without --fuse-two-pass (Mip-NeRF's kernel "
                        "route is K2's one launch)")):
            if flag:
                raise SystemExit(f"--model mipnerf is incompatible with "
                                 f"{name}")


def model_config(args):
    """The model's config for the flags: NeRF's, or Mip-NeRF's under
    ``--model mipnerf``."""
    if args.model == "mipnerf":
        mip_guards(args)
        return mip_configs.CONFIG if args.full else mip_configs.tiny()
    cfg = NERF_FULL if args.full else nerf_tiny()
    if args.ert > 0.0:
        if args.tiled:
            raise SystemExit("--ert requires the single-call pipeline; "
                             "drop --tiled")
        cfg = replace(cfg, ert_eps=args.ert)
    if args.fuse_two_pass and (args.tiled or not args.kernel):
        raise SystemExit("--fuse-two-pass runs the whole chain in one kernel; "
                         "it requires --kernel and the single-call pipeline "
                         "(drop --tiled)")
    return cfg


def budget_classes(args):
    """The adaptive budget classes of the flags (None: the config's
    default ladder), after the adaptive-sampling guards."""
    if not args.adaptive_sampling:
        return None
    if not (args.kernel and args.fuse_two_pass):
        raise SystemExit("--adaptive-sampling rides the fused two-pass "
                         "kernel's dead rows; it requires --kernel "
                         "--fuse-two-pass")
    for flag, name in ((args.degrade_on_overload, "--degrade-on-overload"),
                       (args.inject_faults, "--inject-faults"),
                       (args.hosts > 1, "--hosts > 1")):
        if flag:
            raise SystemExit(f"--adaptive-sampling is incompatible with "
                             f"{name}")
    if args.budget_classes == "auto":
        return None
    return tuple(int(b) for b in args.budget_classes.split(","))


def _shard_mesh_from_args(args):
    """``--shard-weights`` -> the cell list over the first
    ``--shard-devices`` visible cards (all by default), or over the CPU
    with ``--device cpu``; None without the flag."""
    if not args.shard_weights:
        return None
    from repro_torch.runtime import sharding as rsh
    if torch.device(args.device).type == "cpu":
        return rsh.plcore_mesh(args.shard_devices, devices=["cpu"])
    return rsh.plcore_mesh(args.shard_devices)


def sharding_guards(args) -> None:
    """The flag checks of weight sharding, routing and per-cell dispatch."""
    if args.route_by_shard and not args.shard_weights:
        raise SystemExit("--route-by-shard routes tiles by sharded-weight "
                         "ownership; it requires --shard-weights")
    if args.percell_dispatch and not args.route_by_shard:
        raise SystemExit("--percell-dispatch executes tiles on their "
                         "routed home cell; it requires --route-by-shard")
    if args.shard_weights and args.tiled:
        raise SystemExit("--shard-weights needs the single-call pipeline's "
                         "gathers; drop --tiled")
    if args.adaptive_sampling:
        for flag, name in ((args.shard_weights, "--shard-weights"),
                           (args.route_by_shard, "--route-by-shard"),
                           (args.percell_dispatch, "--percell-dispatch")):
            if flag:
                raise SystemExit(f"--adaptive-sampling is a replicated "
                                 f"single-cell feature — incompatible with "
                                 f"{name}")


class _Nvml:
    """The board's energy counter through NVML (``libnvidia-ml.so.1``,
    loaded with ctypes): ``energy_mj()`` is
    ``nvmlDeviceGetTotalEnergyConsumption``, a running total in
    millijoules, of the card behind a CUDA device (matched by PCI bus
    id)."""

    def __init__(self, device: torch.device):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._call("nvmlInit_v2")
        props = torch.cuda.get_device_properties(device)
        self.handle = ctypes.c_void_p()
        if hasattr(props, "pci_bus_id"):
            bus = (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
                   f"{props.pci_device_id:02x}.0").encode()
            self._call("nvmlDeviceGetHandleByPciBusId_v2",
                       ctypes.c_char_p(bus), ctypes.byref(self.handle))
        else:
            # an older PyTorch without the bus id: CUDA's device index
            index = (torch.cuda.current_device() if device.index is None
                     else device.index)
            self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                       ctypes.byref(self.handle))

    def _call(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"NVML {name} failed with code {rc}")

    def energy_mj(self) -> int:
        e = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(e))
        return int(e.value)


def load_plcore(cfg, args, seed: int, params: Optional[dict] = None,
                shard_mesh=None) -> PackedPlcore:
    """A PackedPlcore for the flags, with ``params`` or else weights drawn
    from a ``torch.Generator`` seeded ``seed``; its trunk sharded over
    ``shard_mesh`` when one is given. Under ``--model mipnerf`` a
    ``PackedMipNerf`` of one network drawn the same way."""
    if args.model == "mipnerf":
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = init_params(mipnerf.mip_decls(cfg), gen, "float32")
        if args.scene_bias:
            params["sigma"]["b"] = params["sigma"]["b"] + args.scene_bias
        return mipnerf.PackedMipNerf(cfg, params, use_kernel=args.kernel,
                                     device=args.device,
                                     shard_mesh=shard_mesh)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = init_params(plcore_decls(cfg), gen, "float32")
    if args.scene_bias:
        # negative values carve real empty space into the synthetic scene
        for net in params.values():
            net["sigma"]["b"] = net["sigma"]["b"] + args.scene_bias
    quant = None
    if args.rmcm:
        quant = {net: rmcm.quantize_tree(params[net])
                 for net in ("coarse", "fine")}
    # the tiled loop packs per render call, as the seed did: nothing to
    # pack at load
    return PackedPlcore(cfg, params, quant=quant,
                        use_kernel=args.kernel and not args.tiled,
                        fuse_two_pass=args.fuse_two_pass,
                        device=args.device, shard_mesh=shard_mesh)


def load_model(args, shard_mesh=None):
    """(cfg, PackedPlcore) for the flags: the ``params`` of the newest
    checkpoint in ``--ckpt``, else weights drawn from ``--seed``."""
    cfg = model_config(args)
    params = None
    if args.ckpt:
        state, _ = Checkpointer(args.ckpt).restore(device=args.device)
        params = state["params"]
    return cfg, load_plcore(cfg, args, args.seed, params, shard_mesh)


def serve_nerf(args) -> dict:
    sharding_guards(args)
    shard_mesh = _shard_mesh_from_args(args)
    cfg, engine = load_model(args, shard_mesh)
    packs_at_load = kops.pack_count()
    nvml = _Nvml(engine.device) if engine.device.type == "cuda" else None
    energy_mj = 0
    scene = R.SCENES[args.scene]()
    H = W = args.hw
    n_rays = H * W
    n_samples = n_rays * (cfg.n_coarse + cfg.n_coarse + cfg.n_fine)
    views = []
    for v in range(args.views):
        theta = args.theta + 360.0 * v / args.views
        ro, rd = R.camera_rays(
            R.pose_spherical(theta, args.phi, scene.radius), H, W,
            args.focal or 0.9 * W)
        _sync(engine.device)
        e0 = None if nvml is None else nvml.energy_mj()
        t0 = time.perf_counter()
        if args.tiled:
            img = render_image_tiled(
                cfg, engine.params, engine._rays(ro), engine._rays(rd),
                quant=engine.quant, use_kernel=args.kernel,
                rays_per_batch=args.rays_per_batch)
        else:
            img = engine.render_image(ro, rd,
                                      rays_per_batch=args.rays_per_batch)
        _sync(engine.device)
        dt = time.perf_counter() - t0
        if nvml is not None:
            energy_mj += nvml.energy_mj() - e0
        out = Path(args.out or "runs") / f"serve_nerf_{args.scene}_v{v}.ppm"
        out.parent.mkdir(parents=True, exist_ok=True)
        write_ppm(str(out), img)
        pixels = out.with_suffix(".npy")
        np.save(pixels, img.cpu().numpy())
        views.append({"image": str(out), "pixels": str(pixels),
                      "theta": theta, "wall_s": dt,
                      "rays_per_s": n_rays / dt,
                      "samples_per_s": n_samples / dt,
                      "finite": bool(torch.isfinite(img).all()),
                      "pixel_std": float(img.std())})
    stats = {
        "device": str(engine.device),
        "device_name": (torch.cuda.get_device_name(engine.device)
                        if engine.device.type == "cuda" else "cpu"),
        "config": "full" if args.full else "tiny",
        "ckpt": args.ckpt,
        "hw": H, "rays": n_rays, "samples": n_samples,
        "views": views,
        "rmcm": bool(args.rmcm), "kernel": bool(args.kernel),
        "pipeline": ("tiled" if args.tiled else
                     "two_pass_fused" if args.fuse_two_pass else
                     "two_dispatch" if args.kernel else "plain"),
        "ert_eps": cfg.ert_eps,
        "weight_packs_since_load": kops.pack_count() - packs_at_load,
        # the board's energy over the timed views per sample (the samples
        # counted as the reference counts them); None off the card
        "energy_j_measured": None if nvml is None else energy_mj / 1e3,
        "uj_per_sample_measured": (None if nvml is None else
                                   1e3 * energy_mj
                                   / (n_samples * len(views))),
    }
    if shard_mesh is not None:
        from repro_torch.runtime import sharding as rsh
        from repro_torch.serving.scene_cache import plcore_nbytes
        stats["shard_devices"] = len(shard_mesh)
        stats["weight_shards"] = rsh.plcore_shard_count(shard_mesh,
                                                        cfg.trunk_layers)
        stats["resident_mb_per_device"] = plcore_nbytes(engine) / (1 << 20)
    print(json.dumps(stats, indent=2))
    return stats


#: Pixel tolerance for a request that a tile's oracle rung touched: on
#: the card the two-dispatch chain (K1 twice, resample on the host) agrees
#: with K2 to the K1-vs-K2 tolerance, not bit for bit
ORACLE_ATOL = 1e-3


def parse_host_events(args) -> list:
    """``--host-kill HOST:AT`` / ``--host-slow HOST:AT`` -> HostEvents. AT
    is seconds from the engine's start, or ``@N`` for "when the engine's
    dispatch count reaches N" (clockless, deterministic)."""
    from repro_torch.serving import HostEvent

    def parse(spec: str, kind: str):
        host, sep, at = spec.partition(":")
        if not sep or not at:
            raise SystemExit(f"--host-{kind}: expected HOST:AT_S or "
                             f"HOST:@DISPATCHES, got {spec!r}")
        try:
            at_s = at_dispatch = None
            if at.startswith("@"):
                at_dispatch = int(at[1:])
            else:
                at_s = float(at)
            return HostEvent(kind, int(host), at_s=at_s,
                             at_dispatch=at_dispatch,
                             extra_s=args.host_slow_extra_ms / 1e3)
        except ValueError:
            raise SystemExit(f"--host-{kind}: expected HOST:AT_S or "
                             f"HOST:@DISPATCHES, got {spec!r}") from None

    events = ([parse(s, "kill") for s in args.host_kill]
              + [parse(s, "slow") for s in args.host_slow])
    if args.hosts < 1:
        raise SystemExit(f"--hosts must be >= 1, got {args.hosts}")
    if events and args.hosts < 2:
        raise SystemExit("--host-kill/--host-slow need --hosts >= 2 "
                         "(a single-host engine has no pool)")
    for e in events:
        if not 0 <= e.host < args.hosts:
            raise SystemExit(f"--host-{e.kind}: host {e.host} is not in "
                             f"the pool of {args.hosts}")
    return events


def run_engine(args, shard_mesh=None):
    """Serve the trace of ``--mode engine``: returns ``(report, engine,
    trace, rerun)``. Request ids follow the trace order. ``rerun(depth,
    adaptive=None, routed=None)`` serves the same trace again on a clean
    engine at ``depth`` (no fault plan, a fresh cache, not per-cell;
    ``routed`` defaults to ``--route-by-shard``) and returns that engine;
    the reruns are single-host. ``shard_mesh`` (a cell list) replaces the
    one of ``--shard-weights``, e.g. more cells than the machine has
    cards; under ``--hosts`` its cells are split into the hosts' groups."""
    from repro_torch.runtime import sharding as rsh
    from repro_torch.serving import (ClusterEngine, FaultConfig, FaultPlan,
                                     RenderEngine, SceneCache, loadgen,
                                     split_devices)

    sharding_guards(args)
    host_events = parse_host_events(args)
    cfg = model_config(args)
    classes = budget_classes(args)
    scene_ids = [f"scene{i}" for i in range(args.scenes)]
    if shard_mesh is None:
        shard_mesh = _shard_mesh_from_args(args)
    elif not args.shard_weights:
        raise SystemExit("a shard_mesh serves sharded residents; set "
                         "--shard-weights")

    dev = torch.device(args.device)
    # the hosts' device groups: the cells of the sharded residents split
    # into contiguous groups, each host's residents sharded over its own;
    # without sharding every host renders on --device
    device_groups, host_meshes = None, [shard_mesh] * args.hosts
    if args.hosts > 1:
        device_groups = split_devices(
            args.hosts, list(shard_mesh) if shard_mesh is not None
            else [dev] if dev.type != "cuda" else None)
        if shard_mesh is not None:
            host_meshes = [rsh.plcore_mesh(args.shard_devices, devices=g)
                           for g in device_groups]

    def make_loader(mesh):
        def load_scene(scene_id: str) -> PackedPlcore:
            # one synthetic model per scene id: a distinct weight draw
            # stands in for a distinct trained checkpoint
            return load_plcore(cfg, args,
                               args.seed + scene_ids.index(scene_id),
                               shard_mesh=mesh)
        return load_scene

    load_scene = make_loader(shard_mesh)
    plan = None
    if args.inject_faults:
        plan = FaultPlan(FaultConfig.cluster_chaos(args.fault_seed)
                         if args.hosts > 1
                         else FaultConfig.chaos(args.fault_seed))
    prior_s = (None if args.service_prior_ms is None
               else args.service_prior_ms / 1e3)
    # --trace-out traces the PRIMARY engine only: the reruns stay
    # untraced, so the span stream describes one run and the integrity
    # gate can hold every dispatched tile to a terminal scatter or drop
    tracer = (SpanTracer(sample_every=args.trace_sample)
              if args.trace_out else None)

    def make_engine(depth: int, chaos: bool,
                    adaptive: Optional[bool] = None,
                    routed: Optional[bool] = None,
                    percell: bool = False) -> RenderEngine:
        # reference reruns are clean: no fault plan (reusing this run's
        # plan would continue its streams, not replay them), a fresh
        # cache with the unwrapped loader, one host, and never per-cell:
        # the mesh-wide single-host engine is the anchor a multi-host or
        # per-cell run is held to
        def wrap(loader):
            return (plan.wrap_loader(loader) if chaos and plan is not None
                    else loader)
        if adaptive is None:
            adaptive = args.adaptive_sampling
        # the adaptive keywords only when armed: an adaptive-off engine is
        # built exactly as one that never heard of them
        kw = (dict(adaptive_sampling=True, budget_classes=classes,
                   memo_mb=args.memo_mb) if adaptive else {})
        if routed is None:
            routed = args.route_by_shard
        if routed:
            kw["route_by_shard"] = True
        if percell:
            kw["percell_dispatch"] = True
        kw.update(tile_rays=args.tile_rays, pipeline_depth=depth,
                  max_queue=args.max_queue,
                  degrade_on_overload=args.degrade_on_overload,
                  faults=plan if chaos else None,
                  tile_service_prior_s=prior_s,
                  tracer=tracer if chaos else None)
        if chaos and args.hosts > 1:
            caches = [SceneCache(wrap(make_loader(m)),
                                 capacity_mb=args.cache_mb)
                      for m in host_meshes]
            return ClusterEngine(caches, meshes=host_meshes,
                                 device_groups=device_groups, **kw)
        return RenderEngine(SceneCache(wrap(load_scene),
                                       capacity_mb=args.cache_mb), **kw)

    engine = make_engine(args.pipeline_depth, chaos=True,
                         percell=args.percell_dispatch)
    deadline_choices = ((None,) if args.deadline_ms is None
                        else (args.deadline_ms / 1e3,))
    trace = loadgen.poisson_trace(
        args.requests, scene_ids, rate_rps=args.rate,
        hw_choices=tuple(int(h) for h in args.hw_mix.split(",")),
        priorities=tuple(int(p) for p in args.priority_mix.split(",")),
        deadline_choices=deadline_choices, seed=args.seed)
    report = loadgen.run_trace(engine, trace, mode=args.loop,
                               concurrency=args.concurrency,
                               host_events=host_events or None)
    if tracer is not None:
        # a last drain closes the span chains of any slot still in flight
        engine.drain()
    observability = export_observability(args, engine, tracer)
    report = {"device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "model": args.model,
              "config": "full" if args.full else "tiny",
        "ckpt": args.ckpt,
              "scenes": args.scenes, "tile_rays": args.tile_rays,
              "kernel": bool(args.kernel),
              "fuse_two_pass": bool(args.fuse_two_pass),
              "rmcm": bool(args.rmcm), "ert_eps": args.ert,
              "pipeline_depth": args.pipeline_depth,
              "route_by_shard": bool(args.route_by_shard),
              "percell_dispatch": bool(args.percell_dispatch),
              "inject_faults": bool(args.inject_faults),
              "hosts": args.hosts,
              "host_events": [f"{e.kind}:{e.host}" for e in host_events],
              "deadline_ms": args.deadline_ms, **report}
    if shard_mesh is not None:
        report["shard_devices"] = len(shard_mesh)
        report["weight_shards"] = rsh.plcore_shard_count(shard_mesh,
                                                         cfg.trunk_layers)
    if args.percell_dispatch:
        report["percell"] = engine.percell_report()
    if args.adaptive_sampling:
        report["adaptive_sampling"] = True
        report["scene_bias"] = args.scene_bias
        report["sampling"] = engine.sampling_report()
    if observability:
        report["observability"] = observability

    def rerun(depth: int, adaptive: Optional[bool] = None,
              routed: Optional[bool] = None) -> RenderEngine:
        ref = make_engine(depth, chaos=False, adaptive=adaptive,
                          routed=routed)
        loadgen.run_trace(ref, trace, mode=args.loop,
                          concurrency=args.concurrency)
        return ref
    return report, engine, trace, rerun


def export_observability(args, engine, tracer) -> dict:
    """Write ``--trace-out`` (Chrome trace-event JSON of the primary
    engine's spans) and ``--metrics-out`` (Prometheus text of the engine's
    registry and the process-wide one); returns the report's
    ``observability`` block: the tracer's summary, the span-chain
    validator's verdict on the tracer (``integrity``) and on the written
    file (``chrome_integrity``), and the device busy share
    (``device_busy``: the union of the ``tile.kernel`` spans over the
    traced window; ``busy_share`` None on the CPU) and K2's cycles by
    phase (``plcore_two_pass_phase_share``, ``obs.export.phase_share``;
    None on the CPU)."""
    out = {}
    if tracer is not None:
        tpath = Path(args.trace_out)
        tpath.parent.mkdir(parents=True, exist_ok=True)
        write_chrome_trace(tracer, str(tpath))
        out.update(tracer.summary())
        out["integrity"] = validate_trace(tracer)
        out["chrome_integrity"] = validate_chrome_trace(
            json.loads(tpath.read_text()))
        out["device_busy"] = device_busy(tracer)
        out["plcore_two_pass_phase_share"] = phase_share(engine.stats)
        out["trace_out"] = str(tpath)
    if args.metrics_out:
        mpath = Path(args.metrics_out)
        mpath.parent.mkdir(parents=True, exist_ok=True)
        mpath.write_text(prometheus_text(engine.registry, global_registry()))
        out["metrics_out"] = str(mpath)
    return out


def check_trace(report: dict) -> None:
    """The trace-integrity gate of ``--check`` under ``--trace-out``: the
    trace recorded dispatched tiles, and the span-chain validator passes
    on the tracer and on the written file (every dispatched tile reached
    a terminal scatter or drop, every traced request one terminal)."""
    obs = report["observability"]
    for key in ("integrity", "chrome_integrity"):
        verdict = obs[key]
        if verdict["dispatched_tiles"] < 1:
            raise SystemExit(f"engine check: --trace-out armed but the "
                             f"trace ({key}) recorded no dispatched tiles")
        if not verdict["ok"]:
            raise SystemExit(f"engine check: trace integrity ({key}) "
                             "FAILED:\n  " + "\n  ".join(verdict["errors"]))


def compare_images(engine, ref, label: str) -> int:
    """Hold every request that ended ``ok`` in both runs: bit for bit, or
    within ``ORACLE_ATOL`` where the oracle rung rendered one of its tiles
    in either run. Returns the count compared; raises ``SystemExit`` on a
    difference or when nothing could be compared."""
    n_cmp = 0
    for rid, res in engine.completed.items():
        other = ref.completed.get(rid)
        if res.status != "ok" or other is None or other.status != "ok":
            continue
        n_cmp += 1
        if res.fallbacks or other.fallbacks:
            ok = np.allclose(res.image, other.image, rtol=0,
                             atol=ORACLE_ATOL)
        else:
            ok = np.array_equal(res.image, other.image)
        if not ok:
            raise SystemExit(f"engine check: image for request {rid} "
                             f"differs from the {label} reference render")
    if n_cmp == 0:
        raise SystemExit(f"engine check: no ok-status requests to compare "
                         f"against the {label} reference")
    return n_cmp


def check_engine(args, report: dict, engine, rerun) -> dict:
    """The ``--check`` gates: every request completes, the scene cache
    hits, coalescing issues no more dispatches than the per-request
    baseline (not counting the second dispatch of a tile a killed host
    abandoned, and not under ``--adaptive-sampling``, whose budget buckets
    split a request's rays over per-class tiles on purpose); under
    ``--inject-faults`` the plan injected something, goodput is at least
    0.75 and ok images equal a clean rerun's; at depth >= 2 (closed loop)
    two tiles were in flight at once and the images equal a depth-1
    rerun's. Under ``--adaptive-sampling`` (``check_adaptive``): a tile
    took the adaptive path, the memo served hits, every budget class
    rendered rays, and an adaptive-off rerun at this depth equals one at
    depth 1. With ``--shard-weights``, ``check_sharding``'s gates; with
    ``--host-kill``/``--host-slow``, ``check_cluster``'s. Returns the
    counts compared."""
    if report["requests_completed"] != args.requests:
        raise SystemExit(f"engine check: {report['requests_completed']}"
                         f"/{args.requests} requests completed")
    if report["cache"]["hit_rate"] <= 0.0:
        raise SystemExit("engine check: scene-cache hit rate is 0")
    # a tile a killed host abandoned is dispatched again on another host:
    # recovery work, not coalescing, so it leaves the comparison
    redone = report.get("cluster", {}).get("failovers", 0)
    if report["dispatch_savings"] + redone < 0 and not args.adaptive_sampling:
        raise SystemExit("engine check: coalescing issued MORE dispatches "
                         "than the per-request baseline")
    if args.trace_out:
        check_trace(report)
    compared = {}
    if args.inject_faults:
        rb = report["robustness"]
        if rb["faults_injected"]["total_injected"] < 1:
            raise SystemExit("engine check: --inject-faults armed but the "
                             "plan injected nothing")
        if rb["goodput"] is None or rb["goodput"] < 0.75:
            raise SystemExit(f"engine check: chaos goodput {rb['goodput']} "
                             f"< 0.75")
        compared["clean"] = compare_images(
            engine, rerun(args.pipeline_depth), "clean (no-fault)")
    if args.hosts > 1:
        compared.update(check_cluster(args, report, engine, rerun))
    if args.pipeline_depth > 1:
        # occupancy is deterministic only in the clockless closed loop
        if args.loop == "closed" and report["engine"]["max_in_flight"] < 2:
            raise SystemExit(f"engine check: pipeline_depth "
                             f"{args.pipeline_depth} never had 2 tiles in "
                             f"flight")
        compared["depth1"] = compare_images(engine, rerun(1),
                                            "synchronous depth=1")
    if args.adaptive_sampling:
        compared["adaptive_off"] = check_adaptive(args, report, rerun)
    if args.shard_weights:
        compared.update(check_sharding(args, report, engine, rerun))
    return compared


def check_cluster(args, report: dict, engine, rerun) -> dict:
    """The multi-host gates under scheduled host events: goodput is at
    least 0.75, every ok image equals a clean single-host rerun's (under
    ``--inject-faults`` ``check_engine`` has compared it already), an
    armed kill killed a host, and a kill at a dispatch count in the
    closed loop sent at least one tile across hosts. Returns the counts
    of images compared."""
    events = parse_host_events(args)
    if not events:
        return {}
    cl, rb = report["cluster"], report["robustness"]
    if rb["goodput"] is None or rb["goodput"] < 0.75:
        raise SystemExit(f"engine check: goodput {rb['goodput']} < 0.75 "
                         f"under host events")
    compared = {}
    if not args.inject_faults:
        compared["single_host"] = compare_images(
            engine, rerun(args.pipeline_depth), "clean single-host")
    kills = [e for e in events if e.kind == "kill"]
    if kills and cl["host_kills"] < 1:
        raise SystemExit("engine check: --host-kill armed but no host died")
    if (args.loop == "closed" and any(e.at_dispatch is not None
                                      for e in kills)
            and cl["cross_host_redispatches"] < 1):
        raise SystemExit("engine check: a host was killed mid-run but no "
                         "tile was redispatched across hosts "
                         "(cross_host_redispatches = 0): failover did not "
                         "engage")
    return compared


def check_sharding(args, report: dict, engine, rerun) -> dict:
    """The gates of weight sharding, routing and per-cell dispatch: the
    layer split engaged (more than one shard); with ``--route-by-shard``
    the images equal an unrouted rerun's and (closed loop) routing
    gathered fewer layers; with ``--percell-dispatch`` tiles ran on their
    cells, a (scene, cell) staging was counted, the images equal the
    mesh-wide routed engine's bit for bit, and (closed loop, two scenes or
    more on two cells or more) at least two cells held tiles in flight.
    Returns the counts of images compared."""
    if report["weight_shards"] <= 1:
        raise SystemExit(
            f"engine check: --shard-weights fell back to replicated "
            f"(weight_shards={report['weight_shards']} on "
            f"{report['shard_devices']} cells; the cell count must divide "
            f"the trunk layers)")
    deterministic = args.loop == "closed"
    compared = {}
    if args.route_by_shard:
        unrouted = rerun(args.pipeline_depth, routed=False)
        compared["unrouted"] = compare_images(engine, unrouted, "unrouted")
        routed_g = report["engine"]["plcore_gather_count"]
        unrouted_g = unrouted.stats["plcore_gather_count"]
        if args.percell_dispatch:
            # per-cell tiles gather nothing: hold the mesh-wide routed run
            spmd = rerun(args.pipeline_depth)
            compared["spmd"] = compare_images(engine, spmd,
                                              "mesh-wide routed")
            routed_g = spmd.stats["plcore_gather_count"]
        if deterministic and not routed_g < unrouted_g:
            raise SystemExit(f"engine check: --route-by-shard did not reduce "
                             f"plcore_gather_count (routed {routed_g} vs "
                             f"unrouted {unrouted_g})")
    if args.percell_dispatch:
        pc = report["percell"]
        if pc["percell_tiles"] < 1:
            raise SystemExit("engine check: --percell-dispatch armed but no "
                             "tile ran through a per-cell program")
        if pc["stage_events"] < 1:
            raise SystemExit("engine check: per-cell dispatch ran but no "
                             "(scene, cell) staging was accounted")
        if deterministic and args.scenes >= 2 and report["shard_devices"] >= 2:
            engaged = [c for c, v in pc["cells"].items()
                       if v["max_in_flight"] >= 1]
            if len(engaged) < 2:
                raise SystemExit(
                    f"engine check: --percell-dispatch with {args.scenes} "
                    f"scenes on {report['shard_devices']} cells engaged only "
                    f"cells {engaged} — no cross-cell concurrency")
    return compared


def check_adaptive(args, report: dict, rerun) -> int:
    """The adaptive gates: at least one adaptive tile, at least one memo
    hit, every budget class exercised by real rays (a scene that is not
    mixed starves classes; see ``--scene-bias``), and the same trace
    with adaptive sampling OFF at this depth equal to one at depth 1 bit
    for bit. Returns the count of images compared."""
    sp = report["sampling"]
    if sp["adaptive_tiles"] < 1:
        raise SystemExit("engine check: --adaptive-sampling armed but no "
                         "tile took the adaptive path")
    if sp["memo_hits"] < 1:
        raise SystemExit("engine check: adaptive sampling served zero "
                         "trunk-memo hits — memoization never engaged")
    exercised, n_classes = set(), 0
    for r in sp["scenes"].values():
        n_classes = max(n_classes, len(r["budgets"]))
        exercised |= {b for b, n in r["budget_rays"].items() if n > 0}
    if len(exercised) < n_classes:
        raise SystemExit(f"engine check: only budget classes "
                         f"{sorted(exercised, key=int)} of {n_classes} "
                         f"exercised — the calibration edges starve classes "
                         f"(is --scene-bias set for a mixed scene?)")
    return compare_images(rerun(args.pipeline_depth, adaptive=False),
                          rerun(1, adaptive=False),
                          "adaptive-off synchronous depth=1")


def serve_engine(args) -> dict:
    report, engine, _, rerun = run_engine(args)
    print(json.dumps(report, indent=2))
    if args.check:
        report["check_compared"] = check_engine(args, report, engine, rerun)
        print("engine check OK", json.dumps(report["check_compared"]))
    return report


def lm_session(args) -> dict:
    """What ``serve --mode lm`` serves: the config, the model, its weights
    on the device cast once (``serving_params``), the prompt batch and the
    cache capacity (prompt, the decode tokens and one more, plus the VLM's
    patch prefix: the reference's)."""
    dev = resolve_device(args.device, "serve --mode lm")
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    model = build_model(cfg)
    params = model.serving_params(init_params(
        model.param_decls(), torch.Generator(dev).manual_seed(args.seed),
        cfg.param_dtype))
    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), generator=torch.Generator(dev).manual_seed(1),
        device=dev, dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.ones((B, cfg.vlm.n_patches, cfg.d_model),
                                      device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.ones((B, cfg.encdec.enc_seq, cfg.d_model),
                                     device=dev)
    return {"cfg": cfg, "model": model, "params": params, "batch": batch,
            "capacity": S + args.decode_tokens + 1 + model.prefix_len(),
            "device": dev}


def next_token(logits):
    """Greedy pick of the last position: (B, 1) int32."""
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def serve_lm(args) -> dict:
    lm = lm_session(args)
    dev, params, cap = lm["device"], lm["params"], lm["capacity"]
    prefill = make_prefill_step(lm["model"])
    decode = make_decode_step(lm["model"])
    B, S = args.batch, args.prompt_len

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill(params, lm["batch"], cap)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = next_token(logits)
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(args.decode_tokens):
        cache, logits = decode(params, cache, tok, S + i)
        tok = next_token(logits)
        toks.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = {"arch": args.arch, "batch": B, "prompt_len": S,
           "prefill_s": t_prefill, "decode_tokens": args.decode_tokens,
           "decode_tok_per_s": args.decode_tokens * B / max(t_decode, 1e-9),
           "sample_tokens": torch.cat(toks, 1)[0, :8].tolist()}
    print(json.dumps(out, indent=2))
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["nerf", "engine", "lm"], default="nerf")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--model", choices=["nerf", "mipnerf"], default="nerf",
                    help="the render model of --mode engine")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="blobs", choices=sorted(R.SCENES))
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--theta", type=float, default=45.0)
    ap.add_argument("--phi", type=float, default=-25.0,
                    help="camera elevation in degrees (--mode nerf)")
    ap.add_argument("--focal", type=float, default=None,
                    help="focal length in pixels (default 0.9 * hw)")
    ap.add_argument("--ckpt", default=None,
                    help="serve the params of the newest checkpoint in "
                         "this directory (--mode nerf)")
    ap.add_argument("--views", type=int, default=1,
                    help="requests to serve, one camera pose each")
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--tiled", action="store_true",
                    help="the seed's per-tile loop instead of the "
                         "single-call pipeline (--mode nerf)")
    ap.add_argument("--rmcm", action="store_true")
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--ert", type=float, default=0.0,
                    help="early-ray-termination transmittance threshold")
    ap.add_argument("--fuse-two-pass", action="store_true",
                    help="with --kernel: the whole two-pass render in one "
                         "kernel launch")
    ap.add_argument("--out", default=None,
                    help="directory for the PPMs (default runs/)")
    ap.add_argument("--device", default="cuda")
    # --mode engine
    ap.add_argument("--scenes", type=int, default=3,
                    help="synthetic scenes behind the scene cache")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop Poisson arrival rate, requests/s")
    ap.add_argument("--tile-rays", type=int, default=512,
                    help="rays per coalesced tile (the dispatch shape)")
    ap.add_argument("--cache-mb", type=float, default=256.0,
                    help="scene-cache capacity in MB of resident tensors")
    ap.add_argument("--loop", choices=["open", "closed"], default="open")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="requests in flight in the closed loop")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="tiles in flight in the executor (1 = synchronous)")
    ap.add_argument("--hw-mix", default="16,32",
                    help="comma-separated request resolutions")
    ap.add_argument("--priority-mix", default="0",
                    help="comma-separated request priorities")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (SLO admission + expiry)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded request queue (admission rejects beyond)")
    ap.add_argument("--degrade-on-overload", action="store_true",
                    help="coarse-only rendering for low-priority requests "
                         "under backlog")
    ap.add_argument("--inject-faults", action="store_true",
                    help="arm the seeded chaos fault plan")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=1,
                    help="serve through the multi-host ClusterEngine: N "
                         "hosts (each its own scene cache and executor, "
                         "under --shard-weights over its own group of the "
                         "cells) behind one global scheduler with "
                         "heartbeats, cross-host failover and per-host "
                         "scene quarantine")
    ap.add_argument("--host-kill", action="append", default=[],
                    metavar="HOST:AT",
                    help="kill host HOST AT seconds after the start, or at "
                         "the engine's dispatch count N with HOST:@N; "
                         "repeatable; needs --hosts >= 2")
    ap.add_argument("--host-slow", action="append", default=[],
                    metavar="HOST:AT",
                    help="from AT (seconds, or @dispatches) every dispatch "
                         "on HOST pays --host-slow-extra-ms more latency; "
                         "repeatable; needs --hosts >= 2")
    ap.add_argument("--host-slow-extra-ms", type=float, default=50.0,
                    help="the added per-dispatch latency of --host-slow")
    ap.add_argument("--service-prior-ms", type=float, default=None,
                    help="per-tile service time assumed by admission "
                         "control before the first tile drains")
    ap.add_argument("--adaptive-sampling", action="store_true",
                    help="ASDR: per-scene density probe at scene load, "
                         "per-ray fine-sample budget classes (tiles "
                         "coalesce (scene, budget)-pure) and a trunk memo "
                         "whose empty resident rays enter K2 as dead rows "
                         "(requires --kernel --fuse-two-pass)")
    ap.add_argument("--budget-classes", default="auto", metavar="N,N,N",
                    help="ascending fine-sample budgets of the adaptive "
                         "classes (default 'auto': from the config's "
                         "n_fine, 8,32,64 for 128)")
    ap.add_argument("--memo-mb", type=float, default=32.0,
                    help="per-scene trunk-memo capacity in MB (LRU; counted "
                         "against --cache-mb)")
    ap.add_argument("--scene-bias", type=float, default=0.0,
                    help="shift every synthetic scene's sigma-head bias; "
                         "negative values carve empty space (a mixed scene "
                         "for the adaptive gates: -0.5 on the tiny config, "
                         "-0.1 at --full)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace the primary engine's request and tile "
                         "lifecycle and write it as Chrome trace-event "
                         "JSON (one process track per host, one thread "
                         "track per executor slot and, on the card, per "
                         "device); with --check, gate span-chain integrity")
    ap.add_argument("--trace-sample", type=int, default=1, metavar="N",
                    help="trace 1 in N request chains (tile and cache "
                         "records stay always on, so the integrity gate "
                         "covers every dispatched tile)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the engine's and the process-wide metrics "
                         "registries as Prometheus text after the run")
    ap.add_argument("--shard-weights", action="store_true",
                    help="shard every resident's packed trunk stacks "
                         "layer-wise over a cell list (the visible cards, "
                         "or the CPU with --device cpu); pixels unchanged, "
                         "about 1/n_shards of the trunk per cell")
    ap.add_argument("--shard-devices", type=int, default=None,
                    help="cap the cells of --shard-weights at this many "
                         "devices")
    ap.add_argument("--route-by-shard", action="store_true",
                    help="owner-map tile routing (with --shard-weights): "
                         "each scene's tiles go to a home cell owning the "
                         "most of its trunk layers (--mode engine)")
    ap.add_argument("--percell-dispatch", action="store_true",
                    help="per-cell tile execution (with --route-by-shard): "
                         "a routed tile renders on its home cell against "
                         "weights staged there once per (scene, cell), on "
                         "the cell's own stream, depth slots per cell")
    ap.add_argument("--check", action="store_true",
                    help="gate the engine run (see check_engine)")
    # lm
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=16)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return {"nerf": serve_nerf, "engine": serve_engine,
            "lm": serve_lm}[args.mode](args)


if __name__ == "__main__":
    main()
