"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):
1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all at once.
2. Hold K1 and K2 against their plain PyTorch versions at the full
   ``NerfConfig()`` width and the main path's shape: one 128x128 camera
   view (16384 rays) at the main path's ray tile, which must be above 1
   and leave a ragged last tile. K1 (``fused_plcore_call``) at N=64 and
   N=192, f32 and RMCM, with an alive mask; K2 (``two_pass_plcore_call``)
   f32, RMCM, ERT at 0.01 and at an eps where some rays terminate and
   some do not (the threshold midway between two neighbouring coarse acc
   values), and an alive mask. Tolerances: rgb/acc/weights 1e-3, depth
   1e-2, 5e-3 with RMCM, ERT or a mask. K1 at N=192 in f32 and K2 in f32
   and in RMCM, unmasked, are timed with CUDA events, their timed outputs
   checked, beside the least time the card could take: the larger of the
   bytes over 3.35 TB/s and the operations over the peak of the tensor
   cores that the route uses (3xTF32: three TF32 products; bf16x3: three
   bf16 products; SMs x 2048 or 4096 FLOP/clk x max SM clock), the exact
   heads at the fp32 peak (SMs x 128 FMA/clk x 2 x max SM clock); the
   fp32-core bound (every operation at the fp32 peak) is printed beside it.
3. K3 (``rmcm_matmul``) against its plain version at the NeRF trunk layer
   of one 512-ray tile's fine pass (131072 x 256 x 256), a decode-sized
   product at qwen2-1.5b's MLP width (16 x 1536 x 8960), the rows around
   its route switch at the trunk width (M = 63, 64, 65 x 256 x 256) and at
   the decode width (65 x 1536 x 8960), and a ragged (33 x 512 x 65), f32
   inputs at atol 2e-4 / rtol 1e-4 and bf16 inputs at atol 0.3 / rtol 0.05
   (the reference test's tolerances); each call is repeated and must give
   the same bits, and takes the route its M names. For f32 inputs the
   kernel's and the plain version's errors against a float64 product are
   printed, the kernel's at most twice the plain one's. The trunk, decode
   and trunk-width switch shapes are timed in f32 and bf16 (cycling through
   weight copies that exceed the L2 cache) beside their bounds and one
   ``torch.matmul`` on the dequantized weight in x's type (TF32 off; the
   dequantization is not counted in it); the trunk and decode shapes over
   three runs, the SM clock read after each. Then its entry point
   ``ops.rmcm_matmul`` with leading dims, counted alone.
4. The main path through the serve entry point: full config,
   ``--kernel --fuse-two-pass``, 3 views at 128x128, then one view with
   ``--rmcm --ert 0.01``. Launch counters are zeroed just before and read
   just after: K2 must have launched, no weights re-packed, images finite
   with pixel std > 0.
5. The oracle path: one view-sized tile through ``render_tile_oracle`` (K1
   twice, counters zeroed before and read after) against ``render_tile``
   at 1e-3.
6. The serving engine, ``serve --mode engine`` at full width (3 scenes, 12
   requests at 64x64 and 128x128, closed loop at concurrency 4, 4096-ray
   tiles, pipeline depth 2, ``--check``), clean and then with
   ``--inject-faults``. Counters are zeroed before each run and read after
   it: K2 launches must equal the dispatch attempts that did not raise and
   K1 launches twice the oracle fallbacks; the clean run has no retry and
   no fallback, and in the chaos run every dispatch error, corrupt tile
   and scene-load error traces back to an injected fault (straggler
   redispatches, timed on the host's clock, are reported). Each ok image
   equals a direct
   ``PackedPlcore.render_image`` of its pose bit for bit (within 1e-3
   where the oracle rung rendered one of its tiles).
7. K2 at each adaptive budget (Nf = 8, 32, 64 of ``default_budget_classes``
   at n_fine = 128): the 128x128 view at full width, f32 and RMCM, with an
   alive mask in which a third of the rays are dead, against the plain
   version at 5e-3 (1e-2 for depth), timed with CUDA events beside the
   bound of the work this mask leaves (every ray's coarse pass, the live
   rays' fine pass).
8. The adaptive view: ``AdaptiveRenderer.render_image`` of one 128x128
   view at full width, f32, scene bias -0.1 (``SCENE_BIAS``), 4096-ray
   tiles, the engine's
   probe (a 32^3 grid from 8x8-ray poses), rendered
   twice from fresh aux (equal bits, equal dead masks); every ray that did
   not render dead equals ``PackedPlcore.render_tile(..., budget=b)`` of
   the same rays without a mask bit for bit. Prints the dead-ray fraction,
   skipped fine samples, memo hits, host ms per tile and of
   classification, the PSNR against the static fused view of the adaptive
   view and of the unmasked budget renders, and both wall times.
9. The adaptive engine, ``serve --mode engine --adaptive-sampling
   --scene-bias -0.1 --check`` with step 6's trace: counters zeroed before
   the run and read after it; K2 launches equal the adaptive tiles that
   were not fully dead, K1 never launches; the check's gates (an adaptive
   tile, memo hits, every budget class, depth 2 = depth 1 and the
   adaptive-off rerun at depth 2 = depth 1, bit for bit). Then the trace
   again on the warm engines, adaptive off and on in turns (off, on, on,
   off), rays/s of each; the host time of the probes, of classification
   and per adaptive tile.

10. NeRF training with RMCM QAT at the full width (``train_phase``), the
   Fig. 8 protocol of ``benchmarks/fig8_rmcm_psnr.py``: the blob scene's
   dataset on the card (6 views at 64x64, focal 2.4 * hw), weights from
   ``torch.Generator().manual_seed(0)``, ``TRAIN_STEPS`` QAT steps on
   1024-ray batches (lr 5e-4, warmup 100, cosine decay; the plain path in
   f32 with TF32 off, autograd). Gates: finite losses and gradient norms;
   the mean training PSNR of the last 10 steps at least 3 dB above the
   first 10's; exact vs RMCM on the plain path at 256 dataset rays above
   20 dB; the ``Checkpointer`` save restored bit for bit; ``serve --mode
   nerf --full --kernel --fuse-two-pass --ckpt DIR`` of the 128x128
   hold-out view (counters zeroed before, read after: K2 launched, no
   weight re-packed) equal to ``PackedPlcore.render_image`` of the
   in-memory weights bit for bit; K2 on the trained weights in f32 and
   RMCM within step 2's tolerances of the plain version. Prints the train
   step's median ms (CUDA events, after 10 warm-up steps) beside its
   fp32-core bound (three forward passes of 1024 rays x 256 evaluations at
   the fp32 peak), samples/s, peak memory, the dataset, save and restore
   times, and the Fig. 8 rows at 128x128 on the hold-out view: exact vs
   RMCM, each (exact, RMCM, K2, adaptive) against ground truth, adaptive
   vs K2 and the adaptive PSNR drop beside the 0.1 dB gate (an
   ``AdaptiveRenderer`` on the trained scene with no scene bias, counters
   zeroed before, read after: K2 launches per budget), the first training
   view's exact PSNR, and the training PSNR.

11. K1 and K2 at the other built width pairs (``width_phase``, run after
   step 2): tiny() (64, 32) and the reference kernel tests' 5-layer (64,
   32) and 2-layer (32, 16) configs, and K2 with a coarse and a fine
   network of different formats at tiny() and at the full width, each
   against its plain version on one 128x128 view (1e-3 all-f32, 5e-3 with
   RMCM, ERT or a mask; depth 1e-2) and timed beside its bounds; one row
   per compiled instance in the kernels line.
12. tiny() through the serve entry point on the card (``tiny_serve_phase``,
   after step 4): ``serve --mode nerf --kernel --fuse-two-pass`` without
   ``--full``, 3 views and one ``--rmcm --ert 0.01`` view (K2 at tiny's
   widths, no weight re-packed, finite views with pixel std > 0, the
   first within 5e-3 of the plain render), then ``serve --tiled --kernel``
   (K1 twice per tile, within ``serve.ORACLE_ATOL`` of the fused view).
13. The traced engine (``traced_engine_phase``, after step 6): step 6's
   trace with ``--trace-out``/``--metrics-out`` under ``build/``; the
   check's trace-integrity gate (``validate_trace`` and
   ``validate_chrome_trace`` both ok), one ``tile.kernel`` span per K2
   launch, and the device busy share (their union over the traced
   window).
14. The reference's Fig. 8 protocol at tiny() (``fig8_tiny_phase``, before
   step 10): 6 views at 24x24, 250 QAT steps of 1024 rays at lr 5e-3
   (warmup 20), the hold-out rows (exact, RMCM, K2, adaptive) and the
   reference's gates (training gain >= 3 dB, exact vs RMCM > 20 dB,
   adaptive drop <= 0.1 dB), and the count of memo-dead rays.

15. The paper's SDF workload through K3 (``sdf_phase``, after step 3):
   the SDF at full width (widths 256 x 4, an rff_iso PEU of 128 features
   at sigma 2, K = 259) fitted to a sphere of radius 0.5 for 400 Adam
   steps (plain autograd), RMCM-quantized and packed once
   (``mlp.pack_quant``); then, counters zeroed just before and read just
   after, ``eval_grid`` at 128^3 in 65,536-point chunks, ``sphere_trace``
   of a 128x128 view at 64 steps and ``sdf_normal`` at the hits, every
   RMCM layer through K3. Held to the plain route (the unpacked tree):
   distances and t within 5e-3, hit masks equal except rays whose plain
   distance at their end point lies within a factor 4 of ``hit_eps``.
   Times per grid and per view of both routes; K3 per layer shape on the
   workload's activations beside its bound, its plain version and
   ``torch.matmul`` on the dequantized weight.
16. The SLF workload through K3 (``slf_phase``): ``make_slf_peu()``
   defaults (K = 262), widths (256, 256, 128), fitted to
   ``examples/torch_slf_render.py``'s ``surface_radiance`` for 400 steps,
   quantized and packed; one 128x128 view through K3 (counters zeroed
   before, read after) within 5e-3 of the plain route, PSNR of both on
   the sphere's pixels, the same timings.
17. The per-cell engine (``percell_engine_phase``, after step 13): step
   6's trace with every scene's trunk sharded over 8 cells on this card
   (``plcore_mesh(devices=["cuda:0"] * 8)``, one layer per cell),
   ``--route-by-shard --percell-dispatch``, traced; K2 once per dispatch
   on its home cell's stream; stagings equal to the owner table's remote
   layers; images equal the replicated engine's bit for bit; the check's
   sharding gates. On one card the staged "remote" layers are on-card
   copies, counted as the traffic of one device per cell.
18. Step 4's views also read the board's energy (NVML) over the timed
   views: ``uj_per_sample_measured`` must be measured (the RMCM + ERT
   run now serves 3 views).
19. The multi-host cluster (``cluster_phase``, after step 17, so every
   kernel is built before a heartbeat is watched): step 6's trace through
   ``serve --hosts 2`` at full width, K2, four runs, each printed as a
   ``cluster <label>:`` line. (a) ``kill``: ``--host-kill 1:@6``; K2's
   launches equal the dispatches plus the synchronous failovers, no retry,
   fallback or dispatch error, no heartbeat timeout, one kill, at least one
   cross-host redispatch, each ok image equal to a direct render and the
   check's cluster gates; rays/s beside the one-host engine and a two-host
   engine without a kill on the same trace (cold, then warm in turns).
   (b) ``chaos``: ``--inject-faults`` (the cluster chaos mix); every
   recovery traces back to an injected fault. (c) ``traced``: the kill
   with ``--trace-out``/``--metrics-out``; both validator verdicts ok,
   ``host.kill``, ``tile.requeue`` and ``tile.abandon`` among the spans,
   the four per-host families in the Prometheus text, the device busy
   share, and the kill's recovery cost (re-queued tiles, ms from the kill
   to the last of them scattering). (d) ``sharded``: two hosts over
   ``split_devices(2, [cuda:0] * 8)`` (4 cells each), routed and per-cell,
   host 1 killed at dispatch 6; images equal the replicated one-host
   engine's bit for bit, and the check's sharding gates.

20. LM serving (``lm_phase``, last): (a) every arch of
   ``configs.list_archs()`` at its ``smoke_config``: prefill of 2 x 17
   tokens and 4 teacher-forced decode steps on the card against the port
   on the CPU on the same weights (a CPU ``torch.Generator`` draw moved to
   the card; TF32 and reduced-precision bf16 reductions off): prefill
   logits within 1e-4, decode logits within 2e-3, one ``lm <arch>:`` line
   each; the MoE dispatch at capacity factor 0.5: the card's keep mask
   equals the CPU's. (c) qwen2-1.5b at full width and 2 layers: the bf16
   config's prefill logits against float32 on the same weights, the gap at
   most twice the reference's own (``LM_REF_BF16_GAP``, measured on the
   CPU by ``tests/lm_precision_gap.py``). (b) qwen2-1.5b at full width and
   depth through ``serve --mode lm --full`` at B 4 x S 64 and B 1 x S 2048
   (kernel counters zeroed before and read after: the LM path reaches no
   kernel, the reference's no Pallas call), then on one weight draw the
   warm prefill ms and decode ms per step (CUDA events), the host's
   enqueue ms per step, kernels and their device ms per decode step
   (``torch.profiler``), tok/s, peak memory, and the bounds: the bf16
   weights and KV bytes at 3.35 TB/s against the FLOPs at the bf16 peak.
21. LM training (``lm_train_phase``, after step 20): (a) every arch's
   smoke config, one train step's loss and gradients on the card against
   the port on the CPU on the same weights and driver batch (2 x 32): loss
   within rtol 1e-5, every gradient leaf within 1e-3 of the whole
   gradient's largest |g| (the worst leaf named), then the whole step
   (AdamW in the arch's moment type) on the card, one ``lm train <arch>:``
   line each. (c) ``train.run`` on the card for qwen2-1.5b's smoke config:
   restart 12 against 8 + 4 within rtol 1e-4; ``--grad-accum 2``,
   ``--qat``, ``--compress`` (a group of one) and kimi-k2's smoke config
   (int8 moments) at the reference tests' flags from one step-0
   checkpoint on the card and on the CPU, every loss finite and equal at
   rtol 1e-4, and each for 100 steps with the mean of its last 5 losses
   below its first 5 (``lm train driver:``). (b) qwen2-1.5b at full width
   and depth (remat on, bf16 compute, f32 masters and AdamW): 5 steps at
   B 4 x S 512 (finite, the fifth loss below the first) and 3 at S 4096
   (``SHAPES["train_4k"]`` with its batch of 256 cut to 1), each with the
   warm ms per step (CUDA events) and the host's enqueue ms, one profiled
   step (kernels, device ms, its share by kernel kind, the top kernels),
   one step timed in its halves (loss and gradients, AdamW), peak memory
   and the bound (``lm_train_bounds``); kernel counters zeroed before and
   read after (no launch: the path reaches no kernel); then remat off
   against on at B 4 x S 512: loss and gradients (the largest difference)
   and each one's peak memory above the resident state, remat's lower.

22. ``make_render_step`` (``render_step_phase``, after step 5) on
   ``make_host_mesh()`` (this card, nccl, world size 1) at the full width
   on one 128x128 view, weights from seed 0: the kernel route (two K1
   launches, counted as a main-path run) within 5e-3 of the plain route
   on the same mesh, the plain route equal to an unsharded
   ``render_rays`` bit for bit, ms per call of both (``render step:``).
23. K1 against the composed-core oracle ``kernels.ref.fused_render_ref``
   (``k1_ref_phase``): tiny() and the full width, f32 and RMCM, 4096 rays
   at n_coarse + n_fine samples, at 5e-3; the largest difference printed
   (``k1 vs fused_render_ref:``). A ray off by more is held to the oracle
   at its t moved by one ulp (the far-cap sample's sign is not determined
   at f32 precision there) and counted; the reference holds 1e-5 in
   interpret mode.
24. The dry run (``dryrun_phase``, first after the build): ``dryrun.lower_cell``
   for qwen2-1.5b at train_4k, prefill_32k and decode_32k on 16 x 16,
   moonshot-v1-16b-a3b at train_4k, both train_4k cells also with
   ``optimized=True`` (``--opt``: the models' mesh paths), and
   nerf-icarus render_800 on 16 x 16 and 2 x 16 x 16, one ``dryrun:``
   line each (dominant term, the three roofline terms modelled for a
   cluster of H100s, wall seconds); the card's allocated memory and the
   process group state unchanged; ``launch.mesh.PEAK_FLOPS_BF16`` within
   1% of this card's bf16 peak.
26. The models' mesh paths (``mesh_paths_phase``, right after step 24, before the
   phases whose leftovers hold card memory) on ranks
   that share this card: ``python chip_smoke.py --mesh-rank WHICH DIR``
   processes of a torchrun-style launch. NCCL is tried once on two ranks
   (it refuses two ranks on one device; the cause is printed); the ranks
   run gloo with CUDA tensors, every functional collective staged in the
   rank harness through c10d's synchronous call (the functional
   all-gather segfaults on the card machine's torch). (a) moonshot at
   full width and 4 layers on (1, 4): forward and backward through the
   expert-parallel path against the dense path on rank 0 (the same
   weights and batch), in f32 at the CPU tests' tolerances (loss 1e-3,
   every gradient leaf 1e-3 of the largest |g|, the first MoE layer's y
   1e-4) and in bf16 (loss within 1e-2 relative; ms per step of both
   paths, peak memory per rank). (b) ``train --model-axis 8 --backend
   gloo`` on 8 ranks, qwen2-1.5b at full width and 6 layers, B 8 x S
   512, three steps, the batch split taken on every rank, losses within
   1e-2 relative of ``--model-axis 1`` on the same seed and batches. (c)
   ``make_dp_compressed_train_step`` at n = 2 on this card against the
   same two ranks on the CPU: three steps' losses at rtol 1e-5, every
   residual after the first step equal within 1e-6 or a rounding tie.
   Times are those of ranks sharing one card, not scale-out times.
25. ``examples/torch_lm_train_e2e.py`` at its ~100M config
   (``lm_e2e_phase``, last) in its own process, ``--steps 1000``: a
   restart from step 600, the final loss below the stream's unigram
   entropy (``lm e2e:``, with the wall time). At the example's default
   300 steps the loss is still above it (the reference's own curve too).
27. K2's Mip-NeRF instance (``mip_phase``, after step 11): one 128x128
   view of cones (16384 rays) at the published ``MipNerfConfig`` and at
   its tiny(), against ``ref.mip_two_pass_ref`` (TF32 off) at rgb/acc
   1e-3, depth 1e-2, both timed beside the bound of one network's layers
   at both levels; the traced instance's bits equal the untraced, its
   phase shares and the encoding's share printed (``K2 mipnerf ...:``).
   Only this phase: ``import chip_smoke as cs; cs.build.build();
   cs.mip_phase(cs.peak_flops())`` from a script in ``build/``.
28. Mip-NeRF's main path (``mip_engine_phase``, after step 27): ``serve
   --mode engine --model mipnerf --full --kernel --fuse-two-pass`` on 6
   views of 64x64 and 128x128 over 3 scenes, clean and with
   ``--inject-faults``, launch counts zeroed just before each run and
   read just after: K2's Mip-NeRF instance runs once a dispatch attempt
   that did not raise and once an oracle rung (the model has no second
   kernel: the rung relaunches it), and no other kernel runs; every clean
   image equals a direct render of its view's cones bit for bit, and the
   ``--check`` gates hold. Its launches go into the ``kernels`` row of
   ``mip_two_pass_call``, with step 27's times and bound.

Every main-path run zeroes the launch counters just before and reads
them just after; the instances the main path runs (tiny()'s K2 in f32 and
RMCM and its K1, the full width's K2 in both) must each have launched.
Prints the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``. Exits nonzero with no
result when CUDA is absent or the repository's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_config  # noqa: E402
from repro_torch.configs.nerf_icarus import CONFIG, tiny  # noqa: E402
from repro_torch.configs import mipnerf as mip_configs  # noqa: E402
from repro_torch.core import mipnerf  # noqa: E402
from repro_torch.core import (encoding, mlp, nerf_train, plcore,  # noqa: E402
                              rmcm, sampling, sdf, slf)
from repro_torch.core.pipeline import (AdaptiveRenderer,  # noqa: E402
                                       PackedPlcore, build_scene_aux)
from repro_torch.core.plcore import plcore_decls  # noqa: E402
from repro_torch.data import rays  # noqa: E402
from repro_torch.kernels import build, fused_plcore, ops, ref  # noqa: E402
from repro_torch.kernels import rmcm_matmul as k3  # noqa: E402
from repro_torch.data.tokens import (TokenStreamConfig,  # noqa: E402
                                     synthetic_batch)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import (loss_and_grads,  # noqa: E402
                                      make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving import loadgen  # noqa: E402
from repro_torch.models.params import init_params, param_count  # noqa: E402
from repro_torch.optim.adam import (AdamConfig, adam_update,  # noqa: E402
                                    opt_state_decls, tree_leaves)
from repro_torch.runtime import sharding  # noqa: E402

sys.path.insert(0, str(ROOT / "examples"))
import torch_slf_render as slf_example  # noqa: E402

DEV = torch.device("cuda")
HW = 128
PLAIN_RT = 1024          # rays per tensor batch of the plain versions
# the mixed scene of the adaptive phases: every sigma-head bias shifted by
# -0.1. The reference's gates use -0.5 on the tiny config, where the
# initial raw sigma spreads several times wider; at full width -0.5
# leaves no density at all (every ray white and in the lowest class)
SCENE_BIAS = -0.1
ADAPTIVE_TILE = 4096     # rays per adaptive tile, the engine's tile
ADAPTIVE_AUX = {"grid_res": 32, "probe_hw": 8}   # the engine's probe
HBM_BYTES_PER_S = 3.35e12
HEADER = "src/repro_torch/kernels/csrc/mma_split.cuh"
SOURCE = {"fused_plcore_call":
              "src/repro_torch/kernels/csrc/plcore_kernels.cuh",
          "two_pass_plcore_call":
              "src/repro_torch/kernels/csrc/plcore_kernels.cuh",
           "rmcm_matmul": "src/repro_torch/kernels/csrc/rmcm_matmul.cu"}
REPLACES = {"fused_plcore_call": "src/repro/kernels/fused_plcore.py:239",
            "two_pass_plcore_call": "src/repro/kernels/fused_plcore.py:432",
            "rmcm_matmul": "src/repro/kernels/rmcm_matmul.py:58"}
# K3's shapes (M, K, N): the NeRF trunk layer at one 512-ray tile's fine
# pass (512 rays x 256 samples), a decode-sized product at qwen2-1.5b's MLP
# width (src/repro/configs/qwen2_1_5b.py: d_model 1536, d_ff 8960, 16
# rows), the rows on both sides of the route switch at the trunk width,
# and a ragged shape of the reference's kernel test
K3_SHAPES = {"nerf_trunk": (512 * 256, 256, 256),
             "qwen2_1_5b_mlp_decode": (16, 1536, 8960),
             "switch_m63": (63, 256, 256),
             "switch_m64": (64, 256, 256),
             "switch_m65": (65, 256, 256),
             "decode_width_m65": (65, 1536, 8960),
             "ragged": (33, 512, 65)}
K3_TIMED = ("nerf_trunk", "qwen2_1_5b_mlp_decode", "switch_m63",
            "switch_m64", "switch_m65")
K3_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (0.3, 0.05)}
# the f32 kernel's largest error against a float64 product may be at most
# this many times the plain f32 version's
K3_F64_RATIO = 2.0
# timed runs of the shapes whose margin to torch.matmul is the claim
K3_RUNS = 3
K3_CLAIMED = ("nerf_trunk", "qwen2_1_5b_mlp_decode")
L2_BYTES = 50 * 2 ** 20
# the training phase: the Fig. 8 protocol (benchmarks/fig8_rmcm_psnr.py)
# at full width. The blob scene's dataset, 6 views at 64x64 with focal
# 2.4 * hw; QAT on 1024-ray batches. The reference's lr 5e-3 (warmup 20)
# was tuned for tiny(); the full width trains at the original NeRF's
# 5e-4, warmed up over 100 steps, cosine-decayed to 0 at the last step
TRAIN_VIEWS, TRAIN_HW, TRAIN_RAYS = 6, 64, 1024
TRAIN_STEPS = 2000
TRAIN_LR, TRAIN_WARMUP = 5e-4, 100
TRAIN_TIMED_FROM = 10    # steps before this one are the warm-up
# steps after which the exact render of the hold-out view is scored
TRAIN_EVAL_AT = (100, 250, 500, 1000)
FIG8_HW = 128
FIG8_AUX = {"grid_res": 24, "probe_hw": 12, "memo_mb": 16.0}
PSNR_DROP_GATE_DB = 0.1
# the reference's own Fig. 8 protocol (benchmarks/fig8_rmcm_psnr.py) at
# tiny(): 250 QAT steps, 24x24 views; run from three weight draws
FIG8_TINY_STEPS, FIG8_TINY_HW = 250, 24
FIG8_TINY_SEEDS = (0, 1, 2)
# the paper's other workloads through K3: the SDF at the
# reference's default widths, an rff_iso PEU of 128 features (K = 259),
# fitted for a few hundred steps so the trace meets a surface; the SLF at
# make_slf_peu()'s defaults (K = 262) and the reference's widths
WORKLOAD_TOL = 5e-3
SDF_WIDTHS = (256, 256, 256, 256)
SDF_FIT_STEPS, SDF_FIT_POINTS = 400, 8192
SDF_GRID_RES, SDF_CHUNK = 128, 65536
SDF_VIEW_HW, SDF_TRACE_STEPS = 128, 64
SLF_WIDTHS = (256, 256, 128)
SLF_FIT_STEPS = 400
SLF_VIEW_HW = 128
# per-cell dispatch on this one card: 8 cells (one trunk layer each)
PERCELL_CELLS = 8
DEV_INDEXED = "cuda:0"


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    return float(smi("clocks.sm").split()[0])


def peak_flops() -> dict:
    """Dense FLOP/s of the card by operand type: SMs x (128 FP32 lanes x 2
    FLOP per FMA, 2048 TF32 or 4096 bf16 tensor-core FLOP per clock) x the
    max SM clock."""
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    return {"fp32": n_sm * 128 * 2 * hz, "tf32": n_sm * 2048 * hz,
            "bf16": n_sm * 4096 * hz}


def mma_macs_per_sample(cfg) -> int:
    """Multiply-adds of the layers on the tensor cores: trunk, feature
    head, the feature part of the color layer."""
    W, C, pe = cfg.trunk_width, cfg.color_width, cfg.pos_enc_dim
    trunk = pe * W + (cfg.trunk_layers - 1) * W * W + len(cfg.skip_at) * pe * W
    return trunk + W * W + W * C


def macs_per_sample(cfg) -> int:
    """All multiply-adds of a sample: the MMA layers and the exact sigma
    and rgb heads."""
    return mma_macs_per_sample(cfg) + cfg.trunk_width + 3 * cfg.color_width


def macs_per_ray_pass(cfg) -> int:
    return cfg.dir_enc_dim * cfg.color_width        # direction part of color0


def nbytes(*ts) -> int:
    total = 0
    for t in ts:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def bound_ms(op_seconds: float, n_bytes: int):
    """(ms, "operations" | "bytes"): the larger of the operations' time at
    their peaks and the bytes' time at the memory rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(op_seconds, t_bytes), ("operations"
                                            if op_seconds >= t_bytes
                                            else "bytes")


def plcore_op_seconds(cfg, rays: int, samples: int, passes: int,
                      quantized: bool, peaks: dict):
    """(tensor-core route, fp32 cores) seconds of ``rays`` x ``samples``
    network evaluations plus ``passes`` per-ray direction parts: the MMA
    layers three times (3xTF32 or bf16x3) at the route's tensor-core peak,
    the exact heads and the direction part at the fp32 peak; or all of it
    at the fp32 peak."""
    mma = 2.0 * rays * samples * mma_macs_per_sample(cfg)
    rest = 2.0 * rays * (samples * (macs_per_sample(cfg)
                                    - mma_macs_per_sample(cfg))
                         + passes * macs_per_ray_pass(cfg))
    tc = 3 * mma / peaks["bf16" if quantized else "tf32"] + rest / peaks["fp32"]
    return tc, (mma + rest) / peaks["fp32"]


def bounds_of(tc: float, fp32: float, n_bytes: int) -> dict:
    tc_ms, tc_by = bound_ms(tc, n_bytes)
    fp_ms, fp_by = bound_ms(fp32, n_bytes)
    return {"bound_ms": tc_ms, "bound_by": tc_by, "bound_ms_fp32": fp_ms,
            "bound_by_fp32": fp_by}


def plcore_bounds(cfg, rays: int, samples: int, passes: int, n_bytes: int,
                  quantized: bool, peaks: dict) -> dict:
    """Tensor-core and fp32-core bounds of ``rays`` x ``samples`` network
    evaluations plus ``passes`` per-ray direction parts, one weight
    format (``plcore_op_seconds``), against the bytes' time."""
    return bounds_of(*plcore_op_seconds(cfg, rays, samples, passes,
                                        quantized, peaks), n_bytes)


def k2_bounds(cfg, rays: int, qc: bool, qf: bool, n_bytes: int,
              peaks: dict) -> dict:
    """K2's bounds with every ray alive: the coarse pass (n_coarse samples)
    on the coarse network's route, the fine pass (n_coarse + n_fine) on
    the fine network's."""
    c = plcore_op_seconds(cfg, rays, cfg.n_coarse, 1, qc, peaks)
    f = plcore_op_seconds(cfg, rays, cfg.n_samples, 1, qf, peaks)
    return bounds_of(c[0] + f[0], c[1] + f[1], n_bytes)


def ert_eps_between(acc_c: torch.Tensor) -> float:
    """An ERT eps whose threshold lies midway between two neighbouring
    distinct coarse acc values below 1, the pair with the widest gap in
    the middle half of them: some rays terminate and others go on, and a
    last-ulp difference in one ray's acc cannot move it across."""
    below = torch.unique(acc_c[acc_c < 1.0]).double()
    n = below.numel()
    assert n >= 4, ("too few distinct coarse acc values", n)
    lo, hi = n // 4, max(n // 4 + 1, 3 * n // 4)
    gaps = below[lo + 1:hi + 1] - below[lo:hi]
    i = lo + int(torch.argmax(gaps))
    return 1.0 - float((below[i] + below[i + 1]) / 2)


def cuda_ms(fn, reps: int):
    """Mean ms of ``reps`` calls after one warm-up, and the last output."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def cuda_ms_cycled(fns, reps: int):
    """``cuda_ms`` over calls that cycle through ``fns`` (the same work on
    separate copies of the inputs), so that inputs smaller than the L2
    cache are read from device memory, as a caller with many such
    operands would find them."""
    calls = iter(range(reps + 1))
    ms, out = cuda_ms(lambda: fns[next(calls) % len(fns)](), reps)
    return ms, out, reps % len(fns)


def check(name: str, got, want, tols) -> float:
    torch.cuda.synchronize()
    errs = []
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape and bool(torch.isfinite(x).all()), (name, i)
        e = float((x - y).abs().max())
        assert e <= tols[i], f"{name}: output {i} off by {e} > {tols[i]}"
        errs.append(e)
    print(f"check {name}: max_abs_err per output {errs}", flush=True)
    return max(errs)


def packed_nets(cfg, params, quantized: bool) -> dict:
    out = {}
    for n in ("coarse", "fine"):
        q = rmcm.quantize_tree(params[n]) if quantized else None
        out[n] = bridge.to_device(ops.kernel_weights(cfg, params[n], q), DEV)
    return out


def view_rays(theta: float):
    ro, rd = rays.camera_rays(rays.pose_spherical(theta, -25.0, 4.0),
                              HW, HW, 0.9 * HW)
    return ro.reshape(-1, 3).to(DEV), rd.reshape(-1, 3).to(DEV)


def kernel_phase(cfg, params, peaks: dict) -> dict:
    """Each kernel against its plain version at the main path's shape: one
    128x128 view (16384 rays) at the main path's ray tile, so every block
    walks several rays and the last tile is ragged. The timed calls'
    outputs are checked too."""
    o, d = view_rays(45.0)
    R = o.shape[0]
    Nc, Nf = cfg.n_coarse, cfg.n_fine
    per_sm = fused_plcore.blocks_per_sm(cfg, "k2", (Nc, Nf), (0, 0), DEV)
    rt = ops.pick_ray_tile(R, DEV, per_sm)
    # K2's tile: even where it takes its rays in pairs
    rt2 = ops.pick_ray_tile(R, DEV, per_sm,
                            pairs=fused_plcore.k2_pairs(Nc, Nf))
    assert min(rt, rt2) > 1 and R % rt and R % rt2, (
        "no multi-ray ragged tiling", R, rt, rt2)
    alive = (torch.arange(R, device=DEV) % 3 != 0).to(torch.float32)
    rows = ops.sample_rows(cfg, DEV)
    nets = {q: packed_nets(cfg, params, q) for q in (False, True)}
    # the plain versions read the reference layout, without the stream
    plain_nets = {q: {n: {k: v for k, v in nets[q][n].items() if k != "mma"}
                      for n in nets[q]} for q in nets}
    errs, times = {}, {}

    def hold(name, label, kern, plain, tols, timed=None):
        """Run the kernel and its plain version on the same inputs, check
        the kernel's output; with ``timed`` (a key), time both and check
        the output of the last timed call."""
        if timed:
            ms, got = cuda_ms(kern, 3)
            plain_ms, want = cuda_ms(plain, 3)
            times[timed] = (ms, plain_ms)
        else:
            got, want = kern(), plain()
        errs[name] = max(errs.get(name, 0.0), check(label, got, want, tols))
        return want

    # ---- K1: coarse (N=64) and fine-shaped (N=192) sample sets ----------
    K1 = "fused_plcore_call"
    g = torch.Generator(device=DEV).manual_seed(1)
    Nt = Nc + Nf
    for quantized in (False, True):
        tol = 5e-3 if quantized else 1e-3
        for N in (Nc, Nt):
            t = sampling.stratified(cfg.near, cfg.far, N, (R,), g, device=DEV)
            dl = sampling.deltas_from_t(t)
            k1 = (cfg, nets[quantized]["fine"], o, d, t, dl)
            k1p = (cfg, plain_nets[quantized]["fine"], o, d, t, dl)
            masks = (None, alive) if (N == Nt and not quantized) else (alive,)
            for mask in masks:
                hold(K1, f"K1 N={N} rmcm={quantized} alive-mask="
                     f"{mask is not None}",
                     lambda: fused_plcore.fused_plcore_call(
                         *k1, rt=rt, alive=mask),
                     lambda: ref.fused_plcore_ref(*k1p, rt=PLAIN_RT,
                                                  alive=mask),
                     (tol, tol, tol), timed=K1 if mask is None else None)
                if mask is None:
                    k1_in = (o, d, t, dl, k1[1])

    # ---- K2: f32 and RMCM (both timed), ERT, alive mask --------------------
    K2 = "two_pass_plcore_call"

    def k2_hold(quantized, eps, mask=None, timed=None):
        k2 = (cfg, nets[quantized]["coarse"], nets[quantized]["fine"], o, d,
              *rows)
        plain = (cfg, plain_nets[quantized]["coarse"],
                 plain_nets[quantized]["fine"], o, d, *rows)
        tol = 5e-3 if (quantized or eps or mask is not None) else 1e-3
        return hold(K2, f"K2 rmcm={quantized} ert={eps} alive-mask="
                    f"{mask is not None}",
                    lambda: fused_plcore.two_pass_plcore_call(
                        *k2, rt=rt2, ert_eps=eps, alive=mask),
                    lambda: ref.two_pass_ref(*plain, rt=PLAIN_RT, ert_eps=eps,
                                             alive=mask),
                    (tol, tol, tol, tol, 1e-2), timed=timed)

    acc_c = k2_hold(False, 0.0, timed=K2)[3]
    k2_hold(True, 0.0, timed=K2 + ".rmcm")
    # ERT at the serve eps, then at a threshold between two coarse acc
    # values, where some rays terminate and others go on to their fine pass
    eps_mix = ert_eps_between(acc_c)
    for eps in (0.01, eps_mix):
        dead = int((acc_c >= ref.ert_threshold(eps)).sum())
        print(f"ERT eps {eps}: {dead} of {R} rays skip the fine pass",
              flush=True)
        k2_hold(False, eps)
    assert eps_mix > 0.0 and 0 < dead < R, ("no live/dead mix", eps_mix, dead)
    k2_hold(False, 0.0, alive)

    # the least time for the timed calls' work: every ray alive
    k1_bytes = nbytes(*k1_in) + 4 * R * (3 + Nt + 1)
    k2_bytes = {q: nbytes(o, d, rows, {n: {k: v for k, v in nets[q][n].items()
                                           if k != "mma"}
                                       for n in nets[q]}) + 4 * R * 9
                for q in (False, True)}
    bounds = {K1: plcore_bounds(cfg, R, Nt, 1, k1_bytes, False, peaks),
              K2: plcore_bounds(cfg, R, Nc + Nt, 2, k2_bytes[False], False,
                                peaks),
              K2 + ".rmcm": plcore_bounds(cfg, R, Nc + Nt, 2, k2_bytes[True],
                                          True, peaks)}
    print(f"checked and timed at {R} rays (one {HW}x{HW} view), ray tile "
          f"{rt}, K2's {rt2} (last tiles {R % rt} and {R % rt2} rays, "
          f"{per_sm} K2 block(s) per SM), K1 "
          f"timed at N={Nt}; peaks TFLOP/s "
          f"{ {k: round(v / 1e12, 2) for k, v in peaks.items()} }",
          flush=True)
    for k, (ms, plain_ms) in times.items():
        b = bounds[k]
        print(f"{k}: {ms:.3f} ms; tensor-core bound {b['bound_ms']:.3f} ms "
              f"({100 * b['bound_ms'] / ms:.1f}% of it, by {b['bound_by']}); "
              f"fp32-core bound {b['bound_ms_fp32']:.3f} ms; plain "
              f"{plain_ms:.3f} ms", flush=True)
    rows_out = {k: {"max_abs_err": errs[k], "ms": times[k][0],
                    "plain_ms": times[k][1], **bounds[k]} for k in (K1, K2)}
    rmcm_row = K2 + ".rmcm"
    rows_out[K2].update({
        "ms_rmcm": times[rmcm_row][0], "plain_ms_rmcm": times[rmcm_row][1],
        "bound_ms_rmcm": bounds[rmcm_row]["bound_ms"],
        "bound_ms_fp32_rmcm": bounds[rmcm_row]["bound_ms_fp32"]})
    return rows_out


def mip_phase(peaks: dict) -> dict:
    """K2's Mip-NeRF instance (``mip_two_pass_call``) against its plain
    version (``ref.mip_two_pass_ref``, TF32 off) on one 128x128 view of
    cones (16384 rays) at the main path's ray tile, at the published width
    and at tiny(): rgb/acc within 1e-3, depth 1e-2 (K2's f32 tolerances).
    Both timed with CUDA events beside the least time of the work (one
    network's layers at both levels: ``plcore_bounds`` with 2 x n_samples
    evaluations and two direction parts a ray); the traced instance gives
    the same bits, and its phase shares and the encoding's share."""
    from repro_torch.obs.metrics import K2_MIP_ROW_STATS
    out = {}
    o, d, r = rays.mip_view_rays(45.0, -25.0, 4.0, HW)
    cones = torch.from_numpy(np.concatenate([o, d, r], axis=1)).to(DEV)
    R = cones.shape[0]
    for label, cfg in (("full", mip_configs.CONFIG),
                       ("tiny", mip_configs.tiny())):
        params = init_params(mipnerf.mip_decls(cfg),
                             torch.Generator().manual_seed(4))
        pp = mipnerf.PackedMipNerf(cfg, params, use_kernel=True, device=DEV)
        rt = ops.pick_ray_tile(R, DEV, fused_plcore.mip_blocks_per_sm(cfg,
                                                                      DEV))
        t_row, u_row = ops.mip_sample_rows(cfg, DEV)
        plain_net = {k: v for k, v in pp.packed.items() if k != "mma"}
        args = (cfg, pp.packed, cones, t_row, u_row)
        ms, got = cuda_ms(lambda: fused_plcore.mip_two_pass_call(
            *args, rt=rt), 3)
        plain_ms, want = cuda_ms(lambda: ref.mip_two_pass_ref(
            cfg, plain_net, cones, t_row, u_row, rt=PLAIN_RT), 1)
        err = check(f"K2 mipnerf {label}", got, want,
                    (1e-3, 1e-3, 1e-3, 1e-3, 1e-2))
        phase = torch.zeros((R, len(K2_MIP_ROW_STATS)), dtype=torch.int64,
                            pin_memory=True)
        traced = fused_plcore.mip_two_pass_call(*args, rt=rt,
                                                phase_cycles=phase)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, traced)), label
        c = dict(zip(K2_MIP_ROW_STATS, phase.sum(0).tolist()))
        total = c["plcore_two_pass_cycles_total"]
        shares = {k.rsplit("_", 1)[-1] if "cycles" in k else k:
                  100.0 * v / total for k, v in c.items()
                  if "cycles" in k and not k.endswith("total")}
        assert c["plcore_two_pass_rows_real"] <= c["plcore_two_pass_rows_mma"]
        assert 0 < c["plcore_two_pass_cycles_encode"] \
            <= c["plcore_two_pass_cycles_scalar"], c
        n_bytes = nbytes(cones, t_row, u_row, plain_net) + 4 * R * 9
        b = plcore_bounds(cfg, R, 2 * cfg.n_samples, 2, n_bytes, False, peaks)
        print(f"K2 mipnerf {label}: {ms:.3f} ms at ray tile {rt}; "
              f"tensor-core bound {b['bound_ms']:.3f} ms ({100 * b['bound_ms'] / ms:.1f}% of it, "
              f"by {b['bound_by']}); plain {plain_ms:.3f} ms; phase shares "
              f"{ {k: round(v, 2) for k, v in shares.items()} }; row fill "
              f"{100 * c['plcore_two_pass_rows_real'] / c['plcore_two_pass_rows_mma']:.1f}%",
              flush=True)
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "ray_tile": rt, "phase_pct": shares, **b}
    return out


MIP_ENGINE_ARGV = ["--mode", "engine", "--model", "mipnerf", "--full",
                   "--kernel", "--fuse-two-pass", "--scenes", "3",
                   "--requests", "6", "--hw-mix", "64,128", "--loop",
                   "closed", "--concurrency", "2", "--pipeline-depth", "2",
                   "--tile-rays", "4096", "--check"]


def mip_engine_phase(extra: list) -> dict:
    """Mip-NeRF's main path through ``serve --mode engine --model
    mipnerf`` (its run, then its ``--check`` gates), launch counts zeroed
    just before the run and read just after it: K2's Mip-NeRF instance
    once a dispatch attempt that did not raise and once an oracle rung, no
    NeRF kernel; every clean image equal bit for bit to a direct render of
    its view's cones (``PackedMipNerf.render_tile``, one launch a view)."""
    args = serve.build_parser().parse_args(MIP_ENGINE_ARGV + extra)
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args)
    launches = read_launches()
    st, rb = report["engine"], report["robustness"]
    assert report["device"].startswith("cuda"), report["device"]
    label = "chaos" if args.inject_faults else "clean"
    if not args.inject_faults:
        assert (rb["dispatch_errors"], rb["tile_retries"],
                rb["oracle_fallbacks"]) == (0, 0, 0), rb
    mip = launches.get("mip_two_pass_call", 0)
    assert mip == (st["dispatches"] + st["tile_retries"]
                   - st["dispatch_errors"] + st["oracle_fallbacks"]), (
        launches, st)
    assert mip >= 1 and launches["two_pass_plcore_call"] == 0 and \
        launches["fused_plcore_call"] == 0, launches
    n_exact = 0
    models = {}
    for rid, item in enumerate(trace):
        res = engine.completed[rid]
        if res.status != "ok" or res.fallbacks or res.retries:
            continue
        req = item.request
        if req.scene_id not in models:
            models[req.scene_id] = serve.load_plcore(
                serve.model_config(args), args,
                args.seed + int(req.scene_id.removeprefix("scene")))
        cones = rays.mip_view_rays(req.theta, req.phi, req.radius, req.hw)
        direct = models[req.scene_id].render_tile(*cones).cpu().numpy()
        assert np.array_equal(res.image.reshape(-1, 3), direct), (
            rid, float(np.abs(res.image.reshape(-1, 3) - direct).max()))
        n_exact += 1
    assert n_exact >= 1, (n_exact, rb)
    compared = serve.check_engine(args, report, engine, rerun)
    summary = {"run": label, "rays_per_s": report["rays_per_s"],
               "dispatches": st["dispatches"],
               "tile_retries": rb["tile_retries"],
               "dispatch_errors": rb["dispatch_errors"],
               "oracle_fallbacks": rb["oracle_fallbacks"],
               "status_counts": rb["status_counts"],
               "launches": launches, "images_exact_vs_direct": n_exact,
               "check_compared": compared}
    print(f"mipnerf engine {label}: {json.dumps(summary)}", flush=True)
    return summary


def k3_weights(k: int, n: int, gen, copies: int = 1) -> list:
    """``copies`` RMCM-packed (k, n) weights drawn on the card."""
    return [rmcm.pack(rmcm.quantize(torch.randn(k, n, generator=gen,
                                                device=DEV)))
            for _ in range(copies)]


def k3_bytes(x, packed, y) -> int:
    """Bytes K3 must move: x, 1.125 B per weight, the scales and y."""
    return nbytes(x, packed["mag"], packed["sign_bits"], packed["scale"], y)


def k3_f64(x, packed) -> torch.Tensor:
    """K3's function in float64: (x @ signed magnitudes) * scale."""
    K = packed["k"]
    sg = rmcm.unpack_signs(packed["sign_bits"],
                           packed["sign_bits"].shape[0] * 8)[:K]
    w = packed["mag"].double() * (1.0 - 2.0 * sg.double())
    return (x.double() @ w) * packed["scale"].double().reshape(1, -1)


def k3_phase(peaks: dict) -> dict:
    """K3 against its plain version on the card at ``K3_SHAPES``, f32 and
    bf16 inputs at the reference test's tolerances, each call repeated for
    identical bits and counted by route; for f32 inputs both are also held
    against a float64 product, the kernel's error at most ``K3_F64_RATIO``
    times the plain version's. The timed shapes beside their bounds and one
    PyTorch matmul on the dequantized weight, ``K3_CLAIMED`` over
    ``K3_RUNS`` runs with the SM clock read after each. Then the entry
    point a user calls, ``ops.rmcm_matmul`` with leading dims, counts
    zeroed just before and read just after."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    errs, shapes = {torch.float32: [], torch.bfloat16: []}, {}
    f64_errs = {}
    for label, (M, K, N) in K3_SHAPES.items():
        timed = label in K3_TIMED
        # enough weight copies that one cycle of calls moves twice the L2
        io_bytes = 4 * (M * K + M * N)
        copies = (-(-2 * L2_BYTES // (K * N + (-(-K // 8)) * N + io_bytes))
                  if timed else 1)
        packs = k3_weights(K, N, gen, copies)
        x32 = torch.randn(M, K, generator=gen, device=DEV)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            atol, rtol = K3_TOL[dt]
            before = dict(k3.ROUTE_LAUNCHES)
            got = k3.rmcm_matmul(x, packs[0])
            again = k3.rmcm_matmul(x, packs[0])
            want = ref.rmcm_matmul_ref(x, packs[0])
            torch.cuda.synchronize()
            route = k3.route(M)
            assert k3.ROUTE_LAUNCHES[route] == before[route] + 2, (
                label, route, k3.ROUTE_LAUNCHES)
            assert got.dtype == dt and got.shape == (M, N), (got.dtype,
                                                             got.shape)
            assert bool(torch.isfinite(got).all()), label
            assert torch.equal(got, again), f"K3 {label} {dt}: not repeatable"
            e = float((got.float() - want.float()).abs().max())
            witness = ""
            if dt == torch.float32:
                exact = k3_f64(x, packs[0])
                e_k = float((got.double() - exact).abs().max())
                e_p = float((want.double() - exact).abs().max())
                witness = (f"; against float64: kernel {e_k}, plain {e_p} "
                           f"(ratio {e_k / max(e_p, 1e-30):.3f})")
                f64_errs[label] = {"kernel": e_k, "plain": e_p}
                assert e_k <= K3_F64_RATIO * e_p, (
                    f"K3 {label}: the split route's error {e_k} exceeds "
                    f"{K3_F64_RATIO} x the plain f32 version's {e_p}")
            print(f"check K3 {label} {tuple((M, K, N))} {dt} route {route}: "
                  f"max_abs_err {e} (atol {atol}, rtol {rtol}){witness}, two "
                  "calls bit-identical", flush=True)
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
            errs[dt].append(e)
            if not timed:
                continue
            runs = K3_RUNS if label in K3_CLAIMED else 1
            ms_runs, lib_runs, clocks = [], [], []
            dense_bytes = K * N * x.element_size() + io_bytes
            dense = [rmcm.dequantize(rmcm.unpack(p), dt)
                     for p in packs[:-(-2 * L2_BYTES // dense_bytes)]]
            for _ in range(runs):
                ms, got, last = cuda_ms_cycled(
                    [lambda p=p: k3.rmcm_matmul(x, p) for p in packs], 20)
                torch.testing.assert_close(
                    got.float(), ref.rmcm_matmul_ref(x, packs[last]).float(),
                    atol=atol, rtol=rtol)
                lib_ms, _, _ = cuda_ms_cycled(
                    [lambda w=w: torch.matmul(x, w) for w in dense], 20)
                ms_runs.append(ms)
                lib_runs.append(lib_ms)
                clocks.append(sm_clock_mhz())
            del dense
            plain_ms, _, _ = cuda_ms_cycled(
                [lambda p=p: ref.rmcm_matmul_ref(x, p) for p in packs], 5)
            ms, lib_ms = float(np.median(ms_runs)), float(np.median(lib_runs))
            flops = 2.0 * M * K * N
            n_bytes = k3_bytes(x, packs[0], got)
            passes = 3 if dt == torch.float32 else 1     # bf16x3 or exact
            b_ms, b_by = bound_ms(passes * flops / peaks["bf16"], n_bytes)
            f_ms, f_by = bound_ms(flops / peaks["fp32"], n_bytes)
            shapes[f"{label}.{str(dt).removeprefix('torch.')}"] = {
                "shape_mkn": [M, K, N], "route": route, "ms": ms,
                "ms_runs": ms_runs, "library_ms_runs": lib_runs,
                "sm_clock_mhz_runs": clocks,
                "below_library_every_run": all(
                    a < b for a, b in zip(ms_runs, lib_runs)),
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_ms_fp32": f_ms,
                "bound_by_fp32": f_by, "weight_copies": len(packs)}
            print(f"K3 {label} {dt}: {ms:.4f} ms (runs {ms_runs}, SM clock "
                  f"{clocks} MHz), route {route} (tensor-core bound "
                  f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of it; "
                  f"fp32-core bound {f_ms:.4f} ms by {f_by}; plain "
                  f"{plain_ms:.4f} ms; torch.matmul on the dequantized "
                  f"weight, dequantization not counted, {lib_ms:.4f} ms, "
                  f"runs {lib_runs})", flush=True)
    # the entry point with leading dims, counted on its own
    M, K, N = K3_SHAPES["qwen2_1_5b_mlp_decode"]
    packed = k3_weights(K, N, gen)[0]
    x = torch.randn(2, M // 2, K, generator=gen, device=DEV)
    zero_launches()
    y = ops.rmcm_matmul(x, packed, bm=8, bn=8, bk=8)
    torch.cuda.synchronize()
    launches = k3.LAUNCHES["rmcm_matmul"]
    assert launches == 1 and k3.ROUTE_LAUNCHES["small_m"] == 1, (
        launches, k3.ROUTE_LAUNCHES)
    assert y.shape == (2, M // 2, N), y.shape
    torch.testing.assert_close(
        y, ref.rmcm_matmul_ref(x.reshape(M, K), packed).reshape(y.shape),
        atol=2e-4, rtol=1e-4)
    row = shapes["nerf_trunk.float32"]
    vs_library = {k: {"ms": v["ms"], "library_ms": v["library_ms"],
                      "below_library_every_run": v["below_library_every_run"]}
                  for k, v in shapes.items()
                  if k.split(".")[0] in K3_CLAIMED}
    return {"max_abs_err": max(errs[torch.float32]),
            "max_abs_err_bf16": max(errs[torch.bfloat16]), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_ms_fp32": row["bound_ms_fp32"],
            "library_ms": row["library_ms"],
            "library_call": "torch.matmul(x, W_dequantized) in x's type, "
                            "TF32 off, dequantization not counted",
            "timed_shape": "nerf_trunk.float32", "vs_library": vs_library,
            "f64_err": f64_errs, "shapes": shapes,
            "launches": launches}


def serve_phase(out_dir: str, extra: list, views: int) -> dict:
    """Main path through the serve entry point; launch counts zeroed just
    before and read just after. The board energy per sample over the
    timed views (``uj_per_sample_measured``, NVML) must be measured."""
    zero_launches()
    stats = serve.main(["--mode", "nerf", "--full", "--kernel",
                        "--fuse-two-pass", "--views", str(views), "--hw",
                        str(HW), "--out", out_dir, *extra])
    launches = read_launches()
    assert stats["device"].startswith("cuda"), stats["device"]
    assert stats["weight_packs_since_load"] == 0, stats
    assert launches["two_pass_plcore_call"] >= views, launches
    uj = stats["uj_per_sample_measured"]
    assert uj is not None and uj > 0, ("no measured energy", stats)
    for v in stats["views"]:
        assert v["finite"] and v["pixel_std"] > 0, v
    print(f"main path {extra or ['f32']}: launches {launches}, per-view "
          f"wall_s {[v['wall_s'] for v in stats['views']]}, "
          f"uj_per_sample_measured {uj} ({stats['energy_j_measured']} J over "
          f"{views} views of {stats['samples']} samples; "
          f"{smi('name,power.limit')})", flush=True)
    return {"launches": launches, "uj_per_sample_measured": uj,
            "energy_j_measured": stats["energy_j_measured"],
            "wall_s": [v["wall_s"] for v in stats["views"]]}


ENGINE_ARGV = ["--mode", "engine", "--full", "--kernel", "--fuse-two-pass",
               "--scenes", "3", "--requests", "12", "--hw-mix", "64,128",
               "--loop", "closed", "--concurrency", "4",
               "--pipeline-depth", "2", "--tile-rays", "4096", "--check"]


def zero_launches() -> None:
    for counts in (fused_plcore.LAUNCHES, k3.LAUNCHES, k3.ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0
    fused_plcore.K2_LAUNCHES_BY_NF.clear()
    fused_plcore.INSTANCE_LAUNCHES.clear()
    k3.SHAPE_LAUNCHES.clear()


def read_launches() -> dict:
    return {**fused_plcore.LAUNCHES, **k3.LAUNCHES,
            "k2_by_nf": dict(fused_plcore.K2_LAUNCHES_BY_NF),
            "instances": dict(fused_plcore.INSTANCE_LAUNCHES),
            "k3_by_shape": dict(k3.SHAPE_LAUNCHES)}


def direct_images(args, engine, trace, rb) -> tuple:
    """Hold every ok image of an engine run against a direct
    ``PackedPlcore.render_image`` of its pose (replicated, one host): bit
    for bit, or within ``serve.ORACLE_ATOL`` where the oracle rung
    rendered one of its tiles. Returns ``(n_exact, n_close)``."""
    n_exact = n_close = 0
    direct_models = {}
    for rid, item in enumerate(trace):
        res = engine.completed[rid]
        if res.status != "ok":
            continue
        req = item.request
        ro, rd = rays.camera_rays(
            rays.pose_spherical(req.theta, req.phi, req.radius), req.hw,
            req.hw, 0.9 * req.hw)
        if req.scene_id not in direct_models:
            direct_models[req.scene_id] = serve.load_plcore(
                serve.model_config(args), args,
                args.seed + int(req.scene_id.removeprefix("scene")))
        direct = direct_models[req.scene_id].render_image(
            ro, rd, rays_per_batch=args.tile_rays).cpu().numpy()
        if res.fallbacks:
            assert np.allclose(res.image, direct, rtol=0,
                               atol=serve.ORACLE_ATOL), rid
            n_close += 1
        else:
            assert np.array_equal(res.image, direct), (
                rid, float(np.abs(res.image - direct).max()))
            n_exact += 1
    assert n_exact >= 1 and n_exact + n_close == \
        rb["status_counts"].get("ok", 0), (n_exact, n_close, rb)
    return n_exact, n_close


def engine_phase(extra: list) -> dict:
    """The serving engine through ``serve --mode engine`` (its run, then
    its ``--check`` gates): launch counts zeroed just before the run and
    read just after it, before the check's reruns. Every launch must be
    accounted for by the engine's own counters, so the retry ladder cannot
    hide a broken kernel; every request's image is held against a direct
    ``PackedPlcore.render_image`` of its pose."""
    args = serve.build_parser().parse_args(ENGINE_ARGV + extra)
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args)
    launches = read_launches()
    st, rb = report["engine"], report["robustness"]
    assert report["device"].startswith("cuda"), report["device"]
    label = "chaos" if args.inject_faults else "clean"
    if args.inject_faults:
        inj = rb["faults_injected"]["injected"]
        # every recovery that a raised dispatch, a non-finite tile or a
        # failed load set off traces back to an injected fault; straggler
        # redispatches are timed on the host's clock and only reported
        assert rb["dispatch_errors"] == inj["dispatch_error"], (rb, inj)
        assert rb["corrupt_tiles"] <= inj["corrupt"], (rb, inj)
        assert rb["scene_load_errors"] == inj["loader_error"], (rb, inj)
    else:
        assert (rb["dispatch_errors"], rb["tile_retries"],
                rb["oracle_fallbacks"]) == (0, 0, 0), rb
    # K2 runs once per dispatch attempt that did not raise; the oracle
    # rung runs K1 twice
    assert launches["two_pass_plcore_call"] == (
        st["dispatches"] + st["tile_retries"] - st["dispatch_errors"]), (
        launches, st)
    assert launches["fused_plcore_call"] == 2 * st["oracle_fallbacks"], (
        launches, st)
    assert launches["two_pass_plcore_call"] >= 1, launches
    n_exact, n_close = direct_images(args, engine, trace, rb)
    compared = serve.check_engine(args, report, engine, rerun)
    extra_summary = {}
    if not args.inject_faults:
        # the same trace at depth 1 (synchronous), timed the same way
        t0 = time.perf_counter()
        sync = rerun(1)
        wall = time.perf_counter() - t0
        extra_summary = {"depth1_wall_s": wall, "depth1_rays_per_s":
                         sync.stats["rays_rendered"] / wall}
    summary = {
        "run": label, "rays_per_s": report["rays_per_s"],
        "req_per_s": report["req_per_s"], "wall_s": report["wall_s"],
        "latency_ms": report["latency_ms"],
        "queueing_ms": report["queueing_ms"],
        "service_ms": report["service_ms"],
        "max_in_flight": st["max_in_flight"],
        "dispatches": st["dispatches"],
        "dispatch_baseline": st["dispatch_baseline"],
        "padded_rays": st["padded_rays"], "goodput": rb["goodput"],
        "status_counts": rb["status_counts"],
        "tile_retries": rb["tile_retries"],
        "oracle_fallbacks": rb["oracle_fallbacks"],
        "straggler_redispatches": rb["straggler_redispatches"],
        "cache_hit_rate": report["cache"]["hit_rate"],
        "launches": launches, "images_exact_vs_direct": n_exact,
        "images_within_oracle_atol": n_close, "check_compared": compared,
        **extra_summary}
    if args.inject_faults:
        summary["faults_injected"] = rb["faults_injected"]["injected"]
    print(f"engine {label}: {json.dumps(summary)}", flush=True)
    return summary


def budget_phase(cfg, params, peaks: dict) -> dict:
    """K2 at each adaptive budget on one 128x128 view, f32 and RMCM, with
    a third of the rays dead: checked against the plain version and timed
    beside the bound of the work the mask leaves."""
    o, d = view_rays(45.0)
    R, Nc = o.shape[0], cfg.n_coarse
    alive = (torch.arange(R, device=DEV) % 3 != 0).to(torch.float32)
    n_alive = int(alive.sum())
    nets = {q: packed_nets(cfg, params, q) for q in (False, True)}
    plain_nets = {q: {n: {k: v for k, v in nets[q][n].items() if k != "mma"}
                      for n in nets[q]} for q in nets}
    out = {}
    for Nf in sampling.default_budget_classes(cfg.n_fine):
        cfg_b = dataclasses.replace(cfg, n_fine=Nf)
        rows = ops.sample_rows(cfg_b, DEV)
        row = {"n_fine": Nf, "alive_rays": n_alive, "rays": R}
        for q in (False, True):
            per_sm = fused_plcore.blocks_per_sm(cfg_b, "k2", (Nc, Nf),
                                                (q, q), DEV)
            rt = ops.pick_ray_tile(R, DEV, per_sm,
                                   pairs=fused_plcore.k2_pairs(Nc, Nf))
            k2 = (cfg_b, nets[q]["coarse"], nets[q]["fine"], o, d, *rows)
            plain = (cfg_b, plain_nets[q]["coarse"], plain_nets[q]["fine"],
                     o, d, *rows)
            ms, got = cuda_ms(lambda: fused_plcore.two_pass_plcore_call(
                *k2, rt=rt, ert_eps=0.0, alive=alive), 3)
            plain_ms, want = cuda_ms(lambda: ref.two_pass_ref(
                *plain, rt=PLAIN_RT, ert_eps=0.0, alive=alive), 3)
            err = check(f"K2 Nf={Nf} rmcm={q} alive {n_alive}/{R}", got,
                        want, (5e-3, 5e-3, 5e-3, 5e-3, 1e-2))
            n_bytes = nbytes(o, d, rows, alive, plain_nets[q]) + 4 * R * 9
            # every ray's coarse pass, the live rays' fine pass
            b = plcore_bounds(cfg_b, 1, R * Nc + n_alive * (Nc + Nf),
                              R + n_alive, n_bytes, q, peaks)
            sfx = "_rmcm" if q else ""
            row.update({f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": b["bound_ms"],
                        f"bound_by{sfx}": b["bound_by"],
                        f"bound_ms_fp32{sfx}": b["bound_ms_fp32"],
                        f"ray_tile{sfx}": rt})
            print(f"K2 Nf={Nf} rmcm={q}: {ms:.3f} ms (ray tile {rt}); "
                  f"tensor-core bound {b['bound_ms']:.3f} ms "
                  f"({100 * b['bound_ms'] / ms:.1f}% of it, by "
                  f"{b['bound_by']}); plain {plain_ms:.3f} ms", flush=True)
        out[Nf] = row
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")


def biased_model(cfg, params) -> PackedPlcore:
    """The f32 fused model with every sigma-head bias shifted by
    ``SCENE_BIAS`` (serve's ``--scene-bias``)."""
    biased = {n: {**p, "sigma": {**p["sigma"],
                                 "b": p["sigma"]["b"] + SCENE_BIAS}}
              for n, p in params.items()}
    return PackedPlcore(cfg, biased, use_kernel=True, fuse_two_pass=True,
                        device=DEV)


def adaptive_view_phase(cfg, params) -> dict:
    """``AdaptiveRenderer.render_image`` of one 128x128 view at full
    width, twice from fresh aux: equal bits, and every ray that did not
    render dead equal to the unmasked render of its budget. Launch counts
    zeroed just before the first render and read just after it."""
    pp = biased_model(cfg, params)
    o, d = view_rays(45.0)
    o_h, d_h = o.cpu().numpy(), d.cpu().numpy()
    runs = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = build_scene_aux(pp, **ADAPTIVE_AUX)
        aux_s = time.perf_counter() - t0
        ar = AdaptiveRenderer(pp, aux)
        if i == 0:
            zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, dead = ar.render_image(o_h, d_h, rays_per_tile=ADAPTIVE_TILE,
                                    with_dead=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i == 0:
            launches = read_launches()
        runs.append((img, dead, wall, aux_s, ar.report()))
    (img, dead, wall, aux_s, rep), (img2, dead2, wall2, _, rep2) = runs
    assert np.isfinite(img).all() and img.shape == (HW * HW, 3)
    assert np.array_equal(img, img2) and np.array_equal(dead, dead2), \
        "adaptive view does not repeat bit for bit from fresh aux"
    assert launches["two_pass_plcore_call"] == \
        rep["tiles"] - rep["full_dead_tiles"], (launches, rep)
    assert launches["fused_plcore_call"] == 0, launches
    # every ray unmasked at its class's budget: the live rays must equal
    # it bit for bit; the dead rays show what the memo rebuild changes
    cls = ar.classify_rays(o_h, d_h)
    budget_img = np.empty_like(img)
    for c, b in enumerate(ar.budgets):
        idx = np.nonzero(cls == c)[0]
        if idx.size:
            budget_img[idx] = pp.render_tile(o[idx], d[idx],
                                             budget=b).cpu().numpy()
    n_live = int((~dead).sum())
    assert np.array_equal(img[~dead], budget_img[~dead]), float(
        np.abs(img[~dead] - budget_img[~dead]).max())
    assert 0 < n_live < o.shape[0], ("no live/dead mix", n_live)
    static_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        static = pp.render_image(o.reshape(HW, HW, 3), d.reshape(HW, HW, 3))
        torch.cuda.synchronize()
        static_walls.append(time.perf_counter() - t0)
    static = static.reshape(-1, 3).cpu().numpy()
    summary = {
        "wall_s": wall, "wall_s_second_run": wall2,
        "static_wall_s": static_walls, "aux_build_s": aux_s,
        "psnr_vs_static_db": psnr(img, static),
        "psnr_budgets_only_vs_static_db": psnr(budget_img, static),
        "max_abs_diff_vs_static": float(np.abs(img - static).max()),
        "dead_rays_max_abs_diff_vs_budget_render": float(
            np.abs(img[dead] - budget_img[dead]).max()),
        "classify_ms": rep["classify_ms"],
        "pixel_std": float(img.std()),
        "dead_ray_fraction": rep["dead_ray_fraction"],
        "skipped_fine_samples": rep["skipped_fine_samples"],
        "memo_hits": rep["memo"]["hits"], "tiles": rep["tiles"],
        "full_dead_tiles": rep["full_dead_tiles"],
        "budget_rays": rep["budget_rays"],
        "host_ms_per_tile": rep["host_ms_per_tile"],
        "live_rays_exact_vs_budget_render": n_live, "launches": launches}
    print(f"adaptive view: {json.dumps(summary)}", flush=True)
    return summary


def adaptive_engine_phase() -> dict:
    """``serve --mode engine --adaptive-sampling --scene-bias
    SCENE_BIAS`` on the trace of the engine phase: counts zeroed just
    before the run and read just after it (K2 once per adaptive tile that
    was not fully dead, no K1), then the check's gates."""
    args = serve.build_parser().parse_args(
        ENGINE_ARGV + ["--adaptive-sampling", "--scene-bias",
                       str(SCENE_BIAS)])
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args)
    launches = read_launches()
    st, rb, sp = report["engine"], report["robustness"], report["sampling"]
    assert report["device"].startswith("cuda"), report["device"]
    assert (rb["dispatch_errors"], rb["tile_retries"],
            rb["oracle_fallbacks"]) == (0, 0, 0), rb
    assert st["dispatches"] == sp["adaptive_tiles"], (st, sp)
    assert launches["two_pass_plcore_call"] == \
        sp["adaptive_tiles"] - sp["full_dead_tiles"] >= 1, (launches, sp)
    assert launches["fused_plcore_call"] == 0, launches
    assert sum(launches["k2_by_nf"].values()) == \
        launches["two_pass_plcore_call"], launches
    compared = serve.check_engine(args, report, engine, rerun)
    # the trace again on warm engines (weights packed, probes done, memo
    # filled), adaptive off and on in turns: rays/s of each run
    off = rerun(args.pipeline_depth, adaptive=False)
    warm = {"static": [], "adaptive": []}
    for label, eng in (("static", off), ("adaptive", engine),
                       ("adaptive", engine), ("static", off)):
        rays0 = eng.stats["rays_rendered"]
        t0 = time.perf_counter()
        loadgen.run_trace(eng, trace, mode=args.loop,
                          concurrency=args.concurrency)
        warm[label].append((eng.stats["rays_rendered"] - rays0)
                           / (time.perf_counter() - t0))
    scenes = sp["scenes"].values()
    tiles = sum(r["tiles"] for r in scenes)
    host_ms = sum(r["host_ms_per_tile"] * r["tiles"] for r in scenes
                  if r["tiles"]) / max(tiles, 1)
    summary = {
        "rays_per_s": report["rays_per_s"], "req_per_s": report["req_per_s"],
        "wall_s": report["wall_s"], "latency_ms": report["latency_ms"],
        "queueing_ms": report["queueing_ms"],
        "service_ms": report["service_ms"],
        "max_in_flight": st["max_in_flight"], "dispatches": st["dispatches"],
        "dispatch_baseline": st["dispatch_baseline"],
        "padded_rays": st["padded_rays"],
        "host_ms_per_adaptive_tile": host_ms,
        "classify_ms": sum(r["classify_ms"] for r in scenes),
        "probe_s": sp["probe_s"], "warm_rays_per_s": warm,
        "launches": launches,
        "check_compared": compared,
        "sampling": {k: v for k, v in sp.items() if k != "scenes"},
        "budget_rays": {sid: r["budget_rays"]
                        for sid, r in sp["scenes"].items()},
        "budget_tiles": {sid: r["budget_tiles"]
                         for sid, r in sp["scenes"].items()}}
    print(f"engine adaptive: {json.dumps(summary)}", flush=True)
    return summary


def oracle_phase(cfg, params) -> int:
    model = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                         device=DEV)
    o, d = view_rays(120.0)
    fused = model.render_tile(o, d)
    zero_launches()
    oracle = model.render_tile_oracle(o, d)
    torch.cuda.synchronize()
    launches = fused_plcore.LAUNCHES["fused_plcore_call"]
    assert launches == 2, fused_plcore.LAUNCHES
    e = check("oracle (K1 twice) vs fused tile", (oracle,), (fused,), (1e-3,))
    print(f"oracle path: K1 launches {launches}, max_abs_err {e}", flush=True)
    return launches


def render_step_phase(cfg, params) -> dict:
    """``make_render_step`` on ``make_host_mesh()`` (one card, nccl, world
    size 1) at the full width on one 128x128 view (16384 rays): the
    kernel route (the two-dispatch chain, two K1 launches, counters zeroed
    just before and read just after) against the plain route on the same
    mesh at 5e-3, the plain route against an unsharded ``render_rays``
    bit for bit, and ms per call of both."""
    from repro_torch.launch.mesh import make_host_mesh

    p = bridge.to_device(params, DEV)
    o, d = view_rays(75.0)
    rules = sharding.Rules()
    with make_host_mesh() as mesh:
        plain_step = plcore.make_render_step(cfg, mesh, rules)
        kern_step = plcore.make_render_step(cfg, mesh, rules, use_kernel=True)
        plain = plain_step(p, o, d).to_local()
        zero_launches()
        kern = kern_step(p, o, d).to_local()
        torch.cuda.synchronize()
        launches = read_launches()
        assert launches["fused_plcore_call"] == 2, launches
        assert launches["two_pass_plcore_call"] == 0, launches
        err = check("render step: K1 route vs plain route", (kern,), (plain,),
                    (5e-3,))
        unsharded = plcore.render_rays(cfg, p, o, d)["rgb"]
        assert torch.equal(plain, unsharded)
        ms_plain, _ = cuda_ms(lambda: plain_step(p, o, d), 3)
        ms_kern, _ = cuda_ms(lambda: kern_step(p, o, d), 3)
    assert not dist.is_initialized()
    row = {"rays": int(o.shape[0]), "mesh": [1, 1], "backend": "nccl",
           "k1_launches": launches["fused_plcore_call"],
           "max_abs_err_vs_plain": err, "plain_equals_unsharded": True,
           "ms_kernel_route": ms_kern, "ms_plain_route": ms_plain}
    print(f"render step: {json.dumps(row)}", flush=True)
    return {"launches": launches, "row": row}


def _ray_errs(got: tuple, want: tuple) -> torch.Tensor:
    """Per-ray largest |got - want| over K1's outputs (rgb, weights, acc)."""
    return torch.stack([(x - y).abs().reshape(x.shape[0], -1).amax(-1)
                        for x, y in zip(got, want)]).amax(0)


def k1_ref_phase() -> dict:
    """K1 through ``ops.fused_render`` against the composed-core oracle
    ``kernels.ref.fused_render_ref`` (PEU, NeRF MLP, scan VRU) at tiny()
    and at the full width, f32 and RMCM, on 4096 rays at the config's
    n_coarse + n_fine samples (the reference kernel test's draw: origins
    0.1 x normal, unit directions, sorted t in [2, 6)), every output held
    at 5e-3. The largest difference is printed. A ray off by more is held
    to the oracle evaluated with its t moved by one ulp down or up (deltas
    recomputed): the last sample's delta is the far cap (1e10), so where
    its pre-ReLU sigma lies within the rounding of the sample point of
    zero, its sign, and so the ray's colour, is not determined at f32
    precision. Such rays are counted and printed; one that matches
    neither neighbour fails. The reference holds its kernel at 1e-5 in
    interpret mode."""
    rows = {}
    R, tol = 4096, 5e-3
    for label, c in (("tiny", tiny()), ("full", CONFIG)):
        g = torch.Generator().manual_seed(11)
        p = bridge.to_device(init_params(plcore_decls(c), g)["fine"], DEV)
        o = (0.1 * torch.randn(R, 3, generator=g)).to(DEV)
        d = torch.randn(R, 3, generator=g)
        d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(DEV)
        N = c.n_coarse + c.n_fine
        t = (torch.sort(torch.rand(R, N, generator=g), dim=-1).values * 4
             + 2).to(DEV)
        dl = sampling.deltas_from_t(t)
        for quant in (False, True):
            q = rmcm.quantize_tree(p) if quant else None
            rgb_k, aux_k = ops.fused_render(c, p, o, d, t, dl, quant=q)
            got = (rgb_k, aux_k["weights"], aux_k["acc"])
            assert all(bool(torch.isfinite(x).all()) for x in got)
            rgb_r, aux_r = ref.fused_render_ref(c, p, o, d, t, dl, quant=q)
            errs = _ray_errs(got, (rgb_r, aux_r["weights"], aux_r["acc"]))
            off = (errs > tol).nonzero().flatten().tolist()
            held = {}
            for r in off:
                sl = slice(r, r + 1)
                best = float("inf")
                for toward in (-math.inf, math.inf):
                    tm = torch.nextafter(t[sl], torch.full_like(t[sl], toward))
                    rr, ar = ref.fused_render_ref(
                        c, p, o[sl], d[sl], tm, sampling.deltas_from_t(tm),
                        quant=q)
                    e = float(_ray_errs(tuple(x[sl] for x in got),
                                        (rr, ar["weights"], ar["acc"]))[0])
                    best = min(best, e)
                assert best <= tol, (label, quant, r, float(errs[r]), best)
                held[r] = {"err": float(errs[r]), "err_at_one_ulp": best}
            name = f"{label}_{'rmcm' if quant else 'f32'}"
            rest = errs[errs <= tol]
            rows[name] = {"rays": R, "samples": N,
                          "max_abs_err": float(errs.max()),
                          "max_abs_err_within_tol_rays":
                              float(rest.max()) if rest.numel() else None,
                          "rays_held_at_one_ulp_of_t": held,
                          "above_1e-5": float(errs.max()) > 1e-5}
            print(f"check k1 vs fused_render_ref {name}: max_abs_err "
                  f"{float(errs.max())}, {len(off)} ray(s) held at one ulp "
                  f"of t", flush=True)
    print(f"k1 vs fused_render_ref: {json.dumps(rows)}", flush=True)
    return rows


def width_configs() -> dict:
    """The width pairs K1 and K2 are built for beside the full config:
    ``tiny()`` (64, 32), the config of ``serve`` without ``--full``, and
    the reference's kernel-test sweep (``tests/test_kernels.py:103-115``),
    a 5-layer (64, 32) and a 2-layer (32, 16) network, at their depths,
    skips, encodings and sample counts."""
    return {"tiny": tiny(),
            "sweep5": dataclasses.replace(
                CONFIG, trunk_layers=5, trunk_width=64, skip_at=(2, 4),
                color_width=32, pos_freqs=6, dir_freqs=3, n_coarse=16,
                n_fine=16),
            "sweep2": dataclasses.replace(
                CONFIG, trunk_layers=2, trunk_width=32, skip_at=(1,),
                color_width=16, pos_freqs=4, dir_freqs=2, n_coarse=8,
                n_fine=8)}


def width_phase(peaks: dict) -> dict:
    """K1 and K2 at every built width pair below the full one and K2 with
    a coarse and a fine network of different formats, against their plain
    versions on one 128x128 view at the main path's ray tile: K2 in each
    format pair (f32 and RMCM at every config; the two mixed pairs at
    tiny() and at the full width), with ERT at an eps where some rays
    terminate and an alive mask for the f32 and mixed pairs, and K1 at
    N = n_coarse + n_fine in f32 and RMCM. Tolerances: 1e-3 for K1 in
    f32; 5e-3 with RMCM, ERT or a mask, depth 1e-2; K2 with both networks
    f32: the coarse outputs 1e-3 against the f32 plain version, the fine
    outputs against the plain version in float64 within 1e-3 (depth 1e-2)
    or twice the f32 plain version's own error, the larger. The
    unmasked calls are timed beside their tensor-core and fp32-core
    bounds. Returns rows keyed by compiled instance (``instance_name``),
    each timed at the first config that ran it, the others under
    ``also_checked``."""
    o, d = view_rays(45.0)
    R = o.shape[0]
    alive = (torch.arange(R, device=DEV) % 3 != 0).to(torch.float32)
    rows: dict = {}
    cases = [(label, cfg, ((False, False), (True, True)
                           ) + (((False, True), (True, False))
                                if label == "tiny" else ()))
             for label, cfg in width_configs().items()]
    cases.append(("full", CONFIG, ((False, True), (True, False))))
    for label, cfg, formats in cases:
        params = init_params(plcore_decls(cfg),
                             torch.Generator().manual_seed(0))
        nets = {q: packed_nets(cfg, params, q) for q in (False, True)}
        plain_nets = {q: {n: {k: v for k, v in nets[q][n].items()
                              if k != "mma"} for n in nets[q]}
                      for q in nets}
        grids = ops.sample_rows(cfg, DEV)
        Nc, Nt = cfg.n_coarse, cfg.n_samples
        for qc, qf in formats:
            per_sm = fused_plcore.blocks_per_sm(cfg, "k2", (Nc, cfg.n_fine),
                                                (qc, qf), DEV)
            rt = ops.pick_ray_tile(R, DEV, per_sm, pairs=fused_plcore.k2_pairs(
                Nc, cfg.n_fine))
            k2 = (cfg, nets[qc]["coarse"], nets[qf]["fine"], o, d, *grids)
            plain = (cfg, plain_nets[qc]["coarse"], plain_nets[qf]["fine"],
                     o, d, *grids)
            name = fused_plcore.instance_name(cfg, "two_pass_plcore_call",
                                              (qc, qf))
            ms, got = cuda_ms(lambda: fused_plcore.two_pass_plcore_call(
                *k2, rt=rt, ert_eps=0.0), 3)
            plain_ms, want = cuda_ms(lambda: ref.two_pass_ref(
                *plain, rt=PLAIN_RT, ert_eps=0.0), 3)
            extra_row = {}
            if qc or qf:
                err = check(f"{name} {label}", got, want,
                            (5e-3, 5e-3, 5e-3, 5e-3, 1e-2))
            else:
                # two f32 renders can differ by more than either differs
                # from the exact one: the resampler moves fine samples by
                # the last-ulp differences of the coarse weights. So the
                # coarse outputs (no resample) are held to the f32 plain
                # version at 1e-3, and the fine outputs (rgb, acc, depth)
                # to the plain version in float64: within 1e-3 (depth
                # 1e-2) or twice the f32 plain version's own error, the
                # larger (K3's float64 witness, step 3)
                exact = ref.two_pass_ref(*_f64(plain), rt=PLAIN_RT,
                                         ert_eps=0.0)
                check(f"{name} {label} coarse outputs vs plain f32",
                      got[1::2], want[1::2], (1e-3, 1e-3))
                e_k = [float((a.double() - b).abs().max())
                       for a, b in zip(got, exact)]
                e_p = [float((a.double() - b).abs().max())
                       for a, b in zip(want, exact)]
                for i, tol in ((0, 1e-3), (2, 1e-3), (4, 1e-2)):
                    assert e_k[i] <= max(tol, 2.0 * e_p[i]), (
                        name, label, i, e_k, e_p)
                err = max(e_k[1], e_k[3], *(e_k[i] for i in (0, 2, 4)))
                extra_row = {
                    "max_abs_err_vs_float64": e_k,
                    "plain_f32_vs_float64": e_p,
                    "max_abs_err_vs_plain_f32": [
                        float((a - b).abs().max())
                        for a, b in zip(got, want)]}
                print(f"{name} {label}: vs plain float64 {e_k}, vs plain "
                      f"f32 {extra_row['max_abs_err_vs_plain_f32']}, plain "
                      f"f32 vs float64 {e_p}", flush=True)
            if qc == qf and qc:
                extra = []
            else:
                eps = ert_eps_between(want[3])
                dead = int((want[3] >= ref.ert_threshold(eps)).sum())
                assert 0 < dead < R, ("no live/dead mix", label, eps, dead)
                extra = [(eps, None), (0.0, alive)]
            for eps, mask in extra:
                err = max(err, check(
                    f"{name} {label} ert={eps} alive-mask="
                    f"{mask is not None}",
                    fused_plcore.two_pass_plcore_call(*k2, rt=rt,
                                                      ert_eps=eps,
                                                      alive=mask),
                    ref.two_pass_ref(*plain, rt=PLAIN_RT, ert_eps=eps,
                                     alive=mask),
                    (5e-3, 5e-3, 5e-3, 5e-3, 1e-2)))
            n_bytes = nbytes(o, d, grids, plain_nets[qc]["coarse"],
                             plain_nets[qf]["fine"]) + 4 * R * 9
            row = {"config": label, "rays": R, "ray_tile": rt,
                   "blocks_per_sm": per_sm, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, **extra_row,
                   **k2_bounds(cfg, R, qc, qf, n_bytes, peaks)}
            _add_row(rows, name, row)
        for q in (False, True):
            t = sampling.stratified(cfg.near, cfg.far, Nt, (R,),
                                    torch.Generator(device=DEV).manual_seed(1),
                                    device=DEV)
            dl = sampling.deltas_from_t(t)
            per_sm = fused_plcore.blocks_per_sm(cfg, "k1", (Nt,), (q,), DEV)
            rt = ops.pick_ray_tile(R, DEV, per_sm)
            name = fused_plcore.instance_name(cfg, "fused_plcore_call", (q,))
            tol = 5e-3 if q else 1e-3
            ms, got = cuda_ms(lambda: fused_plcore.fused_plcore_call(
                cfg, nets[q]["fine"], o, d, t, dl, rt=rt), 3)
            plain_ms, want = cuda_ms(lambda: ref.fused_plcore_ref(
                cfg, plain_nets[q]["fine"], o, d, t, dl, rt=PLAIN_RT), 3)
            err = check(f"{name} {label} N={Nt}", got, want, (tol,) * 3)
            n_bytes = nbytes(o, d, t, dl, plain_nets[q]["fine"]) \
                + 4 * R * (3 + Nt + 1)
            row = {"config": label, "rays": R, "samples": Nt,
                   "ray_tile": rt, "blocks_per_sm": per_sm,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **plcore_bounds(cfg, R, Nt, 1, n_bytes, q, peaks)}
            _add_row(rows, name, row)
    for name, row in rows.items():
        print(f"{name} ({row['config']}): {row['ms']:.3f} ms, ray tile "
              f"{row['ray_tile']} ({row['blocks_per_sm']} block(s)/SM); "
              f"tensor-core bound {row['bound_ms']:.3f} ms "
              f"({100 * row['bound_ms'] / row['ms']:.1f}% of it); fp32 "
              f"bound {row['bound_ms_fp32']:.3f} ms; plain "
              f"{row['plain_ms']:.3f} ms; max_abs_err "
              f"{row['max_abs_err']:.3g}", flush=True)
    return rows


def _f64(args: tuple) -> tuple:
    """The plain version's arguments with every float tensor in float64
    (the config first, nested weight dicts)."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.double()
        return t
    return tuple(cast(a) for a in args)


def _add_row(rows: dict, name: str, row: dict) -> None:
    """The first config to run an instance gives its row; later ones go
    under the row's ``also_checked``."""
    if name in rows:
        rows[name].setdefault("also_checked", {})[row["config"]] = row
    else:
        rows[name] = row


def tiny_serve_phase(out_dir: str) -> dict:
    """``serve --mode nerf --kernel --fuse-two-pass`` without ``--full``:
    tiny() on the card through K2 at its widths, 3 views at 128x128, then
    one with ``--rmcm --ert 0.01``; counters zeroed just before each run
    and read just after it. Gates: K2 launched at tiny's widths, no weight
    re-packed, every view finite with pixel std > 0, and the first view
    within 5e-3 of the plain render of the same pose. Then ``serve
    --tiled --kernel`` of that pose: K1 twice per 4096-ray tile, the
    image within ``serve.ORACLE_ATOL`` of the fused view."""
    cfg = tiny()
    out = {}
    for label, extra, views in (("f32", [], 3),
                                ("rmcm_ert", ["--rmcm", "--ert", "0.01"], 1)):
        zero_launches()
        stats = serve.main(["--mode", "nerf", "--kernel", "--fuse-two-pass",
                            "--views", str(views), "--hw", str(HW), "--out",
                            out_dir, *extra])
        launches = read_launches()
        inst = fused_plcore.instance_name(cfg, "two_pass_plcore_call",
                                          (bool(extra),) * 2)
        assert stats["config"] == "tiny", stats
        assert stats["device"].startswith("cuda"), stats
        assert stats["weight_packs_since_load"] == 0, stats
        assert launches["instances"].get(inst, 0) >= views, launches
        assert launches["fused_plcore_call"] == 0, launches
        for v in stats["views"]:
            assert v["finite"] and v["pixel_std"] > 0, v
        out[label] = {"launches": launches,
                      "wall_s": [v["wall_s"] for v in stats["views"]],
                      "pixel_std": [v["pixel_std"] for v in stats["views"]]}
        if label == "f32":
            fused = np.load(stats["views"][0]["pixels"])
    # the first view against the plain route, same weights and pose
    args = serve.build_parser().parse_args(["--hw", str(HW)])
    plain = serve.load_plcore(cfg, args, args.seed)
    ro, rd = rays.camera_rays(rays.pose_spherical(args.theta, args.phi,
                                                  rays.blob_scene().radius),
                              HW, HW, 0.9 * HW)
    img = plain.render_image(ro, rd).cpu().numpy()
    out["f32"]["max_abs_err_vs_plain"] = float(np.abs(fused - img).max())
    assert out["f32"]["max_abs_err_vs_plain"] <= 5e-3, out
    zero_launches()
    stats = serve.main(["--mode", "nerf", "--kernel", "--tiled", "--hw",
                        str(HW), "--rays-per-batch", "4096", "--out",
                        out_dir + "/tiled"])
    launches = read_launches()
    tiles = -(-HW * HW // 4096)
    assert stats["pipeline"] == "tiled", stats
    assert launches["fused_plcore_call"] == 2 * tiles, launches
    assert launches["two_pass_plcore_call"] == 0, launches
    tiled = np.load(stats["views"][0]["pixels"])
    out["tiled"] = {"launches": launches, "tiles": tiles,
                    "wall_s": stats["views"][0]["wall_s"],
                    "weight_packs": stats["weight_packs_since_load"],
                    "max_abs_err_vs_fused": float(np.abs(tiled
                                                         - fused).max())}
    assert out["tiled"]["max_abs_err_vs_fused"] <= serve.ORACLE_ATOL, out
    print(f"tiny serve: {json.dumps(out)}", flush=True)
    return out


def traced_engine_phase() -> dict:
    """The engine phase's trace with ``--trace-out`` and ``--metrics-out``
    (under ``build/``): counters zeroed before the run and read after it;
    the check's gates, the trace-integrity gate among them
    (``validate_trace`` on the tracer, ``validate_chrome_trace`` on the
    written file, both ok); one ``tile.kernel`` span per K2 launch; the
    device busy share (the union of those spans over the traced window)
    in (0, 1]; the Prometheus text holding the engine's and the kernels'
    counters."""
    trace_out = ROOT / "build" / "engine_trace.json"
    metrics_out = ROOT / "build" / "engine_metrics.prom"
    args = serve.build_parser().parse_args(
        ENGINE_ARGV + ["--trace-out", str(trace_out), "--metrics-out",
                       str(metrics_out)])
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args)
    launches = read_launches()
    obs = report["observability"]
    busy = obs["device_busy"]
    assert launches["two_pass_plcore_call"] == \
        report["engine"]["dispatches"] == busy["kernel_spans"], (
        launches, report["engine"], busy)
    assert busy["busy_share"] is not None and 0 < busy["busy_share"] <= 1, busy
    prom = metrics_out.read_text()
    for family in ("engine_dispatches_total", "plcore_kernel_launches_total",
                   "plcore_instance_launches_total"):
        assert f"# TYPE {family} counter" in prom, family
    compared = serve.check_engine(args, report, engine, rerun)
    summary = {"rays_per_s": report["rays_per_s"], "wall_s": report["wall_s"],
               "dispatches": report["engine"]["dispatches"],
               "integrity": obs["integrity"],
               "chrome_integrity": obs["chrome_integrity"],
               "device_busy": busy, "spans": obs["spans"],
               "events": obs["events"], "dropped": obs["dropped"],
               "trace_bytes": trace_out.stat().st_size,
               "metrics_lines": len(prom.splitlines()),
               "launches": launches, "check_compared": compared}
    print(f"engine traced: {json.dumps(summary)}", flush=True)
    return summary


def fig8_tiny_run(seed: int) -> dict:
    """One run of the reference's Fig. 8 protocol at tiny() from weights
    drawn with ``seed`` (batches and jitter from ``seed + 1``, ``seed +
    2``); see ``fig8_tiny_phase``."""
    cfg, hw, steps = tiny(), FIG8_TINY_HW, FIG8_TINY_STEPS
    scene = rays.blob_scene()
    ds = rays.make_dataset(scene, 6, hw, hw, focal=2.4 * hw)
    opt_cfg = AdamConfig(lr=5e-3, warmup_steps=20, total_steps=steps,
                         weight_decay=0.0)
    params, opt = nerf_train.init_nerf_state(
        cfg, opt_cfg, torch.Generator().manual_seed(seed))
    step = nerf_train.make_nerf_train_step(cfg, opt_cfg, qat=True)
    batches = rays.ray_batches(
        ds, 1024, torch.Generator(device=DEV).manual_seed(seed + 1))
    jitter = torch.Generator(device=DEV).manual_seed(seed + 2)
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = step(params, opt, next(batches), jitter)
        metrics.append(m["psnr"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hist = torch.stack(metrics).cpu().numpy()
    assert np.isfinite(hist).all(), hist
    first10, last10 = float(hist[:10].mean()), float(hist[-10:].mean())
    assert last10 >= first10 + 3.0, ("training PSNR gain", seed, first10,
                                      last10)
    ro, rd, gt = rays.holdout_view(scene, hw, hw, focal=2.4 * hw)
    gt = gt.cpu().numpy()
    quant = {n: rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
    img_exact = PackedPlcore(cfg, params, device=DEV).render_image(
        ro, rd).cpu().numpy()
    img_rmcm = PackedPlcore(cfg, params, quant=quant,
                            device=DEV).render_image(ro, rd).cpu().numpy()
    pp = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                      device=DEV)
    zero_launches()
    img_fused = pp.render_image(ro, rd).cpu().numpy()
    ar = AdaptiveRenderer(pp, build_scene_aux(pp, **FIG8_AUX))
    img_adaptive, dead = ar.render_image(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                         with_dead=True)
    torch.cuda.synchronize()
    launches = read_launches()
    rep = ar.report()
    inst = fused_plcore.instance_name(cfg, "two_pass_plcore_call",
                                      (False, False))
    assert launches["instances"].get(inst, 0) == 1 + rep["tiles"] - \
        rep["full_dead_tiles"], (launches, rep)
    img_adaptive = img_adaptive.reshape(hw, hw, 3)
    for img in (img_exact, img_rmcm, img_fused, img_adaptive):
        assert img.shape == gt.shape and np.isfinite(img).all()
    run = {"seed": seed, "train_s": train_s, "psnr_first10": first10,
           "psnr_last10": last10,
           "exact_vs_rmcm": psnr(img_exact, img_rmcm),
           "exact_vs_gt": psnr(img_exact, gt),
           "rmcm_vs_gt": psnr(img_rmcm, gt),
           "fused_vs_gt": psnr(img_fused, gt),
           "fused_vs_exact": psnr(img_fused, img_exact),
           "adaptive_vs_gt": psnr(img_adaptive, gt),
           "adaptive_vs_fused": psnr(img_adaptive, img_fused),
           "exact_pixel_std": float(img_exact.std()),
           "memo_dead_rays": int(dead.sum()),
           "dead_ray_fraction": rep["dead_ray_fraction"],
           "full_dead_tiles": rep["full_dead_tiles"],
           "budget_rays": rep["budget_rays"], "launches": launches}
    run["adaptive_psnr_drop_db"] = run["fused_vs_gt"] - run["adaptive_vs_gt"]
    assert run["exact_vs_rmcm"] > 20.0, run
    assert run["adaptive_psnr_drop_db"] <= PSNR_DROP_GATE_DB, run
    return run


def fig8_tiny_phase() -> dict:
    """The reference's Fig. 8 protocol as it runs it
    (``benchmarks/fig8_rmcm_psnr.py``): tiny(), the blob scene, 6 views at
    24x24 with focal 2.4 * hw, 250 QAT steps of 1024 rays at lr 5e-3
    (warmup 20); then the hold-out view (theta 33, phi -20) at 24x24
    rendered exact and RMCM on the plain path, through K2 (``PackedPlcore``
    fused) and adaptively (``AdaptiveRenderer`` at the reference's probe:
    a 24^3 grid from 12x12-ray poses, a 16 MB memo), counters zeroed
    before the K2 and adaptive renders and read after. Gates, the
    reference's: the training PSNR of the last 10 steps at least 3 dB
    above the first 10's, exact vs RMCM above 20 dB, the adaptive PSNR
    drop against the fused render at most 0.1 dB. Run from the weights
    of each of ``FIG8_TINY_SEEDS`` (the hold-out rows move with the draw:
    6 views constrain the scene loosely); reports whether any ray
    rendered memo-dead. The launches are the runs' summed."""
    runs = [fig8_tiny_run(seed) for seed in FIG8_TINY_SEEDS]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in ("fused_plcore_call", "two_pass_plcore_call",
                          "rmcm_matmul")}
    instances: dict = {}
    for r in runs:
        for inst, n in r["launches"]["instances"].items():
            instances[inst] = instances.get(inst, 0) + n
    launches["instances"] = instances
    fig8 = {"config": "tiny", "steps": FIG8_TINY_STEPS, "hw": FIG8_TINY_HW,
            "psnr_drop_gate_db": PSNR_DROP_GATE_DB, "runs": runs,
            "memo_dead_rays": sum(r["memo_dead_rays"] for r in runs),
            "launches": launches}
    print(f"fig8 tiny: {json.dumps(fig8)}", flush=True)
    return fig8


def profile_steps(step, params, opt, batches, jitter, n: int = 3) -> dict:
    """Kernel time of ``n`` more train steps under ``torch.profiler`` (the
    steps' results are dropped): kernels per step, their summed device
    time per step, and its share in GEMM kernels. The host's tracing slows
    the host many times over, so the window's wall time says nothing of
    the step's; the kernels' own durations are unaffected. "not measured"
    when no kernel is recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(params, opt, next(batches), jitter)
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return {"kernel_ms_per_step": "not measured"}
    kernel_us = sum(t for t, _ in spans)
    gemm_us = sum(t for t, name in spans if "gemm" in name.lower())
    return {"steps": n, "kernels_per_step": len(spans) / n,
            "kernel_ms_per_step": kernel_us / 1e3 / n,
            "gemm_ms_per_step": gemm_us / 1e3 / n,
            "gemm_share_of_kernel_time": gemm_us / kernel_us}


def train_phase(cfg, peaks: dict, steps: int = TRAIN_STEPS) -> dict:
    """NeRF training with RMCM QAT at the full width on the card, then the
    trained scene through the serving path and K2, and the Fig. 8 rows.
    Gates (each raises): finite losses and gradient norms; the mean
    training PSNR of the last 10 steps at least 3 dB above the first 10's;
    exact against RMCM above 20 dB on the plain path at 256 dataset rays;
    the checkpoint restored bit for bit; ``serve --ckpt`` (K2 launched, no
    weight re-packed) equal to a ``PackedPlcore`` render of the in-memory
    weights bit for bit; K2 in f32 and RMCM on the trained weights within
    the kernel phase's tolerances of the plain version."""
    scene = rays.blob_scene()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = rays.make_dataset(scene, TRAIN_VIEWS, TRAIN_HW, TRAIN_HW,
                           focal=2.4 * TRAIN_HW)
    torch.cuda.synchronize()
    dataset_s = time.perf_counter() - t0
    opt_cfg = AdamConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=steps, weight_decay=0.0)
    params, opt = nerf_train.init_nerf_state(
        cfg, opt_cfg, torch.Generator().manual_seed(0))
    assert all(t.device.type == DEV.type for t in
               tree_leaves(params) + tree_leaves(opt) + list(ds.values()))
    step = nerf_train.make_nerf_train_step(cfg, opt_cfg, qat=True)
    batches = rays.ray_batches(ds, TRAIN_RAYS,
                               torch.Generator(device=DEV).manual_seed(1))
    jitter = torch.Generator(device=DEV).manual_seed(2)
    ro, rd, gt = rays.holdout_view(scene, FIG8_HW, FIG8_HW,
                                   focal=2.4 * FIG8_HW)
    gt = gt.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, metrics, host_ms, holdout_by_step = [], [], [], {}
    eval_s, peak_bytes = 0.0, 0
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        batch = next(batches)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        th = time.perf_counter()
        ev[0].record()
        params, opt, m = step(params, opt, batch, jitter)
        ev[1].record()
        host_ms.append(1e3 * (time.perf_counter() - th))
        events.append(ev)
        metrics.append(m)
        if i in TRAIN_EVAL_AT and i < steps:
            # the training peak so far; the eval render's own is left out
            torch.cuda.synchronize()
            peak_bytes = max(peak_bytes, torch.cuda.max_memory_allocated())
            te = time.perf_counter()
            img = PackedPlcore(cfg, params, device=DEV).render_image(ro, rd)
            holdout_by_step[i] = psnr(img.cpu().numpy(), gt)
            del img
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eval_s += time.perf_counter() - te
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0 - eval_s
    peak_bytes = max(peak_bytes, torch.cuda.max_memory_allocated())
    step_ms = [a.elapsed_time(b) for a, b in events]
    hist = {k: torch.stack([m[k] for m in metrics]).cpu().numpy()
            for k in metrics[0]}
    for k in ("loss", "grad_norm", "psnr"):
        assert np.isfinite(hist[k]).all(), (k, hist[k])
    first10 = float(hist["psnr"][:10].mean())
    last10 = float(hist["psnr"][-10:].mean())
    assert last10 >= first10 + 3.0, ("training PSNR gain", first10, last10)

    # the RMCM gate of the reference's QAT test: 256 dataset rays, plain
    quant = {n: rmcm.quantize_tree(params[n]) for n in ("coarse", "fine")}
    o256, d256 = ds["rays_o"][:256], ds["rays_d"][:256]
    exact = plcore.render_rays(cfg, params, o256, d256)["rgb"]
    rm = plcore.render_rays(cfg, params, o256, d256, quant=quant)["rgb"]
    qat_db = psnr(exact.cpu().numpy(), rm.cpu().numpy())
    assert qat_db > 20.0, ("exact vs RMCM after QAT", qat_db)

    # checkpoint: save (async, joined) and restore against a template
    ckpt_dir = ROOT / "chiprun_out" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    state = {"params": params, "opt_state": opt}
    t0 = time.perf_counter()
    ck = Checkpointer(str(ckpt_dir))
    ck.save(steps, state, {"steps": steps, "lr": TRAIN_LR,
                           "rays_per_step": TRAIN_RAYS, "qat": True})
    save_return_s = time.perf_counter() - t0
    ck.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, meta = ck.restore(template=state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert meta["steps"] == steps, meta
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.device.type == DEV.type and a.dtype == b.dtype
        assert torch.equal(a, b)

    # the hold-out view through serve --ckpt against the in-memory weights
    out_dir = str(ROOT / "chiprun_out" / "trained_views")
    zero_launches()
    stats = serve.main(["--mode", "nerf", "--full", "--kernel",
                        "--fuse-two-pass", "--views", "1", "--hw",
                        str(FIG8_HW), "--theta", "33", "--phi", "-20",
                        "--focal", str(2.4 * FIG8_HW), "--ckpt",
                        str(ckpt_dir), "--out", out_dir])
    serve_launches = read_launches()
    assert stats["weight_packs_since_load"] == 0, stats
    assert serve_launches["two_pass_plcore_call"] >= 1, serve_launches
    assert serve_launches["fused_plcore_call"] == 0, serve_launches
    served = np.load(stats["views"][0]["pixels"])
    fused_pp = PackedPlcore(cfg, params, use_kernel=True, fuse_two_pass=True,
                            device=DEV)
    img_fused = fused_pp.render_image(ro, rd).cpu().numpy()
    assert np.array_equal(served, img_fused), float(
        np.abs(served - img_fused).max())

    # K2 on the trained weights against the plain version, f32 and RMCM
    o, d = ro.reshape(-1, 3), rd.reshape(-1, 3)
    R, Nc, Nf = o.shape[0], cfg.n_coarse, cfg.n_fine
    rows = ops.sample_rows(cfg, DEV)
    k2_errs = {}
    for q in (False, True):
        nets = packed_nets(cfg, params, q)
        plain_nets = {n: {k: v for k, v in nets[n].items() if k != "mma"}
                      for n in nets}
        per_sm = fused_plcore.blocks_per_sm(cfg, "k2", (Nc, Nf), (q, q), DEV)
        rt = ops.pick_ray_tile(R, DEV, per_sm,
                               pairs=fused_plcore.k2_pairs(Nc, Nf))
        got = fused_plcore.two_pass_plcore_call(
            cfg, nets["coarse"], nets["fine"], o, d, *rows, rt=rt,
            ert_eps=0.0)
        want = ref.two_pass_ref(cfg, plain_nets["coarse"], plain_nets["fine"],
                                o, d, *rows, rt=PLAIN_RT, ert_eps=0.0)
        tol = 5e-3 if q else 1e-3
        k2_errs["rmcm" if q else "f32"] = check(
            f"K2 trained scene rmcm={q}", got, want,
            (tol, tol, tol, tol, 1e-2))

    # the Fig. 8 rows on the hold-out view
    plain_pp = PackedPlcore(cfg, params, device=DEV)
    img_exact = plain_pp.render_image(ro, rd).cpu().numpy()
    rmcm_pp = PackedPlcore(cfg, params, quant=quant, device=DEV)
    img_rmcm = rmcm_pp.render_image(ro, rd).cpu().numpy()
    # the fit apart from the generalization: the first training view,
    # with the master (exact) weights and with the RMCM weights QAT fit
    view0 = slice(0, TRAIN_HW * TRAIN_HW)
    o0, d0 = ds["rays_o"][view0], ds["rays_d"][view0]
    gt0 = ds["rgb"][view0].cpu().numpy()
    train_view_db = {
        name: psnr(pp.render_rays(o0, d0)["rgb"].cpu().numpy(), gt0)
        for name, pp in (("exact", plain_pp), ("rmcm", rmcm_pp))}
    holdout_by_step[steps] = psnr(img_exact, gt)
    ar = AdaptiveRenderer(fused_pp, build_scene_aux(fused_pp, **FIG8_AUX))
    zero_launches()
    img_adaptive = ar.render_image(o.cpu().numpy(), d.cpu().numpy(),
                                   rays_per_tile=ADAPTIVE_TILE)
    torch.cuda.synchronize()
    adaptive_launches = read_launches()
    rep = ar.report()
    assert adaptive_launches["two_pass_plcore_call"] == \
        rep["tiles"] - rep["full_dead_tiles"], (adaptive_launches, rep)
    img_adaptive = img_adaptive.reshape(FIG8_HW, FIG8_HW, 3)
    for img in (img_exact, img_rmcm, img_fused, img_adaptive):
        assert img.shape == gt.shape and np.isfinite(img).all()
    fig8 = {
        "exact_vs_rmcm": psnr(img_exact, img_rmcm),
        "exact_vs_gt": psnr(img_exact, gt),
        "rmcm_vs_gt": psnr(img_rmcm, gt),
        "fused_vs_gt": psnr(img_fused, gt),
        "adaptive_vs_gt": psnr(img_adaptive, gt),
        "adaptive_vs_fused": psnr(img_adaptive, img_fused),
        "train_view0_exact_vs_gt": train_view_db["exact"],
        "train_view0_rmcm_vs_gt": train_view_db["rmcm"],
        "exact_vs_gt_by_step": holdout_by_step,
        "train_psnr": float(hist["psnr"][-1]), "steps": steps,
        "hw": FIG8_HW, "psnr_drop_gate_db": PSNR_DROP_GATE_DB,
        "dead_ray_fraction": rep["dead_ray_fraction"],
        "full_dead_tiles": rep["full_dead_tiles"],
        "budget_rays": rep["budget_rays"],
        "k2_launches_by_nf": adaptive_launches["k2_by_nf"]}
    fig8["adaptive_psnr_drop_db"] = fig8["fused_vs_gt"] - \
        fig8["adaptive_vs_gt"]
    fig8["adaptive_gate_met"] = \
        fig8["adaptive_psnr_drop_db"] <= PSNR_DROP_GATE_DB

    # the step's least time: forward and backward, about three forward
    # passes of 1024 rays x 256 network evaluations, on the fp32 cores
    # (TF32 off); bytes: the batch, params, gradients, moments in and out
    n_eval = Nc + Nc + Nf
    flop = 3 * 2.0 * TRAIN_RAYS * (n_eval * macs_per_sample(cfg)
                                   + 2 * macs_per_ray_pass(cfg))
    n_bytes = nbytes(batch) + 7 * nbytes(params)
    b_ms, b_by = bound_ms(flop / peaks["fp32"], n_bytes)
    med = float(np.median(step_ms[TRAIN_TIMED_FROM:]))
    summary = {
        "steps": steps, "rays_per_step": TRAIN_RAYS, "lr": TRAIN_LR,
        "warmup_steps": TRAIN_WARMUP, "qat": True,
        "dataset_rays": int(ds["rgb"].shape[0]), "dataset_s": dataset_s,
        "step_ms_median": med,
        "step_ms_p10_p90": [float(np.percentile(step_ms[TRAIN_TIMED_FROM:],
                                                x)) for x in (10, 90)],
        "step_ms_first": step_ms[:3],
        "host_ms_per_step_median": float(np.median(
            host_ms[TRAIN_TIMED_FROM:])),
        "wall_s_per_step": train_s / steps, "train_wall_s": train_s,
        "samples_per_s": TRAIN_RAYS * n_eval / (med / 1e3),
        "step_tflop": flop / 1e12, "bound_ms_fp32": b_ms,
        "bound_by": b_by, "share_of_bound": b_ms / med,
        "peak_mem_bytes": peak_bytes,
        "psnr_first10": first10, "psnr_last10": last10,
        "loss_last": float(hist["loss"][-1]),
        "grad_norm_last": float(hist["grad_norm"][-1]),
        "exact_vs_rmcm_256_rays_db": qat_db,
        "ckpt_save_return_s": save_return_s, "ckpt_save_s": save_s,
        "ckpt_restore_s": restore_s,
        "serve_ckpt": {"wall_s": stats["views"][0]["wall_s"],
                       "launches": serve_launches,
                       "equal_to_in_memory": True},
        "k2_trained_max_abs_err": k2_errs,
        "adaptive_launches": adaptive_launches}
    prof = profile_steps(step, params, opt, batches, jitter)
    if isinstance(prof["kernel_ms_per_step"], float):
        # one stream: the kernels' summed time over the unprofiled step's
        prof["device_busy_share"] = prof["kernel_ms_per_step"] / med
    summary["profile"] = prof
    print(f"train: {json.dumps(summary)}", flush=True)
    print(f"fig8: {json.dumps(fig8)}", flush=True)
    return {"summary": summary, "fig8": fig8,
            "launches": {k: serve_launches[k] + adaptive_launches[k]
                         for k in ("fused_plcore_call",
                                   "two_pass_plcore_call", "rmcm_matmul")},
            "k2_by_nf": adaptive_launches["k2_by_nf"]}


# ------------------------------------------------- SDF and SLF through K3 --
def adam_fit(decls, loss_of, steps: int, opt_cfg, seed: int):
    """Fit a generic MLP with plain autograd and the port's Adam (weights
    from ``torch.Generator().manual_seed(seed)``): ``loss_of(params, i)``
    is step i's loss. Returns (params on the card, per-step losses)."""
    params = bridge.to_device(
        init_params(decls, torch.Generator().manual_seed(seed)), DEV)
    opt = bridge.to_device(init_params(opt_state_decls(decls, opt_cfg),
                                       torch.Generator()), DEV)
    grad_fn = nerf_train.value_and_grad(lambda p, i: (loss_of(p, i), {}))
    losses = []
    for i in range(steps):
        (loss, _), grads = grad_fn(params, i)
        params, opt, _ = adam_update(opt_cfg, params, grads, opt)
        losses.append(loss)
    return params, torch.stack(losses).cpu().numpy()


def k3_layer_rows(workload: str, x0: torch.Tensor, params: dict,
                  quant: dict, packed: dict, launches: dict,
                  peaks: dict) -> dict:
    """K3 at each RMCM layer of a generic MLP on real activations (``x0``
    the PEU output; each next input the plain route's ReLU of this
    layer's output): the kernel against its plain version (the
    reference's product on the unpacked weight), both timed with CUDA
    events beside the bound and one ``torch.matmul`` on the dequantized
    weight (the weights stay in L2, as in the workload). One row per
    layer shape, timed at its first layer, its error the largest over its
    layers; ``launches``: K3's launches at that shape in the workload
    run."""
    rows, x, n = {}, x0, len(params)
    for i in range(n):
        layer = f"l{i}"
        qp, qd = packed[layer]["w"], quant[layer]["w"]
        M, K = x.shape
        N = qp["mag"].shape[1]
        shape = f"{M}x{K}x{N}"
        got = ops.rmcm_matmul(x, qp)
        want = rmcm.rmcm_matmul_ref(x, qd)
        err = check(f"K3 {workload} {layer} ({shape})", (got,), (want,),
                    (WORKLOAD_TOL,))
        row = rows.get(f"{workload} {shape}")
        if row is not None:
            row["layers"].append(layer)
            row["max_abs_err"] = max(row["max_abs_err"], err)
        else:
            w_dense = rmcm.dequantize(qd)
            ms, _ = cuda_ms(lambda: ops.rmcm_matmul(x, qp), 20)
            plain_ms, _ = cuda_ms(lambda: rmcm.rmcm_matmul_ref(x, qd), 20)
            lib_ms, _ = cuda_ms(lambda: torch.matmul(x, w_dense), 20)
            n_bytes = k3_bytes(x, qp, got)
            b_ms, b_by = bound_ms(3 * 2.0 * M * K * N / peaks["bf16"], n_bytes)
            f_ms, f_by = bound_ms(2.0 * M * K * N / peaks["fp32"], n_bytes)
            rows[f"{workload} {shape}"] = {
                "shape_mkn": [M, K, N], "layers": [layer],
                "route": k3.route(M), "launches": launches.get(shape, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_fp32": f_ms, "bound_by_fp32": f_by}
            print(f"K3 {workload} {shape}: {ms:.4f} ms (bound {b_ms:.4f} ms "
                  f"by {b_by}, {100 * b_ms / ms:.1f}% of it; fp32-core bound "
                  f"{f_ms:.4f} ms by {f_by}; plain "
                  f"{plain_ms:.4f} ms; torch.matmul on the dequantized "
                  f"weight {lib_ms:.4f} ms)", flush=True)
        y = want + params[layer]["b"]
        x = torch.relu(y) if i < n - 1 else y
    return rows


def sdf_phase(peaks: dict) -> dict:
    """The paper's SDF workload at full width (``SDF_WIDTHS``, rff_iso PEU
    of 128 features at sigma 2, K = 259): fitted to ``sphere_sdf`` (radius
    0.5) for ``SDF_FIT_STEPS`` Adam steps on ``SDF_FIT_POINTS`` points in
    [-1.2, 1.2]^3 a step (plain autograd), then RMCM-quantized and packed
    once. The workload run, counters zeroed just before it and read just
    after: ``eval_grid`` at resolution 128 (2,097,152 points in
    65,536-point chunks), ``sphere_trace`` of a 128x128 view at 64 steps,
    ``sdf_normal`` at the hits, every RMCM layer through K3. The plain
    route (the unpacked tree) of the same work: distances and t within
    5e-3, hit masks equal except for rays whose plain distance at their
    end point lies within a factor 4 of ``hit_eps`` (counted). Times per
    grid and per view of both routes, K3 per layer shape
    (``k3_layer_rows``)."""
    gen = torch.Generator(device=DEV).manual_seed(17)
    peu = encoding.PEU("rff_iso", 3, n_features=128, sigma=2.0,
                       generator=gen, device=DEV)
    decls = sdf.sdf_decls(peu, widths=SDF_WIDTHS)
    fit_pts = (torch.rand((SDF_FIT_STEPS, SDF_FIT_POINTS, 3), generator=gen,
                          device=DEV) * 2.4 - 1.2)
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=20, total_steps=SDF_FIT_STEPS,
                         weight_decay=0.0)
    t0 = time.perf_counter()
    params, losses = adam_fit(
        decls, lambda p, i: torch.mean(torch.square(
            sdf.sdf_eval(peu, p, fit_pts[i])
            - sdf.sphere_sdf(fit_pts[i], radius=0.5))),
        SDF_FIT_STEPS, opt_cfg, seed=17)
    fit_s = time.perf_counter() - t0
    fit_loss = float(losses[-10:].mean())
    assert np.isfinite(losses).all() and fit_loss < 2e-3, (
        "SDF fit", losses[:3], fit_loss)
    quant = rmcm.quantize_tree(params)
    packed = mlp.pack_quant(quant)
    hw, steps, t_max, hit_eps = SDF_VIEW_HW, SDF_TRACE_STEPS, 4.0, 1e-3
    ro, rd = rays.camera_rays(rays.pose_spherical(30.0, -20.0, 2.0), hw, hw,
                              0.9 * hw)
    ro, rd = ro.reshape(-1, 3).to(DEV), rd.reshape(-1, 3).to(DEV)

    def run(q):
        grid = sdf.eval_grid(peu, params, SDF_GRID_RES, chunk=SDF_CHUNK,
                             quant=q)
        t, hit = sdf.sphere_trace(peu, params, ro, rd, n_steps=steps,
                                  t_max=t_max, hit_eps=hit_eps, quant=q)
        pts = (ro + t[:, None] * rd)[hit]
        normal = sdf.sdf_normal(peu, params, pts, quant=q)
        return grid, t, hit, normal

    zero_launches()
    grid, t, hit, normal = run(packed)
    torch.cuda.synchronize()
    launches = read_launches()
    grid_p, t_p, hit_p, normal_p = run(quant)
    torch.cuda.synchronize()
    n_layers = len(params)
    n_hit = int(hit.sum())
    expect = n_layers * (-(-SDF_GRID_RES ** 3 // SDF_CHUNK) + steps
                         + (6 if n_hit else 0))
    assert launches["rmcm_matmul"] == expect, (launches, expect)
    assert launches["two_pass_plcore_call"] == 0, launches
    grid_err = check("SDF grid K3 vs plain", (grid,), (grid_p,),
                     (WORKLOAD_TOL,))
    # rays whose hit status may rightly differ: the plain distance at
    # either route's end point within a factor 4 of hit_eps
    end_d = torch.minimum(
        sdf.sdf_eval(peu, params, ro + t[:, None] * rd, quant).abs(),
        sdf.sdf_eval(peu, params, ro + t_p[:, None] * rd, quant).abs())
    borderline = (end_d > hit_eps / 4) & (end_d < 4 * hit_eps)
    flips = hit != hit_p
    assert not bool((flips & ~borderline).any()), int(flips.sum())
    agree = ~flips & ~borderline
    t_err = check("SDF trace t K3 vs plain", (t[agree],), (t_p[agree],),
                  (WORKLOAD_TOL,))
    hit_frac = n_hit / hit.numel()
    assert 0.05 < hit_frac < 0.95, ("the trace hits no surface", hit_frac)
    # the analytic sphere's intersection at the hits
    b = torch.sum(ro * rd, -1)
    t_true = -b - torch.sqrt(torch.clamp(b * b - (ro * ro).sum(-1) + 0.25,
                                         min=0.0))
    t_vs_sphere = float((t - t_true)[hit].abs().median())
    both = hit & hit_p
    normal_err = float((normal - normal_p).abs().max()) if n_hit else 0.0
    assert bool(torch.isfinite(normal).all()), "non-finite normals"
    grid_ms, _ = cuda_ms(lambda: sdf.eval_grid(
        peu, params, SDF_GRID_RES, chunk=SDF_CHUNK, quant=packed), 2)
    grid_plain_ms, _ = cuda_ms(lambda: sdf.eval_grid(
        peu, params, SDF_GRID_RES, chunk=SDF_CHUNK, quant=quant), 2)
    view_ms, _ = cuda_ms(lambda: sdf.sphere_trace(
        peu, params, ro, rd, n_steps=steps, t_max=t_max, quant=packed), 2)
    view_plain_ms, _ = cuda_ms(lambda: sdf.sphere_trace(
        peu, params, ro, rd, n_steps=steps, t_max=t_max, quant=quant), 2)
    chunk_pts = torch.stack(torch.meshgrid(
        *[torch.linspace(-1.0, 1.0, SDF_GRID_RES, device=DEV)] * 3,
        indexing="ij"), -1).reshape(-1, 3)[:SDF_CHUNK]
    layer_rows = k3_layer_rows("sdf_grid", peu(chunk_pts), params, quant,
                               packed, launches["k3_by_shape"], peaks)
    layer_rows.update(k3_layer_rows("sdf_trace", peu(ro), params, quant,
                                    packed, launches["k3_by_shape"], peaks))
    summary = {
        "widths": list(SDF_WIDTHS), "peu": "rff_iso 128 features sigma 2",
        "k": peu.out_dim, "fit_steps": SDF_FIT_STEPS,
        "fit_points": SDF_FIT_POINTS, "fit_loss": fit_loss, "fit_s": fit_s,
        "grid_points": SDF_GRID_RES ** 3, "grid_chunk": SDF_CHUNK,
        "view": f"{hw}x{hw}", "trace_steps": steps, "hit_fraction": hit_frac,
        "borderline_rays": int(borderline.sum()),
        "hit_flips": int(flips.sum()),
        "t_median_abs_vs_analytic_sphere": t_vs_sphere,
        "grid_max_abs_err": grid_err, "t_max_abs_err": t_err,
        "normal_max_abs_err": normal_err, "hits_both": int(both.sum()),
        "k3_launches": launches["rmcm_matmul"],
        "k3_launches_by_shape": launches["k3_by_shape"],
        "grid_ms": grid_ms, "grid_plain_ms": grid_plain_ms,
        "view_ms": view_ms, "view_plain_ms": view_plain_ms,
        "k3_layers": layer_rows, "launches": launches,
        "card": smi("name,power.limit")}
    print(f"sdf: {json.dumps(summary)}", flush=True)
    return summary


def slf_phase(peaks: dict) -> dict:
    """The paper's SLF workload at full width: ``make_slf_peu()`` defaults
    (rff_aniso, 128 features, sigmas 8 and 1, K = 262), widths (256, 256,
    128), fitted to ``examples/torch_slf_render.py``'s
    ``surface_radiance`` (``SLF_FIT_STEPS`` Adam steps on 4096 surface
    samples, plain autograd), then RMCM-quantized and packed once. One
    128x128 view (the example's camera) through K3, counters zeroed just
    before and read just after, against the plain route within 5e-3;
    PSNR of both against the analytic radiance on the sphere's pixels.
    Times per view and K3 per layer shape."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    peu = slf.make_slf_peu(gen, device=DEV)
    decls = slf.slf_decls(peu, widths=SLF_WIDTHS)
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=20, total_steps=SLF_FIT_STEPS,
                         weight_decay=0.0)
    t0 = time.perf_counter()
    params, losses = adam_fit(
        decls, lambda p, i: slf.slf_loss(
            peu, p, slf_example.surface_batch(4096, gen)),
        SLF_FIT_STEPS, opt_cfg, seed=23)
    fit_s = time.perf_counter() - t0
    assert (np.isfinite(losses).all()
            and losses[-10:].mean() < losses[:10].mean() / 4), (
        "SLF fit", losses[:3], losses[-3:])
    quant = rmcm.quantize_tree(params)
    packed = mlp.pack_quant(quant)
    hw = SLF_VIEW_HW
    ro, rd = rays.camera_rays(rays.pose_spherical(40.0, -15.0, 3.0), hw, hw,
                              1.4 * hw)
    ro, rd = ro.reshape(-1, 3).to(DEV), rd.reshape(-1, 3).to(DEV)
    t, hit = slf_example.ray_sphere(ro, rd)
    p = ro + t[..., None] * rd
    zero_launches()
    rgb = slf.slf_eval(peu, params, p, rd, quant=packed)
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches["rmcm_matmul"] == len(params), launches
    rgb_p = slf.slf_eval(peu, params, p, rd, quant=quant)
    err = check("SLF view K3 vs plain", (rgb,), (rgb_p,), (WORKLOAD_TOL,))
    gt = slf_example.surface_radiance(p, rd)

    def hit_psnr(img):
        mse = float((torch.square(img - gt) * hit[:, None]).sum()
                    / max(int(hit.sum()) * 3, 1))
        return -10.0 * math.log10(max(mse, 1e-12))
    view_ms, _ = cuda_ms(lambda: slf.slf_eval(peu, params, p, rd,
                                              quant=packed), 10)
    view_plain_ms, _ = cuda_ms(lambda: slf.slf_eval(peu, params, p, rd,
                                                    quant=quant), 10)
    x0 = peu(torch.cat([p, rd], -1))
    summary = {
        "widths": list(SLF_WIDTHS),
        "peu": "rff_aniso 128 features, sigmas 8 (point) and 1 (direction)",
        "k": peu.out_dim, "fit_steps": SLF_FIT_STEPS,
        "fit_loss": float(losses[-10:].mean()), "fit_s": fit_s,
        "view": f"{hw}x{hw}", "hit_pixels": int(hit.sum()),
        "max_abs_err": err, "psnr_k3_vs_analytic": hit_psnr(rgb),
        "psnr_plain_vs_analytic": hit_psnr(rgb_p),
        "k3_launches": launches["rmcm_matmul"],
        "k3_launches_by_shape": launches["k3_by_shape"],
        "view_ms": view_ms, "view_plain_ms": view_plain_ms,
        "k3_layers": k3_layer_rows("slf_view", x0, params, quant, packed,
                                   launches["k3_by_shape"], peaks),
        "launches": launches, "card": smi("name,power.limit")}
    print(f"slf: {json.dumps(summary)}", flush=True)
    return summary


# ------------------------------------------------------ per-cell engine --
def percell_engine_phase() -> dict:
    """The engine phase's trace at full width with every scene's trunk
    sharded over 8 cells on this one card (``plcore_mesh(devices=[cuda:0]
    * 8)``: one trunk layer per cell), ``--route-by-shard
    --percell-dispatch``, depth 2, traced: counters zeroed just before the
    run and read just after (K2 once per dispatch, on the home cell's own
    stream). Its images equal the replicated engine's on the same trace
    bit for bit; the check's gates (depth 1, unrouted and mesh-wide
    routed reruns, per-cell tiles, stagings, cross-cell concurrency).
    Reports the ``percell_report``, the gather and stage counters against
    the owner table, rays/s beside the replicated engine's (cold, then the
    trace again on the warm engines in turns: replicated, per-cell,
    per-cell, replicated), the device busy share from the trace and the
    host time of the traced ``plcore.dispatch`` and ``plcore.stage``
    spans."""
    trace_out = ROOT / "build" / "percell_trace.json"
    args = serve.build_parser().parse_args(
        ENGINE_ARGV + ["--shard-weights", "--route-by-shard",
                       "--percell-dispatch", "--trace-out", str(trace_out)])
    mesh = sharding.plcore_mesh(devices=[DEV_INDEXED] * PERCELL_CELLS)
    L = CONFIG.trunk_layers
    stage0 = (sharding.plcore_stage_count(), sharding.plcore_stage_bytes())
    gather0 = (sharding.plcore_gather_count(), sharding.plcore_gather_bytes())
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args, shard_mesh=mesh)
    launches = read_launches()
    stages = (sharding.plcore_stage_count() - stage0[0],
              sharding.plcore_stage_bytes() - stage0[1])
    gathers = (sharding.plcore_gather_count() - gather0[0],
               sharding.plcore_gather_bytes() - gather0[1])
    st, pc = report["engine"], report["percell"]
    assert report["weight_shards"] == PERCELL_CELLS == L, report
    assert launches["two_pass_plcore_call"] == st["dispatches"], (
        launches, st)
    assert launches["fused_plcore_call"] == 0, launches
    assert pc["percell_tiles"] == st["dispatches"], pc
    assert st["plcore_gather_count"] == 0, st
    # staging against the owner table: each scene stages into its home
    # cell once, every layer it does not own, per stacked array (trunk_w,
    # trunk_b and the tensor-core stream) of both networks
    homes = {s: sharding.plcore_home_cell(mesh, L, s)
             for s in sorted({item.request.scene_id for item in trace})}
    owned = sharding.plcore_owner_table(mesh, L).sum(1)
    want_layers = sum(2 * 3 * (L - int(owned[c])) for c in homes.values())
    assert pc["stage_events"] == len(homes), (pc, homes)
    assert pc["stage_layers"] == stages[0] == want_layers, (
        pc, stages, want_layers)
    assert gathers == (0, 0), gathers
    obs = report["observability"]
    busy = obs["device_busy"]
    assert busy["kernel_spans"] == st["dispatches"], busy
    # the replicated engine on the same trace: bit for bit
    base_args = serve.build_parser().parse_args(ENGINE_ARGV)
    base_report, base, _, _ = serve.run_engine(base_args)
    n_cmp = serve.compare_images(engine, base, "replicated engine")
    assert all(r.fallbacks == 0 for r in engine.completed.values())
    compared = serve.check_engine(args, report, engine, rerun)
    events = json.loads(trace_out.read_text())["traceEvents"]
    host_ms = {name: sum(e["dur"] for e in events
                         if e["name"] == name and e["ph"] == "X") / 1e3
               for name in ("plcore.dispatch", "plcore.stage")}
    warm = {"replicated": [], "percell": []}
    for label, eng in (("replicated", base), ("percell", engine),
                       ("percell", engine), ("replicated", base)):
        rays0 = eng.stats["rays_rendered"]
        t0 = time.perf_counter()
        loadgen.run_trace(eng, trace, mode=args.loop,
                          concurrency=args.concurrency)
        warm[label].append((eng.stats["rays_rendered"] - rays0)
                           / (time.perf_counter() - t0))
    summary = {
        "cells": PERCELL_CELLS, "cell_devices": sorted({str(d) for d in mesh}),
        "note": "one card: every cell is cuda:0 with its own stream; the "
                "staged 'remote' layers are on-card copies, counted as "
                "the traffic one device per cell would pay",
        "homes": homes, "percell": pc, "stage_layers": stages[0],
        "stage_bytes": stages[1], "stage_layers_owner_table": want_layers,
        "rays_per_s": report["rays_per_s"],
        "replicated_rays_per_s": base_report["rays_per_s"],
        "wall_s": report["wall_s"], "replicated_wall_s": base_report["wall_s"],
        "warm_rays_per_s": warm, "host_ms_traced": host_ms,
        "latency_ms": report["latency_ms"],
        "max_in_flight": st["max_in_flight"], "dispatches": st["dispatches"],
        "device_busy": busy, "integrity_ok": obs["integrity"]["ok"],
        "images_equal_replicated": n_cmp, "check_compared": compared,
        "launches": launches, "card": smi("name,power.limit")}
    print(f"percell engine: {json.dumps(summary)}", flush=True)
    return summary


CLUSTER_ARGV = ENGINE_ARGV + ["--hosts", "2"]
CLUSTER_KILL = ["--host-kill", "1:@6"]


def cluster_launches(report: dict, launches: dict) -> dict:
    """K2's launches of a cluster run against the engine's counters: one
    per dispatch attempt that did not raise (primary and retry ladder), and
    one per synchronous cross-host failover (the redispatch hook; the other
    cross-host redispatches are re-queued tiles, already dispatches). K1
    twice per oracle fallback. Returns the counts."""
    st, cl = report["engine"], report["cluster"]
    hook = cl["cross_host_redispatches"] - cl["failovers"]
    want = st["dispatches"] + st["tile_retries"] - st["dispatch_errors"] \
        + hook
    assert launches["fused_plcore_call"] == 2 * st["oracle_fallbacks"], (
        launches, st)
    return {"k2": launches["two_pass_plcore_call"], "dispatches":
            st["dispatches"], "tile_retries": st["tile_retries"],
            "dispatch_errors": st["dispatch_errors"], "failover_hook": hook,
            "accounted": want}


def recovery_from_trace(tracer) -> dict:
    """The kill's recovery cost from the span stream: the tiles re-queued
    at ``host.kill`` and the time from the kill to the last of them
    scattering on another host."""
    spans = tracer.spans()
    kills = [s for s in spans if s.name == "host.kill"]
    assert len(kills) == 1, [s.attrs for s in kills]
    t_kill = kills[0].t0
    tids = {s.attrs["tile"] for s in spans if s.name == "tile.requeue"}
    ends = [s.t1 for s in spans
            if s.name == "tile.scatter" and s.attrs.get("tile") in tids]
    assert len(ends) == len(tids) >= 1, (tids, ends)
    redispatch = [s.attrs.get("host") for s in spans
                  if s.name == "tile.dispatch" and s.attrs.get("tile") in tids
                  and s.t0 > t_kill]
    assert redispatch and 1 not in redispatch, redispatch
    return {"requeued_tiles": len(tids),
            "kill_to_last_scatter_ms": 1e3 * (max(ends) - t_kill)}


def cluster_run(argv: list, shard_mesh=None) -> tuple:
    """One cluster run through ``serve.run_engine``: counters zeroed just
    before, read just after; the gates every cluster run shares (K2's
    launches accounted for, no heartbeat timeout, each ok image equal to a
    direct render, the serve check's gates). Returns ``(summary, report,
    engine, trace, rerun)``."""
    args = serve.build_parser().parse_args(argv)
    zero_launches()
    report, engine, trace, rerun = serve.run_engine(args,
                                                    shard_mesh=shard_mesh)
    launches = read_launches()
    acc = cluster_launches(report, launches)
    st, rb, cl = report["engine"], report["robustness"], report["cluster"]
    assert report["device"].startswith("cuda"), report["device"]
    assert report["hosts"] == 2 and cl["n_hosts"] == 2, report["hosts"]
    # no hang is scheduled: every kill is one the run asked for
    assert cl["heartbeat_timeouts"] == 0, cl
    assert cl["host_kills"] == len(args.host_kill), cl
    if args.inject_faults:
        inj = rb["faults_injected"]["injected"]
        # every recovery traces back to an injected fault: the failover
        # hook draws dispatch and corrupt faults too, and declines those
        # without counting them as the engine's
        assert rb["dispatch_errors"] <= inj["dispatch_error"], (rb, inj)
        assert rb["corrupt_tiles"] <= inj["corrupt"], (rb, inj)
        assert rb["scene_load_errors"] == inj["loader_error"], (rb, inj)
        assert cl["host_slow_events"] == inj["host_slow"], (cl, inj)
        # a hook launch whose result was corrupted declines after it ran
        assert acc["accounted"] <= acc["k2"] <= acc["accounted"] \
            + inj["corrupt"], acc
    else:
        assert (rb["dispatch_errors"], rb["tile_retries"],
                rb["oracle_fallbacks"], rb["corrupt_tiles"]) == \
            (0, 0, 0, 0), rb
        assert acc["k2"] == acc["accounted"] == st["dispatches"] + \
            acc["failover_hook"], acc
    if args.host_kill:
        assert cl["requeued_tiles"] >= 1 and cl["failovers"] >= 1, cl
        assert cl["cross_host_redispatches"] >= 1, cl
        assert cl["hosts"][1]["state"] == "dead", cl["hosts"]
    n_exact, n_close = direct_images(args, engine, trace, rb)
    compared = serve.check_engine(args, report, engine, rerun)
    summary = {
        "rays_per_s": report["rays_per_s"], "wall_s": report["wall_s"],
        "latency_ms": report["latency_ms"], "goodput": rb["goodput"],
        "status_counts": rb["status_counts"], "launches_accounted": acc,
        "dispatches_per_host": {h: v["dispatches"]
                                for h, v in cl["hosts"].items()},
        "host_states": {h: v["state"] for h, v in cl["hosts"].items()},
        **{k: cl[k] for k in ("host_kills", "heartbeat_timeouts",
                              "requeued_tiles", "failovers",
                              "cross_host_redispatches", "host_slow_events",
                              "slow_host_flags", "failover_latency_s",
                              "quarantines", "quarantine_probes",
                              "quarantine_recoveries")},
        "tile_retries": rb["tile_retries"],
        "oracle_fallbacks": rb["oracle_fallbacks"],
        "dispatch_errors": rb["dispatch_errors"],
        "corrupt_tiles": rb["corrupt_tiles"],
        "straggler_redispatches": rb["straggler_redispatches"],
        "images_exact_vs_direct": n_exact,
        "images_within_oracle_atol": n_close, "check_compared": compared,
        "launches": launches}
    if args.inject_faults:
        summary["faults_injected"] = rb["faults_injected"]["injected"]
    return summary, report, engine, trace, rerun


def warm_rays_per_s(engines: list, args) -> dict:
    """The trace again on warm engines in turns (A, B, B, A ...): rays/s
    of each turn by label."""
    out: dict = {}
    for label, eng, trace in engines:
        rays0 = eng.stats["rays_rendered"]
        t0 = time.perf_counter()
        loadgen.run_trace(eng, trace, mode=args.loop,
                          concurrency=args.concurrency)
        out.setdefault(label, []).append(
            (eng.stats["rays_rendered"] - rays0) / (time.perf_counter() - t0))
    return out


def cluster_phase() -> dict:
    """The multi-host serving cluster at full width through ``serve
    --mode engine --hosts 2`` (the engine phase's trace, K2), after the
    engine phases so every kernel is built before a heartbeat is watched:

    (a) clean with a kill (``--host-kill 1:@6``): K2's launches equal the
        dispatches plus the synchronous failovers (none here: the
        re-queued tiles' second dispatches are dispatches), no retry,
        fallback or dispatch error, no heartbeat timeout, one kill, a
        cross-host redispatch, each ok image equal to a direct render; the
        check's cluster gates (bit for bit against a clean single-host
        rerun). Rays/s beside the one-host engine and a two-host engine
        without the kill on the same trace, cold and warm in turns.
    (b) chaos (``--inject-faults``, the cluster chaos mix): every recovery
        traces back to an injected fault.
    (c) traced with the kill: both validator verdicts ok, ``host.kill``
        among the spans, the per-host families in the Prometheus text, the
        device busy share, and the kill's recovery cost from the trace.
    (d) sharded through the API: two hosts over ``split_devices(2,
        [cuda:0] * 8)`` (4 cells each, one stream per cell list slot),
        routed and per-cell, host 1 killed at dispatch 6 (``abandon_all``
        on cell streams); images equal the replicated single-host
        engine's bit for bit, and the check's sharding gates."""
    out = {}
    # (a) and the one-host and two-host references on the same trace
    kill, report, killed, trace, rerun = cluster_run(CLUSTER_ARGV
                                                     + CLUSTER_KILL)
    args = serve.build_parser().parse_args(ENGINE_ARGV)
    one_report, one, _, _ = serve.run_engine(args)
    two_report, two, _, _ = serve.run_engine(
        serve.build_parser().parse_args(CLUSTER_ARGV))
    assert two_report["cluster"]["host_kills"] == 0, two_report["cluster"]
    assert two_report["cluster"]["heartbeat_timeouts"] == 0
    assert serve.compare_images(killed, one, "one-host engine") >= 1
    warm = warm_rays_per_s([("one_host", one, trace), ("two_hosts", two, trace),
                            ("two_hosts", two, trace), ("one_host", one, trace)],
                           args)
    kill["rays_per_s_one_host"] = one_report["rays_per_s"]
    kill["rays_per_s_two_hosts_no_kill"] = two_report["rays_per_s"]
    kill["dispatches_per_host_no_kill"] = {
        h: v["dispatches"] for h, v in two_report["cluster"]["hosts"].items()}
    kill["warm_rays_per_s"] = warm
    kill["card"] = smi("name,power.limit")
    print(f"cluster kill: {json.dumps(kill)}", flush=True)
    out["kill"] = kill
    # (b)
    chaos = cluster_run(CLUSTER_ARGV + ["--inject-faults"])[0]
    assert chaos["faults_injected"]["host_slow"] >= 1, chaos
    print(f"cluster chaos: {json.dumps(chaos)}", flush=True)
    out["chaos"] = chaos
    # (c)
    trace_out = ROOT / "build" / "cluster_trace.json"
    metrics_out = ROOT / "build" / "cluster_metrics.prom"
    traced, report, engine, _, _ = cluster_run(
        CLUSTER_ARGV + CLUSTER_KILL + ["--trace-out", str(trace_out),
                                       "--metrics-out", str(metrics_out)])
    obs = report["observability"]
    assert obs["integrity"]["ok"] and obs["chrome_integrity"]["ok"], obs
    names = {s.name for s in engine.tracer.spans()}
    assert {"host.kill", "tile.requeue", "tile.abandon"} <= names, names
    prom = metrics_out.read_text()
    for family, kind in (("engine_host_dispatches_total", "counter"),
                         ("engine_host_tile_service_seconds", "histogram"),
                         ("engine_host_service_ewma_seconds", "gauge"),
                         ("engine_host_state", "gauge")):
        assert f"# TYPE {family} {kind}" in prom, family
    assert 'engine_host_state{host="1"} 3' in prom, "host 1 not dead"
    busy = obs["device_busy"]
    k2_spans = traced["launches_accounted"]["k2"]
    assert busy["busy_share"] is not None and 0 < busy["busy_share"] <= 1
    assert busy["kernel_spans"] == report["engine"]["dispatches"] - \
        traced["requeued_tiles"] <= k2_spans, (busy, traced)
    traced.update(recovery_from_trace(engine.tracer))
    traced.update({"device_busy": busy, "integrity": obs["integrity"],
                   "chrome_integrity": obs["chrome_integrity"],
                   "trace_bytes": trace_out.stat().st_size,
                   "card": smi("name,power.limit")})
    print(f"cluster traced: {json.dumps(traced)}", flush=True)
    out["traced"] = traced
    # (d)
    mesh = sharding.plcore_mesh(devices=[DEV_INDEXED] * PERCELL_CELLS)
    sharded, report, engine, _, _ = cluster_run(
        CLUSTER_ARGV + CLUSTER_KILL + ["--shard-weights", "--route-by-shard",
                                       "--percell-dispatch"],
        shard_mesh=mesh)
    groups = [h.mesh for h in engine.pool]
    assert [len(g) for g in groups] == [PERCELL_CELLS // 2] * 2, groups
    assert report["percell"]["percell_tiles"] == \
        report["engine"]["dispatches"], report["percell"]
    sharded["images_equal_replicated_one_host"] = serve.compare_images(
        engine, one, "replicated single-host engine")
    sharded["percell"] = report["percell"]
    sharded["cells_per_host"] = [len(g) for g in groups]
    print(f"cluster sharded: {json.dumps(sharded)}", flush=True)
    out["sharded"] = sharded
    return out


# ----------------------------------------------------------- LM serving --
# phase (a): every arch's smoke_config, the card against the CPU on the
# same weights (a CPU torch.Generator draw moved to the card), TF32 off
LM_BATCH, LM_PROMPT, LM_TEACHER_STEPS = 2, 17, 4
LM_PREFILL_TOL, LM_DECODE_TOL = 1e-4, 2e-3
# phase (b): qwen2-1.5b at full width and depth through serve --mode lm
# --full, at serve's defaults and at one 2048-token prompt (two
# attn_chunk chunks of 1024)
LM_ARCH = "qwen2-1.5b"
LM_SERVE_SHAPES = ((4, 64), (1, 2048))
LM_DECODE_TOKENS = 16
LM_PROFILE_STEPS = 4
# phase (c): the bf16-vs-f32 gap of LM_ARCH's prefill logits at full
# width and 2 layers, weights torch.Generator().manual_seed(0) on the CPU,
# prompt 2 x 64 from np.random.default_rng(0): the reference's own gap,
# jitted as its serve runs it, measured on the CPU by
# tests/lm_precision_gap.py (0.0522 of logits; op by op 0.0508, the port on
# the CPU 0.0497). The card's gap may be at most twice it.
LM_GAP_LAYERS = 2
LM_REF_BF16_GAP = 0.052239418029785156


def lm_batch(cfg, batch: int, prompt: int, rng) -> dict:
    """Tokens (prompt + LM_TEACHER_STEPS teacher-forced ones) from numpy,
    the VLM's patches and the enc-dec frames 0.1 * normal."""
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt + LM_TEACHER_STEPS)).astype(np.int32))}
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy((0.1 * rng.standard_normal(
            (batch, cfg.vlm.n_patches, cfg.d_model))).astype(np.float32))
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy((0.1 * rng.standard_normal(
            (batch, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32))
    return out


def lm_teacher_forced(model, params, batch: dict, prompt: int) -> list:
    """Prefill of the prompt, then LM_TEACHER_STEPS decode steps fed the
    batch's next tokens: the logits of each, on the host."""
    pre = {k: (v[:, :prompt] if k == "tokens" else v) for k, v in batch.items()}
    cap = prompt + LM_TEACHER_STEPS + 1 + model.prefix_len()
    cache, logits = model.prefill(params, pre, cap)
    out = [logits]
    for i in range(LM_TEACHER_STEPS):
        tok = batch["tokens"][:, prompt + i:prompt + i + 1]
        cache, logits = model.decode(params, cache, tok, prompt + i)
        out.append(logits)
    return [t.float().cpu() for t in out]


def lm_smoke_phase() -> dict:
    """(a) Every arch at its smoke_config: prefill and LM_TEACHER_STEPS
    teacher-forced decode steps on the card against the port on the CPU,
    same weights and tokens; prefill logits within LM_PREFILL_TOL, decode
    logits within LM_DECODE_TOL. The MoE dispatch at capacity factor 0.5
    (the reference test's tight config): the keep mask of a layer's
    routing on the card equals the CPU's."""
    rows = {}
    for arch in list_archs():
        cfg = smoke_config(arch)
        model = build_model(cfg)
        params = init_params(model.param_decls(),
                             torch.Generator().manual_seed(0), cfg.param_dtype)
        batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, np.random.default_rng(0))
        cpu = lm_teacher_forced(model, params, batch, LM_PROMPT)
        card = lm_teacher_forced(model, bridge.to_device(params, DEV),
                                 bridge.to_device(batch, DEV), LM_PROMPT)
        errs = [float((a - b).abs().max()) for a, b in zip(card, cpu)]
        assert all(bool(torch.isfinite(t).all()) for t in card), arch
        assert errs[0] <= LM_PREFILL_TOL, (arch, "prefill", errs)
        assert max(errs[1:]) <= LM_DECODE_TOL, (arch, "decode", errs)
        rows[arch] = {"family": cfg.family, "prefill_max_abs_err": errs[0],
                      "decode_max_abs_err": errs[1:]}
        print(f"lm {arch}: {json.dumps(rows[arch])}", flush=True)

    cfg = smoke_config("moonshot-v1-16b-a3b")
    tight = cfg.replace(moe=dataclasses.replace(
        cfg.moe, n_shared_experts=0, first_k_dense=0, capacity_factor=0.5))
    params = init_params(build_model(tight).param_decls(),
                         torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in params["layers"].items()
          if not isinstance(v, dict)}
    lp["experts"] = {k: v[0] for k, v in params["layers"]["experts"].items()}
    x = torch.randn((2, 32, tight.d_model), generator=torch.Generator().manual_seed(1))
    got = []
    for dev in ("cpu", DEV):
        lpd, xd = bridge.to_device(lp, dev), x.to(dev)
        probs = torch.softmax(xd.reshape(-1, tight.d_model).float()
                              @ lpd["router"].float(), dim=-1)
        keep = moe.route(tight, probs)["keep"].cpu()
        y, aux = moe.moe_apply(tight, lpd, xd)
        got.append((keep, y.cpu(), float(aux)))
    (k_cpu, y_cpu, a_cpu), (k_card, y_card, a_card) = got
    assert torch.equal(k_cpu, k_card), "MoE keep mask differs on the card"
    assert not bool(k_cpu.all()), "capacity 0.5 dropped nothing"
    moe_row = {"capacity_factor": 0.5, "kept": int(k_card.sum()),
               "pairs": k_card.numel(),
               "y_max_abs_err": float((y_card - y_cpu).abs().max()),
               "aux_abs_err": abs(a_card - a_cpu)}
    assert moe_row["y_max_abs_err"] <= LM_PREFILL_TOL, moe_row
    print(f"lm moe dispatch: {json.dumps(moe_row)}", flush=True)
    return {"archs": rows, "moe_dispatch": moe_row}


def lm_bounds(cfg, model, batch: int, prompt: int, peaks: dict) -> dict:
    """Least times of one prefill of ``batch`` x ``prompt`` tokens and of
    one decode step at the end of ``LM_DECODE_TOKENS``: the bf16 weights
    read once (every layer, the tied embedding for the logits) and the KV
    cache read and written, at HBM_BYTES_PER_S; the products (2 FLOP per
    weight per token, the logits of the last position only, attention over
    the causal pairs only) at the bf16 tensor-core peak."""
    layer_w = param_count(model.param_decls()["layers"])
    embed_w = cfg.vocab_size * cfg.d_model
    L, H, K, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w_bytes = 2 * (layer_w + embed_w)
    kv_row = 2 * L * K * hd * 2           # k and v of one position, bf16
    pairs = prompt * (prompt + 1) // 2
    pre_flop = 2.0 * batch * (prompt * layer_w + embed_w) \
        + 4.0 * batch * L * H * hd * pairs
    pre_bytes = w_bytes + batch * prompt * kv_row
    ctx = prompt + LM_DECODE_TOKENS
    dec_flop = 2.0 * batch * (layer_w + embed_w) + 4.0 * batch * L * H * hd * ctx
    dec_bytes = w_bytes + batch * ctx * kv_row
    out = {"weight_bytes_bf16": w_bytes}
    for name, flop, nb in (("prefill", pre_flop, pre_bytes),
                           ("decode_step", dec_flop, dec_bytes)):
        ms_b, ms_f = 1e3 * nb / HBM_BYTES_PER_S, 1e3 * flop / peaks["bf16"]
        out[name] = {"flop": flop, "bytes": nb, "bytes_ms": ms_b,
                     "flop_ms": ms_f, "bound_ms": max(ms_b, ms_f),
                     "bound_by": "bytes" if ms_b >= ms_f else "operations"}
    return out


def lm_measure(model, params, batch: dict, cap: int, prompt: int) -> dict:
    """Warm prefill ms (CUDA events, 3 calls after one), then
    LM_DECODE_TOKENS greedy decode steps: device ms per step (CUDA events
    over the steps) beside the host's ms to enqueue them (no sync inside),
    and LM_PROFILE_STEPS more steps under torch.profiler: kernels per step
    and their summed device time ("not measured" without device events)."""
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    prefill_ms, (cache, logits) = cuda_ms(lambda: prefill(params, batch, cap), 3)
    tok = serve.next_token(logits)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(LM_DECODE_TOKENS):
        cache, logits = decode(params, cache, tok, prompt + i)
        tok = serve.next_token(logits)
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    out = {"prefill_ms": prefill_ms,
           "decode_ms_per_step": start.elapsed_time(end) / LM_DECODE_TOKENS,
           "host_enqueue_ms_per_step": 1e3 * host_s / LM_DECODE_TOKENS}

    from torch.profiler import ProfilerActivity, profile
    cache, logits = prefill(params, batch, cap)
    tok = serve.next_token(logits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(LM_PROFILE_STEPS):
            cache, logits = decode(params, cache, tok, prompt + i)
            tok = serve.next_token(logits)
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if spans:
        kernel_us = sum(t for t, _ in spans)
        gemm_us = sum(t for t, n in spans if "gemm" in n.lower())
        out.update({"kernels_per_decode_step": len(spans) / LM_PROFILE_STEPS,
                    "kernel_ms_per_decode_step":
                        kernel_us / 1e3 / LM_PROFILE_STEPS,
                    "gemm_share_of_kernel_time": gemm_us / kernel_us})
    else:
        out["kernel_ms_per_decode_step"] = "not measured"
    return out


def lm_serve_phase(peaks: dict) -> dict:
    """(b) LM_ARCH at full width and depth: ``serve --mode lm --full`` at
    each of LM_SERVE_SHAPES (kernel counters zeroed before and read after:
    the LM path reaches no kernel, as the reference's reaches no Pallas
    call), then the warm numbers of ``lm_measure`` on one weight draw,
    peak memory, tok/s and the bounds of ``lm_bounds``."""
    rows = {}
    for b, s in LM_SERVE_SHAPES:
        argv = ["--mode", "lm", "--full", "--arch", LM_ARCH, "--batch", str(b),
                "--prompt-len", str(s), "--decode-tokens", str(LM_DECODE_TOKENS)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        out = serve.main(argv)
        launches = read_launches()
        assert len(out["sample_tokens"]) == min(8, LM_DECODE_TOKENS + 1), out
        assert all(0 <= t < get_config(LM_ARCH).vocab_size
                   for t in out["sample_tokens"]), out
        rows[f"b{b}_s{s}"] = {"serve": out,
                              "serve_peak_mem_bytes":
                                  torch.cuda.max_memory_allocated(),
                              "kernel_launches": {
                                  k: launches[k] for k in
                                  ("fused_plcore_call", "two_pass_plcore_call",
                                   "rmcm_matmul")}}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve.build_parser().parse_args(
        ["--mode", "lm", "--full", "--arch", LM_ARCH])
    lm = serve.lm_session(args)
    cfg, model, params = lm["cfg"], lm["model"], lm["params"]
    for b, s in LM_SERVE_SHAPES:
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (b, s), device=DEV, dtype=torch.int32,
            generator=torch.Generator(DEV).manual_seed(1))}
        cap = s + LM_DECODE_TOKENS + 1
        torch.cuda.reset_peak_memory_stats()
        row = rows[f"b{b}_s{s}"]
        row.update(lm_measure(model, params, batch, cap, s))
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        row["decode_tok_per_s"] = 1e3 * b / row["decode_ms_per_step"]
        row["prefill_tok_per_s"] = 1e3 * b * s / row["prefill_ms"]
        row["bounds"] = lm_bounds(cfg, model, b, s, peaks)
        row["card"] = smi("name,power.limit")
        print(f"lm {LM_ARCH} full b{b} s{s}: {json.dumps(row)}", flush=True)
    return {"arch": LM_ARCH, "params": cfg.param_count(),
            "layers": cfg.n_layers, "shapes": rows}


def lm_precision_phase() -> dict:
    """(c) LM_ARCH at full width and LM_GAP_LAYERS layers on the card: the
    bf16 config's prefill logits against the same weights in float32, the
    gap (largest |bf16 - f32|) at most twice the reference's own
    (LM_REF_BF16_GAP, tests/lm_precision_gap.py's weights and prompt)."""
    cfg = get_config(LM_ARCH).replace(n_layers=LM_GAP_LAYERS)
    params = bridge.to_device(init_params(
        build_model(cfg).param_decls(), torch.Generator().manual_seed(0)), DEV)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(DEV)
    logits = {}
    for dt in ("bfloat16", "float32"):
        model = build_model(cfg.replace(dtype=dt))
        _, out = model.prefill(model.serving_params(params), {"tokens": tokens})
        logits[dt] = out.float()
    gap = float((logits["bfloat16"] - logits["float32"]).abs().max())
    row = {"arch": LM_ARCH, "n_layers": LM_GAP_LAYERS, "gap": gap,
           "reference_gap_cpu": LM_REF_BF16_GAP,
           "gate": 2 * LM_REF_BF16_GAP}
    assert bool(torch.isfinite(logits["bfloat16"]).all()), row
    assert gap <= 2 * LM_REF_BF16_GAP, row
    print(f"lm precision: {json.dumps(row)}", flush=True)
    return row


def lm_phase(peaks: dict) -> dict:
    """The LM serving path: phases (a), (c), then (b)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {"smoke": lm_smoke_phase(), "precision": lm_precision_phase(),
            "serve": lm_serve_phase(peaks)}


# LM training (lm_train_phase). (a) every arch's smoke config: one step on
# the card against the port on the CPU, same weights and batch; the
# gradient bound is PR 16's card-against-CPU bound of the NeRF step
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_TOL = 1e-5, 1e-3
# (b) LM_ARCH at full width and depth (remat on, f32 AdamW): 5 steps at
# B 4 x S 512, then SHAPES["train_4k"]'s sequence with its global batch of
# 256 cut to 1 for one card
LM_TRAIN_SHAPES = ((4, 512, 5), (1, 4096, 3))
LM_TRAIN_OPT_BYTES = 28    # per param: read p, g, m, v; write p, m, v (f32)
# (c) the driver: the reference tests' flags (tests/test_train_driver.py);
# a 6-step run's last loss against its first is batch noise at this size
# (the reference falls on 7 of seeds 0-9, the port on 6), so learning is
# held over LM_TRAIN_LEARN_STEPS steps: the mean of the last 5 losses
# below the mean of the first 5 (on the CPU, seeds 0-7 of each of the four
# runs, the gap is 0.17 to 0.44 nats)
LM_TRAIN_DRIVER = (("grad_accum", {"steps": 6, "grad_accum": 2}),
                   ("qat", {"steps": 6, "qat": True}),
                   ("compress", {"steps": 6, "compress": True}),
                   ("kimi_int8", {"steps": 4, "arch": "kimi-k2-1t-a32b"}))
LM_TRAIN_LEARN_STEPS = 100
LM_TRAIN_DRIVER_RTOL = 1e-4


def lm_train_batch(cfg, batch: int, seq: int, step: int = 0) -> dict:
    """The driver's batch of ``step``: the token stream's tokens and
    labels and the stub modality inputs, on the CPU."""
    out = synthetic_batch(TokenStreamConfig(cfg.vocab_size), step, batch, seq)
    out.update(train.extra_inputs(cfg, batch))
    return out


def grad_gap(want: dict, got: dict) -> tuple:
    """(worst leaf, its largest |got - want| over the largest |g| of the
    whole of ``want``) of two gradient trees, compared on the host."""
    w = dict(zip(_leaf_names(want), tree_leaves(want)))
    g = dict(zip(_leaf_names(got), tree_leaves(got)))
    gmax = max(float(v.abs().max()) for v in w.values())
    gaps = {k: float((g[k].float().cpu() - w[k].float().cpu()).abs().max())
            / gmax for k in w}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def _leaf_names(tree, path: str = "") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}" if path else k)]
    return [path]


def lm_train_smoke_phase() -> dict:
    """(a) Every arch's smoke config: the loss and gradients of one train
    step on the card against the port on the CPU (weights from
    ``torch.Generator().manual_seed(0)``, the driver's batch of 2 x 32),
    then the whole step (AdamW in the arch's moment type) on the card."""
    rows = {}
    card = smi("name,power.limit")
    for arch in list_archs():
        cfg = smoke_config(arch)
        model = build_model(cfg)
        params = init_params(model.param_decls(),
                             torch.Generator().manual_seed(0), cfg.param_dtype)
        batch = lm_train_batch(cfg, 2, 32)
        cpu_loss, cpu_g = loss_and_grads(model.loss, params, batch)
        cparams = bridge.to_device(params, DEV)
        cbatch = bridge.to_device(batch, DEV)
        loss, grads = loss_and_grads(model.loss, cparams, cbatch)
        worst, gap = grad_gap(cpu_g, grads)
        opt_cfg = AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                             moment_dtype=cfg.moment_dtype)
        opt = bridge.to_device(init_params(
            opt_state_decls(model.param_decls(), opt_cfg),
            torch.Generator().manual_seed(0), "float32"), DEV)
        _, opt, met = make_train_step(model, opt_cfg)(cparams, opt, cbatch)
        row = {"family": cfg.family, "moments": cfg.moment_dtype,
               "loss_card": float(loss), "loss_cpu": float(cpu_loss),
               "loss_rel_err": abs(float(loss) - float(cpu_loss))
               / abs(float(cpu_loss)),
               "worst_grad_leaf": worst, "worst_grad_gap_of_max_g": gap,
               "step_loss": float(met["loss"]),
               "step_grad_norm": float(met["grad_norm"]),
               "step": int(opt["step"]), "card": card}
        assert row["loss_rel_err"] <= LM_TRAIN_LOSS_RTOL, (arch, row)
        assert gap <= LM_TRAIN_GRAD_TOL, (arch, row)
        assert math.isfinite(row["step_loss"]) and row["step"] == 1, row
        rows[arch] = row
        print(f"lm train {arch}: {json.dumps(row)}", flush=True)
    return rows


def lm_train_bounds(cfg, model, batch: int, seq: int, peaks: dict) -> dict:
    """Least time of one train step: the products of forward (2 FLOP per
    weight per token), backward (4) and the remat recompute of the layers'
    forward (2 per layer weight), i.e. 6 N T + 2 N_layers T, and attention
    over the causal pairs (QK^T and PV, 4 FLOP per pair per head dim,
    forward, backward twice, recompute) at the bf16 tensor-core peak; plus
    AdamW's LM_TRAIN_OPT_BYTES per param at HBM_BYTES_PER_S (the two run
    one after the other)."""
    decls = model.param_decls()
    n, n_layers = param_count(decls), param_count(decls["layers"])
    tokens = batch * seq
    pairs = seq * (seq + 1) // 2
    dense = 6.0 * n * tokens + 2.0 * n_layers * tokens
    attn = 4 * 4.0 * batch * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs
    flop_ms = 1e3 * (dense + attn) / peaks["bf16"]
    opt_bytes = LM_TRAIN_OPT_BYTES * n
    opt_ms = 1e3 * opt_bytes / HBM_BYTES_PER_S
    return {"params": n, "tokens": tokens, "flop_dense": dense,
            "flop_attention": attn, "flop_ms_bf16_peak": flop_ms,
            "optimizer_bytes": opt_bytes, "optimizer_ms_hbm": opt_ms,
            "bound_ms": flop_ms + opt_ms}


def _kernel_kind(name: str) -> str:
    """A device kernel's kind by its name: cuBLAS's and CUTLASS's
    matrix products, PyTorch's elementwise and reduction kernels, or
    other (copies, index and sort kernels, ...)."""
    n = name.lower()
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm"
    if "elementwise" in n:
        return "elementwise"
    if "reduce" in n:
        return "reduce"
    return "other"


def lm_train_profile(step, state: dict, batch) -> dict:
    """One more step of ``state`` (``{"params", "opt"}``, updated in place)
    under torch.profiler: kernels, their summed device ms, its share by
    kernel kind and the five kernels that take the most ("not measured"
    without device events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return {"kernel_ms_per_step": "not measured"}
    us = sum(t for t, _ in spans)
    kinds, names = {}, {}
    for t, n in spans:
        kinds[_kernel_kind(n)] = kinds.get(_kernel_kind(n), 0) + t
        names[n[:90]] = names.get(n[:90], 0) + t
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    return {"kernels_per_step": len(spans), "kernel_ms_per_step": us / 1e3,
            "gemm_share_of_kernel_time": kinds.get("gemm", 0) / us,
            "kernel_share_by_kind": {k: v / us for k, v in kinds.items()},
            "top_kernels_ms": {n: t / 1e3 for n, t in top}}


def lm_train_split(model, opt_cfg, state: dict, batch) -> dict:
    """One more step of ``state`` in its two halves, each timed with CUDA
    events: the loss and gradients (forward, remat recompute, backward),
    then AdamW."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = loss_and_grads(model.loss, state["params"], batch)
    ev[1].record()
    state["params"], state["opt"], _ = adam_update(
        opt_cfg, state["params"], grads, state["opt"])
    ev[2].record()
    ev[2].synchronize()
    return {"loss_and_grads_ms": ev[0].elapsed_time(ev[1]),
            "adamw_ms": ev[1].elapsed_time(ev[2])}


def lm_train_steps(step, state: dict, cfg, batch: int, seq: int,
                   n_steps: int):
    """``n_steps`` steps of ``state`` (``{"params", "opt"}``, updated in
    place, so that no caller holds an old state) on the driver's batches
    (step i's batch for step i): each step's loss, its device ms (CUDA
    events) and the host's ms to enqueue it (the step has no host sync
    inside); peak memory. Returns (the last batch, the row)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, dev_ms, host_ms = [], [], []
    for i in range(n_steps):
        b = bridge.to_device(lm_train_batch(cfg, batch, seq, i), DEV)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        state["params"], state["opt"], met = step(state["params"],
                                                  state["opt"], b)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(met["loss"]))
    warm = slice(1, None)                     # the first step warms cuBLAS
    return b, {
        "losses": losses, "ms_per_step_first": dev_ms[0],
        "ms_per_step_warm": float(np.mean(dev_ms[warm])),
        "ms_per_step_warm_all": dev_ms[warm],
        "host_enqueue_ms_per_step_warm": float(np.mean(host_ms[warm])),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def lm_train_full_phase(peaks: dict) -> dict:
    """(b) LM_ARCH at full width and depth (remat on, bf16 compute, f32
    masters and AdamW moments), weights from ``torch.Generator(cuda)
    .manual_seed(0)``: LM_TRAIN_SHAPES' steps (counters zeroed before the
    first and read after the last: the path reaches no kernel), a
    profiled step and a step timed in its halves (``lm_train_split``); then
    at B 4 x S 512 the loss and gradients with remat off against remat on,
    each with its peak memory above the state resident before its call."""
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    decls = model.param_decls()
    # the schedule spans every step run: each shape's, its profiled one
    # and its split one
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=1,
                         total_steps=sum(n + 2 for _, _, n in LM_TRAIN_SHAPES))
    torch.cuda.empty_cache()
    gen = torch.Generator(DEV).manual_seed(0)
    state = {"params": init_params(decls, gen, cfg.param_dtype),
             "opt": init_params(opt_state_decls(decls, opt_cfg), gen,
                                "float32")}
    step = make_train_step(model, opt_cfg)
    card = smi("name,power.limit")
    rows = {}
    zero_launches()
    for b, s, n in LM_TRAIN_SHAPES:
        batch, row = lm_train_steps(step, state, cfg, b, s, n)
        assert all(math.isfinite(x) for x in row["losses"]), row
        if (b, s) == LM_TRAIN_SHAPES[0][:2]:
            assert row["losses"][-1] < row["losses"][0], row
        row.update(lm_train_profile(step, state, batch))
        row.update(lm_train_split(model, opt_cfg, state, batch))
        row["bounds"] = lm_train_bounds(cfg, model, b, s, peaks)
        row["card"] = card
        rows[f"b{b}_s{s}"] = row
        print(f"lm train {LM_ARCH} full b{b} s{s}: {json.dumps(row)}",
              flush=True)
    launches = read_launches()
    kernels = {k: launches[k] for k in ("fused_plcore_call",
                                        "two_pass_plcore_call", "rmcm_matmul")}
    assert not any(kernels.values()), kernels

    # (c) remat off against on, on the first shape's last batch
    b, s, n = LM_TRAIN_SHAPES[0]
    batch = bridge.to_device(lm_train_batch(cfg, b, s, n - 1), DEV)
    got, peak, base = {}, {}, {}
    for remat in (True, False):
        m = build_model(cfg.replace(remat=remat))
        torch.cuda.synchronize()
        base[remat] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got[remat] = loss_and_grads(m.loss, state["params"], batch)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated() - base[remat]
    worst, gap = grad_gap(got[True][1], got[False][1])
    remat_row = {"loss_remat_on": float(got[True][0]),
                 "loss_remat_off": float(got[False][0]),
                 "loss_abs_diff": abs(float(got[True][0])
                                      - float(got[False][0])),
                 "worst_grad_leaf": worst, "worst_grad_gap_of_max_g": gap,
                 "peak_above_state_bytes_remat_on": peak[True],
                 "peak_above_state_bytes_remat_off": peak[False],
                 "resident_state_bytes": base[True], "card": card}
    assert peak[True] < peak[False], remat_row
    assert math.isfinite(remat_row["loss_remat_off"]), remat_row
    print(f"lm train {LM_ARCH} full remat: {json.dumps(remat_row)}",
          flush=True)
    return {"arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "remat": cfg.remat, "shapes": rows, "remat_off_vs_on": remat_row,
            "kernel_launches": kernels}


def lm_train_start(directory: str, arch: str) -> None:
    """A step-0 checkpoint of ``arch``'s smoke config drawn on the CPU
    (``torch.Generator().manual_seed(0)``, zero moments), so that the
    driver on the card and on the CPU start from the same weights."""
    cfg = smoke_config(arch)
    decls = build_model(cfg).param_decls()
    gen = torch.Generator().manual_seed(0)
    params = init_params(decls, gen, cfg.param_dtype)
    opt = init_params(opt_state_decls(
        decls, AdamConfig(moment_dtype=cfg.moment_dtype)), gen, "float32")
    ck = Checkpointer(directory)
    ck.save(0, {"params": params, "opt": opt},
            {"train_step": 0, "arch": arch, "losses_tail": []})
    ck.wait()


def lm_train_driver_phase() -> dict:
    """(c) ``train.run`` on the card for LM_ARCH's smoke config: restart 12
    against 8 + 4 at rtol 1e-4; LM_TRAIN_DRIVER's runs from one step-0
    checkpoint on the card and on the CPU (finite; first and last loss
    equal at rtol LM_TRAIN_DRIVER_RTOL); each again on the card for
    LM_TRAIN_LEARN_STEPS steps, the mean of its last 5 losses below the
    mean of its first 5."""
    import tempfile

    def args(device="cuda", **kw):
        argv = ["--arch", LM_ARCH, "--smoke", "--steps", "8", "--batch", "4",
                "--seq", "32", "--log-every", "1000", "--device", device]
        for k, v in kw.items():
            argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
        return train.build_parser().parse_args(argv)

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        full = train.run(args(steps=12, ckpt_dir=d1, ckpt_every=100))
        train.run(args(steps=12, stop_after=8, ckpt_dir=d2, ckpt_every=8))
        resumed = train.run(args(steps=12, ckpt_dir=d2, ckpt_every=100))
    rows = {"restart": {"full_final": full["final_loss"],
                        "resumed_final": resumed["final_loss"],
                        "resumed_steps": resumed["steps"]}}
    assert resumed["steps"] == 4, rows
    assert math.isclose(full["final_loss"], resumed["final_loss"],
                        rel_tol=1e-4), rows
    for name, kw in LM_TRAIN_DRIVER:
        out = {}
        for dev in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as d:
                lm_train_start(d, kw.get("arch", LM_ARCH))
                out[dev] = train.run(args(device=dev, ckpt_dir=d,
                                          ckpt_every=1000, **kw))
        card, cpu = out["cuda"], out["cpu"]
        learn = train.run(args(**{**kw, "steps": LM_TRAIN_LEARN_STEPS}))
        ls = learn["losses"]
        row = {"losses": card["losses"], "cpu_losses": cpu["losses"],
               "falls_in_%d_steps" % kw["steps"]:
                   card["final_loss"] < card["loss_first"],
               "learn_steps": LM_TRAIN_LEARN_STEPS,
               "learn_mean_first5": float(np.mean(ls[:5])),
               "learn_mean_last5": float(np.mean(ls[-5:])),
               "learn_ms_per_step": 1e3 * learn["wall_s"] / LM_TRAIN_LEARN_STEPS}
        assert all(math.isfinite(x) for x in card["losses"] + ls), (name, row)
        assert len(card["losses"]) == kw["steps"], (name, row)
        for a, c in zip(card["losses"], cpu["losses"]):
            assert math.isclose(a, c, rel_tol=LM_TRAIN_DRIVER_RTOL), (name, row)
        assert row["learn_mean_last5"] < row["learn_mean_first5"], (name, row)
        rows[name] = row
    rows["card"] = smi("name,power.limit")
    print(f"lm train driver: {json.dumps(rows)}", flush=True)
    return rows


def lm_train_phase(peaks: dict) -> dict:
    """The LM training path: (a), the driver (c), then full width (b)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return {"smoke": lm_train_smoke_phase(),
            "driver": lm_train_driver_phase(),
            "full": lm_train_full_phase(peaks)}


# (arch, shape, two pods, --opt): the --opt cells beside their baselines
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False, False),
                ("qwen2-1.5b", "train_4k", False, True),
                ("qwen2-1.5b", "prefill_32k", False, False),
                ("qwen2-1.5b", "decode_32k", False, False),
                ("moonshot-v1-16b-a3b", "train_4k", False, False),
                ("moonshot-v1-16b-a3b", "train_4k", False, True),
                ("nerf-icarus", "render_800", False, False),
                ("nerf-icarus", "render_800", True, False))


def dryrun_phase(peaks: dict) -> dict:
    """``dryrun.lower_cell`` for qwen2-1.5b at train_4k, prefill_32k and
    decode_32k on 16 x 16, moonshot-v1-16b-a3b at train_4k, the two
    train_4k cells also ``--opt`` (the models' mesh paths), and
    nerf-icarus render_800 on 16 x 16 and 2 x 16 x 16 (no probes): each
    cell's dominant term, its three roofline terms (modelled for a cluster
    of H100s) and its wall time. The phase
    takes no card memory and leaves the process group state as it found
    it; the roofline's bf16 peak is within 1% of this card's."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh

    ratio = lmesh.PEAK_FLOPS_BF16 / peaks["bf16"]
    assert abs(ratio - 1.0) <= 0.01, (lmesh.PEAK_FLOPS_BF16, peaks["bf16"])
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    pg0 = dist.is_initialized()
    rows = []
    t_all = time.perf_counter()
    for arch, shape, mp, opt in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dryrun.lower_cell(arch, shape, multi_pod=mp, verbose=False,
                              probes=False, optimized=opt)
        assert r["optimized"] == opt
        row = {"arch": arch, "shape": shape, "optimized": opt,
               "mesh": "2x16x16" if mp else "16x16",
               "dominant": r["dominant"], **r["roofline"],
               "useful_flops_ratio": r["useful_flops_ratio"],
               "analytic_ops": sorted(r["counted_by"]["analytic"]),
               "wall_s": time.perf_counter() - t0}
        print(f"dryrun: {json.dumps(row)}", flush=True)
        rows.append(row)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == mem0
    assert dist.is_initialized() == pg0
    out = {"cells": rows, "wall_s": time.perf_counter() - t_all,
           "peak_bf16_ratio": ratio, "card_memory_taken": 0}
    print(f"dryrun phase: wall {out['wall_s']:.1f} s, bf16 peak ratio "
          f"{ratio:.5f}, card memory unchanged", flush=True)
    return out


# ------------------------------------------------------------ mesh paths --
# ranks of one launch share this card: NCCL refuses two ranks on one
# device, so the phase tries it once, prints why, and runs gloo (collectives
# of CUDA tensors through the host)
MESH_BACKEND = "gloo"
MESH_ARCH_EP = "moonshot-v1-16b-a3b"
MESH_EP_LAYERS = 4           # the depth cut: the dense layer and 3 MoE layers
MESH_EP_RANKS = 4            # (data 1, model 4): 16 experts per rank
MESH_EP_BATCH = (4, 512)
MESH_SPLIT_RANKS = 8         # (data 1, model 8): 12 heads, batch split taken
MESH_SPLIT_BATCH = (8, 512)
# the depth cut of (b): at its 28 layers the 8 ranks' AdamW state beside
# the logits torch 2.11's DTensor gathers over the vocab does not fit one
# 80 GB card (out of memory at 77 GB in the first step); at 12 layers the
# ranks peak at 7.93 GB each and ran out of memory in 2 of 4 runs; 6
# layers leave ~9 GB free. No other model axis of at most 8 ranks leaves
# 12 heads undivided and divides the batch of 8
MESH_SPLIT_LAYERS = 6
MESH_TRAIN_STEPS = 3
MESH_TIMED = 3               # timed fwd+bwd steps after one warm-up
# the CPU tests' tolerances (tests/test_torch_mesh_paths.py), held in f32
MESH_LOSS_ATOL = 1e-3
MESH_GRAD_OF_MAX = 1e-3
MESH_Y_ATOL = 1e-4
# bf16 runs of the same paths (reported; gated at this relative gap)
MESH_BF16_RTOL = 1e-2
MESH_RANK_TIMEOUT = 600


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(n: int, which: str, out_dir: pathlib.Path,
                timeout: int = MESH_RANK_TIMEOUT, check: bool = True) -> list:
    """``python chip_smoke.py --mesh-rank WHICH OUT`` in ``n`` processes on
    this card, a torchrun-style launch (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; no LOCAL_RANK: every rank takes cuda:0); their JSON
    results in rank order. A rank that fails stops the others, and every
    process is stopped before this returns."""
    out_dir.mkdir(parents=True, exist_ok=True)
    port = str(_free_port())
    procs, logs = [], []
    try:
        for r in range(n):
            env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
            env.update({"PYTHONPATH": str(ROOT / "src"),
                        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                        "WORLD_SIZE": str(n), "RANK": str(r)})
            logs.append(open(out_dir / f"{which}_rank{r}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-X", "faulthandler", str(ROOT / "chip_smoke.py"),
                 "--mesh-rank", which, str(out_dir)], env=env, cwd=ROOT,
                stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        t_end = time.time() + timeout
        first_failed = None
        while any(pr.poll() is None for pr in procs):
            failed = [r for r, pr in enumerate(procs) if pr.poll()]
            if failed:
                first_failed = failed[0]
                break
            if time.time() > t_end:
                break
            time.sleep(0.5)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    errs = []
    for f in logs:
        f.seek(0)
        errs.append(f.read())
        f.close()
    if check:
        bad = [r for r, pr in enumerate(procs) if pr.returncode]
        if bad:
            r = bad[0] if first_failed is None else first_failed
            others = {q: errs[q].strip().splitlines()[-1:] for q in bad if q != r}
            raise AssertionError(
                f"{which} rank {r} failed first (rc {procs[r].returncode}; "
                f"the others' last lines {others}): {errs[r][-6000:]}")
    out = []
    for r in range(n):
        f = out_dir / f"{which}_rank{r}.json"
        out.append(json.loads(f.read_text()) if f.exists() else
                   {"error": errs[r][-2000:]})
    return out


def _count_calls(module, name: str, counts: dict) -> None:
    fn = getattr(module, name)

    def wrapped(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)
    setattr(module, name, wrapped)


def _timed(fn, n: int) -> list:
    """ms of ``n`` calls of ``fn``, each ended by a device synchronize and a
    barrier of the ranks."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _rank_nccl_probe(out_dir: str) -> None:
    """Two ranks on this card over nccl: one all-reduce, or the cause."""
    from repro_torch.launch.mesh import make_host_mesh

    row = {}
    try:
        with make_host_mesh(1, backend="nccl"):
            t = torch.ones(1, device=DEV)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            row["ok"] = float(t) == dist.get_world_size()
    except Exception as e:   # the cause is the result
        row["refused"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    path = pathlib.Path(out_dir) / f"nccl_probe_rank{os.environ['RANK']}.json"
    path.write_text(json.dumps(row))


def _rank_ep(out_dir: str) -> None:
    """(a) MESH_ARCH_EP at full width, MESH_EP_LAYERS layers, on a (1, 4)
    mesh: forward and backward through the EP path (DTensors laid out by
    Rules, the activation context installed) against the dense path on
    rank 0 (the same weights, drawn on this card from seed 0, and batch);
    the first MoE layer's y on one hidden state; in f32 (held to the CPU
    tests' tolerances) and bf16 (the config's dtype; timed)."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import spmd
    from repro_torch.runtime.sharding import Rules, set_activation_context

    calls: dict = {}
    _count_calls(moe, "_moe_apply_ep", calls)
    base = get_config(MESH_ARCH_EP).replace(n_layers=MESH_EP_LAYERS)
    B, S = MESH_EP_BATCH
    row = {"rows": {}}
    with make_host_mesh(MESH_EP_RANKS, backend=MESH_BACKEND) as mesh:
        rules = Rules()
        lead = dist.get_rank() == 0
        for label, cfg in (("f32", base.replace(dtype="float32")),
                           ("bf16", base)):
            model = build_model(cfg)
            decls = model.param_decls()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = train.init_sharded(decls, torch.Generator(DEV).manual_seed(0),
                                        cfg.param_dtype, mesh, rules)
            batch = bridge.to_device(lm_train_batch(cfg, B, S), DEV)
            db = train._mesh_batch(batch, mesh, rules)
            h = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
                DEV).manual_seed(1), device=DEV).to(getattr(torch, cfg.dtype))
            lp = {k: v[0] for k, v in params["layers"].items()
                  if not isinstance(v, dict)}
            lp.update({k: {kk: vv[0] for kk, vv in v.items()}
                       for k, v in params["layers"].items()
                       if isinstance(v, dict)})
            cdt = getattr(torch, cfg.dtype)
            lp = {k: ({kk: vv.to(cdt) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(cdt))
                  for k, v in lp.items()}
            step_loss = spmd.FsdpLoss(model, mesh, rules).loss
            got = {}

            def ep_step():
                with spmd.sharded_program():
                    got["loss"], got["grads"] = loss_and_grads(
                        step_loss, params, db)

            set_activation_context(mesh, rules)
            try:
                before = calls.get("_moe_apply_ep", 0)
                ep_step()
                r = {"ep_calls_per_step": calls.get("_moe_apply_ep", 0) - before}
                r["ep_ms"] = _timed(ep_step, MESH_TIMED) if label == "bf16" else None
                with spmd.sharded_program():
                    hd = distribute_tensor(h, mesh, [Replicate(), Replicate()],
                                           src_data_rank=None)
                    y_ep = moe.moe_apply(cfg, spmd.fsdp_gathered(lp, mesh, rules),
                                         hd)[0].full_tensor()
                    loss_ep = float(got["loss"].full_tensor())
            finally:
                set_activation_context(None)
            torch.cuda.synchronize()
            r["peak_bytes_ep"] = torch.cuda.max_memory_allocated()
            grads = got.pop("grads")
            got.clear()
            torch.cuda.empty_cache()
            dist.barrier()
            if lead:
                # the dense path, mesh-free, on the same weights and batch
                torch.cuda.reset_peak_memory_stats()
                full = init_params(decls, torch.Generator(DEV).manual_seed(0),
                                   cfg.param_dtype)
                dense = {}

                def dense_step():
                    dense["loss"], dense["grads"] = loss_and_grads(
                        model.loss, full, batch)
                dense_step()
                r["dense_ms"] = [1e3 * t for t in _host_timed(
                    dense_step, MESH_TIMED)] if label == "bf16" else None
                lp_full = {k: (v[0].to(cdt) if not isinstance(v, dict) else
                               {kk: vv[0].to(cdt) for kk, vv in v.items()})
                           for k, v in full["layers"].items()}
                y_dense = moe._moe_apply_dense(cfg, lp_full, h)[0]
                r["peak_bytes_dense"] = torch.cuda.max_memory_allocated()
                r["loss_ep"], r["loss_dense"] = loss_ep, float(dense["loss"])
                r["y_max_abs_diff"] = float((y_ep.float() - y_dense.float())
                                            .abs().max())
                dense_leaves = dict(zip(_leaf_names(full),
                                        tree_leaves(dense["grads"])))
                gmax = max(float(v.abs().max()) for v in dense_leaves.values())
                del full["layers"], full["dense_layers"]
                torch.cuda.empty_cache()
            names = _leaf_names(grads)
            gaps = {}
            for name, g in zip(names, tree_leaves(grads)):
                g = g.full_tensor() if isinstance(g, DTensor) else g
                if lead:   # slice by slice: no full-size temporaries
                    want = dense_leaves[name]
                    d = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(g.reshape(-1, g.shape[-1]).split(4096),
                                            want.reshape(-1, g.shape[-1]).split(4096))) \
                        if g.ndim else float((g - want).abs())
                    gaps[name] = d
                del g
                torch.cuda.empty_cache()
            if lead:
                top = sorted(gaps, key=gaps.get, reverse=True)[:5]
                r.update({"worst_grad_leaf": top[0],
                          "worst_grad_gap_of_max_g": gaps[top[0]] / gmax,
                          "next_worst_of_max_g": {k: gaps[k] / gmax
                                                  for k in top[1:]},
                          "max_abs_g": gmax})
                del full, dense, dense_leaves
            del params, grads, lp
            row["rows"][label] = r
            dist.barrier()
    if lead:
        _rank_dump_path(out_dir, "ep", 0, row)
    else:
        _rank_dump_path(out_dir, "ep", int(os.environ["RANK"]),
                        {"rows": {k: {"peak_bytes_ep": v["peak_bytes_ep"]}
                                  for k, v in row["rows"].items()}})


def _rank_dump_path(out_dir: str, which: str, rank: int, row: dict) -> None:
    (pathlib.Path(out_dir) / f"{which}_rank{rank}.json").write_text(
        json.dumps(row))


def _host_timed(fn, n: int) -> list:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _split_argv(model_axis: int) -> list:
    B, S = MESH_SPLIT_BATCH
    argv = ["--arch", LM_ARCH, "--steps", str(MESH_TRAIN_STEPS), "--batch",
            str(B), "--seq", str(S), "--log-every", "1000",
            "--model-axis", str(model_axis)]
    return argv + (["--backend", MESH_BACKEND] if model_axis > 1 else [])


def _split_config(arch: str):
    return get_config(arch).replace(n_layers=MESH_SPLIT_LAYERS)


def _rank_split(out_dir: str) -> None:
    """(b) ``train --model-axis 8`` on LM_ARCH at full width,
    MESH_SPLIT_LAYERS layers (the driver's config hook patched)."""
    from repro_torch.models import blocks

    calls: dict = {}
    _count_calls(blocks, "_batch_split_attention", calls)
    train.get_config = _split_config
    torch.cuda.reset_peak_memory_stats()
    out = train.run(train.build_parser().parse_args(
        _split_argv(MESH_SPLIT_RANKS)))
    torch.cuda.synchronize()
    _rank_dump_path(out_dir, "split", int(os.environ["RANK"]), {
        "losses": out["losses"], "step_s": out["step_s"],
        "batch_split_calls": calls.get("_batch_split_attention", 0),
        "peak_bytes": torch.cuda.max_memory_allocated()})


def _rank_compress(out_dir: str) -> None:
    """(c) ``make_dp_compressed_train_step`` at n = 2 for LM_ARCH's smoke
    config: three steps on this card and on the CPU from one seed-0 draw,
    each rank on its half of the driver's batches; losses and each rank's
    residuals."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dp_compressed_train_step
    from repro_torch.runtime.compression import init_error_state

    cfg = smoke_config(LM_ARCH)
    model = build_model(cfg)
    decls = model.param_decls()
    opt_cfg = AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    row = {}
    with make_host_mesh(1, backend=MESH_BACKEND):
        rank, n = dist.get_rank(), dist.get_world_size()
        row["backend"] = dist.get_backend()
        for dev in ("cuda", "cpu"):
            gen = torch.Generator().manual_seed(0)
            params = bridge.to_device(init_params(decls, gen, cfg.param_dtype),
                                      dev)
            opt = bridge.to_device(init_params(opt_state_decls(decls, opt_cfg),
                                               gen, "float32"), dev)
            opt["err"] = init_error_state(params, n)
            step = make_dp_compressed_train_step(model, opt_cfg)
            losses, errs = [], []
            for i in range(MESH_TRAIN_STEPS):
                b = lm_train_batch(cfg, 4, 32, i)
                half = {k: v[rank * 2:(rank + 1) * 2] for k, v in b.items()}
                params, opt, met = step(params, opt, bridge.to_device(half, dev))
                losses.append(float(met["loss"]))
                errs.append({k: v.float().cpu().numpy().tolist()
                             for k, v in zip(_leaf_names(opt["err"]),
                                             tree_leaves(opt["err"]))})
            row[dev] = {"losses": losses, "err_step1": errs[0],
                        "err_last": errs[-1]}
    _rank_dump_path(out_dir, "compress", rank, row)


# The ranks of this phase run gloo with CUDA tensors. On the card
# machine's torch (2.11) the functional all-gather of a CUDA tensor on a
# gloo group segfaults in its wait_tensor (c10d's own all_gather_into_tensor
# of the same tensors works), and the EP comparison showed a gradient leaf
# wrong by its own size with the functional collectives left asynchronous.
# So the rank harness stages every functional collective DTensor and the
# regions issue through c10d's synchronous call on the same CUDA tensors,
# after a device synchronize (gloo copies through the host).
STAGED_COLLECTIVES = ("_c10d_functional.{all_gather_into_tensor, "
                      "reduce_scatter_tensor, all_reduce, all_to_all_single, "
                      "broadcast}: c10d's synchronous call after a device "
                      "synchronize")
_STAGED_LIB = []
_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT"}


def stage_gloo_cuda_collectives() -> None:
    from torch.distributed.distributed_c10d import _resolve_process_group as pg

    def reduce(t, op, group, fn):
        if op == "avg":         # gloo has no AVG: the sum over the group
            fn(t, dist.ReduceOp.SUM, group)
            return t.div_(dist.get_world_size(group))
        fn(t, getattr(dist.ReduceOp, _REDUCE_OPS[op]), group)
        return t

    def all_gather_into_tensor(inp, group_size, group_name):
        torch.cuda.synchronize()
        out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=pg(group_name))
        return out

    def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
        torch.cuda.synchronize()
        inp = inp.contiguous()
        out = inp.new_empty((inp.shape[0] // group_size,) + tuple(inp.shape[1:]))
        return reduce(out, reduce_op, pg(group_name),
                      lambda t, o, g: dist.reduce_scatter_tensor(t, inp, op=o,
                                                                 group=g))

    def all_reduce(inp, reduce_op, group_name):
        torch.cuda.synchronize()
        return reduce(inp.clone(), reduce_op, pg(group_name),
                      lambda t, o, g: dist.all_reduce(t, op=o, group=g))

    def all_to_all_single(inp, out_splits, in_splits, group_name):
        torch.cuda.synchronize()
        out = inp.new_empty((sum(out_splits),) + tuple(inp.shape[1:])) \
            if out_splits else torch.empty_like(inp)
        dist.all_to_all_single(out, inp.contiguous(), list(out_splits) or None,
                               list(in_splits) or None, group=pg(group_name))
        return out

    def broadcast(inp, src, group_name):
        torch.cuda.synchronize()
        out = inp.clone()
        dist.broadcast(out, src, group=pg(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_gather_into_tensor, reduce_scatter_tensor, all_reduce,
               all_to_all_single, broadcast):
        lib.impl(fn.__name__, fn, "CUDA")
    _STAGED_LIB.append(lib)


def mesh_rank_main(argv: list) -> None:
    which, out_dir = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if which != "nccl_probe":
        stage_gloo_cuda_collectives()
    {"nccl_probe": _rank_nccl_probe, "ep": _rank_ep, "split": _rank_split,
     "compress": _rank_compress}[which](out_dir)


def _err_ties(a: list, b: list) -> tuple:
    """(entries more than 1e-6 apart, of them the ones that are not a
    rounding tie) of two residual vectors: a tie is a segment entry on .5
    of its int8 step rounded to neighbouring codes, its residuals +s/2 and
    -s/2 (they sum to 0), the CPU test's rule."""
    a, b = np.asarray(a), np.asarray(b)
    off = np.abs(a - b) > 1e-6
    return int(off.sum()), int((np.abs(a[off] + b[off]) > 1e-6).sum())


def mesh_paths_phase() -> dict:
    """The models' mesh paths on ranks that share this card (times are not
    scale-out times): the backend, (a) expert-parallel MoE against the
    dense path at full width, (b) ``train --model-axis 8`` with the batch
    split against ``--model-axis 1``, (c) the compressed step at n = 2."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    card = smi("name,power.limit")
    parent = {"allocated": torch.cuda.memory_allocated(),
              "reserved": torch.cuda.memory_reserved()}
    work = ROOT / "build" / "mesh_paths"
    shutil.rmtree(work, ignore_errors=True)
    label = f"ranks share one card ({card}); not scale-out times"

    probe = spawn_ranks(2, "nccl_probe", work, timeout=120, check=False)
    nccl = probe[0].get("refused") or probe[1].get("refused") or \
        ("ok" if all(p.get("ok") for p in probe) else probe)
    print(f"mesh paths: backend {MESH_BACKEND} with CUDA tensors (nccl on "
          f"one card: {nccl}); staged in the rank harness: "
          f"{STAGED_COLLECTIVES}; this process's card bytes {parent}",
          flush=True)

    # (a)
    t0 = time.perf_counter()
    ep = spawn_ranks(MESH_EP_RANKS, "ep", work)
    rows = ep[0]["rows"]
    for lbl, r in rows.items():
        r["peak_bytes_ep_per_rank"] = [e["rows"][lbl]["peak_bytes_ep"] for e in ep]
        r.pop("peak_bytes_ep")
    f32, bf16 = rows["f32"], rows["bf16"]
    ep_row = {"arch": MESH_ARCH_EP, "cut": f"depth {MESH_EP_LAYERS} of "
              f"{get_config(MESH_ARCH_EP).n_layers} (the dense layer and "
              f"{MESH_EP_LAYERS - 1} MoE layers), full width",
              "mesh": [1, MESH_EP_RANKS], "batch": list(MESH_EP_BATCH),
              "f32": f32, "bf16": bf16, "label": label,
              "wall_s": time.perf_counter() - t0}
    print(f"mesh paths ep: {json.dumps(ep_row)}", flush=True)
    assert f32["ep_calls_per_step"] >= MESH_EP_LAYERS - 1, f32
    assert abs(f32["loss_ep"] - f32["loss_dense"]) < MESH_LOSS_ATOL, f32
    assert f32["worst_grad_gap_of_max_g"] < MESH_GRAD_OF_MAX, f32
    assert f32["y_max_abs_diff"] < MESH_Y_ATOL, f32
    assert math.isfinite(bf16["loss_ep"]), bf16
    assert abs(bf16["loss_ep"] - bf16["loss_dense"]) \
        < MESH_BF16_RTOL * abs(bf16["loss_dense"]), bf16

    # (b): --model-axis 1 here, then 8 ranks
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hook = train.get_config
    train.get_config = _split_config
    try:
        one = train.run(train.build_parser().parse_args(_split_argv(1)))
    finally:
        train.get_config = hook
    one_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    split = spawn_ranks(MESH_SPLIT_RANKS, "split", work)
    losses = split[0]["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
    split_row = {"arch": LM_ARCH, "mesh": [1, MESH_SPLIT_RANKS],
                 "cut": f"depth {MESH_SPLIT_LAYERS} of "
                        f"{get_config(LM_ARCH).n_layers}, full width (8 "
                        "ranks' state does not fit one card at full depth)",
                 "batch": list(MESH_SPLIT_BATCH), "losses": losses,
                 "losses_model_axis_1": one["losses"], "rel_gaps": gaps,
                 "batch_split_calls": [r["batch_split_calls"] for r in split],
                 "ms_per_step": [1e3 * t for t in split[0]["step_s"]],
                 "ms_per_step_model_axis_1": [1e3 * t for t in one["step_s"]],
                 "peak_bytes_per_rank": [r["peak_bytes"] for r in split],
                 "peak_bytes_model_axis_1": one_peak, "label": label,
                 "wall_s": time.perf_counter() - t0}
    print(f"mesh paths split: {json.dumps(split_row)}", flush=True)
    assert all(r["losses"] == losses for r in split), split
    assert all(r["batch_split_calls"] > 0 for r in split), split_row
    assert all(math.isfinite(x) for x in losses), split_row
    assert max(gaps) < MESH_BF16_RTOL, split_row

    # (c)
    comp = spawn_ranks(2, "compress", work)
    c_row = {"backend": comp[0]["backend"], "n": 2, "label": label}
    for r, res in enumerate(comp):
        card_l, cpu_l = res["cuda"]["losses"], res["cpu"]["losses"]
        c_row[f"rank{r}_losses_card"] = card_l
        c_row[f"rank{r}_losses_cpu"] = cpu_l
        for a, b in zip(card_l, cpu_l):
            assert math.isclose(a, b, rel_tol=1e-5), (r, card_l, cpu_l)
        card_e, cpu_e = res["cuda"], res["cpu"]
        first = [_err_ties(card_e["err_step1"][k], cpu_e["err_step1"][k])
                 for k in card_e["err_step1"]]
        last = [_err_ties(card_e["err_last"][k], cpu_e["err_last"][k])
                for k in card_e["err_last"]]
        c_row[f"rank{r}_err_entries"] = sum(len(v) for v in
                                            card_e["err_step1"].values())
        c_row[f"rank{r}_step1_ties"] = sum(a for a, _ in first)
        c_row[f"rank{r}_step1_not_ties"] = sum(b for _, b in first)
        # after step 1 a tie's other code feeds the next quantization:
        # later residuals drift apart beyond ties (reported)
        c_row[f"rank{r}_step{MESH_TRAIN_STEPS}_apart"] = sum(a for a, _ in last)
        # after one step, every residual is equal or a rounding tie
        assert c_row[f"rank{r}_step1_not_ties"] == 0, c_row
    assert comp[0]["cuda"]["losses"] == comp[1]["cuda"]["losses"], c_row
    print(f"mesh paths compress: {json.dumps(c_row)}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"backend": MESH_BACKEND, "nccl": nccl,
            "staged": STAGED_COLLECTIVES, "ep": ep_row, "split": split_row,
            "compress": c_row}


# the e2e example's steps: at its default 300 the loss is still above the
# stream's unigram entropy (11.04 against 10.78 nats on the card; the JAX
# package's step on its own stream and weights follows the same curve);
# the structure is learned from ~400 steps on (PERF.md §6)
E2E_STEPS = 1000


def lm_e2e_phase() -> dict:
    """``examples/torch_lm_train_e2e.py`` at its full ~100M config on the
    card for ``E2E_STEPS`` steps, in its own process (it patches the
    driver's config hook): phase 1 stops at 60%, phase 2 restarts from
    the checkpoint and finishes; the final loss must be below the
    stream's unigram entropy (the example asserts it)."""
    work = ROOT / "build" / "lm_e2e"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_lm_train_e2e.py"),
         "--steps", str(E2E_STEPS)], cwd=work, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    final = [ln for ln in lines if ln.startswith("[e2e] final loss")]
    assert final and lines[-1].startswith("[e2e] OK"), lines[-5:]
    words = final[0].split()
    loss, entropy = float(words[3]), float(words[7])
    assert loss < entropy
    restored = int(E2E_STEPS * 0.6)
    assert f"[train] restored step={restored} from runs/lm_e2e_ckpt_torch" \
        in lines
    row = {"final_loss": loss, "unigram_entropy": entropy,
           "restored_step": restored, "steps": E2E_STEPS, "wall_s": wall,
           "params": [ln for ln in lines if "model params" in ln][0]}
    print(f"lm e2e: {json.dumps(row)}", flush=True)
    return row


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    print(f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    lib = build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    cfg = CONFIG
    params = init_params(plcore_decls(cfg), torch.Generator().manual_seed(0))
    peaks = peak_flops()
    # the dry run takes no card memory; the mesh paths' ranks need the
    # card's memory to themselves (8 ranks of qwen2-1.5b beside this
    # process's leftovers of the later phases do not fit), so both run
    # first
    dry = dryrun_phase(peaks)
    mesh_paths = mesh_paths_phase()
    rows = kernel_phase(cfg, params, peaks)
    width_rows = width_phase(peaks)
    mip_rows = mip_phase(peaks)
    mip_engine = {label: mip_engine_phase(extra) for label, extra in
                  (("clean", []), ("chaos", ["--inject-faults"]))}

    k3_row = k3_phase(peaks)
    sdf_run = sdf_phase(peaks)
    slf_run = slf_phase(peaks)

    out_dir = str(ROOT / "chiprun_out" / "smoke_views")
    main_serve = serve_phase(out_dir, [], 3)
    rmcm_serve = serve_phase(out_dir, ["--rmcm", "--ert", "0.01"], 3)
    tiny_serve = tiny_serve_phase(out_dir + "/tiny")
    oracle_launches = oracle_phase(cfg, params)
    render_step = render_step_phase(cfg, params)
    k1_ref = k1_ref_phase()
    clean = engine_phase([])
    chaos = engine_phase(["--inject-faults"])
    traced = traced_engine_phase()
    percell = percell_engine_phase()
    cluster = cluster_phase()
    budgets = budget_phase(cfg, params, peaks)
    view = adaptive_view_phase(cfg, params)
    adaptive = adaptive_engine_phase()
    fig8_tiny = fig8_tiny_phase()
    trained = train_phase(cfg, peaks)
    lm = lm_phase(peaks)
    lm_train = lm_train_phase(peaks)
    lm_e2e = lm_e2e_phase()

    k2 = "two_pass_plcore_call"
    # every main-path run: counters zeroed just before, read just after
    runs = [main_serve["launches"], rmcm_serve["launches"],
            tiny_serve["f32"]["launches"],
            tiny_serve["rmcm_ert"]["launches"], tiny_serve["tiled"]["launches"],
            clean["launches"], traced["launches"], view["launches"],
            adaptive["launches"], fig8_tiny["launches"],
            trained["launches"], sdf_run["launches"], slf_run["launches"],
            percell["launches"], render_step["launches"]] + [
                cluster[run]["launches"] for run in (
                    "kill", "chaos", "traced", "sharded")]
    main_path = {k: sum(r[k] for r in runs)
                 for k in ("fused_plcore_call", k2, "rmcm_matmul")}
    instances: dict = {}
    for r in runs + [{"instances": {fused_plcore.instance_name(
            cfg, "fused_plcore_call", (False,)): oracle_launches}}]:
        for inst, n in r.get("instances", {}).items():
            instances[inst] = instances.get(inst, 0) + n
    by_nf = {nf: view["launches"]["k2_by_nf"].get(nf, 0)
             + adaptive["launches"]["k2_by_nf"].get(nf, 0)
             + trained["k2_by_nf"].get(nf, 0) for nf in budgets}
    kernels = []
    for k in ("fused_plcore_call", k2):
        # the function's launches over every instance: K2's on the main
        # path, K1's on the oracle path and serve --tiled; the row's
        # numbers are the full width's (timed in f32, K2 also in RMCM)
        launches = main_path[k] + (oracle_launches
                                   if k == "fused_plcore_call" else 0)
        kernels.append({"name": k, "route": "cuda", "source": SOURCE[k],
                        "header": HEADER,
                        "mma_route": "wgmma: 3xTF32 (f32 weights), bf16x3 "
                                     "(RMCM); weights by bulk copy",
                        "replaces": REPLACES[k], "launches": launches,
                        "launches_on": ("main path, the four cluster "
                                        "runs included" if k == k2
                                        else "oracle path, serve --tiled and "
                                             "make_render_step"),
                        **({"launches_render_step":
                            render_step["launches"][k]}
                           if k == "fused_plcore_call" else {}),
                        "launches_by_instance": {
                            i: n for i, n in instances.items()
                            if i.startswith(k + "[")},
                        "launches_trained_scene": (
                            trained["launches"][k] if k == k2 else 0),
                        **rows[k], "library_ms": None})
    for inst, row in width_rows.items():
        kind = inst.split("[")[0]
        kernels.append({"name": inst, "route": "cuda", "source": SOURCE[kind],
                        "header": HEADER, "replaces": REPLACES[kind],
                        "launches": instances.get(inst, 0),
                        "launches_on": ("main path" if instances.get(inst)
                                        else "kernel phase only: no serve "
                                             "path runs this instance"),
                        **row, "library_ms": None})
    for nf, row in budgets.items():
        kernels.append({"name": f"{k2}[n_fine={nf}]", "route": "cuda",
                        "source": SOURCE[k2], "header": HEADER,
                        "replaces": REPLACES[k2], "launches": by_nf[nf],
                        "launches_on": "adaptive view, adaptive engine and "
                                       "the trained scene's adaptive view",
                        "alive_mask": "every third ray dead",
                        **row, "library_ms": None})
    mip_launches = {label: run["launches"].get("mip_two_pass_call", 0)
                    for label, run in mip_engine.items()}
    kernels.append({"name": "mip_two_pass_call", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/plcore_mip.cuh",
                    "header": HEADER,
                    "mma_route": "wgmma: 3xTF32 (f32 weights); one weight "
                                 "stream read by both levels",
                    "replaces": REPLACES[k2],
                    "launches": sum(mip_launches.values()),
                    "launches_by_run": mip_launches,
                    "launches_on": "serve --mode engine --model mipnerf, "
                                   "clean and with --inject-faults (its "
                                   "oracle rung included)",
                    "launches_by_instance": {
                        i: n for r in mip_engine.values()
                        for i, n in r["launches"]["instances"].items()},
                    **{k: v for k, v in mip_rows["full"].items()},
                    "tiny": mip_rows["tiny"], "library_ms": None})
    kernels.append({"name": "rmcm_matmul", "route": "cuda",
                    "source": SOURCE["rmcm_matmul"], "header": HEADER,
                    "mma_route": "wgmma: bf16x3 (f32 x), bf16 (bf16 x); "
                                 "weight tiles by TMA; large_m or small_m "
                                 "(split K) by M",
                    "replaces": REPLACES["rmcm_matmul"],
                    **k3_row,
                    "launches_on": "the SDF (grid, trace, normals) and SLF "
                                   "(view) workloads' RMCM layers",
                    "launches": main_path["rmcm_matmul"],
                    "entry_point_launches": k3_row["launches"]})
    for workload in (sdf_run, slf_run):
        for label, row in workload["k3_layers"].items():
            kernels.append({"name": f"rmcm_matmul[{label}]", "route": "cuda",
                            "source": SOURCE["rmcm_matmul"],
                            "replaces": REPLACES["rmcm_matmul"],
                            "launches_on": "launches at this shape in the "
                                           "workload run", **row})
    # the instances the main path runs: tiny()'s K2 (serve without
    # --full, f32 and RMCM), its K1 (serve --tiled), the full width's K2
    tiny_cfg = tiny()
    for inst in (fused_plcore.instance_name(tiny_cfg, k2, (False, False)),
                 fused_plcore.instance_name(tiny_cfg, k2, (True, True)),
                 fused_plcore.instance_name(tiny_cfg, "fused_plcore_call",
                                            (False,)),
                 fused_plcore.instance_name(cfg, k2, (False, False)),
                 fused_plcore.instance_name(cfg, k2, (True, True))):
        assert instances.get(inst, 0) >= 1, (inst, instances)
    print(json.dumps({"engine": {"clean": clean, "chaos": chaos,
                                 "adaptive": adaptive, "traced": traced,
                                 "percell": percell},
                      "cluster": {run: {k: v for k, v in r.items()
                                        if k != "launches"}
                                  for run, r in cluster.items()},
                      "serve_energy": {
                          "f32": {k: v for k, v in main_serve.items()
                                  if k != "launches"},
                          "rmcm_ert": {k: v for k, v in rmcm_serve.items()
                                       if k != "launches"}},
                      "sdf": {k: v for k, v in sdf_run.items()
                              if k not in ("k3_layers", "launches")},
                      "slf": {k: v for k, v in slf_run.items()
                              if k not in ("k3_layers", "launches")},
                      "tiny_serve": tiny_serve, "adaptive_view": view,
                      "train": trained["summary"], "fig8": trained["fig8"],
                      "fig8_tiny": fig8_tiny, "lm": lm, "lm_train": lm_train,
                      "render_step": render_step["row"],
                      "k1_vs_fused_render_ref": k1_ref, "dryrun": dry,
                      "mesh_paths": mesh_paths,
                      "lm_e2e": lm_e2e, "mipnerf_k2": mip_rows,
                      "mipnerf_engine": {label: {
                          k: v for k, v in run.items() if k != "launches"}
                          for label, run in mip_engine.items()},
                      "main_path_instances": instances}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(sys.argv[2:])
    else:
        main()
