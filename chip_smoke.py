#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, in the order they run, each failing hard:

1. Device: the card's name, count and power limit. No card, no run.
2. Build: every kernel under ``src/repro_torch/kernels/csrc`` is compiled
   with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started
   together (``-Xptxas -v`` shown). Five libraries are disassembled
   (``cuobjdump -sass``, beside ``nvcc`` or Triton's copy): the bf16 flash
   library must hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
   instructions, the bf16 SSD and RWKV-6 libraries ``HMMA`` (mma.sync) and
   ``LDGSTS`` (cp.async) ones, the f32 flash library ``FFMA`` and ``LDGSTS``
   ones, each with no ptxas spills; the f32 SSD and RWKV-6 libraries
   ``FFMA`` and ``LDGSTS`` ones, no ``LDL``/``STL``, and every instance no
   spills and a 0-byte stack frame (ptxas's registers shown); the JRBA
   library must hold no ``LDL``/``STL`` (local memory) and every kernel of
   it a 0-byte stack frame.
3. Flash attention against plain: the two CUDA kernels (bf16 on the tensor
   cores, ``flash_attention_wgmma.cu``; f32 on the CUDA cores,
   ``flash_attention.cu``) against their plain version
   (``blockwise_attention``) on the card, bf16 within 2e-2 and f32 within
   2e-4 of each output row's scale (``kernels.ref.row_limit_ratio``), at
   ``tests/test_kernels.py``'s shapes, gemma3-1b's (S=4096, H=4, KH=1, D=256,
   window 512 and 0) and internlm2-1.8b's (H=16, KH=8, D=128), in both
   types, at the S=32768 shapes of the gemma3-1b prefill in bf16, and at
   zamba2-7b's shared attention (H=KH=32, D=112, global; S=4096 in both
   types, S=32768 in bf16), at MLA's head dims, v narrower than q and k, with
   the scale D^-0.5 (minicpm3-4b: H=KH=40, D=96, Dv=64; deepseek-v2-lite-16b:
   H=KH=16, D=192, Dv=128; S=4096 in both types, S=32768 in bf16), at the
   GQA prefills of starcoder2-7b (H=36, KH=4: a group of 9; D=128),
   phi-3-vision-4.2b (H=KH=32, D=96) and musicgen-medium (H=KH=24, D=64),
   S=4096 in both types, S=32768 in bf16; then with
   ``causal=False`` (window 0 and > 0)
   and a scale other than D^-0.5, in both types, at small shapes and at
   internlm2-1.8b's S=4096. Kernel, plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never on the
   port's path) are timed with CUDA events.
4. Scans against plain: the SSD kernels (bf16 on the tensor cores,
   ``ssd_scan_mma.cu``; f32 on the CUDA cores, ``ssd_scan.cu``) and the
   RWKV-6 kernels (bf16 on the tensor cores, ``rwkv6_scan_mma.cu``; f32 on
   the CUDA cores, ``rwkv6_scan.cu``), through the model-layout wrappers,
   against their chunked plain versions at zamba2-7b's (H=112, P=N=64,
   chunk 64) and rwkv6-3b's (H=40, P=64, chunk 16) heads at S=32768
   and 4096, then at ``tests/test_kernels.py``'s cases and, for the SSD, at
   the odd chunks the model passes for short prompts (48, 37, 24, 8; also
   against the sequential oracles), bf16 and f32, with that file's
   tolerances (rtol, and atol as a share of each output row's root mean
   square). Kernel and plain version are timed; no single PyTorch call
   computes a chunked scan.
5. Prefill, for gemma3-1b (999,812,736 parameters), zamba2-7b (7,586,693,952),
   rwkv6-3b (2,863,516,160), minicpm3-4b (4,261,902,848),
   deepseek-v2-lite-16b (15,706,484,224), starcoder2-7b (7,399,051,776),
   phi-3-vision-4.2b (3,821,079,552) and musicgen-medium (1,365,394,944) in
   turn, each at full width and depth from the port's seeded init and freed
   before the next: ``prefill`` at B=1, S=32768 (the prefill_32k length; a
   frontend model's S holds its seeded frontend embeddings, 256 or 64, then
   its tokens, and every forward and prefill of it takes them): time,
   tokens/s, peak memory, the MoE aux (deepseek-v2-lite-16b; finite), and
   exactly one launch per layer of each kernel's kind (gemma3-1b: 26 bf16
   flash; zamba2-7b: 68 bf16 SSD and 13 bf16 flash; rwkv6-3b: 32 bf16
   RWKV-6; minicpm3-4b: 62 bf16 flash; deepseek-v2-lite-16b: 27 bf16 flash;
   starcoder2-7b and phi-3-vision-4.2b: 32 bf16 flash; musicgen-medium: 48
   bf16 flash; the f32 checks of each model
   the same counts, on the f32 kernels, but at a cut depth, full width, for
   five models (``F32_REPEATS``): deepseek-v2-lite-16b's f32 copy would not
   fit beside its bf16 weights, so its f32 checks run its dense first layer
   and 3 MoE layers (4 f32 flash); zamba2-7b's run 4 of its 13 groups and
   its last 3 blocks (23 f32 SSD, 4 f32 flash), and starcoder2-7b's,
   phi-3-vision-4.2b's and musicgen-medium's their first 8 layers (8 f32
   flash), to keep the run's time). At
   S=4096 the last-position logits through the kernels and through their plain
   versions must agree within the model's limit (a share of the largest logit,
   2-4x the gap read on the card) with the same top-1 token, and so must
   zamba2-7b's at S=48, whose SSD chunk of 48 has no tile instance of its own.
   In every such comparison of a MoE model the second run takes the first
   run's expert choices (``Routing``: a rounding difference flips near-tied
   top-k choices), and the share its own router would have made otherwise is
   held to the model's limit. A profiler window shows where the prefill's time
   goes. The f32 checks' kernel-path prefill at S=4096 is profiled once (the
   f32 scans' grids a call, held to their plans) and timed warm with CUDA
   events.
6. Serving: ``ServingEngine`` on the same weights (gemma3-1b: 16 requests of
   16-256 prompt tokens and 32 new ones, 8 slots, max_len 1024; zamba2-7b and
   rwkv6-3b: 8 requests of 16-64 and 16 new, 4 slots, max_len 256, so slots
   are recycled and the recurrent state reset; minicpm3-4b,
   deepseek-v2-lite-16b, starcoder2-7b, phi-3-vision-4.2b and
   musicgen-medium: 4 such requests, one a slot; the frontend models
   text-only, as the engine serves them in both packages): every request
   must finish. One prompt's teacher-forced decode logits must match the
   kernel-path ``forward`` within the model's limit, with the same top-1
   token at all but the model's allowance of positions (a MoE model at its
   drop-free capacity for this check, as the JAX package's tests hold it:
   the forward dispatches the prompt as one group, decode each token); a
   frontend model's text-only decode has not seen the prefix its forward
   takes, so it is held finite, of the right shape and cache length, as
   the reference's ``test_frontend_decode_runs`` holds it, at bf16 and at
   f32. A profiler window over 4 ticks (2 for starcoder2-7b,
   phi-3-vision-4.2b and musicgen-medium) shows the device's busy share.
7. Training: each kernel's ``autograd.Function`` (the kernel forward, the
   plain version's gradient: the JAX package has no backward kernel) against
   the plain version under autograd, bf16 and f32: flash attention at
   ``tests/test_kernels.py``'s shapes, MLA's (96, 64) and (192, 128) and the
   training runs' shapes at B=4, S=2048 (internlm2-1.8b's 16/8 heads of
   D=128, gemma3-1b's 4/1 of D=256 at window 512 and global, zamba2-7b's
   32/32 of D=112; musicgen-medium's 24/24 of D=64 over 2112 rows, its 64
   frontend embeddings and 2048 tokens; MLA's 40/40 at (96, 64) and 16/16
   at (192, 128); starcoder2-7b's 36/4 of D=128, a group of 9;
   phi-3-vision-4.2b's 32/32 of D=96 over 2304 rows, its 256 frontend
   embeddings and 2048 tokens), each causal at its window (the
   test shapes, MLA's and internlm2-1.8b's also not causal with scale 0.1);
   the SSD and RWKV-6 scans at the kernel tests' cases and zamba2-7b's and
   rwkv6-3b's heads at S=4096 and at B=4, S=2048, and once past the SSD's
   cliff (decays summing far past f32's exp range in a chunk), where every
   gradient must be finite. The Function's output must equal the kernel's
   and every input gradient the plain version's, bit for bit, for a seeded
   output gradient; each gradient's gap to the f32 plain gradient is read.
   Then the training runs (``TRAIN_RUNS``), one model on the card at a
   time, each at full width, bf16 with f32 AdamW moments and remat, at
   B=4, S=2048 on the synthetic pipeline (seed 0), lr 3e-3:
   internlm2-1.8b (1,889,110,016 parameters, 48 bf16 flash launches a
   step), rwkv6-3b (2,863,516,160; 64 bf16 RWKV-6), gemma3-1b (999,812,736;
   52 bf16 flash at D=256), musicgen-medium (1,365,394,944; 96 bf16 flash at
   D=64; its batches carry 64 frontend embeddings before the 2048 tokens, in
   bf16, as ``launch/train.py`` feeds them), zamba2-7b cut to 27 of its
   81 layers (2,690,678,832; 46 bf16 SSD and 8 bf16 flash at D=112; its full
   state does not fit one card), minicpm3-4b at full depth (4,261,902,848;
   124 bf16 flash at (96, 64), MLA with its q LoRA) and deepseek-v2-lite-16b
   cut to its dense layer and 3 of its 26 MoE layers (2,254,983,168; 8 bf16
   flash at (192, 128); its full state is 188 GB), phi-3-vision-4.2b at
   full depth (3,821,079,552; 64 bf16 flash at D=96 over its 256 frontend
   embeddings and 2048 tokens) and starcoder2-7b cut to 12 of its 32 layers
   (3,057,762,816; 24 bf16 flash, a GQA group of 9; its full state and
   gradients, 89 GB, do not fit).
   ``repro_torch.launch.train.main`` trains internlm2-1.8b for 8 steps
   (every loss finite, the last below the first), rwkv6-3b, musicgen-medium,
   minicpm3-4b and phi-3-vision-4.2b for 2, gemma3-1b for 3 (every loss
   finite);
   ms a step, tokens/s (of the labelled tokens) and peak
   memory are printed. Then, for each model, one step through the plain versions on
   a copy of the parameters and one through the kernels from the same state,
   its AdamW moments zeroed again (step 0's), beside the witness of bf16
   rounding, the f32 plain path (a forward; for rwkv6-3b a gradient): held
   to the run's limits, the loss and gradient-norm gaps, the spread of the
   per-position loss gaps over the witness's (not internlm2-1.8b's) and,
   for rwkv6-3b in place of the gradient norm, the kernel path's gradient
   distance from the f32 gradient over the plain path's; no gradient all
   zeros where the plain path's is not; the largest gradient and
   updated-parameter gaps read. minicpm3-4b's plain step moves its updated
   parameters to the host before the kernel step (``HOST_PLAIN_SHARE``).
   deepseek-v2-lite-16b's plain step records its expert choices and the
   kernel step and the witness replay them (``Routing``): the share the
   kernel step's own router made otherwise is held to its limit, remat's
   recompute must choose as the forward did in both paths, and a second
   plain gradient from the same state must equal the first bit for bit;
   the MoE terms of both paths are printed. It is compared twice, from a
   fresh state each: at ``TrainConfig()`` and with two microbatches and
   the MTP head at weight 0.3 (16 launches a step). A further kernel step is timed (ms,
   tokens/s, peak memory) where no entry point ran, and one more profiled
   (the device's busy share, its leading kernels). Before the first
   profiled window of the run, one of 64 known launches holds the
   profiler's raw events against its public event tree.
8. The examples' twins: ``examples/torch_quickstart.py`` in full through
   the JRBA kernel and through its plain version on the card
   (``REPRO_TORCH_JRBA_SOLVER=sparse``), Fig. 2's figures and every
   policy's records identical; ``examples/torch_serve_cluster.py``'s serving
   demo on the card and with the model kernels routed to their plain
   versions, the same tokens (the engine prefills by decode steps, as the
   JAX package's does, so neither launches a kernel); ``examples/torch_train_100m.py`` at its 100m
   preset (its full width) for 6 of its 300 steps with a checkpoint at step
   3, then resumed from it: exactly 24 bf16 flash launches a step, each
   resumed loss within ``TRAIN_LIMITS["loss"]`` of the uninterrupted run's,
   ms a step and tokens/s printed; ``examples/torch_fleet_demo.py``'s seven
   sections through the JRBA kernel, every records-identical check True.
9. Placement: ``examples/torch_serve_cluster.py``'s placement demo places
   ``examples/serve_cluster.py``'s five stage graphs on an 8x8 torus
   through the JRBA kernel and on the CPU: assignments, routes, bandwidths
   and spans must be identical.
10. JRBA kernel against plain: every JRBA program that the port's
   ``OnlineScheduler`` solves (OTFS and OTFA, k=3, all 12 scenarios, seeds
   0-1, 8 jobs) is replayed through the CUDA kernel (``solver="cuda"``) and
   through its plain PyTorch version (``solver="sparse"``), both on the
   card at ``n_iters=400``, as ``solve_many`` batches of up to 64 and singly
   (the plain version singly seed 0's programs only, for the run's time).
   Rounded routes, bandwidths and spans must be identical, relaxed spans
   within rtol 5e-2, on every program both ran. The kernel and the plain
   version are timed with CUDA events on batches from that stream, where
   ``w``, spans and step counts
   must agree bit for bit; beside each time stand the batch's slowest lane's
   steps, the time per step, and the latency floor: those steps times one
   step's minimum dependent chain, timed by the source's one-warp
   microbenchmark (``jrba_congestion.step_floor_ms``).
11. Fleet: a 256-lane async-built fleet (the fleet families plus
   ``wan-mesh-xl`` and ``edge-mesh-flash``, drift churn on every 4th lane,
   ``n_jobs=4``, ``n_iters=250``) runs under the lockstep and the async
   runtime on a ``solver="cuda"`` engine: records must be identical, every
   job must finish and the kernel must have launched. A 32-lane fleet on the
   kernel and on the plain version must give identical records; both run
   with the port's mutation sanitizer installed
   (``repro_torch.analysis.sanitizer``): no ``SanitizerError``, and the
   graph mutations (drift churn on every 4th lane) and engine builds it
   audited are printed and must both be more than 0. The 256-lane runs are
   not sanitized.
12. Dry run (``repro_torch.launch.dryrun``), in a child process started
   before the build (``--dry-run-child``; it needs a CPU core, no device
   time, and its output goes under ``build/``): over a fake process group of
   256 ranks on the single production mesh (16 x 16, device type cuda),
   ``run_cell`` for internlm2-1.8b x train_4k, deepseek-v2-lite-16b x
   decode_32k (MoE and the MLA cache through ``models/hints.py``), and
   zamba2-7b and rwkv6-3b x train_4k (the SSM mixers' padding and
   ``cumsum``'s gradient on DTensors); every cell must be ``ok`` (a cell
   whose refused ops had to gather the batch is not) and the records are
   printed, with what the resharding of refused ops did (``reshard``).
   internlm2-1.8b x train_4k's peak bytes a device, counted from the cell's
   local ops, must be within 10% of the 7.51e10 that PyTorch 2.13 reads.
   ``scripts/torch_hillclimb.py --arch internlm2-1.8b --cell train_4k
   --breakdown`` runs there too: its FLOPs and collective bytes must be the
   cell's record's. On a (1, 1) mesh the static bytes
   of internlm2-1.8b's training state must equal exactly the bytes of the
   state the training phase held on the card (params, AdamW moments,
   steps). The run waits for the child at its end.

Every path is driven with every kernel's launch count set to 0 just before
it and read just after; a kernel a path is not expected to launch must show
0. The JRBA kernel's main path is the 256-lane lockstep fleet: each path on
``solver="cuda"`` (the examples, the placement, the scheduler, the single
and batched replays, each fleet run) must have launched it, each on ``solver="sparse"``
or the CPU must not have. Each model kernel's main path is the S=32768
prefill of its model (bf16 flash attention: gemma3-1b's, 26 launches, and
at MLA's head dims minicpm3-4b's, 62, and deepseek-v2-lite-16b's, 27, at the
new GQA shapes starcoder2-7b's and phi-3-vision-4.2b's, 32, and
musicgen-medium's, 48; bf16 SSD: zamba2-7b's, 68; bf16 RWKV-6: rwkv6-3b's,
32); the S=4096 prefills and
``forward`` launch them once per layer, the plain reference runs and the
serving loops (whose decode is plain PyTorch) not at all. The f32 flash
kernel's path is gemma3-1b's f32 prefill at S=4096 (26 launches), the f32
SSD kernel's zamba2-7b's at its f32 depth (23), the f32 RWKV-6 kernel's
rwkv6-3b's (32). A full-width train step launches each kernel exactly twice
a layer that reaches it (the forward and remat's recompute): internlm2-1.8b
48 bf16 flash (384 in its 8-step entry-point run), rwkv6-3b 64 bf16 RWKV-6
(128 in 2 steps), gemma3-1b 52 bf16 flash (156 in 3), musicgen-medium 96
bf16 flash (192 in 2), zamba2-7b at 27 layers 46 bf16 SSD and 8 bf16 flash,
minicpm3-4b 124 bf16 flash (248 in 2), deepseek-v2-lite-16b at 4 layers 8
bf16 flash (16 with two microbatches), phi-3-vision-4.2b 64 bf16 flash (128
in 2), starcoder2-7b at 12 layers 24 bf16 flash; each plain-path step none.
``flash_attention_hsd.launches``, ``ssd_scan_hsd.launches`` and
``rwkv6_scan_hsd.launches`` each count their two kernels, and each must
equal their sum on every path. A bf16 RWKV-6 call counts one launch however
many grids it runs (three for a sequence of more than one segment), and so
do the f32 RWKV-6 kernel and the f32 SSD kernel (two: C B^T, then y); each
record's ``grids_per_call`` is the count of
its grids in its profiled prefill's trace (rwkv6-3b's bf16 one at S=32768,
the f32 ones at S=4096) over its calls there, and must match its plan.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SCENARIOS, JRBAEngine, OnlineScheduler  # noqa: E402
from repro_torch.core.graph import NetworkGraph  # noqa: E402
from repro_torch.core.jrba import sparse_batch_inputs  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.fleet import FLEET_SCENARIOS, FleetRuntime, build_async_fleet  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import jrba_congestion as jc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6 as rw  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    row_limit_ratio, rwkv6_sequential, same_bits, ssd_sequential)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import gelu_tanh, mlp_apply, silu  # noqa: E402
from repro_torch.models.moe import moe_capacity  # noqa: E402
from repro_torch.models.transformer import pick_chunk  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state  # noqa: E402
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.train_step import loss_and_grads, split_microbatches  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

K = 3
STREAM_ITERS = 400
FLEET_ITERS = 250
SPAN_RTOL = 5e-2
BATCH = 64
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def load_script(path: str):
    """A script of the repository (an example's twin, a driver) as a module."""
    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# every kernel launcher of the port, by kernel name; each counts its launches
COUNTERS = {
    "jrba_congestion": jc.sparse_congestion_solve,
    "flash_attention_wgmma": fa.flash_attention_wgmma,  # bf16, tensor cores
    "flash_attention": fa.flash_attention_f32,  # f32, CUDA cores
    "ssd_scan_mma": ssd.ssd_scan_mma,  # bf16, tensor cores
    "ssd_scan": ssd.ssd_scan_f32,  # f32, CUDA cores
    "rwkv6_scan_mma": rw.rwkv6_scan_mma,  # bf16, tensor cores
    "rwkv6_scan": rw.rwkv6_scan_f32,  # f32, CUDA cores
}
# the device kernels a launcher's call may run as grids of its own, by the
# substrings of their names in the profiler's trace
GRID_KERNELS = {
    "rwkv6_scan_mma": ("rwkv6_mma_kernel", "rwkv6_pass_states"),
    "ssd_scan": ("ssd_gram_kernel", "ssd_f32_kernel"),
    "rwkv6_scan": ("rwkv6_f32_kernel", "rwkv6_f32_pass_states"),
}
# grids a call, read from each kernel's profiled prefill: the bf16 RWKV-6
# kernel's at S=32768 (prefill_phase), the f32 scans' at S=4096 (f32_phase)
GRIDS_PER_CALL: dict[str, float] = {}
# each dtype-routing wrapper's count is the sum of its kernels' counts
ROUTED = {
    fa.flash_attention_hsd: ("flash_attention_wgmma", "flash_attention"),
    ssd.ssd_scan_hsd: ("ssd_scan_mma", "ssd_scan"),
    rw.rwkv6_scan_hsd: ("rwkv6_scan_mma", "rwkv6_scan"),
}


def counted_all(label: str, expect: dict, fn, *args, **kwargs):
    """Drive one path with every kernel's launch count set to 0 just before
    it and read just after; returns ``(result, {kernel: launches})``.
    ``expect`` maps a kernel to True (must have launched), or to the exact
    count it must show; kernels it does not name must show 0."""
    for wrapper in (*COUNTERS.values(), *ROUTED):
        wrapper.launches = 0
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    counts = {name: wrapper.launches for name, wrapper in COUNTERS.items()}
    log(f"[launches] {label}: {json.dumps(counts)}")
    for wrapper, names in ROUTED.items():
        total = sum(counts[name] for name in names)
        assert wrapper.launches == total, (
            f"{label}: {wrapper.__name__} counted {wrapper.launches}, its kernels {total}"
        )
    for name, n in counts.items():
        want = expect.get(name, 0)
        if want is True:
            assert n > 0, f"{label}: {name} was never launched"
        else:
            assert n == want, f"{label}: {name} launched {n} times, expected {want}"
    return out, counts


def counted(label: str, kernel: bool, fn, *args, **kwargs):
    """A JRBA path: the JRBA kernel must have launched on a kernel path and
    not on a plain one; the model kernels never. Returns ``(result, launches)``."""
    expect = {"jrba_congestion": True} if kernel else {}
    out, counts = counted_all(label, expect, fn, *args, **kwargs)
    return out, counts["jrba_congestion"]


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def build_all() -> dict[str, str]:
    """Returns each source's compiler output (``-Xptxas -v``) by name."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    # one nvcc per source, all started together, so the build takes as long
    # as the slowest source however many the port grows; built anew from the
    # checkout's sources even where a library is there, so ptxas reports
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(lambda n: _build.build(n, ptxas_verbose=True, force=True), names))
    for name, (lib, seconds, output) in zip(names, built):
        for line in output.strip().splitlines():
            log(f"[build] {name}: {line}")
        log(f"[build] {name}: {lib.name} in {seconds:.2f} s (nvcc, sm_90a)")
    log(f"[build] all {len(names)} kernel sources in {time.perf_counter() - t0:.2f} s")
    return {name: output for name, (_, _, output) in zip(names, built)}


def cuobjdump_path() -> Path:
    """``cuobjdump`` beside ``nvcc``, else Triton's copy; fails without one."""
    found = Path(_build.nvcc_path()).parent / "cuobjdump"
    if found.exists():
        return found
    try:
        import triton
    except ImportError:
        triton = None
    if triton is not None:
        found = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        if found.exists():
            return found
    raise FileNotFoundError("no cuobjdump beside nvcc or in Triton's package")


def ptxas_entries(ptxas: str, pattern: str = "") -> list[dict]:
    """ptxas -v's report of each kernel entry whose mangled name holds
    ``pattern``: its name, stack frame, spill stores and loads, and
    registers."""
    out = []
    for m in re.finditer(r"Compiling entry function '([^']*)'.*?(\d+) bytes stack frame, "
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                         r"Used (\d+) registers", ptxas, re.S):
        name, stack, st, ld, regs = m.group(1), *map(int, m.groups()[1:])
        if pattern in name:
            out.append({"entry": name, "stack_frame": stack, "spill_stores": st,
                        "spill_loads": ld, "registers": regs})
    return out


def sass_counts(name: str, ops: tuple) -> dict:
    """How often each SASS opcode in ``ops`` appears in the library's
    disassembly (``LDL`` counts ``LDL.64`` and the like)."""
    lib, _, _ = _build.build(name)
    sass = subprocess.run([str(cuobjdump_path()), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def wgmma_evidence(ptxas: str) -> dict:
    """The bf16 flash library's SASS counts (wgmma, TMA loads, mbarrier
    operations) and ptxas's registers and spills for each instance, with the
    dynamic shared memory of each instance's plan; fails unless the kernel
    runs on the tensor cores, loads by TMA and spills nothing."""
    counts = sass_counts("flash_attention_wgmma", ("HGMMA", "UTMALDG", "SYNCS"))
    plans = {(p.d_pad, p.dv_pad): p for p in (fa.wgmma_plan(*dims) for dims in fa.HEAD_DIMS)}
    instances = {}
    for e in ptxas_entries(ptxas, "flash_fwd_wgmma"):
        d_pad, dv_pad, block_k, stages = map(int, re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                                                            e["entry"]).groups())
        plan = plans[d_pad, dv_pad]
        assert (plan.block_k, plan.stages) == (block_k, stages), f"{e['entry']} is not {plan}"
        instances[f"d_pad={d_pad},dv_pad={dv_pad},block_k={block_k},stages={stages}"] = {
            "registers": e["registers"], "spill_stores": e["spill_stores"],
            "spill_loads": e["spill_loads"], "dynamic_smem_bytes": plan.smem_bytes,
        }
    out = {"sass": counts, "ptxas": instances}
    log(f"[build] flash_attention_wgmma evidence: {json.dumps(out)}")
    assert counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, "no wgmma or TMA in the bf16 kernel"
    assert len(instances) == len(plans), f"ptxas reported {len(instances)} instances"
    assert all(i["spill_stores"] == i["spill_loads"] == 0 for i in instances.values()), "spills"
    return out


def ssd_mma_evidence(ptxas: str) -> dict:
    """The bf16 SSD library's SASS counts (mma.sync, cp.async, ldmatrix,
    barriers) and ptxas's registers and spills for each (chunk, block
    columns) instance, 16 and 32 value columns at each chunk; fails unless it
    runs on the tensor cores, loads by cp.async and spills nothing."""
    counts = sass_counts("ssd_scan_mma", ("HMMA", "LDGSTS", "LDSM", "BAR", "LDL", "STL"))
    instances = {}
    for e in ptxas_entries(ptxas, "ssd_scan_mma_kernel"):
        q, pb = map(int, re.search(r"ILi(\d+)ELi(\d+)E", e["entry"]).groups())
        instances[f"Q={q},PB={pb}"] = {k: e[k] for k in
                                       ("registers", "spill_stores", "spill_loads", "stack_frame")}
    out = {"sass": counts, "ptxas": instances}
    log(f"[build] ssd_scan_mma evidence: {json.dumps(out)}")
    assert counts["HMMA"] > 0 and counts["LDGSTS"] > 0, "no mma.sync or cp.async in the SSD kernel"
    assert set(instances) == {f"Q={q},PB={pb}" for q in ssd.CHUNKS for pb in (16, 32)}, (
        f"ptxas reported instances {sorted(instances)}")
    assert all(i["spill_stores"] == i["spill_loads"] == 0 for i in instances.values()), "spills"
    return out


def rwkv6_mma_evidence(ptxas: str) -> dict:
    """The bf16 RWKV-6 library's SASS counts (mma.sync, cp.async, ldmatrix,
    shuffles, barriers, local memory) and ptxas's registers and spills for
    each (P, value columns, pass) instance; fails unless it runs on the
    tensor cores, loads by cp.async and spills nothing."""
    counts = sass_counts("rwkv6_scan_mma", ("HMMA", "LDGSTS", "LDSM", "SHFL", "BAR", "LDL", "STL"))
    instances = {}
    for e in ptxas_entries(ptxas, "rwkv6_mma_kernel"):
        p, ncol, with_y = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", e["entry"]).groups()
        instances[f"P={p},NCOL={ncol},{'y' if with_y == '1' else 'state'}"] = {
            k: e[k] for k in ("registers", "spill_stores", "spill_loads", "stack_frame")}
    out = {"sass": counts, "ptxas": instances}
    log(f"[build] rwkv6_scan_mma evidence: {json.dumps(out)}")
    assert counts["HMMA"] > 0 and counts["LDGSTS"] > 0, "no mma.sync or cp.async in RWKV-6"
    assert len(instances) == 8, f"ptxas reported instances {sorted(instances)}"
    assert all(i["spill_stores"] == i["spill_loads"] == 0 for i in instances.values()), "spills"
    assert counts["LDL"] == counts["STL"] == 0, "local memory in the RWKV-6 kernel"
    return out


def flash_f32_evidence(ptxas: str) -> dict:
    """The f32 flash library's SASS counts (FMAs, cp.async, shared loads,
    shuffles, barriers, local memory) and ptxas's registers and spills for
    each (D, Dv, rows a thread, kv tile) instance; fails unless it loads by
    cp.async and spills nothing."""
    counts = sass_counts("flash_attention", ("FFMA", "LDGSTS", "LDS", "SHFL", "BAR", "LDL", "STL"))
    instances = {}
    for e in ptxas_entries(ptxas, "flash_fwd"):
        d, dv, rm, bk, rg = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                                      e["entry"]).groups()
        instances[f"D={d},DV={dv},RM={rm},BK={bk},RG={rg}"] = {
            k: e[k] for k in ("registers", "spill_stores", "spill_loads", "stack_frame")}
    out = {"sass": counts, "ptxas": instances}
    log(f"[build] flash_attention evidence: {json.dumps(out)}")
    assert counts["FFMA"] > 0 and counts["LDGSTS"] > 0, "no FMAs or cp.async in f32 flash"
    assert len(instances) == len(fa.HEAD_DIMS), f"ptxas reported instances {sorted(instances)}"
    assert all(i["spill_stores"] == i["spill_loads"] == 0 for i in instances.values()), "spills"
    assert counts["LDL"] == counts["STL"] == 0, "local memory in the f32 flash kernel"
    return out


def scan_f32_evidence(name: str, ptxas: str, kernels: dict) -> dict:
    """An f32 scan library's SASS counts (FMAs, cp.async, shared loads,
    shuffles, barriers, local memory) and ptxas's registers, spills and stack
    frame for each instance of its kernels (``kernels`` maps an entry name to
    the labels of its template arguments); fails unless it loads by cp.async,
    spills nothing and keeps no stack frame."""
    counts = sass_counts(name, ("FFMA", "LDGSTS", "LDS", "SHFL", "BAR", "LDL", "STL"))
    instances = {}
    for kernel, labels in kernels.items():
        for e in ptxas_entries(ptxas, kernel):
            args = re.findall(r"L([ib])(\d+)E", e["entry"].split(kernel, 1)[1])
            label = ",".join(f"{k}={v}" for k, (_, v) in zip(labels, args))
            instances[f"{kernel}<{label}>"] = {
                k: e[k] for k in ("registers", "spill_stores", "spill_loads", "stack_frame")}
    out = {"sass": counts, "ptxas": instances}
    log(f"[build] {name} evidence: {json.dumps(out)}")
    assert counts["FFMA"] > 0 and counts["LDGSTS"] > 0, f"no FMAs or cp.async in {name}"
    assert instances, f"ptxas reported no instances of {sorted(kernels)}"
    assert all(i["spill_stores"] == i["spill_loads"] == 0 for i in instances.values()), "spills"
    assert all(i["stack_frame"] == 0 for i in instances.values()), "stack frames"
    assert counts["LDL"] == counts["STL"] == 0, f"local memory in {name}"
    return out


# the f32 scans' kernel templates, by the labels of their arguments
SSD_F32_KERNELS = {"ssd_gram_kernel": ("Q",), "ssd_f32_kernel": ("Q", "PB")}
RWKV_F32_KERNELS = {"rwkv6_f32_kernel": ("P", "NCOL", "y")}


def jrba_evidence(ptxas: str) -> dict:
    """The JRBA library's local-memory instructions (none allowed) and each
    kernel instance's stack frame (0 bytes required), registers and spills."""
    counts = sass_counts("jrba_congestion", ("LDL", "STL", "LDS", "SHFL", "BAR"))
    entries = ptxas_entries(ptxas, "jrba_")
    frames = {e["stack_frame"] for e in entries}
    out = {"sass": counts, "entries": len(entries), "stack_frames": sorted(frames),
           "max_registers": max(e["registers"] for e in entries),
           "spills": sum(e["spill_stores"] + e["spill_loads"] for e in entries)}
    log(f"[build] jrba_congestion evidence: {json.dumps(out)}")
    assert counts["LDL"] == 0 and counts["STL"] == 0, "local memory in the JRBA kernel"
    assert entries and frames == {0}, f"JRBA stack frames {sorted(frames)} bytes"
    return out


# ---------------------------------------------------------------------------
# phase 3: flash attention against its plain version
# ---------------------------------------------------------------------------
# (B, S, H, KH, D, window): tests/test_kernels.py's shapes, then gemma3-1b's
# sliding-window and global attention and internlm2-1.8b's at S=4096; bf16
# and f32 each
FLASH_SHAPES = [
    (1, 128, 4, 4, 64, 0),
    (2, 256, 8, 2, 64, 0),
    (1, 256, 4, 1, 128, 0),
    (2, 256, 4, 2, 64, 96),
    (1, 512, 2, 2, 32, 128),
    (1, 128, 2, 2, 96, 0),
    (1, 4096, 4, 1, 256, 512),
    (1, 4096, 4, 1, 256, 0),
    (1, 4096, 16, 8, 128, 0),
]
# the training runs' flash shapes at B=4, S=2048 (training phase), bf16:
# internlm2-1.8b's (each of its step's 48 launches), gemma3-1b's windowed and
# global layers, zamba2-7b's shared attention, musicgen-medium's, whose
# 2048 tokens follow 64 frontend embeddings (2112 rows, not a multiple of
# 128), MLA's, minicpm3-4b's (96, 64) and deepseek-v2-lite-16b's
# (192, 128), with Dv as a seventh entry, starcoder2-7b's (36/4 heads, a
# GQA group of 9) and phi-3-vision-4.2b's (D = Dv = 96 over 256 frontend
# embeddings and 2048 tokens)
TRAIN_FLASH_SHAPES = [(4, 2048, 16, 8, 128, 0), (4, 2048, 4, 1, 256, 512),
                      (4, 2048, 4, 1, 256, 0), (4, 2048, 32, 32, 112, 0),
                      (4, 2048 + 64, 24, 24, 64, 0), (4, 2048, 40, 40, 96, 0, 64),
                      (4, 2048, 16, 16, 192, 0, 128), (4, 2048, 36, 4, 128, 0),
                      (4, 2048 + 256, 32, 32, 96, 0)]
# the keywords the model never passes: (shape, causal, scale); small shapes,
# then internlm2-1.8b's at S=4096, bf16 and f32 each
FLASH_KEYWORD_CASES = [
    ((1, 128, 4, 4, 64, 0), False, None),
    ((2, 256, 4, 2, 64, 96), False, None),
    ((1, 333, 4, 1, 256, 100), False, 0.05),
    ((2, 200, 8, 2, 112, 0), True, 0.3),
    ((1, 256, 2, 2, 32, 0), False, 0.25),
    ((1, 4096, 16, 8, 128, 0), False, 0.1),
]
# the shapes gemma3-1b's prefill at S=32768 gives the kernel (22 sliding-window
# layers, 4 global); bf16 only, the record is the first
PREFILL_SHAPES = [(1, 32768, 4, 1, 256, 512), (1, 32768, 4, 1, 256, 0)]
# zamba2-7b's shared attention: 32/32 heads of D=112, global, at S=4096 (bf16
# and f32) and at the S=32768 of its prefill (bf16)
ZAMBA_FLASH_SHAPES = [(1, 4096, 32, 32, 112, 0), (1, 32768, 32, 32, 112, 0)]
# MLA's prefill attention, (B, S, H, KH, D, window, Dv): minicpm3-4b (40
# heads, D = 64 + 32, Dv = 64), deepseek-v2-lite-16b (16 heads, D = 128 +
# 64, Dv = 128) and deepseek-v3-671b (128 heads, the same dims), global and
# causal with the scale D**-0.5; at S=4096 in both types and at the S=32768
# of their prefills in bf16
MLA_FLASH_SHAPES = {
    "minicpm3-4b": [(1, 4096, 40, 40, 96, 0, 64), (1, 32768, 40, 40, 96, 0, 64)],
    "deepseek-v2-lite-16b": [(1, 4096, 16, 16, 192, 0, 128), (1, 32768, 16, 16, 192, 0, 128)],
    "deepseek-v3-671b": [(1, 4096, 128, 128, 192, 0, 128), (1, 32768, 128, 128, 192, 0, 128)],
}
# shapes whose plain version runs once, for the comparison, and is not
# timed: deepseek-v3-671b's S=32768 attention, about 2.4 s a plain call
PLAIN_UNTIMED = {MLA_FLASH_SHAPES["deepseek-v3-671b"][1]}
# the GQA prefills of starcoder2-7b (36 query heads over 4 kv heads: a group
# of 9, D=128), phi-3-vision-4.2b (32/32 heads of D=96) and musicgen-medium
# (24/24 of D=64), causal with the scale D**-0.5: at S=4096 in both types and
# at the S=32768 of their prefills in bf16
GQA_FLASH_SHAPES = {
    "starcoder2-7b": [(1, 4096, 36, 4, 128, 0), (1, 32768, 36, 4, 128, 0)],
    "phi-3-vision-4.2b": [(1, 4096, 32, 32, 96, 0), (1, 32768, 32, 32, 96, 0)],
    "musicgen-medium": [(1, 4096, 24, 24, 64, 0), (1, 32768, 24, 24, 64, 0)],
}
# tests/test_kernels.py's tolerances (rtol, and atol as a share of each
# output row's root mean square): at S=32768 a global row's outputs are ~0.01
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: PEAK_F32}  # tensor-core bf16, f32
SEED = 0


def live_pairs(S: int, window: int, causal: bool = True) -> int:
    """(q, k) pairs inside the causal band (all keys when not causal) and the
    window, per batch and head."""
    q = np.arange(S, dtype=np.int64)
    last = q + 1 if causal else np.full(S, S, dtype=np.int64)  # keys 0 .. last - 1
    first = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, dtype=np.int64)
    return int((last - first).sum())


def library_attention(q, k, v, window: int, causal: bool = True, scale: float | None = None):
    """One PyTorch call computing the same function: SDPA, causal or not, or
    with a boolean band mask. Timed as a yardstick only; the port never
    calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window <= 0:
        return sdpa(q, k, v, is_causal=causal, scale=scale, enable_gqa=True)
    S = q.shape[2]
    i = torch.arange(S, device=q.device)
    band = i[None, :] > i[:, None] - window
    if causal:
        band &= i[None, :] <= i[:, None]
    return sdpa(q, k, v, attn_mask=band, scale=scale, enable_gqa=True)


def flash_case(shape, dtype, device, reps: int, causal: bool = True,
               scale: float | None = None) -> dict:
    """``shape`` is (B, S, H, KH, D, window), with v's head dim Dv as a
    seventh entry where it is not D."""
    B, S, H, KH, D, window = shape[:6]
    Dv = shape[6] if len(shape) > 6 else D
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + sum(shape))
    q, k, v = (
        torch.randn(s, generator=gen, device=device).to(dtype)
        for s in ((B, H, S, D), (B, KH, S, D), (B, KH, S, Dv))
    )
    chunk = 1024 if S % 1024 == 0 else S
    kw = dict(causal=causal, window=window, scale=scale)
    got = fa.flash_attention_hsd(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, chunk=chunk, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL[dtype]
    label = f"flash {shape} causal={causal} scale={scale} {dtype}"
    assert bool(torch.isfinite(got).all()), f"{label}: non-finite output"
    ratio = row_limit_ratio(got, want, tol)
    assert ratio <= 1.0, f"{label}: error {ratio:.3g} times the limit"
    lib = library_attention(q, k, v, window, causal, scale)
    lib_err = float((lib.float() - want.float()).abs().max())
    del lib
    ms = time_call(fa.flash_attention_hsd, (q, k, v), kw, reps=reps)
    plain_ms = None if shape in PLAIN_UNTIMED else time_call(
        fa.flash_attention_plain, (q, k, v), dict(kw, chunk=chunk), reps=max(1, reps // 3)
    )
    library_ms = time_call(library_attention, (q, k, v, window, causal, scale), {},
                           reps=max(1, reps // 3))
    # bound: q, k, v read once, o written once; 2*D flops per live (q, k)
    # pair for Q.K^T and 2*Dv for P.V
    nbytes = (q.numel() + k.numel() + v.numel() + B * H * S * Dv) * q.element_size()
    flops = (2 * D + 2 * Dv) * live_pairs(S, window, causal) * B * H
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    out = {
        "kernel": "flash_attention_wgmma" if dtype == torch.bfloat16 else "flash_attention",
        "shape": {"B": B, "S": S, "H": H, "KH": KH, "D": D, "Dv": Dv, "window": window,
                  "causal": causal, "scale": scale},
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "tolerance": tol,
        "limit_ratio": ratio,
        "library_max_abs_err": lib_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "tflops": flops / (ms * 1e-3) / 1e12,
    }
    log(f"[flash] {json.dumps(out)}")
    return out


def flash_phase(device) -> list[dict]:
    """Kernel against plain (and the library call) at every listed shape;
    returns the timings, the prefill shapes first."""
    out = [flash_case(s, torch.bfloat16, device, reps=5) for s in PREFILL_SHAPES]
    for shape in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            out.append(flash_case(shape, dtype, device, reps=10))
    out += [flash_case(s, torch.bfloat16, device, reps=10) for s in TRAIN_FLASH_SHAPES]
    short, full = ZAMBA_FLASH_SHAPES
    out.append(flash_case(short, torch.float32, device, reps=5))
    out += [flash_case(s, torch.bfloat16, device, reps=3) for s in (short, full)]
    for short, full in GQA_FLASH_SHAPES.values():
        out.append(flash_case(short, torch.float32, device, reps=5))
        out += [flash_case(s, torch.bfloat16, device, reps=3) for s in (short, full)]
    for short, full in MLA_FLASH_SHAPES.values():  # MLA's scale: D**-0.5 of q.k's head
        out.append(flash_case(short, torch.float32, device, reps=5, scale=short[4] ** -0.5))
        out += [flash_case(s, torch.bfloat16, device, reps=3, scale=s[4] ** -0.5)
                for s in (short, full)]
    for shape, causal, scale in FLASH_KEYWORD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            out.append(flash_case(shape, dtype, device, reps=5, causal=causal, scale=scale))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the SSM scan kernels against their plain versions
# ---------------------------------------------------------------------------
# tests/test_kernels.py's SSD_CASES (B, S, H, P, N, chunk), then chunks the
# model passes for prompts under 64 tokens (48, 37, 24 and 8: no tile
# instance of their own), and RWKV_CASES (B, S, H, P, chunk); then the heads
# of zamba2-7b and rwkv6-3b at the lengths of the prefills below; bf16 and
# f32 each, the record first
SSD_CASES = [(2, 128, 2, 16, 8, 32), (1, 256, 4, 64, 64, 64), (2, 64, 1, 32, 16, 64),
             (1, 512, 2, 64, 32, 128), (2, 96, 3, 64, 16, 48), (1, 37, 2, 64, 64, 37),
             (2, 64, 2, 32, 16, 8), (1, 120, 2, 16, 8, 24)]
RWKV_CASES = [(2, 128, 2, 16, 16), (1, 256, 4, 64, 16), (2, 64, 1, 32, 8), (1, 512, 2, 64, 16)]
SSD_MODEL = [(1, 32768, 112, 64, 64, 64), (1, 4096, 112, 64, 64, 64)]
RWKV_MODEL = [(1, 32768, 40, 64, 16), (1, 4096, 40, 64, 16)]
# the same heads at the training runs' batch, B=4, S=2048 (training phase), bf16
SSD_TRAIN = (4, 2048, 112, 64, 64, 64)
RWKV_TRAIN = (4, 2048, 40, 64, 16)
# tests/test_kernels.py's tolerances (rtol, atol); the atol a share of each
# output row's root mean square
SCAN_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-4, 5e-4)}
# kernel (through the model-layout wrapper, as the model calls it), plain
# version, sequential oracle
SCANS = {
    "ssd_scan": (ops.ssd_scan, lambda *a, chunk: ssd.ssd_chunked(*a, chunk=chunk)[0],
                 ssd_sequential),
    "rwkv6_scan": (ops.rwkv6_scan, lambda *a, chunk: rw.rwkv6_chunked(*a, chunk=chunk)[0],
                   rwkv6_sequential),
}


# the kernel each scan family launches, by dtype
SCAN_KERNEL = {
    ("ssd_scan", torch.bfloat16): "ssd_scan_mma",
    ("ssd_scan", torch.float32): "ssd_scan",
    ("rwkv6_scan", torch.bfloat16): "rwkv6_scan_mma",
    ("rwkv6_scan", torch.float32): "rwkv6_scan",
}


def scan_inputs(name: str, shape, dtype, device) -> tuple:
    """Model-layout inputs from a seed: tests/test_kernels.py's
    distributions (decays across the model's whole valid range)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + sum(shape))

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device=device) * scale

    if name == "ssd_scan":
        B, S, H, P, N, _ = shape
        x = randn(B, S, H, P).to(dtype)
        dt = torch.nn.functional.softplus(randn(B, S, H) - 1.0)
        A = -torch.exp(torch.rand(H, generator=gen, device=device) * 2.0)
        return x, dt, A, randn(B, S, N).to(dtype), randn(B, S, N).to(dtype)
    B, S, H, P, _ = shape
    r, k = randn(B, S, H, P, scale=0.5).to(dtype), randn(B, S, H, P, scale=0.5).to(dtype)
    v = randn(B, S, H, P).to(dtype)
    logw = -torch.exp(torch.rand((B, S, H, P), generator=gen, device=device) * 9.0 - 8.0)
    return r, k, v, logw, randn(H, P, scale=0.3)


def scan_bound(name: str, shape, dtype) -> tuple[float, str, float]:
    """The least time the card could take: each input read once and the
    output written once at 3.35 TB/s, or the chunked algorithm's operations
    at the dtype's peak (as for flash attention), whichever is larger.
    Returns (ms, what bounds it, operations)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    if name == "ssd_scan":
        B, S, H, P, N, Q = shape
        pairs = Q * (Q + 1) // 2
        nbytes = 2 * B * S * H * P * elt + B * S * H * 4 + H * 4 + 2 * B * S * N * elt
        # per chunk: C.B^T once (B and C are shared by the heads); per head:
        # decay and mask, W.x, C.state, B^T.x, the scalings and the carry
        ops_ = B * (S // Q) * (2 * Q * Q * N + H * (
            4 * pairs + 2 * pairs * P + 4 * Q * N * P + 2 * Q * P + Q * N + 2 * N * P + 3 * Q))
    else:
        B, S, H, P, Q = shape
        strict, pairs = Q * (Q - 1) // 2, Q * (Q + 1) // 2
        nbytes = 4 * B * S * H * P * elt + B * S * H * P * 4 + H * P * 4
        # per chunk and head: cumsum and decays, qn.kn^T, the bonus, A.v,
        # qn.S, kd^T.v and the carry
        ops_ = B * (S // Q) * H * (
            9 * Q * P + 2 * strict * P + 2 * pairs * P + 4 * Q * P * P + 2 * P * P)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops_ / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", float(ops_)


def scan_case(name: str, shape, dtype, device, reps: int, sequential: bool) -> dict:
    kernel, plain, oracle = SCANS[name]
    chunk = shape[-1]
    args = scan_inputs(name, shape, dtype, device)
    got = kernel(*args, chunk=chunk)
    want = plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    label = f"{name} {shape} {str(dtype).replace('torch.', '')}"
    assert bool(torch.isfinite(got).all()), f"{label}: non-finite output"
    rtol, atol = SCAN_TOL[dtype]
    ratio = row_limit_ratio(got, want, rtol, atol)
    assert ratio <= 1.0, f"{label}: error {ratio:.3g} times the limit"
    out = {"kernel": SCAN_KERNEL[name, dtype], "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "tolerance": [rtol, atol], "limit_ratio": ratio}
    if sequential:
        seq = oracle(*args)[0]
        out["sequential_limit_ratio"] = row_limit_ratio(got, seq, rtol, atol)
        assert out["sequential_limit_ratio"] <= 1.0, f"{label}: kernel vs sequential oracle"
    del got, want
    out["ms"] = time_call(kernel, args, dict(chunk=chunk), reps=reps)
    out["plain_ms"] = time_call(plain, args, dict(chunk=chunk), reps=max(1, reps // 3))
    out["library_ms"] = None  # no single PyTorch call computes the chunked scan
    out["bound_ms"], out["bound_by"], flops = scan_bound(name, shape, dtype)
    out["gflops"] = flops / (out["ms"] * 1e-3) / 1e9
    log(f"[scan] {json.dumps(out)}")
    return out


def scan_phase(device) -> dict:
    """Each scan kernel against its plain version (and, at the test shapes,
    the sequential oracle); returns the timings by scan family, the model's
    S=32768 shape first in each dtype (each kernel's record)."""
    out = {}
    for name, cases, model, train in (("ssd_scan", SSD_CASES, SSD_MODEL, SSD_TRAIN),
                                      ("rwkv6_scan", RWKV_CASES, RWKV_MODEL, RWKV_TRAIN)):
        rows = [scan_case(name, s, dt, device, 5, False)
                for dt in (torch.bfloat16, torch.float32) for s in model]
        rows.append(scan_case(name, train, torch.bfloat16, device, 5, False))
        rows += [scan_case(name, s, dt, device, 10, True)
                 for s in cases for dt in (torch.bfloat16, torch.float32)]
        out[name] = rows
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 5-6: full-width prefill and serving of each model
# ---------------------------------------------------------------------------
PREFILL_LEN = 32768  # the repo's prefill_32k sequence length, at batch 1
CHECK_LEN = 4096
# the launches of one forward: one per layer of each kernel's kind
FORWARD_LAUNCHES = {
    "gemma3-1b": {"flash_attention_wgmma": 26},
    "zamba2-7b": {"ssd_scan_mma": 68, "flash_attention_wgmma": 13},
    "rwkv6-3b": {"rwkv6_scan_mma": 32},
    "minicpm3-4b": {"flash_attention_wgmma": 62},  # MLA, (D, Dv) = (96, 64)
    "deepseek-v2-lite-16b": {"flash_attention_wgmma": 27},  # MLA, (192, 128); 26 MoE layers
    "starcoder2-7b": {"flash_attention_wgmma": 32},  # GQA 36/4 (a group of 9), ungated MLP
    "phi-3-vision-4.2b": {"flash_attention_wgmma": 32},  # 32/32 at D=96, 256 frontend embeds
    "musicgen-medium": {"flash_attention_wgmma": 48},  # 24/24 at D=64, ungated, 64 embeds
    # MLA at 128 heads, (192, 128), with a q LoRA; 3 dense layers, then 1 MoE
    # layer of 256 experts, top-8 (PREFILL_REPEATS)
    "deepseek-v3-671b": {"flash_attention_wgmma": 4},
}
# the prefill's depth, pattern repeats kept at full width, where the whole
# model does not fit one card: deepseek-v3-671b keeps its 3 dense layers and
# 1 of its 58 MoE layers (15,111,101,440 parameters, 30.2 GB in bf16); a
# second MoE layer would bring 11.3e9 more (53.2 GB before activations),
# and the S=32768 dispatch buffers take 4.7 GB each
PREFILL_REPEATS = {"deepseek-v3-671b": 1}
# the f32 checks' depth, pattern repeats kept at full width, where the full
# depth did not fit or does not fit the run's time: deepseek-v2-lite-16b
# keeps its dense first layer and 3 of its 26 MoE layers (its f32 copy, 63
# GB, did not fit beside its bf16 weights, 31 GB; upcast in place it would,
# and the cut keeps the run's time); zamba2-7b keeps 4 of its 13 groups (5
# Mamba-2 blocks and the shared attention each) and its 3 last Mamba-2
# blocks, 27 of 81 layers, to keep the run under 700 s; starcoder2-7b,
# phi-3-vision-4.2b and musicgen-medium 8 of their 32, 32 and 48 layers, to
# keep it under 880 s with their training (PERF.md 4). deepseek-v3-671b
# keeps all 4 layers of its prefill cut: its f32 copy (60.4 GB) does not fit
# beside its bf16 weights (30.2 GB), so f32_phase runs after serving and
# upcasts the weights in place, leaf by leaf (peak 66.06 GB on the H100);
# fewer layers would drop its one MoE layer, the layer the check is for
F32_REPEATS = {"zamba2-7b": 4, "deepseek-v2-lite-16b": 3, "starcoder2-7b": 8,
               "phi-3-vision-4.2b": 8, "musicgen-medium": 8}
# at f32 the same layers launch the f32 flash, SSD and RWKV-6 kernels instead
F32_KERNEL = {"flash_attention_wgmma": "flash_attention", "ssd_scan_mma": "ssd_scan",
              "rwkv6_scan_mma": "rwkv6_scan"}
F32_LAUNCHES = {
    arch: {F32_KERNEL.get(k, k): n for k, n in kinds.items()}
    for arch, kinds in FORWARD_LAUNCHES.items()
}
F32_LAUNCHES["zamba2-7b"] = {"ssd_scan": 5 * 4 + 3, "flash_attention": 4}
F32_LAUNCHES["deepseek-v2-lite-16b"] = {"flash_attention": 1 + 3}
F32_LAUNCHES.update({arch: {"flash_attention": F32_REPEATS[arch]}  # a layer a repeat
                     for arch in ("starcoder2-7b", "phi-3-vision-4.2b", "musicgen-medium")})
# requests, slots, max_len, prompt lengths, new tokens; an SSM model's first
# prompt is the prefill prompt's first DECODE_LEN tokens (a chunk length its
# kernels take), the prompt of its decode-vs-forward checks; "ticks", where
# given, the profile window's ticks in place of PROFILE_TICKS
SERVING = {
    "gemma3-1b": dict(requests=16, slots=8, max_len=1024, prompt=(16, 256), new=32, first=False),
    "zamba2-7b": dict(requests=8, slots=4, max_len=256, prompt=(16, 64), new=16, first=True),
    "rwkv6-3b": dict(requests=8, slots=4, max_len=256, prompt=(16, 64), new=16, first=True),
    # 4 requests, one a slot, to keep the run under 700 s (PERF.md 4)
    "minicpm3-4b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16, first=False),
    "deepseek-v2-lite-16b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16,
                                 first=False),
    # served as the MLA models are; the frontend models text-only, as the
    # engine serves them in both packages; windows of 2 ticks to keep the
    # run under 880 s with their training (PERF.md 4)
    "starcoder2-7b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16, first=False,
                          ticks=2),
    "phi-3-vision-4.2b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16,
                              first=False, ticks=2),
    "musicgen-medium": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16,
                            first=False, ticks=2),
    "deepseek-v3-671b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16,
                             first=False, ticks=2),
}
# Logit limits, each a share of the largest logit and 2-4x the gap read on
# the H100 (PERF.md section 2; the noise of bf16 hidden states is absolute in
# a d-term dot product). "prefill" holds the kernel path to the plain path at
# S=4096, "decode" the teacher-forced decode to the kernel-path forward, both
# at bf16; the "_f32" checks repeat them with the same weights upcast to f32,
# where only the order of f32 sums differs. "flips" is how many of a decoded
# prompt's positions may change their top-1 token at bf16: twice the number
# read (one for gemma3-1b, as in PR 12). The SSM models' bf16 drift is the
# rounding of their recurrences amplified by their per-head norms: their
# decode is as far from the plain forward as from the kernel one, and at f32
# both gaps are under 1e-5 (rwkv6-3b's decode 3.2e-4). A MoE model's two
# runs of a check take the same expert choices (Routing); "route_flips" is
# the share of choices its second run's own router may make otherwise
# (deepseek-v2-lite-16b's random routers are near-uniform: 8.7% at bf16,
# none at f32; deepseek-v3-671b's 6.7%, and 1 of 32,768 at f32). "ties":
# the S=4096 prefill check's one position may change its top-1 token where
# the plain path scores the kernel path's token within the "prefill" limit
# of its own (deepseek-v3-671b: a logit spread of 355 over 129,280 tokens
# puts its top two 0.228 apart, under the bf16 gap of 2.43). A frontend
# model (phi-3-vision-4.2b, musicgen-medium) has no decode-vs-forward check
# (its text-only decode has not seen the frontend prefix its forward takes;
# tests/test_arch_smoke.py skips that parity), so no "decode" or "flips":
# "decode_f32" holds its f32 forwards, kernel against plain, at every
# position.
LIMITS = {
    "gemma3-1b": dict(prefill=1e-3, decode=1e-3, flips=1, prefill_f32=4e-7, decode_f32=3e-6),
    "zamba2-7b": dict(prefill=0.12, decode=0.13, flips=10, prefill_f32=3e-5, decode_f32=3e-5),
    "rwkv6-3b": dict(prefill=0.1, decode=0.3, flips=22, prefill_f32=2e-5, decode_f32=1e-3),
    "minicpm3-4b": dict(prefill=0.08, decode=0.08, flips=1, prefill_f32=6e-6, decode_f32=5e-6),
    "deepseek-v2-lite-16b": dict(prefill=0.06, decode=0.06, flips=2, prefill_f32=3e-6,
                                 decode_f32=6e-6, route_flips=0.2),
    "starcoder2-7b": dict(prefill=0.04, decode=0.05, flips=2, prefill_f32=5e-6, decode_f32=4e-6),
    "phi-3-vision-4.2b": dict(prefill=0.05, prefill_f32=1e-5, decode_f32=8e-6),
    "musicgen-medium": dict(prefill=0.03, prefill_f32=3e-6, decode_f32=2e-6),
    "deepseek-v3-671b": dict(prefill=0.02, decode=0.025, flips=4, prefill_f32=5e-6,
                             decode_f32=1e-5, route_flips=0.2, ties=True),
}
DECODE_LEN = 64  # the f32 decode-vs-forward prompt
# ticks of each serving phase's profile window: 4, cut from 24 and then 8 to
# keep the run, its training and examples phases included, under 700 s
# (PERF.md 4); ms a tick and the busy share are still read
PROFILE_TICKS = 4
# zamba2-7b's short prefill check: a prompt under 64 tokens whose SSD chunk
# (min(64, pick_chunk(S)) = 48) has no tile instance of its own
SHORT_LEN = 48


def drop_free(cfg):
    """``cfg`` with, for a MoE model, the capacity at which no choice is
    dropped (E / top_k), as tests/test_arch_smoke.py sets it for decode
    against forward: the forward dispatches a sequence a group and decode the
    slot batch, so at the configured capacity the two drop different
    choices."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


class Routing:
    """A MoE model's expert choices, recorded from one run and replayed in
    another, so that the two runs of a comparison route every token alike: a
    rounding difference in a hidden state flips the top-k of near-tied
    experts, and a flipped choice moves a token's whole expert output (the
    CPU tests hold the port to the JAX package at bf16 the same way).
    ``flips`` counts the choices in which the replaying run's own router
    differed. For a model without MoE blocks both contexts do nothing."""

    def __init__(self, cfg, choices: list | None = None):
        self.on = cfg.n_experts > 0
        self.choices: list = choices or []
        self.own: list = []  # the replaying run's own choices, in call order
        self.flips = self.total = 0

    @contextlib.contextmanager
    def _topk(self, fn):
        if not self.on:
            yield
            return
        saved = torch.topk
        torch.topk = functools.partial(fn, saved)
        try:
            yield
        finally:
            torch.topk = saved

    def record(self):
        def recording(topk, probs, k, dim=-1):
            out = topk(probs, k, dim=dim)
            self.choices.append(out[1])
            return out

        self.choices = []
        return self._topk(recording)

    def replay(self, per_token: bool = False):
        """Each MoE block takes the recorded choices in call order; with
        ``per_token`` a decode step's block takes its token's choices from
        the recorded forward (call c: MoE layer c % L, token c // L)."""
        calls = itertools.count()
        self.own = []

        def replaying(topk, probs, k, dim=-1):
            c, L = next(calls), len(self.choices)
            ref = self.choices[c % L]
            if per_token:
                ref = ref[:, c // L : c // L + 1]
            own = topk(probs, k, dim=dim)[1]
            self.own.append(own)
            self.flips += int((own != ref).sum())
            self.total += ref.numel()
            return probs.gather(-1, ref), ref

        return self._topk(replaying)

    @staticmethod
    def recompute_flips(choices: list, layers: int) -> int:
        """The choices a train step's remat recompute made otherwise than its
        forward. Each microbatch calls top-k for its ``layers`` MoE layers
        in order, then again in the backward's recompute, last layer first
        (the stack's non-reentrant checkpoints run its units backwards)."""
        assert len(choices) % (2 * layers) == 0, (len(choices), layers)
        flips = 0
        for start in range(0, len(choices), 2 * layers):
            forward = choices[start:start + layers]
            recompute = choices[start + layers:start + 2 * layers][::-1]
            for a, b in zip(forward, recompute):
                assert a.shape == b.shape, (a.shape, b.shape)
                flips += int((a != b).sum())
        return flips

    def forward_only(self, cfg, layers: int) -> "Routing":
        """A Routing that replays the recorded train step's forward choices
        only (each microbatch's first ``layers`` calls), for a run that
        takes no gradient."""
        chosen = [c for start in range(0, len(self.choices), 2 * layers)
                  for c in self.choices[start:start + layers]]
        return Routing(cfg, chosen)

    def check(self, label: str, limit: float) -> None:
        """The share of replayed choices the run's own router made otherwise,
        at most ``limit``."""
        if not self.on:
            return
        share = self.flips / self.total
        log(f"[routing] {label}: {self.flips} of {self.total} expert choices differ ({share:.3g}, "
            f"limit {limit})")
        assert share <= limit, f"{label}: {share} of the expert choices differ"


# the MoE check's tolerance against its per-expert reference: bf16's, as
# tests/test_torch_moe.py holds moe_apply to the JAX package's
MOE_TOL = 2e-2


class MoeCapture:
    """A MoE model's dispatch in one run: every MoE layer's destinations
    (``_dispatch_group``'s dst; the overflow row E*C marks a dropped
    choice) and the first layer's parameters, input, expert choices and
    output. The port's functions run unchanged; the capture keeps
    references only."""

    def __init__(self):
        self.dst: list = []
        self.first: dict = {}

    @contextlib.contextmanager
    def capture(self):
        apply, dispatch = moe_mod.moe_apply, moe_mod._dispatch_group

        def dispatching(x, topi, C, cfg):
            out = dispatch(x, topi, C, cfg)
            self.dst.append((out[1], cfg.n_experts * C))
            if "topi" not in self.first:
                self.first.update(topi=topi, C=C)
            return out

        def applying(p, cfg, x):
            y, aux = apply(p, cfg, x)
            if "x" not in self.first:
                self.first.update(p=p, x=x, y=y)
            return y, aux

        moe_mod.moe_apply, moe_mod._dispatch_group = applying, dispatching
        try:
            yield
        finally:
            moe_mod.moe_apply, moe_mod._dispatch_group = apply, dispatch

    def check(self, label: str, cfg, dropped_frac: float) -> None:
        """The run's ``moe_dropped_frac`` (summed over the layers) equals the
        dropped share of the destinations the dispatch returned; and the
        first layer's output equals a per-expert reference on the same input
        and expert choices: each expert takes its choosers in the dispatch's
        order (first choices in token order, then second choices, ...), its
        first C, through plain matrix products, and the gated outputs are
        summed into their tokens (``index_add_``). Its kept choices must be
        the dispatch's exactly. At S=32768 deepseek-v3-671b's buffer passes
        2**31 elements (327,681 rows of 7168): this holds the port's scatter,
        views and gathers there against indexing that never builds it."""
        shares = [float((dst == overflow).sum()) / dst.numel() for dst, overflow in self.dst]
        f = self.first
        p, x, y, topi, C = f["p"], f["x"][0], f["y"][0], f["topi"][0], f["C"]
        E, k = cfg.n_experts, cfg.top_k
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        gates = probs.gather(-1, topi)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        want = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        kept = torch.zeros(topi.shape, dtype=torch.bool, device=x.device)
        for e in range(E):
            j, t = (topi.T == e).nonzero(as_tuple=True)  # choice-major, then token order
            j, t = j[:C], t[:C]
            kept[t, j] = True
            xe = x[t]
            up = xe @ p["w_up"][e]
            h = silu(xe @ p["w_gate"][e]) * up if "w_gate" in p else gelu_tanh(up)
            want.index_add_(0, t, (h @ p["w_down"][e]).float() * gates[t, j, None])
        want = want.to(x.dtype)
        if "shared" in p:
            want = want + mlp_apply(p["shared"], x)
        dst, overflow = self.dst[0]
        out = {"layers": len(shares), "buffer_elements": (overflow + 1) * x.shape[-1],
               "dropped_frac": sum(shares), "aux_dropped_frac": dropped_frac,
               "first_layer_dropped": shares[0],
               "kept_equal": bool(torch.equal(kept, dst[0] != overflow)),
               "limit_ratio": row_limit_ratio(y, want, MOE_TOL)}
        log(f"[moe] {label}: {json.dumps(out)}")
        assert np.isfinite(dropped_frac), f"{label}: moe_dropped_frac {dropped_frac}"
        assert abs(dropped_frac - out["dropped_frac"]) <= 1e-5 * max(1.0, len(shares)), (
            f"{label}: moe_dropped_frac {dropped_frac}, the dispatch dropped {out['dropped_frac']}")
        assert out["kept_equal"], f"{label}: the dispatch kept other choices than the reference"
        assert out["limit_ratio"] <= 1.0, f"{label}: MoE output off its reference: {out}"


@contextlib.contextmanager
def plain_kernels():
    """Route the model's attention and scans through the kernels' plain
    versions (on the card) instead of the kernels, for a reference run."""
    saved = model_attention.flash_attention, ops.ssd_scan, ops.rwkv6_scan

    def attention(q, k, v, *, causal=True, window=0, scale=None, chunk=1024):
        return fa.blockwise_attention(q, k, v, window=window, chunk=chunk, scale=scale,
                                      causal=causal)

    model_attention.flash_attention = attention
    ops.ssd_scan, ops.rwkv6_scan = SCANS["ssd_scan"][1], SCANS["rwkv6_scan"][1]
    try:
        yield
    finally:
        model_attention.flash_attention, ops.ssd_scan, ops.rwkv6_scan = saved


# a profiler session may not record launches made in its first moments,
# some or all of them (63 of 64 known launches in two chip_smoke runs on the
# H100; scripts/torch_profiler_probe.py there: sessions that lost launches,
# 3 of 800 with no pause or 1 ms, 1 of 700 with 5 ms, none of 300 with 20
# ms; PERF.md section 6), so each window waits this long after its session
# starts
PROFILER_SETTLE_S = 0.02


def profile_window(label: str, card: str, fn, *args, grids: dict | None = None,
                   expect_kernels: int | None = None) -> dict:
    """Where one window's time goes: ``torch.profiler`` kernel intervals on
    the card, their union over the host's wall clock (the device's busy
    share), and the kernels that took the most device time. It records the
    device's activity only and reads the trace's raw events
    (``prof.profiler.kineto_results.events()``, which is not public API;
    read on PyTorch 2.11 and 2.13), not the profiler's per-op event tree:
    recording the host's ops too doubled a window's cost and inflated its
    wall clock (PERF.md section 4). ``grids`` maps a name to substrings of
    kernel names: the result's ``device_grids`` counts the device launches
    whose name holds one. With ``expect_kernels`` the raw events must hold
    exactly that many device kernels, as many as the public event tree
    (``prof.events()``), with the same summed time: a PyTorch that drops or
    doubles raw events fails there (``profiler_check``). ``fn`` starts
    PROFILER_SETTLE_S after the session does (outside the wall clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(  # microseconds, as the profiler's event tree gives them
        (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA
        and not getattr(e, "is_hidden_event", lambda: False)()
    )
    if expect_kernels is not None:
        tree = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                      for e in prof.events() if e.device_type == DeviceType.CUDA)
        assert len(spans) == len(tree) == expect_kernels, (
            f"{label}: {len(spans)} raw device kernels, {len(tree)} in the event tree, "
            f"{expect_kernels} launched")
        # the raw events' times are whole microseconds (PyTorch 2.11), the
        # tree's finer: each kernel's two readings within 1 us
        worst = max(abs((stop - start) - us) for (start, stop, _), (_, us) in zip(spans, tree))
        log(f"[profile] {label}: raw and tree durations {worst:.3f} us apart at most")
        assert worst <= 1.0, (label, worst)
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for start, stop, name in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_kernels": len(spans),
        "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top],
    }
    if grids:
        out["device_grids"] = {key: sum(1 for _, _, name in spans if any(s in name for s in subs))
                               for key, subs in grids.items()}
    log(f"[profile] {label}: {json.dumps(out)} [{card}]")
    return out


# the profiler check's window: this many launches of one elementwise kernel
PROFILER_CHECK_KERNELS = 64


def profiler_check(device, card) -> None:
    """profile_window's raw device events against the profiler's event tree
    on a window of known launches, before any window is read."""
    x = torch.zeros(1 << 20, device=device)

    def adds():
        for _ in range(PROFILER_CHECK_KERNELS):
            x.add_(1.0)

    profile_window("profiler check", card, adds, expect_kernels=PROFILER_CHECK_KERNELS)


def gap_share(label: str, got, want) -> float:
    """The largest logit difference as a share of the largest logit; read,
    not held to a limit."""
    share = float((got - want).abs().max()) / float(want.abs().max())
    log(f"[{label}] {json.dumps({'gap_share': share})}")
    return share


def logits_close(label: str, got, want, atol: float, min_top1: float,
                 ties: bool = False) -> dict:
    """Logits within ``atol`` of the largest logit, with the same top-1 token
    at a share of at least ``min_top1`` of the positions. ``top1_gap`` is
    the largest amount by which ``want`` scores ``got``'s top-1 token under
    its own; with ``ties`` a position whose top-1 differs by no more than
    the logit limit is a near-tie, and agrees."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    gap = want.amax(-1) - want.gather(-1, got.argmax(-1, keepdim=True))[..., 0]
    same = got.argmax(-1) == want.argmax(-1)
    if ties:
        same |= gap <= atol * scale
    top1 = float(same.float().mean())
    out = {"max_abs_err": err, "max_abs_logit": scale, "gap_share": err / scale,
           "atol": atol * scale, "top1_agree": top1, "min_top1": min_top1,
           "top1_gap": float(gap.max()), "ties": ties}
    log(f"[{label}] {json.dumps(out)}")
    assert err <= atol * scale, f"{label}: logits differ by {err} > {atol * scale}"
    assert top1 >= min_top1, f"{label}: top-1 agreement {top1} < {min_top1}"
    return out


def prompt_tokens(cfg, device) -> torch.Tensor:
    """(1, PREFILL_LEN) tokens from the seed: the prefill's prompt, whose
    first CHECK_LEN and first DECODE_LEN tokens the checks take."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (1, PREFILL_LEN))).to(device)


def frontend_embeds(cfg, device) -> torch.Tensor | None:
    """A frontend model's stubbed embeddings (1, frontend_tokens, d_model):
    standard normal from the seed, as the data pipeline makes them, rounded
    to bf16 as the training driver feeds them (so the f32 checks see the
    same values). None for a text-only model."""
    if not cfg.frontend:
        return None
    rng = np.random.default_rng(SEED + 2)
    embeds = rng.standard_normal((1, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(embeds).to(device).to(torch.bfloat16)


def backbone_inputs(cfg, S: int, device) -> tuple:
    """(tokens, frontend_embeds) of a backbone sequence of S positions, as
    the repo's shapes count it (configs/shapes.py): a frontend model's
    embeddings, then the prompt's first S - frontend_tokens tokens; a
    text-only model's first S tokens and None."""
    n = S - (cfg.frontend_tokens if cfg.frontend else 0)
    return prompt_tokens(cfg, device)[:, :n], frontend_embeds(cfg, device)


def prefill_phase(arch: str, device, card) -> tuple:
    """Returns the model, its weights, each kernel's launches by path and
    the plain path's logits at S=4096. A frontend model's S counts its
    frontend embeddings (``backbone_inputs``)."""
    cfg = get_config(arch)
    reduced = None
    if arch in PREFILL_REPEATS:  # full width, the first pattern repeats only
        cut = dataclasses.replace(cfg, n_pattern_repeats=PREFILL_REPEATS[arch])
        reduced = {"layers": [cfg.n_layers, cut.n_layers],
                   "n_pattern_repeats": [cfg.n_pattern_repeats, cut.n_pattern_repeats]}
        cfg = cut
    expect = FORWARD_LAUNCHES[arch]
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    log(f"[prefill] {arch}: {n_params} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s"
        + (f", reduced {json.dumps(dict(reduced, params=n_params))}" if reduced else ""))
    tokens, embeds = backbone_inputs(cfg, PREFILL_LEN, device)
    moe = MoeCapture()  # a MoE model's dispatch, read in the warm-up run
    with moe.capture():  # warm-up: cuBLAS workspaces, the kernels' first load
        _, warm_aux = prefill(params, cfg, tokens, embeds)
    torch.cuda.synchronize()
    if cfg.n_experts:
        moe.check(f"{arch} prefill S={PREFILL_LEN}", cfg, float(warm_aux["moe_dropped_frac"]))
    del moe, warm_aux
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    (logits, aux), counts = counted_all(
        f"{arch} prefill S={PREFILL_LEN} (main path)", expect, prefill, params, cfg, tokens, embeds
    )
    seconds = time.perf_counter() - t0
    assert tuple(logits.shape) == (1, 1, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite prefill logits"
    if cfg.n_experts:  # the MoE blocks' load-balance metrics, summed over the layers
        aux = {k: float(v) for k, v in aux.items()}
        log(f"[prefill] {arch} aux: {json.dumps(aux)}")
        assert sorted(aux) == ["moe_balance_loss", "moe_dropped_frac", "moe_router_zloss"]
        assert all(np.isfinite(v) for v in aux.values()), f"{arch}: non-finite aux {aux}"
    stats = {
        "arch": arch,
        **({"reduced": reduced} if reduced else {}),
        "seq": PREFILL_LEN,
        "frontend_tokens": cfg.frontend_tokens if cfg.frontend else 0,
        "ms": seconds * 1e3,
        "tokens_per_s": PREFILL_LEN / seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "launches": {k: counts[k] for k in expect},
    }
    log(f"[prefill] {json.dumps(stats)} [{card}]")
    short = backbone_inputs(cfg, CHECK_LEN, device)
    routes = Routing(cfg)  # a MoE model's plain run takes the kernel run's choices
    with routes.record():
        (k_logits, _), k_counts = counted_all(
            f"{arch} prefill S={CHECK_LEN} (kernel)", expect, prefill, params, cfg, *short
        )
    with plain_kernels(), routes.replay():
        (p_logits, _), _ = counted_all(f"{arch} prefill S={CHECK_LEN} (plain)", {}, prefill,
                                       params, cfg, *short)
    routes.check(f"{arch} prefill S={CHECK_LEN} plain on the kernel's choices",
                 LIMITS[arch].get("route_flips", 0.0))
    logits_close(f"{arch} prefill S={CHECK_LEN} kernel vs plain", k_logits, p_logits,
                 LIMITS[arch]["prefill"], min_top1=1.0, ties=LIMITS[arch].get("ties", False))
    plain_logits = p_logits
    short_counts = {}
    if "ssd_scan_mma" in expect:  # a chunk with no tile instance of its own
        tiny = tokens[:, :SHORT_LEN]
        (k_logits, _), short_counts = counted_all(
            f"{arch} prefill S={SHORT_LEN} (kernel)", expect, prefill, params, cfg, tiny)
        with plain_kernels():
            (p_logits, _), _ = counted_all(f"{arch} prefill S={SHORT_LEN} (plain)", {}, prefill,
                                           params, cfg, tiny)
        logits_close(f"{arch} prefill S={SHORT_LEN} kernel vs plain", k_logits, p_logits,
                     LIMITS[arch]["prefill"], min_top1=1.0)
    calls = {name: COUNTERS[name].launches for name in GRID_KERNELS}
    prof = profile_window(f"{arch} prefill S={PREFILL_LEN}", card, prefill, params, cfg, tokens,
                          embeds, grids=GRID_KERNELS)
    for name in GRID_KERNELS:
        calls[name] = COUNTERS[name].launches - calls[name]
        if calls[name]:  # the launcher's calls in the profiled prefill
            GRIDS_PER_CALL[name] = prof["device_grids"][name] / calls[name]
            log(f"[profile] {name}: {prof['device_grids'][name]} grids in {calls[name]} calls")
    by_path = {
        name: {f"{arch}:prefill_{PREFILL_LEN}": counts[name],
               f"{arch}:prefill_{CHECK_LEN}": k_counts[name],
               **({f"{arch}:prefill_{SHORT_LEN}": short_counts[name]} if short_counts else {})}
        for name in expect
    }
    return cfg, params, by_path, plain_logits


def serving_phase(arch: str, cfg, params, device, card) -> dict:
    """Returns each kernel's launches by path."""
    spec = SERVING[arch]
    rng = np.random.default_rng(SEED + 1)
    lo, hi = spec["prompt"]
    requests = []
    for i in range(spec["requests"]):
        prompt = rng.integers(1, cfg.vocab, int(rng.integers(lo, hi + 1))).tolist()
        if i == 0 and spec["first"]:  # the prefill prompt's first DECODE_LEN tokens
            prompt = prompt_tokens(cfg, "cpu")[0, :DECODE_LEN].tolist()
        requests.append(Request(uid=i, prompt=prompt, max_new_tokens=spec["new"]))
    eng = ServingEngine(cfg, params, slots=spec["slots"], max_len=spec["max_len"], device=device)
    for r in requests:
        eng.submit(r)
    t0 = time.perf_counter()
    # prefill in the engine is teacher-forced decode, plain PyTorch (as the
    # JAX package's is jnp): the serving loop launches no model kernel
    done, s_counts = counted_all(
        f"{arch} serving (ServingEngine.run_until_drained)", {}, eng.run_until_drained
    )
    seconds = time.perf_counter() - t0
    assert len(done) == len(requests) and all(r.done for r in done), f"{arch}: unfinished"
    assert all(len(r.output) == r.max_new_tokens for r in done)
    generated = sum(len(r.output) for r in done)
    stats = {
        "arch": arch,
        "requests": len(done),
        "slots": spec["slots"],
        "finished": sum(r.done for r in done),
        "ticks": eng.ticks,
        "seconds": seconds,
        "generated_tokens": generated,
        "tokens_per_s": generated / seconds,
        "prompt_tokens": sum(len(r.prompt) for r in done),
        "ms_per_tick": seconds / eng.ticks * 1e3,
    }
    log(f"[serve] {json.dumps(stats)} [{card}]")
    expect = FORWARD_LAUNCHES[arch]
    toks = torch.tensor([requests[0].prompt], device=device)
    n = toks.shape[1]
    paths = {name: {f"{arch}:serving": s_counts[name]} for name in expect}
    t0 = time.perf_counter()
    if cfg.frontend:  # no prefix for the forward to match
        frontend_decode_check(arch, params, cfg, toks, device)
    else:
        # teacher-forced decode of one prompt against the kernel-path
        # forward: what ties the recurrent decode to the kernels
        check = drop_free(cfg)
        routes = Routing(cfg)  # a MoE model's decode takes the forward's choices
        with routes.record():
            (fwd, _), f_counts = counted_all(f"{arch} forward S={n}", expect, forward,
                                             params, check, toks)
        with routes.replay(per_token=True):
            dec, _ = decode_logits(params, check, toks, device)
        routes.check(f"{arch} decode on the forward's choices",
                     LIMITS[arch].get("route_flips", 0.0))
        logits_close(f"{arch} decode vs forward", dec, fwd, LIMITS[arch]["decode"],
                     min_top1=1 - LIMITS[arch]["flips"] / n)
        for name in expect:
            paths[name][f"{arch}:forward_{n}"] = f_counts[name]
    log(f"[time] {arch} decode check {time.perf_counter() - t0:.1f} s")
    # a window of steady serving: every slot busy, prefilling and decoding
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, slots=spec["slots"], max_len=spec["max_len"], device=device)
    for r in requests[: spec["slots"]]:
        eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    eng.tick()  # admit
    ticks = spec.get("ticks", PROFILE_TICKS)
    profile_window(f"{arch} serving, {ticks} ticks", card,
                   lambda: [eng.tick() for _ in range(ticks)])
    log(f"[time] {arch} serving profile window {time.perf_counter() - t0:.1f} s")
    return paths


def decode_logits(params, cfg, toks, device) -> tuple[torch.Tensor, dict]:
    """Teacher-forced decode of ``toks`` (1, n) from an empty cache: the
    logits (1, n, V) and the cache."""
    cache = init_cache(cfg, 1, toks.shape[1], device=device)
    outs = []
    for i in range(toks.shape[1]):
        step_logits, cache = decode_step(params, cfg, cache, toks[:, i : i + 1])
        outs.append(step_logits)
    return torch.cat(outs, 1), cache


def frontend_decode_check(label: str, params, cfg, toks, device) -> None:
    """A frontend model's text-only teacher-forced decode of ``toks`` (1,
    n): finite f32 logits of shape (1, n, V) and a cache length of n, as
    the reference's ``test_frontend_decode_runs`` holds it. Decode launches
    no kernel, and its forward needs the frontend prefix that a text-only
    decode has not seen, so no decode-vs-forward parity is held
    (tests/test_arch_smoke.py skips it for frontend archs)."""
    (dec, cache), _ = counted_all(f"{label} text-only decode", {}, decode_logits, params, cfg,
                                  toks, device)
    n = toks.shape[1]
    out = {"shape": list(dec.shape), "finite": bool(torch.isfinite(dec).all()),
           "length": cache["length"].tolist()}
    log(f"[{label} text-only decode] {json.dumps(out)}")
    assert dec.dtype == torch.float32 and out["shape"] == [1, n, cfg.vocab], out
    assert out["finite"] and out["length"] == [n], out


def scan_rows_vs_f64(arch: str, p32, cfg32, toks) -> dict:
    """Each f32 scan call of the kernel-path forward on ``toks``, at the
    model's own inputs: the kernel's output and its plain version's against
    the sequential oracle computed in f64. Per row (a head's P values at one
    position, which the mixers' per-head norms rescale) the largest error
    over the row's root mean square (``row_rel``), and the ratio to the f32
    tolerance (``tol_ratio``), each the largest over the calls. Fails unless
    the kernel's ``tol_ratio`` is at most 1 at every call."""
    out = {}
    for name, (kernel, plain, oracle) in SCANS.items():
        if name not in F32_LAUNCHES[arch]:
            continue
        calls = []

        def record(*a, chunk, kernel=kernel, calls=calls):
            y = kernel(*a, chunk=chunk)
            calls.append((a, chunk, y))
            return y

        saved = getattr(ops, name)
        setattr(ops, name, record)
        try:
            forward(p32, cfg32, toks)
        finally:
            setattr(ops, name, saved)
        rec = {"calls": len(calls)}
        for label in ("kernel", "plain"):
            row_rel, tol_ratio = [], []
            for a, chunk, y in calls:
                got = y if label == "kernel" else plain(*a, chunk=chunk)
                truth, _ = oracle(*a, acc=torch.float64)
                row_rel.append(row_limit_ratio(got, truth, 0.0, 1.0))
                tol_ratio.append(row_limit_ratio(got, truth, *SCAN_TOL[torch.float32]))
            rec[label] = {"row_rel": max(row_rel), "row_rel_call": row_rel.index(max(row_rel)),
                          "tol_ratio": max(tol_ratio)}
        log(f"[{arch} f32 {name} vs f64 oracle, S={toks.shape[1]}] {json.dumps(rec)}")
        assert rec["kernel"]["tol_ratio"] <= 1.0, f"{arch} {name} off the f64 oracle: {rec}"
        out[name] = rec
    return out


def upcast_in_place(tree) -> None:
    """Every tensor of ``tree`` (dicts and lists, and tuples of them)
    replaced by its f32 copy, one at a time, each bf16 tensor freed before
    the next is copied: the peak is the f32 tree and one bf16 tensor, not
    both trees (deepseek-v3-671b's 4 layers: 60.4 GB and 7.5 GB, against
    60.4 GB and 30.2 GB)."""
    for key in (tree if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[key], torch.Tensor):
            tree[key] = tree[key].float()
        elif tree[key] is not None:
            upcast_in_place(tree[key])


def f32_phase(arch: str, cfg, params, device, card, bf16_plain=None) -> tuple[dict, dict]:
    """The logit checks with the same weights upcast to f32: kernel path
    against plain path at S=4096, and on the first 64 tokens decode against
    the kernel-path forward, decode against the plain-path forward, and the
    two forwards against each other; then each f32 scan call of that
    forward against its f64 oracle (``scan_rows_vs_f64``). What the bf16
    checks show beyond these gaps is the amplification of bf16 rounding, not
    the kernels. The kernel-path prefill is then profiled once (the f32
    scans' grids a call) and timed warm with CUDA events. A model in
    F32_REPEATS runs these checks on its first groups only. ``bf16_plain``,
    the bf16 plain path's logits at S=4096, is read against the f32 plain
    path's: the gap bf16 rounding alone makes. A frontend model's prefills
    take its embeddings within S (``backbone_inputs``), its forwards the 64
    tokens after them; its text-only decode is held finite
    (``frontend_decode_check``), not to a forward. The weights are upcast
    in place (``upcast_in_place``): the caller's ``params`` hold the f32
    weights after it, so this phase comes last. Returns each kernel's
    launches by path and the prefill's record."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if arch in F32_REPEATS:  # the first groups only
        repeats = F32_REPEATS[arch]
        cfg32 = dataclasses.replace(cfg32, n_pattern_repeats=repeats)
        params["stack"]["groups"] = params["stack"]["groups"][:repeats]
        log(f"[f32] {arch}: {cfg32.n_layers} of {cfg.n_layers} layers, full width")
    upcast_in_place(params)
    p32 = params
    short = backbone_inputs(cfg, CHECK_LEN, device)
    expect = F32_LAUNCHES[arch]
    routes = Routing(cfg)
    with routes.record():
        (k_logits, _), k_counts = counted_all(f"{arch} f32 prefill S={CHECK_LEN} (kernel)",
                                              expect, prefill, p32, cfg32, *short)
    with plain_kernels(), routes.replay():
        (p_logits, _), _ = counted_all(f"{arch} f32 prefill S={CHECK_LEN} (plain)", {}, prefill,
                                       p32, cfg32, *short)
    routes.check(f"{arch} f32 prefill S={CHECK_LEN} plain on the kernel's choices",
                 LIMITS[arch].get("route_flips", 0.0))
    logits_close(f"{arch} f32 prefill S={CHECK_LEN} kernel vs plain", k_logits, p_logits,
                 LIMITS[arch]["prefill_f32"], min_top1=1.0)
    if bf16_plain is not None:  # bf16 rounding alone: the bf16 plain path against the f32 one
        gap_share(f"{arch} bf16 plain vs f32 plain prefill S={CHECK_LEN}", bf16_plain, p_logits)
    calls = {name: COUNTERS[name].launches for name in GRID_KERNELS}
    prof = profile_window(f"{arch} f32 prefill S={CHECK_LEN}", card, prefill, p32, cfg32,
                          *short, grids=GRID_KERNELS)
    for name in GRID_KERNELS:
        calls[name] = COUNTERS[name].launches - calls[name]
        if calls[name] and name in expect:
            GRIDS_PER_CALL[name] = prof["device_grids"][name] / calls[name]
            log(f"[profile] {name}: {prof['device_grids'][name]} grids in {calls[name]} calls")
    stats = {"arch": arch, "dtype": "float32", "seq": CHECK_LEN, "layers": cfg32.n_layers,
             "ms": time_call(prefill, (p32, cfg32, *short), {}, reps=2, warm=0)}
    stats["tokens_per_s"] = CHECK_LEN / stats["ms"] * 1e3
    log(f"[prefill] {json.dumps(stats)} [{card}]")
    toks = prompt_tokens(cfg, device)[:, :DECODE_LEN]
    embeds = frontend_embeds(cfg, device)
    cfg32 = drop_free(cfg32)  # decode against forward: as in the serving phase
    routes = Routing(cfg)  # decode and the plain forward take the kernel forward's choices
    with routes.record():
        (fwd, _), f_counts = counted_all(f"{arch} f32 forward S={DECODE_LEN}", expect, forward,
                                         p32, cfg32, toks, embeds)
    if cfg.frontend:
        frontend_decode_check(f"{arch} f32", p32, cfg32, toks, device)
    else:
        with routes.replay(per_token=True):
            dec, _ = decode_logits(p32, cfg32, toks, device)
        routes.check(f"{arch} f32 decode on the forward's choices",
                     LIMITS[arch].get("route_flips", 0.0))
        logits_close(f"{arch} f32 decode vs forward", dec, fwd, LIMITS[arch]["decode_f32"],
                     min_top1=1.0)
    # a second witness of that gap: decode against the plain path's forward,
    # and the kernel path's forward against the plain path's, at this length.
    # Both compare every position, as decode vs forward does, so both take
    # its limit (prefill_f32 was read on a prefill's last position only)
    with plain_kernels(), routes.replay():
        (p_fwd, _), _ = counted_all(f"{arch} f32 forward S={DECODE_LEN} (plain)", {}, forward,
                                    p32, cfg32, toks, embeds)
    if not cfg.frontend:
        logits_close(f"{arch} f32 decode vs plain forward", dec, p_fwd,
                     LIMITS[arch]["decode_f32"], min_top1=1.0)
    logits_close(f"{arch} f32 forward S={DECODE_LEN} kernel vs plain", fwd, p_fwd,
                 LIMITS[arch]["decode_f32"], min_top1=1.0)
    scan_rows_vs_f64(arch, p32, cfg32, toks)
    return {name: {f"{arch}:f32_prefill_{CHECK_LEN}": k_counts[name],
                   f"{arch}:f32_forward_{DECODE_LEN}": f_counts[name]} for name in expect}, stats


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------
# the kernel Functions' gradient checks: tests/test_kernels.py's attention
# shapes (B, S, H, KH, D, Dv, window), MLA's head dims and internlm2-1.8b's
# training shape; each causal at its window, then not causal with scale 0.1
GRAD_FLASH_SHAPES = [
    (1, 128, 4, 4, 64, 64, 0), (2, 256, 8, 2, 64, 64, 0), (1, 256, 4, 1, 128, 128, 0),
    (2, 256, 4, 2, 64, 64, 96), (1, 512, 2, 2, 32, 32, 128), (1, 128, 2, 2, 96, 96, 0),
    (1, 256, 4, 4, 96, 64, 0), (1, 256, 4, 4, 192, 128, 0),  # minicpm3-4b's, deepseek-v2's MLA
    (4, 2048, 16, 8, 128, 128, 0),  # internlm2-1.8b's training batch
]
# the other training runs' attention at B=4, S=2048, causal at the window the
# model passes only: gemma3-1b's windowed and global layers, zamba2-7b's
# shared attention, musicgen-medium's (2048 tokens after 64 embeddings),
# minicpm3-4b's and deepseek-v2-lite-16b's MLA, starcoder2-7b's group of 9
# and phi-3-vision-4.2b's D=96 (2048 tokens after 256 embeddings)
GRAD_FLASH_TRAIN = [(4, 2048, 4, 1, 256, 256, 512), (4, 2048, 4, 1, 256, 256, 0),
                    (4, 2048, 32, 32, 112, 112, 0), (4, 2048 + 64, 24, 24, 64, 64, 0),
                    (4, 2048, 40, 40, 96, 64, 0), (4, 2048, 16, 16, 192, 128, 0),
                    (4, 2048, 36, 4, 128, 128, 0), (4, 2048 + 256, 32, 32, 96, 96, 0)]
# the scans at tests/test_kernels.py's cases, the models' heads at S=4096 and
# at the training batch (zamba2-7b's, rwkv6-3b's)
GRAD_SSD_SHAPES = [*SSD_CASES[:4], SSD_MODEL[1], SSD_TRAIN]
# an SSD case past the cliff: dt 1.5-2.5 and A -8..-12 give log-decays of
# -12..-30 a step, a chunk of 64 sums them far past f32's exp range (88),
# where an unmasked exp's gradient is NaN; the plain gradient must be finite
GRAD_SSD_CLIFF = [(2, 256, 4, 64, 64, 64)]
GRAD_RWKV_SHAPES = [*RWKV_CASES, RWKV_MODEL[1], RWKV_TRAIN]
TRAIN_ARCH = "internlm2-1.8b"  # the reference trainer's family, at full width and depth
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 8
# the reference driver's default; of 3e-3, 1e-3, 3e-4 and 1e-4, the only one
# whose 8th loss was below the first on the H100 (PERF.md section 6). The
# gate is weak: from seed 1 the 8th loss is above the first at this lr
# (scripts/torch_train_probe.py); the kernel-vs-plain step holds the trainer
TRAIN_LR = 3e-3
# a step's bf16 flash launches: 24 attention layers, each in the forward and
# again in remat's recompute
TRAIN_LAUNCHES = {"flash_attention_wgmma": 48}
# kernel path against plain path, one step from the same state and batch:
# relative gaps of the loss and the gradient norm, 3-4x the gaps read on the
# H100 (1.37e-4 and 3.25e-4; PERF.md section 2)
TRAIN_LIMITS = {"loss": 5e-4, "grad_norm": 1e-3}


@dataclasses.dataclass(frozen=True)
class TrainRun:
    """One model's training run at TRAIN_BATCH x TRAIN_SEQ, full width.
    ``launches``: a step's kernel launches, each kernel layer once in the
    forward and once in remat's recompute (the backward runs the plain
    versions); ``limits``: what the kernel-vs-plain step holds, 2-4x what
    was read on the H100 (``kernel_vs_plain_step``: ``loss`` and
    ``grad_norm``, relative gaps; ``spread``, the per-position loss gaps'
    spread over the witness's; ``grad_f32``, the kernel path's gradient
    distance from the f32 plain gradient over the plain path's);
    ``steps``: the entry point's steps (0: none); ``loss_falls``: hold its
    last loss below its first; ``repeats``: the pattern repeats kept where
    the depth is cut; ``train_cfgs``: the kernel-vs-plain comparisons, each
    from a fresh state (a step launches ``launches`` once a microbatch);
    ``route_flips`` in ``limits``: the share of the plain step's expert
    choices the kernel step's own router made otherwise."""
    launches: dict
    limits: dict
    steps: int
    loss_falls: bool = False
    repeats: int | None = None
    train_cfgs: tuple = (TrainConfig(),)


# phase 7's runs, in order. rwkv6-3b: 32 RWKV-6 layers; gemma3-1b: 26 flash
# layers at D=256 (22 windowed at 512, 4 global); musicgen-medium: 48 flash
# layers at D=64 over its 64 frontend embeddings and 2048 tokens, an ungated
# MLP (its limits 2-4x what the H100 read from seed 0: loss and gradient-
# norm gaps 1.04e-4 and 4.65e-4, spread 1.082; PERF.md section 2; its entry
# point 2 steps, cut from 3 for the run's time); zamba2-7b: its full state
# (91 GB) does not fit one card, so 4 of its 13 groups (5 Mamba-2 blocks and
# the shared attention at D=112 each) and its 3 last Mamba-2 blocks, 27 of 81
# layers (the f32 checks' cut, F32_REPEATS); the JAX driver has no depth
# flag, so the cut model has no entry-point run. Limits, against what the
# H100 read from seed 0 (seeds 1 and 2: scripts/torch_train_probe.py;
# PERF.md section 6): gemma3-1b's and zamba2-7b's loss and gradient-norm
# gaps about 3x theirs (1.72e-6 and 4.67e-6; 4.87e-5 and 3.85e-4); spreads
# 0.298 and 0.885 (0.299, 0.883 from seed 1). rwkv6-3b's forward is chaotic
# at the init: a one-step bf16 difference in 0.4% of the scan's outputs (its
# kernel is as close to the f32 plain scan as the bf16 plain scan is) moves
# each position's loss by 2.7 (the loss is 195), as the whole bf16-vs-f32
# difference does (2.5), so a loss gap is one draw of noise whose standard
# error is 1.39e-4 of the loss: the kernel path read 3.61e-4 (2.6 standard
# errors), 6.1e-5 and 8.2e-5 from seeds 1 and 2, the witness 1.5e-5,
# 1.55e-4 and 1.24e-4; the limit is about 2x the gap, 5.4 standard errors.
# Its spread read 1.092 (1.119, 1.098). Its bf16 gradient at the init is
# decided by a few first-position rows whose group-norm variance is near
# norm_eps (the bf16 plain path's gradient norm 6.9x the f32 one's, its
# gap to the kernel path's 0.776), so no gradient-norm gap is held there;
# the kernel path's gradient is held no farther from the f32 plain gradient
# than 2x the plain path's (0.254; 1.050 and 1.171 from seeds 1 and 2).
# minicpm3-4b: 62 MLA layers at (96, 64), the q LoRA, full depth; its state
# is 42.6 GB (bf16 parameters, f32 moments), so the plain step's updated
# parameters go to the host before the kernel step (HOST_PLAIN_SHARE).
# deepseek-v2-lite-16b: its full state (188 GB) does not fit one card, so
# its dense first layer and 3 of its 26 MoE layers (the f32 checks' cut,
# F32_REPEATS), 4 MLA layers at (192, 128), and no entry point; the kernel
# and plain steps route alike (Routing), once at TrainConfig() and once,
# from a fresh state, with two microbatches and the MTP head
# (MOE_TRAIN_CFG). phi-3-vision-4.2b: 32 flash layers at D = Dv = 96 over
# its 256 frontend embeddings and 2048 tokens, full depth; its state and
# three copies of the parameters (61.1 GB) stay within HOST_PLAIN_SHARE of
# the card. starcoder2-7b: its full state and gradients (89 GB) do not fit
# one card, so 12 of its 32 layers (n_pattern_repeats 32 -> 12), a GQA
# group of 9 (36/4 heads of D=128), and no entry point, as for zamba2-7b.
# Limits 2-4x what the H100 read from seed 0 (PERF.md section 2):
# minicpm3-4b's loss and gradient-norm gaps 9.58e-5 and 8.08e-4, spread
# 1.136; deepseek-v2-lite-16b's, the larger of its two comparisons, 6.72e-6
# and 1.85e-4, spread 1.038, and its kernel step's own router differed in
# 3.51% of the choices (10,360 of 294,912); phi-3-vision-4.2b's 1.67e-5 and
# 6.67e-4, spread 1.144; starcoder2-7b's 7.50e-6 and 1.63e-4, spread 1.142
MOE_TRAIN_CFG = TrainConfig(microbatches=2, mtp_weight=0.3)
# the comparison moves the plain step's updated parameters to the host
# before the kernel step where the state and three copies of the parameters
# (the plain copy, both paths' gradients) would take more than this share of
# the card (85.0e9 bytes on the H100 80GB HBM3, so 63.8 GB): minicpm3-4b's
# 68.2 GB (with its plain gradients on the host too its comparison peaked at
# 66.5 GB); the other runs' 16-61 GB stay on the card (rwkv6-3b's 46 GB
# peaked at 64.3, phi-3-vision-4.2b's 61.1 GB at 67.0)
HOST_PLAIN_SHARE = 0.75
TRAIN_RUNS = {
    TRAIN_ARCH: TrainRun(TRAIN_LAUNCHES, TRAIN_LIMITS, TRAIN_STEPS, loss_falls=True),
    "rwkv6-3b": TrainRun({"rwkv6_scan_mma": 64},
                         {"loss": 7.5e-4, "spread": 2.25, "grad_f32": 2.0}, 2),
    "gemma3-1b": TrainRun({"flash_attention_wgmma": 52},
                          {"loss": 5e-6, "grad_norm": 1.5e-5, "spread": 1.0}, 3),
    "musicgen-medium": TrainRun({"flash_attention_wgmma": 96},
                                {"loss": 3e-4, "grad_norm": 1.5e-3, "spread": 2.5}, 2),
    "zamba2-7b": TrainRun({"ssd_scan_mma": 46, "flash_attention_wgmma": 8},
                          {"loss": 1.5e-4, "grad_norm": 1.2e-3, "spread": 2.0}, 0, repeats=4),
    "minicpm3-4b": TrainRun({"flash_attention_wgmma": 124},
                            {"loss": 3e-4, "grad_norm": 2.5e-3, "spread": 2.5}, 2),
    "deepseek-v2-lite-16b": TrainRun(
        {"flash_attention_wgmma": 8},
        {"loss": 2e-5, "grad_norm": 6e-4, "spread": 2.5, "route_flips": 0.1}, 0, repeats=3,
        train_cfgs=(TrainConfig(), MOE_TRAIN_CFG)),
    "phi-3-vision-4.2b": TrainRun({"flash_attention_wgmma": 64},
                                  {"loss": 5e-5, "grad_norm": 2e-3, "spread": 2.5}, 2),
    "starcoder2-7b": TrainRun({"flash_attention_wgmma": 24},
                              {"loss": 2e-5, "grad_norm": 5e-4, "spread": 2.5}, 0, repeats=12),
}


def grad_row_share(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """The largest ``|got - want|`` over the root mean square of its row
    (last axis) of ``want``, over the entries finite in both, and the count
    of the others."""
    g, w = got.float(), want.float()
    finite = torch.isfinite(g) & torch.isfinite(w)
    g, w = torch.where(finite, g, 0.0), torch.where(finite, w, 0.0)
    rms = w.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((g - w).abs() / rms).max()), int((~finite).sum())


def grad_case(label: str, function, hsd, plain, args, kw: dict, seed: int, card: str) -> dict:
    """A kernel Function against the plain version on the card: its output
    must equal the kernel's and each input's gradient autograd's through the
    plain version, bit for bit, for a seeded output gradient. Read, not
    held: each gradient's largest gap to the f32 plain version's (inputs
    upcast) as a share of its row's RMS, and the entries that are not finite
    in either (held at 0 past the SSD's cliff, GRAD_SSD_CLIFF: the SSD plain
    version masks its exponent above a chunk's diagonal, where the JAX twin's
    overflows and its gradient is NaN)."""
    t0 = time.perf_counter()
    ins = [a.detach().clone().requires_grad_() for a in args]
    out = function.apply(*ins, kw)
    with torch.no_grad():
        kernel_out = hsd(*args, **kw)
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    cot = torch.randn(out.shape, generator=gen, device=args[0].device).to(out.dtype)
    got = torch.autograd.grad(out, ins, cot)
    ref_in = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(plain(*ref_in, **kw), ref_in, cot)
    if all(a.dtype == torch.float32 for a in args):  # the plain version is the f32 one
        f32 = want
    else:
        f32_in = [a.detach().float().requires_grad_() for a in args]
        f32 = torch.autograd.grad(plain(*f32_in, **kw), f32_in, cot.float())
    torch.cuda.synchronize()
    shares = [grad_row_share(g, w) for g, w in zip(got, f32)]
    rec = {"case": label, "output_equal": same_bits(out.detach(), kernel_out),
           "grads_equal": [same_bits(g, w) for g, w in zip(got, want)],
           "f32_row_share": max(s for s, _ in shares),
           "non_finite": sum(n for _, n in shares), "s": time.perf_counter() - t0}
    log(f"[grad] {json.dumps(rec)} [{card}]")
    assert rec["output_equal"], f"{label}: the Function's output is not the kernel's"
    assert all(rec["grads_equal"]), f"{label}: gradients differ from the plain version's"
    return rec


def grad_checks(device, card) -> int:
    """Every kernel Function's gradient check; returns the count of cases."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for shape, model_only in [(s, False) for s in GRAD_FLASH_SHAPES] + [
                (s, True) for s in GRAD_FLASH_TRAIN]:
            B, S, H, KH, D, Dv, window = shape
            gen = torch.Generator(device=device).manual_seed(SEED + S + H + D)
            q = torch.randn((B, H, S, D), generator=gen, device=device).to(dtype)
            k = torch.randn((B, KH, S, D), generator=gen, device=device).to(dtype)
            v = torch.randn((B, KH, S, Dv), generator=gen, device=device).to(dtype)
            variants = [(True, window, None)] + ([] if model_only else [(False, 0, 0.1)])
            for causal, win, scale in variants:
                kw = dict(causal=causal, window=win, scale=scale, chunk=pick_chunk(S))
                grad_case(f"flash {(B, S, H, KH, D, Dv)} causal={causal} window={win} "
                          f"scale={scale} {name}", fa.FlashAttention, fa.flash_attention_hsd,
                          fa.flash_attention_plain, (q, k, v), kw, SEED + n, card)
                n += 1
            del q, k, v
        for shape, cliff in [(s, False) for s in GRAD_SSD_SHAPES] + [
                (s, True) for s in GRAD_SSD_CLIFF]:
            x, dt, A, Bm, Cm = scan_inputs("ssd_scan", shape, dtype, device)
            if cliff:
                gen = torch.Generator(device=device).manual_seed(SEED + n)
                dt = 1.5 + torch.rand(dt.shape, generator=gen, device=device)
                A = -8.0 - 4.0 * torch.rand(A.shape, generator=gen, device=device)
            rec = grad_case(f"ssd {shape}{' cliff' if cliff else ''} {name}", ssd.SSDScan,
                            ssd.ssd_scan_hsd, ssd.ssd_scan_plain,
                            (x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm),
                            dict(chunk=shape[-1]), SEED + n, card)
            assert not (cliff and rec["non_finite"]), f"ssd {shape} cliff: non-finite gradients"
            n += 1
        for shape in GRAD_RWKV_SHAPES:
            r, k, v, logw, u = scan_inputs("rwkv6_scan", shape, dtype, device)
            grad_case(f"rwkv6 {shape} {name}", rw.RWKV6Scan, rw.rwkv6_scan_hsd,
                      rw.rwkv6_scan_plain, (*(t.transpose(1, 2) for t in (r, k, v, logw)), u),
                      dict(chunk=shape[-1]), SEED + n, card)
            n += 1
        torch.cuda.empty_cache()
    return n


CARD_STATE_BYTES: dict[str, int] = {}


def train_config(arch: str):
    """The run's config: the model's, at TRAIN_RUNS' depth."""
    cfg = get_config(arch)
    repeats = TRAIN_RUNS[arch].repeats
    return cfg if repeats is None else dataclasses.replace(cfg, n_pattern_repeats=repeats)


def train_batch(cfg, device, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                seed: int = SEED) -> dict:
    """Step 0 of the synthetic data pipeline at the training shape, as
    ``launch/train.py`` builds and feeds it: a frontend model's ``seq``
    tokens follow its frontend embeddings, cast to bf16."""
    front = cfg.frontend_tokens if cfg.frontend else 0
    dcfg = DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq + front, seed=seed,
                      frontend_tokens=front, d_model=cfg.d_model)
    return train_driver._to_device(synthetic_batch(dcfg, 0), device)


def train_opt(cfg) -> AdamWConfig:
    """``launch/train.py``'s AdamW settings for a TRAIN_STEPS run."""
    return AdamWConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 1),
                       total_steps=TRAIN_STEPS, moment_dtype=cfg.optimizer_state_dtype,
                       factored_second_moment=cfg.optimizer_factored)


def entry_point_run(arch: str, device, card) -> tuple[dict, dict]:
    """``launch/train.py`` at full width for the run's steps, exactly its
    launches a step: finite losses (with ``loss_falls``, the last below the
    first). Returns its record and its launches."""
    run = TRAIN_RUNS[arch]
    argv = ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(run.steps), "--lr", str(TRAIN_LR), "--log-every", "1",
            "--seed", str(SEED)]
    expect = {k: n * run.steps for k, n in run.launches.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out, counts = counted_all(f"{arch} launch.train.main, {run.steps} steps (main path)",
                              expect, train_driver.main, argv)
    seconds = time.perf_counter() - t0
    losses = out["losses"]
    assert len(losses) == run.steps and all(np.isfinite(losses)), losses
    if run.loss_falls:
        assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    steady = sorted(out["step_seconds"][1:])[len(out["step_seconds"][1:]) // 2]
    rec = {"arch": arch, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "frontend_tokens": train_config(arch).frontend_tokens, "steps": run.steps,
           "lr": TRAIN_LR, "losses": losses, "call_s": seconds,
           "first_step_ms": out["step_seconds"][0] * 1e3, "ms_per_step": steady * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
           "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "launches": {k: counts[k] for k in run.launches}}
    log(f"[train] {json.dumps(rec)} [{card}]")
    return rec, counts


def train_step_once(state, cfg, opt, batch, train_cfg: TrainConfig = TrainConfig()):
    """One train step, keeping its gradients: what ``make_train_step``'s step
    runs (``loss_and_grads``, then ``apply_updates``)."""
    grads, metrics = loss_and_grads(state["params"], cfg, train_cfg, batch)
    _, state["opt"], opt_metrics = apply_updates(opt, state["params"], grads, state["opt"])
    return grads, {k: float(v) for k, v in {**metrics, **opt_metrics}.items()}


@contextlib.contextmanager
def position_losses(store: list):
    """Each loss the block computes through ``loss_and_grads`` also kept in
    ``store``: the CE by position (B, S) in f64, from the logits the loss
    takes (no second forward), and the MoE terms of its aux (the layers'
    sums), as ``(ce, {name: f32 scalar})``; one entry a microbatch."""
    saved = train_step_mod.total_loss

    def loss(logits, labels, aux, **kw):
        with torch.no_grad():
            store.append((position_ce(logits, labels),
                          {k: v.detach().float() for k, v in aux.items() if k.startswith("moe_")}))
        return saved(logits, labels, aux, **kw)

    train_step_mod.total_loss = loss
    try:
        yield
    finally:
        train_step_mod.total_loss = saved


def position_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The CE at each position (B, S), f64, NaN where the label is ignored;
    no host sync, so a step that keeps it runs as it would without."""
    lf = logits.detach().float()
    ce = torch.logsumexp(lf, dim=-1) - lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(labels >= 0, ce.double(), float("nan"))


def labelled(t: torch.Tensor) -> torch.Tensor:
    """The entries of a per-position tensor that are not NaN."""
    return t[~t.isnan()]


def stored_ce(store: list) -> torch.Tensor:
    """The CE by position of a step's microbatches (``position_losses``),
    as one (B, S) tensor."""
    return torch.cat([ce for ce, _ in store])


def stored_moe(store: list) -> dict:
    """A step's MoE terms (``position_losses``), each the mean over its
    microbatches, as floats."""
    return {k: sum(float(aux[k]) for _, aux in store) / len(store) for k in store[0][1]}


def f32_plain_witness(params, cfg, batch, with_grads: bool,
                      train_cfg: TrainConfig = TrainConfig(),
                      routing: Routing | None = None) -> tuple[float, torch.Tensor, dict]:
    """The f32 plain path (weights upcast): its loss (the step's: the CE,
    the MoE terms and an MTP head's, over the microbatches) and its CE by
    position, the witness of what bf16 rounding alone moves, and with
    ``with_grads`` its gradient (leaf path -> f32 gradient; else an empty
    dict). A MoE model's blocks take ``routing``'s choices."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    store: list = []
    routed = routing.replay() if routing is not None else contextlib.nullcontext()
    if not with_grads:
        with torch.no_grad(), plain_kernels(), position_losses(store), routed:
            p32 = tree_map(lambda t: t.detach().float(), params)
            parts = split_microbatches(batch, train_cfg.microbatches)
            loss = sum(float(train_step_mod._loss_fn(p32, cfg32, train_cfg, mb)[0])
                       for mb in parts) / len(parts)
        del p32
        torch.cuda.empty_cache()
        return loss, stored_ce(store), {}
    p32 = tree_map(lambda t: t.detach().float().requires_grad_(), params)
    with plain_kernels(), position_losses(store), routed:
        (grads, metrics), _ = counted_all(f"{cfg.name} f32 plain gradient", {},
                                          loss_and_grads, p32, cfg32, train_cfg, batch)
    del p32
    torch.cuda.empty_cache()
    return float(metrics["loss"]), stored_ce(store), dict(tree_paths(grads))


def spread(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> float:
    """The standard deviation of the per-position gaps ``a - b`` over that
    of ``b - c``."""
    return float(labelled(a - b).std() / labelled(b - c).std())


def f32_distance(grads: dict, g32: dict) -> float:
    """``|grads - g32| / |g32|`` over all leaves, summed in f64 leaf by leaf."""
    num = sum(float((grads[k].double() - g).square().sum()) for k, g in g32.items())
    den = sum(float(g.double().square().sum()) for g in g32.values())
    return (num / den) ** 0.5


def cfg_tag(train_cfg: TrainConfig) -> str:
    """A comparison's suffix in the launches by path: ``""`` at
    TrainConfig(), else its microbatches and MTP head."""
    tag = f"_mb{train_cfg.microbatches}" if train_cfg.microbatches > 1 else ""
    return tag + ("_mtp" if train_cfg.mtp_weight > 0 else "")


def kernel_vs_plain_step(arch: str, device, card,
                         train_cfg: TrainConfig = TrainConfig()) -> dict:
    """One full-width step through the plain versions and one, from the same
    state, through the kernels, holding one training state: the plain step
    runs on a copy of the parameters and the state's zero AdamW moments,
    which are then zeroed again for the kernel step (step 0's moments are
    zero). Exactly the run's launches on the kernel path (once a
    microbatch), none on the plain path. Beside them the witness, the f32
    plain path (a forward, or with ``grad_f32`` in the run's limits a
    gradient): the bf16 plain loss's gap to its loss and the standard error
    of the per-position gaps' mean. What is held to the run's limits: the
    relative gaps of the loss and the gradient norm; ``spread``, the
    per-position loss gaps between the paths over those of the witness
    (standard deviations); ``grad_f32``, the kernel path's gradient distance
    from the f32 gradient over the plain path's; ``route_flips``. No
    gradient all zeros where the plain path's is not; the largest gradient
    and updated-parameter gaps read, leaf by leaf.

    A MoE model's plain step records its expert choices (``Routing``), and
    the kernel step and the witness replay them, in call order: each
    microbatch's forward, then remat's recompute. Within each path the
    recompute must choose as its forward did (else the gradient is another
    function's), and two plain gradients from one state must be equal bit
    for bit (the dispatch's scatters and gathers, and their backward, on
    the card); the MoE terms of both paths are read.

    Where the state and three copies of the parameters would fill more
    than HOST_PLAIN_SHARE of the card, the plain step's updated parameters
    go to the host before the kernel step.

    Then, at the run's first config, a further kernel step is timed (ms,
    tokens/s, peak memory) where no entry point ran, and one more profiled.
    Returns the launches by path."""
    clock = [time.perf_counter()]

    def lap() -> float:
        clock.append(time.perf_counter())
        return round(clock[-1] - clock[-2], 1)

    run = TRAIN_RUNS[arch]
    first = train_cfg == run.train_cfgs[0]
    label = f"{arch}{cfg_tag(train_cfg)}"
    launches = {k: n * train_cfg.microbatches for k, n in run.launches.items()}
    cfg = train_config(arch)
    opt = train_opt(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    state = init_train_state(cfg, opt, SEED, train_cfg=train_cfg, device=device)
    # the training state the card holds (params, AdamW moments, steps): the
    # dry run's (1, 1)-mesh static bytes must equal internlm2-1.8b's
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    if first:
        CARD_STATE_BYTES[arch] = state_bytes
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    mtp = cfg.d_model ** 2 if train_cfg.mtp_weight > 0 else 0  # the MTP head's projection
    assert n_params == cfg.param_count() + mtp, (n_params, cfg.param_count())
    batch = train_batch(cfg, device)
    laps = {"init": lap()}
    routing = Routing(cfg)
    moe_layers = sum(b.mlp == "moe" for b in cfg.blocks)

    def witness_run(forward_routing=None):
        return f32_plain_witness(state["params"], cfg, batch, "grad_f32" in run.limits,
                                 train_cfg, forward_routing)

    if not routing.on:
        witness, ce32, g32 = witness_run()
        laps["witness"] = lap()
    plain = {"params": tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad),
                                state["params"]), "opt": state["opt"]}
    p_store: list = []
    with plain_kernels(), position_losses(p_store), routing.record():
        (p_grads, p_metrics), _ = counted_all(f"{label} train step (plain)", {},
                                              train_step_once, plain, cfg, opt, batch, train_cfg)
    laps["plain_step"] = lap()
    moe = {}
    if routing.on:
        moe["recompute_flips_plain"] = Routing.recompute_flips(routing.choices, moe_layers)
        # the same plain gradient again, from the parameters the plain copy
        # was taken from (the kernel step's, not yet updated), routed by its
        # own router
        with plain_kernels():
            (again, again_metrics), _ = counted_all(f"{label} plain gradient again", {},
                                                    loss_and_grads, state["params"], cfg,
                                                    train_cfg, batch)
        moe["plain_twice_equal_leaves"] = sum(
            same_bits(a, b) for a, b in zip(tree_leaves(again), tree_leaves(p_grads)))
        moe["leaves"] = len(tree_leaves(p_grads))
        moe["plain_twice_equal_metrics"] = all(
            float(again_metrics[k]) == p_metrics[k] for k in again_metrics)
        del again
        witness, ce32, g32 = witness_run(routing.forward_only(cfg, moe_layers))
        laps["witness"] = lap()
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state["params"]))
    host_plain = (state_bytes + 3 * param_bytes
                  > HOST_PLAIN_SHARE * torch.cuda.get_device_properties(device).total_memory)
    if host_plain:  # the kernel step's state, activations and gradients need the room
        plain = {"params": tree_map(lambda t: t.detach().cpu(), plain["params"])}
        torch.cuda.empty_cache()
        laps["to_host"] = lap()
    with torch.no_grad():  # step 0's moments again
        for key, tree in state["opt"].items():
            if key != "step":
                for t in tree_leaves(tree):
                    t.zero_()
    k_store: list = []
    with position_losses(k_store), routing.replay():
        (k_grads, k_metrics), k_counts = counted_all(
            f"{label} train step (kernel)", launches, train_step_once, state, cfg, opt, batch,
            train_cfg)
    laps["kernel_step"] = lap()
    zero, grad_gap, grad_at = 0, 0.0, ""
    for (path, g), (_, w) in zip(tree_paths(k_grads), tree_paths(p_grads)):
        if not bool(g.any()) and bool(w.any()):
            zero += 1
        gap = float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
        if gap > grad_gap:
            grad_gap, grad_at = gap, path
    log(f"[train] {label}: {zero} gradients all zero on the kernel path only")
    assert not zero, f"{label}: {zero} gradients all zero on the kernel path only"
    param_gap = max(float((a.detach().float() - b.detach().to(a.device).float()).abs().max())
                    for a, b in zip(tree_leaves(state["params"]), tree_leaves(plain["params"])))
    p_ce, k_ce = stored_ce(p_store), stored_ce(k_store)
    reads = {k: abs(k_metrics[k] - p_metrics[k]) / abs(p_metrics[k])
             for k in ("loss", "grad_norm")}
    reads["spread"] = spread(k_ce, p_ce, ce32)
    w_gaps = labelled(p_ce - ce32)
    dist = {}
    if g32:
        dist = {"plain": f32_distance(dict(tree_paths(p_grads)), g32),
                "kernel": f32_distance(dict(tree_paths(k_grads)), g32)}
        reads["grad_f32"] = dist["kernel"] / dist["plain"]
    if routing.on:
        assert len(routing.own) == len(routing.choices), (len(routing.own), len(routing.choices))
        reads["route_flips"] = routing.flips / routing.total
        moe.update({"kernel_flips": routing.flips, "choices": routing.total,
                    "recompute_flips_kernel": Routing.recompute_flips(routing.own, moe_layers),
                    "plain": stored_moe(p_store), "kernel": stored_moe(k_store),
                    "capacity": moe_capacity(TRAIN_SEQ, cfg)})
    del plain, p_grads, k_grads, g32  # their cached blocks serve the steps below
    laps["compare"] = lap()
    rec = {"layers": cfg.n_layers, "params": n_params,
           "microbatches": train_cfg.microbatches, "mtp_weight": train_cfg.mtp_weight,
           "kernel": {k: k_metrics[k] for k in ("loss", "grad_norm", "clip_scale", "lr")},
           "plain": {k: p_metrics[k] for k in ("loss", "grad_norm")}, "gaps": reads,
           "limits": run.limits, "f32_plain_loss": witness,
           "witness_loss_gap": abs(p_metrics["loss"] - witness) / abs(witness),
           "witness_loss_se": float(w_gaps.std()) / len(w_gaps) ** 0.5 / abs(witness),
           "grad_distance_from_f32": dist,
           "grads_all_zero_on_kernel_path_only": zero,
           "largest_grad_gap_share": grad_gap, "at": grad_at,
           "largest_param_gap": param_gap, "param_gap_over_lr": param_gap / k_metrics["lr"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "state_gb": state_bytes / 1e9, "plain_params_on_host": host_plain, "moe": moe,
           "launches": {k: k_counts[k] for k in launches}, "seconds": laps}
    if "mtp_ce" in k_metrics:
        rec["mtp_ce"] = {"kernel": k_metrics["mtp_ce"], "plain": p_metrics["mtp_ce"]}
    log(f"[train] {label} kernel vs plain step: {json.dumps(rec)} [{card}]")
    for k, limit in run.limits.items():
        assert reads[k] <= limit, f"{label} train step: {k} {reads[k]} > {limit}"
    if routing.on:
        assert moe["recompute_flips_plain"] == 0 and moe["recompute_flips_kernel"] == 0, (
            f"{label}: remat's recompute chose other experts than its forward")
        assert moe["plain_twice_equal_leaves"] == moe["leaves"], (
            f"{label}: two plain gradients from one state differ")
        assert moe["plain_twice_equal_metrics"], f"{label}: two plain steps' metrics differ"
    if first and not run.steps:  # no entry-point run gave its ms a step
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        train_step_once(state, cfg, opt, batch, train_cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        step = {"arch": arch, "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "ms_per_step": seconds * 1e3, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / seconds,
                "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
                "state_gb": state_bytes / 1e9}
        log(f"[train] {arch} kernel step, timed: {json.dumps(step)} [{card}]")
    if first:
        # a further step, not the compared one: the profiled compared step
        # (the kernel path's first) read busy shares 30-40 points low for
        # internlm2-1.8b and gemma3-1b (PERF.md section 6)
        profile_window(f"{arch} train step, B={TRAIN_BATCH} S={TRAIN_SEQ}", card,
                       train_step_once, state, cfg, opt, batch, train_cfg)
    del state
    torch.cuda.empty_cache()
    tag = cfg_tag(train_cfg)
    return {name: {f"{arch}:train_step{tag}": k_counts[name],
                   f"{arch}:train_step{tag}_plain": 0} for name in launches}


def training_phase(device, card) -> dict:
    """The kernel Functions' gradients, then for each of TRAIN_RUNS the entry
    point at full width (where it has steps) and, for each of its configs, a
    kernel-path step against a plain-path step. Returns the launches by
    path."""
    t0 = time.perf_counter()
    n = grad_checks(device, card)
    log(f"[time] {n} kernel gradient checks {time.perf_counter() - t0:.1f} s")
    paths: dict[str, dict] = {}
    records = {}
    for arch, run in TRAIN_RUNS.items():  # one model on the card at a time
        if run.steps:
            t0 = time.perf_counter()
            records[arch], counts = entry_point_run(arch, device, card)
            log(f"[time] {arch} entry point {time.perf_counter() - t0:.1f} s")
            for name in run.launches:
                paths.setdefault(name, {})[f"{arch}:train_main_{run.steps}_steps"] = counts[name]
        for train_cfg in run.train_cfgs:
            t0 = time.perf_counter()
            for name, counts in kernel_vs_plain_step(arch, device, card, train_cfg).items():
                paths.setdefault(name, {}).update(counts)
            log(f"[time] {arch}{cfg_tag(train_cfg)} kernel vs plain step and profile "
                f"{time.perf_counter() - t0:.1f} s")
    return paths, records


# ---------------------------------------------------------------------------
# phase 8: the examples' twins
# ---------------------------------------------------------------------------
# examples/torch_train_100m.py's 100m preset (its full width), cut from 300
# steps to 6 for the run's time, with a checkpoint at step 3 that a second
# run resumes from
EXAMPLE_TRAIN_STEPS = 6
# a step's bf16 flash launches: 12 attention layers, each in the forward and
# again in remat's recompute
EXAMPLE_TRAIN_LAUNCHES = {"flash_attention_wgmma": 24}
EXAMPLES_OUT = ROOT / "build" / "chip_smoke_examples"


def same_records(a, b) -> bool:
    """Two ``SimResult``s with identical records: schedule and finish times,
    routes and bandwidths, and the same event count."""
    if max_record_dev([a], [b]) != 0.0 or a.n_events != b.n_events:
        return False
    return all(ra.routes == rb.routes and np.array_equal(ra.bandwidths, rb.bandwidths)
               for ra, rb in zip(a.records, b.records))


def quickstart_example(device, card) -> int:
    """``examples/torch_quickstart.py`` in full through the JRBA kernel and
    through its plain version on the card (``REPRO_TORCH_JRBA_SOLVER=sparse``):
    Fig. 2's throughputs, routes and bandwidths and every policy's records
    identical. Returns the kernel's launches."""
    qs = load_script("examples/torch_quickstart.py")
    t0 = time.perf_counter()
    argv = ["--device", str(device)]
    got, n = counted("examples/torch_quickstart.py (JRBA kernel)", True, qs.main, argv)
    seconds = time.perf_counter() - t0
    with mock.patch.dict(os.environ, {"REPRO_TORCH_JRBA_SOLVER": "sparse"}):
        want, _ = counted("examples/torch_quickstart.py (REPRO_TORCH_JRBA_SOLVER=sparse)", False,
                          qs.main, argv)
    assert got["single"] == want["single"], (got["single"], want["single"])
    for policy in qs.POLICIES:
        a, b = got["online"][policy], want["online"][policy]
        assert same_records(a, b) and a.avg_throughput == b.avg_throughput, policy
    log(f"[examples] quickstart: Fig. 2 and {len(qs.POLICIES)} policies' records identical on "
        f"the kernel and the plain path; {n} JRBA launches; {seconds:.2f} s on the kernel "
        f"[{card}]")
    return n


def serving_example(device, card) -> None:
    """``examples/torch_serve_cluster.py``'s serving demo on the card, and
    with the model kernels routed to their plain versions: the same tokens.
    The engine prefills by teacher-forced decode steps, tick for tick the
    JAX package's engine, and decode is plain PyTorch, so neither run
    launches a kernel (held to 0): a serving smoke, no kernel's path."""
    demo = load_script("examples/torch_serve_cluster.py")
    t0 = time.perf_counter()
    got, _ = counted_all("examples/torch_serve_cluster.py serving demo",
                              {}, demo.serving_demo, device)
    seconds = time.perf_counter() - t0
    with plain_kernels():
        want, _ = counted_all("examples/torch_serve_cluster.py serving demo (plain)", {},
                              demo.serving_demo, device)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want], "served tokens differ"
    log(f"[examples] serving demo: {len(got)} requests, {sum(len(r.output) for r in got)} "
        f"tokens, the plain path's tokens; no kernel launches; {seconds:.2f} s [{card}]")


def train_example(device, card) -> tuple[int, dict]:
    """``examples/torch_train_100m.py``'s 100m preset for EXAMPLE_TRAIN_STEPS
    steps, checkpointing halfway; then, its last snapshot unflagged, a second
    run that resumes from the halfway one: each resumed step's loss within
    ``TRAIN_LIMITS["loss"]`` of the uninterrupted run's. Exactly
    EXAMPLE_TRAIN_LAUNCHES bf16 flash launches a step. Returns the
    uninterrupted run's launches and its record."""
    demo = load_script("examples/torch_train_100m.py")
    ckpt = EXAMPLES_OUT / "train_100m_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, every = EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_STEPS // 2
    args = ("100m", steps, str(ckpt), str(device))
    t0 = time.perf_counter()
    full, counts = counted_all(
        f"examples/torch_train_100m.py --preset 100m, {steps} steps",
        {k: n * steps for k, n in EXAMPLE_TRAIN_LAUNCHES.items()},
        demo.train, *args, ckpt_every=every, log_every=1)
    seconds = time.perf_counter() - t0
    (ckpt / f"step_{steps:08d}" / "COMPLETE").unlink()
    resumed, _ = counted_all(
        f"examples/torch_train_100m.py --preset 100m, resumed at step {every}",
        {k: n * (steps - every) for k, n in EXAMPLE_TRAIN_LAUNCHES.items()},
        demo.train, *args, ckpt_every=every, log_every=1)
    assert len(resumed["losses"]) == steps - every, resumed["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(resumed["losses"], full["losses"][every:])]
    _, batch, seq = demo.PRESETS["100m"]
    steady = sorted(full["step_seconds"][1:])[len(full["step_seconds"][1:]) // 2]
    rec = {"preset": "100m", "batch": batch, "seq": seq, "steps": steps, "resumed_at": every,
           "losses": full["losses"], "resumed_losses": resumed["losses"],
           "resume_loss_gaps": gaps, "limit": TRAIN_LIMITS["loss"], "call_s": seconds,
           "first_step_ms": full["step_seconds"][0] * 1e3, "ms_per_step": steady * 1e3,
           "tokens_per_s": batch * seq / steady,
           "launches": counts["flash_attention_wgmma"]}
    log(f"[examples] train_100m: {json.dumps(rec)} [{card}]")
    assert all(np.isfinite(full["losses"])), full["losses"]
    assert max(gaps) <= TRAIN_LIMITS["loss"], f"resumed losses {gaps} off the uninterrupted run"
    return counts["flash_attention_wgmma"], rec


def fleet_example(device, card) -> int:
    """``examples/torch_fleet_demo.py``'s seven sections through the JRBA
    kernel: every records-identical check True and no span deviation.
    Returns the kernel's launches."""
    demo = load_script("examples/torch_fleet_demo.py")
    t0 = time.perf_counter()
    out, n = counted("examples/torch_fleet_demo.py, seven sections (JRBA kernel)", True,
                     demo.main, ["--device", str(device), "--out-dir",
                                 str(EXAMPLES_OUT / "fleet_demo")])
    seconds = time.perf_counter() - t0
    same = {k: out[k]["same"] for k in ("speculative_rounds", "async_fleet", "churn_storm",
                                        "churn_speculation")}
    devs = {k: out[k]["dev"] for k in ("batched_fleet", "cosched_fleet")}
    log(f"[examples] fleet demo: records identical {same}, span deviations {devs}; {n} JRBA "
        f"launches; {seconds:.2f} s [{card}]")
    assert all(same.values()) and not any(devs.values()), (same, devs)
    return n


def examples_phase(device, card) -> dict:
    """The examples' twins on the card; returns the launches by path."""
    t0 = time.perf_counter()
    jrba = {"examples/torch_quickstart.py": quickstart_example(device, card)}
    serving_example(device, card)
    n, _ = train_example(device, card)
    flash = {f"examples/torch_train_100m.py:{EXAMPLE_TRAIN_STEPS}_steps": n}
    jrba["examples/torch_fleet_demo.py"] = fleet_example(device, card)
    log(f"[time] examples phase {time.perf_counter() - t0:.1f} s")
    return {"jrba_congestion": jrba, "flash_attention_wgmma": flash}


# ---------------------------------------------------------------------------
# phase 9: ENTS placement of model stage graphs
# ---------------------------------------------------------------------------
def placement_phase(device) -> int:
    """``examples/torch_serve_cluster.py``'s placement demo through the JRBA
    kernel and on the CPU: the same reports."""
    demo = load_script("examples/torch_serve_cluster.py")
    got, n = counted("placement (place_job, JRBA kernel)", True, demo.placement_demo, device)
    want, _ = counted("placement (place_job, device=cpu)", False, demo.placement_demo, "cpu")
    placed = 0
    for (arch, _), a, b in zip(demo.JOBS, got, want):
        assert (a is None) == (b is None), f"{arch}: feasibility differs"
        if a is None:
            log(f"[place] {arch}: infeasible on both")
            continue
        placed += 1
        same = (
            np.array_equal(a.assignment, b.assignment)
            and a.routes == b.routes
            and np.array_equal(a.bandwidths, b.bandwidths)
            and a.span == b.span
        )
        assert same, f"{arch}: kernel and CPU placements differ"
        log(f"[place] {arch}: span {a.span * 1e3:.6f} ms/microbatch, {len(a.routes)} flows, "
            "identical on the kernel and the CPU")
    assert placed >= 3, f"only {placed} jobs placed"
    return n


FLASH_SOURCES = {
    "flash_attention_wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def flash_record(name: str, timings: list[dict], launches: int, by_path: dict,
                 extra: dict | None = None) -> dict:
    """A flash kernel's record: the bf16 kernel's main timing is the
    gemma3-1b prefill's sliding-window shape at S=32768, the f32 kernel's
    the same shape at the S=4096 of its f32 prefill check."""
    main = timings[0]
    return {
        "name": name,
        "route": "cuda",
        "source": FLASH_SOURCES[name],
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": main["shape"],
        "dtype": main["dtype"],
        "tolerance": "bf16 2e-2, f32 2e-4 against the plain version (rtol, and atol as a share "
        "of each output row's root mean square)",
        "limit_ratio": max(t["limit_ratio"] for t in timings),
        **(extra or {}),
        "launches_by_path": by_path,
        "timings": timings,
    }


SCAN_SOURCES = {
    "ssd_scan_mma": ("src/repro_torch/kernels/csrc/ssd_scan_mma.cu",
                     "src/repro/kernels/ssd.py:23"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd.py:23"),
    "rwkv6_scan_mma": ("src/repro_torch/kernels/csrc/rwkv6_scan_mma.cu",
                       "src/repro/kernels/rwkv6.py:22"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6.py:22"),
}


def scan_record(name: str, timings: list[dict], launches: int, by_path: dict,
                extra: dict | None = None) -> dict:
    """A scan kernel's record: its main timing is the first of its
    timings, at the model's S=32768 shape."""
    main = timings[0]
    source, replaces = SCAN_SOURCES[name]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": main["shape"],
        "tolerance": "bf16 rtol 2e-2 atol 2e-2, f32 rtol 2e-4 atol 5e-4 against the plain "
        "version (atol as a share of each output row's root mean square)",
        "limit_ratio": max(t["limit_ratio"] for t in timings),
        **(extra or {}),
        "launches_by_path": by_path,
        "timings": timings,
    }


# ---------------------------------------------------------------------------
# phase 10: the scheduler's program stream through the kernel and the plain version
# ---------------------------------------------------------------------------
class CapturingEngine(JRBAEngine):
    """Records every (net, flows, capacity) solve request it serves, and in
    ``seeds`` the scenario seed (``seed``, set by the caller) it served."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.captured: list = []
        self.seeds: list = []
        self.seed = None

    def _record(self, net, flows, capacity):
        self.captured.append((net, list(flows), None if capacity is None else capacity.copy()))
        self.seeds.append(self.seed)

    def solve(self, net, flows, *, capacity=None, **kwargs):
        self._record(net, flows, capacity)
        return super().solve(net, flows, capacity=capacity, **kwargs)

    def solve_many(self, net, flow_sets, *, capacities=None, **kwargs):
        nets = [net] * len(flow_sets) if isinstance(net, NetworkGraph) else list(net)
        caps = capacities if capacities is not None else [None] * len(flow_sets)
        for g, fs, c in zip(nets, flow_sets, caps):
            self._record(g, fs, c)
        return super().solve_many(net, flow_sets, capacities=capacities, **kwargs)


def capture_stream(device, solver, *, seeds=(0, 1), n_jobs=8,
                   n_iters=STREAM_ITERS) -> tuple[list, list]:
    """The programs the scheduler solves, and each one's scenario seed."""
    eng = CapturingEngine(k=K, n_iters=n_iters, solver=solver, device=device)
    for name in sorted(SCENARIOS):
        for seed in seeds:
            eng.seed = seed
            for policy in ("OTFS", "OTFA"):
                net, arrivals = SCENARIOS[name].build(seed=seed, n_jobs=n_jobs)
                OnlineScheduler(net, policy, k_paths=K, jrba_iters=n_iters, engine=eng).run(
                    arrivals
                )
    return eng.captured, eng.seeds


def replay_single(eng: JRBAEngine, stream: list) -> tuple[list, list[int]]:
    results, steps = [], []
    for net, flows, cap in stream:
        s0 = eng.stats.solver_steps
        results.append(eng.solve(net, flows, capacity=cap))
        steps.append(eng.stats.solver_steps - s0)
    return results, steps


def batch_groups(eng: JRBAEngine, stream: list, size: int = BATCH) -> list[list[int]]:
    """Stream indices grouped by the kernel's batch signature, in chunks of
    at most ``size``, so that ``solve_many`` sees full batches."""
    by_key: dict[tuple, list[int]] = {}
    for i, (net, flows, cap) in enumerate(stream):
        prog = eng.build(net, flows, capacity=cap)
        key = ("empty",) if prog is None else eng._shape_key(prog)
        by_key.setdefault(key, []).append(i)
    return [idx[j : j + size] for idx in by_key.values() for j in range(0, len(idx), size)]


def replay_batched(eng: JRBAEngine, stream: list, groups: list[list[int]]) -> list:
    out: list = [None] * len(stream)
    for idx in groups:
        res = eng.solve_many(
            [stream[i][0] for i in idx],
            [stream[i][1] for i in idx],
            capacities=[stream[i][2] for i in idx],
        )
        for i, r in zip(idx, res):
            out[i] = r
    return out


def compare(label: str, got: list, want: list) -> float:
    """Identical records; returns the worst relative relaxed-span gap."""
    worst = 0.0
    bad = []
    for i, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None):
            bad.append((i, "one side empty"))
            continue
        if a is None:
            continue
        if a.routes != b.routes or not np.array_equal(a.bandwidth, b.bandwidth) or a.span != b.span:
            bad.append((i, f"routes/bandwidth/span differ: span {a.span} vs {b.span}"))
        gap = abs(a.relaxed_span - b.relaxed_span) / max(abs(b.relaxed_span), 1e-12)
        worst = max(worst, gap)
        if gap > SPAN_RTOL:
            bad.append((i, f"relaxed span {a.relaxed_span} vs {b.relaxed_span}"))
    if bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(got)} programs disagree: {bad[:10]}")
    return worst


def time_call(fn, args, kwargs, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls after
    ``warm`` untimed ones."""
    for _ in range(warm):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_batch(progs: list, device) -> dict:
    """Kernel and plain version on one batch: agreement, CUDA-event times,
    and the card's bound for the same work."""
    args = sparse_batch_inputs(progs, device)
    kw = dict(n_iters=STREAM_ITERS)
    w_k, span_k, steps_k = jc.sparse_congestion_solve(*args, **kw)
    w_p, span_p, steps_p = jc.sparse_congestion_plain(*args, **kw)
    torch.cuda.synchronize()
    # the plain version sums in the kernel's order: bit for bit, or a fault
    assert torch.equal(w_k, w_p), f"w differs: max abs {float((w_k - w_p).abs().max())}"
    assert torch.equal(span_k, span_p), "spans differ"
    assert torch.equal(steps_k, steps_p), "step counts differ"
    ms = time_call(jc.sparse_congestion_solve, args, kw, reps=20)
    plain_ms = time_call(jc.sparse_congestion_plain, args, kw, reps=3)
    # a launch lasts as long as its slowest lane: its steps times one step's
    # minimum dependent chain (the source's one-warp microbenchmark, at this
    # batch's K, link tree width and hop width) is the latency floor
    max_steps = int(steps_k.max())
    step_floor = step_floor_ms(args)
    # bound: each input read once, each output written once; operations per
    # executed step per lane ~ softmax+Adam on Nf*K slots (25 each), the
    # scatter and gather over the lane's link entries (2 each), the smoothed
    # max over La links (9 each), counted with the steps this run took
    B, Nf, Kp, P = args[0].shape
    La = args[3].shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += STREAM_ITERS * 3 * 4 + B * Nf * Kp * 4  # schedule table, derived mask
    nbytes += (w_k.numel() + span_k.numel() + steps_k.numel()) * 4
    nnz = (args[5][:, -1] - args[5][:, 0]).double()
    ops = float((steps_k.double() * (25 * Nf * Kp + 2 * nnz + 9 * La)).sum())
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    out = {
        "shape": {"B": B, "Nf": Nf, "K": Kp, "P": P, "La": La, "n_iters": STREAM_ITERS},
        "threads": jc.launch_plan(B, Nf, Kp, P, La, STREAM_ITERS)["threads"],
        "mean_steps": float(steps_k.double().mean()),
        "max_steps": max_steps,
        "ms_per_step": ms / max_steps,
        "step_floor_ms": step_floor,
        "latency_floor_ms": max_steps * step_floor,
        "max_abs_err": float((w_k - w_p).abs().max()),
        "max_span_rel_err": float(((span_k - span_p).abs() / span_p.clamp_min(1e-12)).max()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    log(f"[kernel] {json.dumps(out)}")
    return out


def step_floor_ms(args) -> float:
    """One step's minimum dependent chain for a batch's inputs: K paths,
    link trees as wide as the power of two above the widest link's slot
    count, hop trees of the kernel's hop width."""
    ridx, ptr = args[0], args[5]
    K, P = ridx.shape[2], ridx.shape[3]
    deg = int((ptr[:, 1:] - ptr[:, :-1]).max())
    return _step_floor(K, 1 << max(deg - 1, 0).bit_length(), jc.hop_width(P), ridx.device)


@functools.lru_cache(maxsize=None)
def _step_floor(K: int, link_width: int, hop_width: int, device) -> float:
    return jc.step_floor_ms(K, link_width, hop_width, device=device)


def kernel_record(eng: JRBAEngine, stream: list, groups: list[list[int]], device) -> dict:
    """Time the kernel and its plain version on batches from the stream: a
    full batch of the most common signature (the record), a full batch of
    the widest signature, and that signature's first program alone."""

    def progs_of(idx):
        return [eng.build(*stream[i][:2], capacity=stream[i][2]) for i in idx]

    def padded(progs):  # the engine pads a batch the same way
        return progs + [progs[-1]] * (BATCH - len(progs))

    groups = [g for g in groups if eng.build(*stream[g[0]][:2], capacity=stream[g[0]][2])]
    common = progs_of(max(groups, key=len))
    widest = progs_of(max(groups, key=lambda g: eng.build(*stream[g[0]][:2]).usage_active.size))
    timings = [time_batch(padded(common), device), time_batch(padded(widest), device)]
    timings.append(time_batch(widest[:1], device))
    main = timings[0]
    return {
        "name": "jrba_congestion",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/jrba_congestion.cu",
        "replaces": "src/repro/kernels/jrba_congestion.py:42",
        "launches": None,  # set from the main path's run
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bound_note": "operations spread over the whole card; a lane's steps are serial, so "
        "latency_floor_ms is the yardstick",
        "library_ms": None,
        "shape": main["shape"],
        "max_steps": main["max_steps"],
        "ms_per_step": main["ms_per_step"],
        "step_floor_ms": main["step_floor_ms"],
        "latency_floor_ms": main["latency_floor_ms"],
        "tolerance": "timed batches: w, span, steps bit for bit; stream: records identical, "
        "relaxed span rtol 5e-2",
        "timings": timings,
    }


def stream_phase(device, kernel_solver: str, plain_solver: str, *, seeds, n_jobs) -> tuple:
    """Returns the kernel's record and the launches of each kernel path. The
    kernel replays every program singly and in batches, the plain version
    the batches and, singly, the first seed's programs only: its single
    replay of all of them took 120.8-140.8 s of a run that must stay under
    880 s (PERF.md section 4)."""
    launches = {}
    t0 = time.perf_counter()
    (stream, seed_of), launches["scheduler"] = counted(
        "scheduler (OnlineScheduler.run, OTFS+OTFA, 12 scenarios)", True,
        capture_stream, device, kernel_solver, seeds=seeds, n_jobs=n_jobs,
    )
    log(f"[stream] captured {len(stream)} JRBA programs in {time.perf_counter() - t0:.1f} s")
    ek = JRBAEngine(k=K, n_iters=STREAM_ITERS, solver=kernel_solver, device=device)
    ep = JRBAEngine(k=K, n_iters=STREAM_ITERS, solver=plain_solver, device=device)
    t0 = time.perf_counter()
    (single_k, steps_k), launches["stream_single"] = counted(
        f"stream single ({kernel_solver})", True, replay_single, ek, stream
    )
    tk = time.perf_counter() - t0
    plain = [i for i, seed in enumerate(seed_of) if seed == seeds[0]]
    t0 = time.perf_counter()
    (single_p, steps_p), _ = counted(
        f"stream single ({plain_solver}), seed {seeds[0]}'s programs", False, replay_single, ep,
        [stream[i] for i in plain]
    )
    tp = time.perf_counter() - t0
    gap1 = compare("single", [single_k[i] for i in plain], single_p)
    relaxed = sum(1 for s in steps_k if s)
    n_diff = sum(1 for i, b in zip(plain, steps_p) if steps_k[i] != b)
    log(
        f"[stream] single: {len(stream)} programs ({relaxed} relaxed, "
        f"{ek.stats.fast_path_solves} fast-path), {len(plain)} of them (seed {seeds[0]}'s) on "
        f"both: identical records; worst relaxed-span gap {gap1:.3g}; steps differ on "
        f"{n_diff}; replay {tk:.2f} s kernel (all), {tp:.2f} s plain"
    )
    groups = batch_groups(ek, stream)
    batch_k, launches["stream_batched"] = counted(
        f"stream batched ({kernel_solver})", True, replay_batched, ek, stream, groups
    )
    batch_p, _ = counted(
        f"stream batched ({plain_solver})", False, replay_batched, ep, stream, groups
    )
    gap2 = compare("batched", batch_k, batch_p)
    moved = sum(
        1
        for a, b in zip(batch_k, single_k)
        if a is not None and (a.routes, a.span) != (b.routes, b.span)
    )
    log(
        f"[stream] batched: {len(groups)} solve_many calls, largest {max(map(len, groups))}, "
        f"identical records; worst relaxed-span gap {gap2:.3g}; "
        f"{moved} programs round differently batched than single (kernel)"
    )
    return kernel_record(ek, stream, groups, device), launches


# ---------------------------------------------------------------------------
# phase 11: fleets
# ---------------------------------------------------------------------------
def max_record_dev(results_a, results_b) -> float:
    """Worst relative deviation between two runs' job records: zero only when
    every schedule/finish time is exactly equal."""
    dev = 0.0
    for a, b in zip(results_a, results_b):
        if len(a.records) != len(b.records):
            return 1.0
        for ra, rb in zip(a.records, b.records):
            for va, vb in ((ra.schedule_time, rb.schedule_time), (ra.finish_time, rb.finish_time)):
                if va == vb:
                    continue
                scale = abs(va) if np.isfinite(va) and va != 0 else 1.0
                gap = abs(va - vb)
                dev = max(dev, gap / scale if np.isfinite(gap) else 1.0)
    return dev


def run_fleet(device, solver: str, mode: str, lanes: int, names) -> tuple:
    eng = JRBAEngine(k=K, n_iters=FLEET_ITERS, solver=solver, device=device)
    sims = build_async_fleet(eng, lanes, n_jobs=4, names=names)
    res = FleetRuntime(eng, mode=mode).run(sims)
    return res, eng


def report_fleet(label: str, res, eng: JRBAEngine, card: str) -> None:
    s = res.telemetry.summary
    st = eng.stats
    log(
        f"[fleet] {label}: {res.total_events} events in {res.wall_seconds:.2f} s = "
        f"{s['events_per_s']:.1f} events/s; dispatches {s['n_dispatches']}, rounds "
        f"{s['n_rounds']}, batch calls {s['batch_calls']}, mean batch occupancy "
        f"{s['mean_batch_occupancy']:.2f}; engine build {st.build_seconds:.2f} s, cache "
        f"{st.cache_seconds:.2f} s, dispatch {st.dispatch_seconds:.2f} s, finalize "
        f"{st.finalize_seconds:.2f} s; steps {st.solver_steps}/{st.solver_step_budget}; "
        f"unfinished {res.unfinished} [{card}]"
    )


def fleet_phase(device, kernel_solver, plain_solver, card, *, lanes, small_lanes) -> dict:
    """Returns the launches of each kernel fleet run."""
    names = FLEET_SCENARIOS + ("wan-mesh-xl", "edge-mesh-flash")
    launches = {}
    (lock, eng_l), launches[f"fleet_{lanes}_lockstep"] = counted(
        f"{lanes}-lane fleet lockstep ({kernel_solver})", True,
        run_fleet, device, kernel_solver, "lockstep", lanes, names,
    )
    (asyn, eng_a), launches[f"fleet_{lanes}_async"] = counted(
        f"{lanes}-lane fleet async ({kernel_solver})", True,
        run_fleet, device, kernel_solver, "async", lanes, names,
    )
    report_fleet(f"{lanes} lanes lockstep ({kernel_solver})", lock, eng_l, card)
    report_fleet(f"{lanes} lanes async ({kernel_solver})", asyn, eng_a, card)
    dev = max_record_dev(lock.results, asyn.results)
    log(f"[fleet] lockstep vs async max_record_rel_dev {dev}")
    assert dev == 0.0, f"lockstep and async records differ: {dev}"
    assert lock.unfinished == 0 and asyn.unfinished == 0, "unfinished jobs"
    # the kernel-vs-plain comparison runs under the port's mutation
    # sanitizer: every graph mutation and engine build of both runs audited
    uninstall = sanitizer.install()
    sanitizer.reset_counts()
    try:
        (small_k, eng_k), launches[f"fleet_{small_lanes}_lockstep"] = counted(
            f"{small_lanes}-lane fleet lockstep ({kernel_solver}, sanitized)", True,
            run_fleet, device, kernel_solver, "lockstep", small_lanes, names,
        )
        (small_p, eng_p), _ = counted(
            f"{small_lanes}-lane fleet lockstep ({plain_solver}, sanitized)", False,
            run_fleet, device, plain_solver, "lockstep", small_lanes, names,
        )
    finally:
        uninstall()
    audited = dict(sanitizer.AUDITED)
    log(f"[fleet] sanitizer: {audited['mutations']} graph mutations and {audited['builds']} "
        f"engine builds audited over the {small_lanes}-lane kernel and plain runs")
    assert audited["mutations"] > 0 and audited["builds"] > 0, audited
    report_fleet(f"{small_lanes} lanes lockstep ({kernel_solver})", small_k, eng_k, card)
    report_fleet(f"{small_lanes} lanes lockstep ({plain_solver})", small_p, eng_p, card)
    dev = max_record_dev(small_k.results, small_p.results)
    log(f"[fleet] kernel vs plain max_record_rel_dev {dev}")
    assert dev == 0.0, f"kernel and plain fleet records differ: {dev}"
    return launches


# ---------------------------------------------------------------------------
# phase 12: the dry run, in a child process beside the other phases
# ---------------------------------------------------------------------------
# (arch, cell) on the single production mesh: a full-size training cell, a
# decode cell that puts MoE and the MLA cache through the hints, and the SSM
# models' training cells, which run the causal conv's and the token shift's
# zero padding on DTensors (their decode cells pad nothing; train_4k ran
# faster than prefill_32k for both on a CPU, PERF.md section 4)
DRYRUN_CELLS = [("internlm2-1.8b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
                ("zamba2-7b", "train_4k"), ("rwkv6-3b", "train_4k")]
DRYRUN_CHILD = "--dry-run-child"
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"
# internlm2-1.8b x train_4k's peak bytes a device as PyTorch 2.13 reads it
# (the dry run on a CPU, PERF.md section 6): the card's PyTorch must read it
# within PEAK_RTOL
DRYRUN_PEAK = {("internlm2-1.8b", "train_4k"): 7.51e10}
PEAK_RTOL = 0.1
HILLCLIMB = ["--arch", "internlm2-1.8b", "--cell", "train_4k", "--breakdown"]


def dryrun_child() -> int:
    """The dry run's cells on the single production mesh (256 fake ranks,
    device type cuda), ``scripts/torch_hillclimb.py`` on internlm2-1.8b x
    train_4k, then the (1, 1) mesh's static bytes of internlm2-1.8b's
    training state. Prints one JSON line."""
    out: dict = {"cells": []}
    t0 = time.perf_counter()
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        for arch, cell in DRYRUN_CELLS:
            t1 = time.perf_counter()
            out["cells"].append(dryrun.run_cell(arch, cell, mesh, "single"))
            out["cells"][-1]["child_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    hc = load_script("scripts/torch_hillclimb.py").main(HILLCLIMB)
    out["hillclimb"] = {"terms": hc["terms"], "dominant": hc["dominant"], "per_op": hc["per_op"],
                        "flops": hc["info"]["flops"], "breakdown": hc["breakdown"],
                        "collectives": hc["info"]["collectives"]["total"],
                        "child_s": time.perf_counter() - t1}
    with dryrun.fake_world(1):
        _, aux = dryrun.lower_cell(TRAIN_ARCH, "train_4k", make_debug_mesh((1, 1)))
        out["static_1x1"] = aux["static_state_bytes_per_device"]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def start_dryrun() -> subprocess.Popen:
    """The dry run in a child process: it needs no device time, only a CPU
    core, so it runs while the build and the first phases do. Its output
    goes to files under the gitignored ``build/``."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    with open(DRYRUN_OUT / "stdout", "w") as so, open(DRYRUN_OUT / "stderr", "w") as se:
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), DRYRUN_CHILD],
                                stdout=so, stderr=se, cwd=ROOT)


def finish_dryrun(child: subprocess.Popen, card: str) -> dict:
    """Waits for the child; every cell must be ``ok``, internlm2-1.8b x
    train_4k's peak within PEAK_RTOL of PyTorch 2.13's, the hillclimb's
    FLOPs and collective bytes those of the same cell's record, and the
    (1, 1) static bytes the training state the card held. Prints the
    records."""
    t0 = time.perf_counter()
    rc = child.wait(timeout=600)
    waited = time.perf_counter() - t0
    text = (DRYRUN_OUT / "stdout").read_text()
    if rc != 0 or not text.strip():
        log((DRYRUN_OUT / "stderr").read_text()[-4000:])
        raise AssertionError(f"the dry-run child exited {rc}")
    out = json.loads(text.strip().splitlines()[-1])
    for rec in out["cells"]:
        tb = rec.pop("traceback", None)
        log(f"[dryrun] {json.dumps(rec)}")
        assert rec["ok"], f"dry run {rec['arch']} x {rec['cell']}: {rec.get('error')}\n{tb}"
        want = DRYRUN_PEAK.get((rec["arch"], rec["cell"]))
        if want is not None:
            gap = abs(rec["memory"]["peak_bytes"] - want) / want
            log(f"[dryrun] {rec['arch']} x {rec['cell']} peak {rec['memory']['peak_bytes']} "
                f"bytes a device, {gap:.4f} off PyTorch 2.13's {want:.4g} (torch "
                f"{torch.__version__})")
            assert gap <= PEAK_RTOL, f"{rec['arch']} x {rec['cell']}: peak {gap:.3f} off"
    hc = out["hillclimb"]
    log(f"[hillclimb] {' '.join(HILLCLIMB)}: {json.dumps(hc)}")
    ref = out["cells"][0]
    assert (hc["flops"], hc["collectives"]) == (ref["flops"], ref["collectives"]["total"]), hc
    log(f"[dryrun] {TRAIN_ARCH} training state on a (1, 1) mesh: {out['static_1x1']} bytes; "
        f"on the card: {CARD_STATE_BYTES[TRAIN_ARCH]} bytes")
    assert out["static_1x1"] == CARD_STATE_BYTES[TRAIN_ARCH], out["static_1x1"]
    log(f"[time] dry-run child {out['seconds']:.1f} s, waited for {waited:.1f} s [{card}]")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if sys.argv[1:] == [DRYRUN_CHILD]:
        return dryrun_child()
    child = start_dryrun()
    try:
        return run(child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def run(child: subprocess.Popen) -> int:
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[device] {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    ptxas = build_all()
    evidence = wgmma_evidence(ptxas["flash_attention_wgmma"])
    ssd_evidence = ssd_mma_evidence(ptxas["ssd_scan_mma"])
    rwkv_evidence = rwkv6_mma_evidence(ptxas["rwkv6_scan_mma"])
    f32_flash_evidence = flash_f32_evidence(ptxas["flash_attention"])
    ssd_f32_sass = scan_f32_evidence("ssd_scan", ptxas["ssd_scan"], SSD_F32_KERNELS)
    assert len(ssd_f32_sass["ptxas"]) == len(ssd.CHUNKS) * 3, "ssd_scan instances"
    rwkv_f32_sass = scan_f32_evidence("rwkv6_scan", ptxas["rwkv6_scan"], RWKV_F32_KERNELS)
    assert len(rwkv_f32_sass["ptxas"]) == 8, "rwkv6_scan instances"
    jrba_sass = jrba_evidence(ptxas["jrba_congestion"])
    flash_timings = flash_phase(device)
    log(f"[time] after flash phase {time.perf_counter() - t_start:.1f} s")
    scan_timings = scan_phase(device)
    log(f"[time] after scan phase {time.perf_counter() - t_start:.1f} s")
    profiler_check(device, card)
    model_paths: dict[str, dict] = {name: {} for name in COUNTERS}
    f32_prefills = {}
    for arch in FORWARD_LAUNCHES:  # one model on the card at a time
        cfg, params, by_path, bf16_plain = prefill_phase(arch, device, card)
        log(f"[time] after {arch} prefill phase {time.perf_counter() - t_start:.1f} s")
        serving_paths = serving_phase(arch, cfg, params, device, card)
        log(f"[time] after {arch} serving phase {time.perf_counter() - t_start:.1f} s")
        # last: it upcasts the weights in place
        f32_paths, f32_prefills[arch] = f32_phase(
            arch, cfg, params, device, card, None if arch in F32_REPEATS else bf16_plain)
        del bf16_plain, params
        torch.cuda.empty_cache()
        for paths in (by_path, serving_paths, f32_paths):
            for name, counts in paths.items():
                model_paths[name].update(counts)
        log(f"[time] after {arch} serving and f32 phases {time.perf_counter() - t_start:.1f} s")
    train_paths, train_record = training_phase(device, card)
    for name, counts in train_paths.items():
        model_paths[name].update(counts)
    log(f"[time] after training phase {time.perf_counter() - t_start:.1f} s")
    example_paths = examples_phase(device, card)
    model_paths["flash_attention_wgmma"].update(example_paths["flash_attention_wgmma"])
    log(f"[time] after examples phase {time.perf_counter() - t_start:.1f} s")
    placement_launches = placement_phase(device)
    record, by_path = stream_phase(device, "cuda", "sparse", seeds=(0, 1), n_jobs=8)
    log(f"[time] after stream phase {time.perf_counter() - t_start:.1f} s")
    by_path.update(fleet_phase(device, "cuda", "sparse", card, lanes=256, small_lanes=32))
    # the main path is the 256-lane lockstep fleet; every other path's count
    # stands beside it
    record["launches"] = by_path["fleet_256_lockstep"]
    by_path["placement"] = placement_launches
    by_path.update(example_paths["jrba_congestion"])
    record["evidence"] = jrba_sass
    record["launches_by_path"] = by_path
    # each model kernel's main path is the S=32768 prefill of its model:
    # gemma3-1b for bf16 flash attention, zamba2-7b for bf16 SSD, rwkv6-3b for
    # RWKV-6; the f32 kernels' are the f32 prefills at S=4096 of gemma3-1b
    # (flash attention), zamba2-7b (SSD) and rwkv6-3b (RWKV-6)
    main_path = f"prefill_{PREFILL_LEN}"
    by_dtype = {d: [t for t in flash_timings if t["dtype"] == d] for d in ("bfloat16", "float32")}
    f32 = sorted(by_dtype["float32"], key=lambda t: (  # the f32 prefill's windowed shape first
        t["shape"]["S"], t["shape"]["D"], t["shape"]["window"]) != (CHECK_LEN, 256, 512))
    flashes = [
        flash_record("flash_attention_wgmma", by_dtype["bfloat16"],
                     model_paths["flash_attention_wgmma"][f"gemma3-1b:{main_path}"],
                     model_paths["flash_attention_wgmma"], evidence),
        flash_record("flash_attention", f32,
                     model_paths["flash_attention"][f"gemma3-1b:f32_prefill_{CHECK_LEN}"],
                     model_paths["flash_attention"], {"evidence": f32_flash_evidence}),
    ]
    ssd_rows = scan_timings["ssd_scan"]
    rwkv_rows = scan_timings["rwkv6_scan"]
    # each scan's grids a call, counted in its profiled prefill: the bf16
    # RWKV-6 kernel's at S=32768, the f32 scans' at S=4096. The RWKV-6
    # kernels run three when their plan cuts the sequence into more than one
    # segment (end states, passing, y), else one; the f32 SSD kernel runs
    # two (C B^T, then y)
    B_, S_, H_, P_, Q_ = RWKV_MODEL[0]
    planned = {
        "rwkv6_scan_mma": 3 if rw.segment_chunks(B_, H_, S_, P_, Q_) < S_ // Q_ else 1,
        "rwkv6_scan": 3 if rw.segment_chunks(B_, H_, CHECK_LEN, P_, Q_) < CHECK_LEN // Q_ else 1,
        "ssd_scan": 2,
    }
    for name, grids in planned.items():
        assert GRIDS_PER_CALL[name] == grids, (
            f"{name} ran {GRIDS_PER_CALL[name]} grids a call, planned {grids}")
    rwkv_grids = GRIDS_PER_CALL["rwkv6_scan_mma"]
    scans = [
        scan_record("ssd_scan_mma", [t for t in ssd_rows if t["kernel"] == "ssd_scan_mma"],
                    model_paths["ssd_scan_mma"][f"zamba2-7b:{main_path}"],
                    model_paths["ssd_scan_mma"], {"evidence": ssd_evidence}),
        scan_record("ssd_scan", [t for t in ssd_rows if t["kernel"] == "ssd_scan"],
                    model_paths["ssd_scan"][f"zamba2-7b:f32_prefill_{CHECK_LEN}"],
                    model_paths["ssd_scan"],
                    {"evidence": ssd_f32_sass, "grids_per_call": GRIDS_PER_CALL["ssd_scan"],
                     "f32_prefill": f32_prefills["zamba2-7b"]}),
        scan_record("rwkv6_scan_mma", [t for t in rwkv_rows if t["kernel"] == "rwkv6_scan_mma"],
                    model_paths["rwkv6_scan_mma"][f"rwkv6-3b:{main_path}"],
                    model_paths["rwkv6_scan_mma"],
                    {"evidence": rwkv_evidence, "grids_per_call": rwkv_grids}),
        scan_record("rwkv6_scan", [t for t in rwkv_rows if t["kernel"] == "rwkv6_scan"],
                    model_paths["rwkv6_scan"][f"rwkv6-3b:f32_prefill_{CHECK_LEN}"],
                    model_paths["rwkv6_scan"],
                    {"evidence": rwkv_f32_sass, "grids_per_call": GRIDS_PER_CALL["rwkv6_scan"],
                     "f32_prefill": f32_prefills["rwkv6-3b"]}),
    ]
    finish_dryrun(child, card)
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [record, *flashes, *scans]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
