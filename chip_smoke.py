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
   H=KH=16, D=192, Dv=128; S=4096 in both types, S=32768 in bf16); then with
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
   rwkv6-3b (2,863,516,160), minicpm3-4b (4,261,902,848) and
   deepseek-v2-lite-16b (15,706,484,224) in turn, each at full width and
   depth from the port's seeded init and freed before the next: ``prefill``
   at B=1, S=32768 (the prefill_32k length): time, tokens/s, peak memory,
   the MoE aux (deepseek-v2-lite-16b; finite), and exactly one launch per
   layer of each kernel's kind (gemma3-1b: 26 bf16 flash; zamba2-7b: 68 bf16
   SSD and 13 bf16 flash; rwkv6-3b: 32 bf16 RWKV-6; minicpm3-4b: 62 bf16
   flash; deepseek-v2-lite-16b: 27 bf16 flash; the f32 checks of each model
   the same counts, on the f32 kernels, but at a cut depth, full width, for
   two models (``F32_REPEATS``): deepseek-v2-lite-16b's f32 copy would not
   fit beside its bf16 weights, so its f32 checks run its dense first layer
   and 3 MoE layers (4 f32 flash); zamba2-7b's run 4 of its 13 groups and
   its last 3 blocks (23 f32 SSD, 4 f32 flash) to keep the run's time). At
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
   are recycled and the recurrent state reset; minicpm3-4b and
   deepseek-v2-lite-16b: 4 such requests, one a slot): every request must
   finish. One
   prompt's teacher-forced decode logits must match the kernel-path
   ``forward`` within the model's limit, with the same top-1 token at all
   but the model's allowance of positions (a MoE model at its drop-free
   capacity for this check, as the JAX package's tests hold it: the forward
   dispatches the prompt as one group, decode each token). A profiler
   window over 8 ticks shows the device's busy share.
7. Training: each kernel's ``autograd.Function`` (the kernel forward, the
   plain version's gradient: the JAX package has no backward kernel) against
   the plain version under autograd, bf16 and f32: flash attention at
   ``tests/test_kernels.py``'s shapes, MLA's (96, 64) and (192, 128) and
   internlm2-1.8b's training batch (B=4, S=2048, 16/8 heads, D=128), each
   causal at its window and not causal with scale 0.1; the SSD and RWKV-6
   scans at the kernel tests' cases and zamba2-7b's and rwkv6-3b's heads at
   S=4096, and once past the SSD's cliff (decays summing far past f32's exp
   range in a chunk), where every gradient must be finite. The Function's
   output must equal the kernel's and every input
   gradient the plain version's, bit for bit, for a seeded output gradient;
   each gradient's gap to the f32 plain gradient is read. Then
   ``repro_torch.launch.train.main`` trains internlm2-1.8b (1,889,110,016
   parameters, bf16, f32 AdamW moments, remat) at full width and depth for
   8 steps at B=4, S=2048 on the synthetic pipeline, lr 3e-3: every loss
   finite, the last below the first; ms a step, tokens/s and peak memory are
   printed. One step through the kernels and one from a copy of the same
   state through the plain versions: their loss and gradient-norm gaps held
   to ``TRAIN_LIMITS``, the largest updated-parameter gap read, and no
   gradient all zeros where the plain path's is not; a further kernel step
   is profiled.
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
   card at ``n_iters=400``, singly and as ``solve_many`` batches of up to 64.
   Rounded routes, bandwidths and spans must be identical, relaxed spans
   within rtol 5e-2. The kernel and the plain version are timed with CUDA
   events on batches from that stream, where ``w``, spans and step counts
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
at MLA's head dims minicpm3-4b's, 62, and deepseek-v2-lite-16b's, 27; bf16
SSD: zamba2-7b's, 68; bf16 RWKV-6: rwkv6-3b's, 32); the S=4096 prefills and
``forward`` launch them once per layer, the plain reference runs and the
serving loops (whose decode is plain PyTorch) not at all. The f32 flash
kernel's path is gemma3-1b's f32 prefill at S=4096 (26 launches), the f32
SSD kernel's zamba2-7b's at its f32 depth (23), the f32 RWKV-6 kernel's
rwkv6-3b's (32). A full-width internlm2-1.8b train step launches the bf16
flash kernel exactly 48 times (24 layers, forward and remat's recompute; 384
in the 8-step entry-point run), its plain-path step none.
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
from repro_torch.models.transformer import pick_chunk  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
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
# internlm2-1.8b's training batch: the shape of each of a full-width train
# step's 48 launches (training phase), bf16
TRAIN_FLASH_SHAPE = (4, 2048, 16, 8, 128, 0)
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
# heads, D = 64 + 32, Dv = 64) and deepseek-v2-lite-16b (16 heads, D = 128 +
# 64, Dv = 128), global and causal with the scale D**-0.5; at S=4096 in both
# types and at the S=32768 of their prefills in bf16
MLA_FLASH_SHAPES = {
    "minicpm3-4b": [(1, 4096, 40, 40, 96, 0, 64), (1, 32768, 40, 40, 96, 0, 64)],
    "deepseek-v2-lite-16b": [(1, 4096, 16, 16, 192, 0, 128), (1, 32768, 16, 16, 192, 0, 128)],
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
    plain_ms = time_call(
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
    out.append(flash_case(TRAIN_FLASH_SHAPE, torch.bfloat16, device, reps=10))
    short, full = ZAMBA_FLASH_SHAPES
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
    for name, cases, model in (("ssd_scan", SSD_CASES, SSD_MODEL),
                               ("rwkv6_scan", RWKV_CASES, RWKV_MODEL)):
        rows = [scan_case(name, s, dt, device, 5, False)
                for dt in (torch.bfloat16, torch.float32) for s in model]
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
}
# the f32 checks' depth, pattern repeats kept at full width, where the full
# depth does not fit or does not fit the run's time: deepseek-v2-lite-16b's
# f32 copy (63 GB) does not fit beside its bf16 weights (31 GB), so it keeps
# its dense first layer and 3 of its 26 MoE layers; zamba2-7b keeps 4 of its
# 13 groups (5 Mamba-2 blocks and the shared attention each) and its 3 last
# Mamba-2 blocks, 27 of 81 layers, to keep the run under 700 s (PERF.md 4)
F32_REPEATS = {"zamba2-7b": 4, "deepseek-v2-lite-16b": 3}
# at f32 the same layers launch the f32 flash, SSD and RWKV-6 kernels instead
F32_KERNEL = {"flash_attention_wgmma": "flash_attention", "ssd_scan_mma": "ssd_scan",
              "rwkv6_scan_mma": "rwkv6_scan"}
F32_LAUNCHES = {
    arch: {F32_KERNEL.get(k, k): n for k, n in kinds.items()}
    for arch, kinds in FORWARD_LAUNCHES.items()
}
F32_LAUNCHES["zamba2-7b"] = {"ssd_scan": 5 * 4 + 3, "flash_attention": 4}
F32_LAUNCHES["deepseek-v2-lite-16b"] = {"flash_attention": 1 + 3}
# requests, slots, max_len, prompt lengths, new tokens; an SSM model's first
# prompt is the prefill prompt's first DECODE_LEN tokens (a chunk length its
# kernels take), the prompt of its decode-vs-forward checks
SERVING = {
    "gemma3-1b": dict(requests=16, slots=8, max_len=1024, prompt=(16, 256), new=32, first=False),
    "zamba2-7b": dict(requests=8, slots=4, max_len=256, prompt=(16, 64), new=16, first=True),
    "rwkv6-3b": dict(requests=8, slots=4, max_len=256, prompt=(16, 64), new=16, first=True),
    # 4 requests, one a slot, to keep the run under 700 s (PERF.md 4)
    "minicpm3-4b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16, first=False),
    "deepseek-v2-lite-16b": dict(requests=4, slots=4, max_len=256, prompt=(16, 64), new=16,
                                 first=False),
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
# none at f32).
LIMITS = {
    "gemma3-1b": dict(prefill=1e-3, decode=1e-3, flips=1, prefill_f32=4e-7, decode_f32=3e-6),
    "zamba2-7b": dict(prefill=0.12, decode=0.13, flips=10, prefill_f32=3e-5, decode_f32=3e-5),
    "rwkv6-3b": dict(prefill=0.1, decode=0.3, flips=22, prefill_f32=2e-5, decode_f32=1e-3),
    "minicpm3-4b": dict(prefill=0.08, decode=0.08, flips=1, prefill_f32=6e-6, decode_f32=5e-6),
    "deepseek-v2-lite-16b": dict(prefill=0.06, decode=0.06, flips=2, prefill_f32=3e-6,
                                 decode_f32=6e-6, route_flips=0.2),
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

    def __init__(self, cfg):
        self.on = cfg.n_experts > 0
        self.choices: list = []
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

        def replaying(topk, probs, k, dim=-1):
            c, L = next(calls), len(self.choices)
            ref = self.choices[c % L]
            if per_token:
                ref = ref[:, c // L : c // L + 1]
            own = topk(probs, k, dim=dim)[1]
            self.flips += int((own != ref).sum())
            self.total += ref.numel()
            return probs.gather(-1, ref), ref

        return self._topk(replaying)

    def check(self, label: str, limit: float) -> None:
        """The share of replayed choices the run's own router made otherwise,
        at most ``limit``."""
        if not self.on:
            return
        share = self.flips / self.total
        log(f"[routing] {label}: {self.flips} of {self.total} expert choices differ ({share:.3g}, "
            f"limit {limit})")
        assert share <= limit, f"{label}: {share} of the expert choices differ"


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


def profile_window(label: str, card: str, fn, *args, grids: dict | None = None) -> dict:
    """Where one window's time goes: ``torch.profiler`` kernel intervals on
    the card, their union over the host's wall clock (the device's busy
    share; the profiler's own host cost inflates the wall clock of
    host-bound windows), and the kernels that took the most device time.
    ``grids`` maps a name to substrings of kernel names: the result's
    ``device_grids`` counts the device launches whose name holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
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


def gap_share(label: str, got, want) -> float:
    """The largest logit difference as a share of the largest logit; read,
    not held to a limit."""
    share = float((got - want).abs().max()) / float(want.abs().max())
    log(f"[{label}] {json.dumps({'gap_share': share})}")
    return share


def logits_close(label: str, got, want, atol: float, min_top1: float) -> dict:
    """Logits within ``atol`` of the largest logit, with the same top-1 token
    at a share of at least ``min_top1`` of the positions."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    out = {"max_abs_err": err, "max_abs_logit": scale, "gap_share": err / scale,
           "atol": atol * scale, "top1_agree": top1, "min_top1": min_top1}
    log(f"[{label}] {json.dumps(out)}")
    assert err <= atol * scale, f"{label}: logits differ by {err} > {atol * scale}"
    assert top1 >= min_top1, f"{label}: top-1 agreement {top1} < {min_top1}"
    return out


def prompt_tokens(cfg, device) -> torch.Tensor:
    """(1, PREFILL_LEN) tokens from the seed: the prefill's prompt, whose
    first CHECK_LEN and first DECODE_LEN tokens the checks take."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (1, PREFILL_LEN))).to(device)


def prefill_phase(arch: str, device, card) -> tuple:
    """Returns the model, its weights, each kernel's launches by path and
    the plain path's logits at S=4096."""
    cfg = get_config(arch)
    expect = FORWARD_LAUNCHES[arch]
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    log(f"[prefill] {arch}: {n_params} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = prompt_tokens(cfg, device)
    prefill(params, cfg, tokens)  # warm-up: cuBLAS workspaces, the kernels' first load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    (logits, aux), counts = counted_all(
        f"{arch} prefill S={PREFILL_LEN} (main path)", expect, prefill, params, cfg, tokens
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
        "seq": PREFILL_LEN,
        "ms": seconds * 1e3,
        "tokens_per_s": PREFILL_LEN / seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "launches": {k: counts[k] for k in expect},
    }
    log(f"[prefill] {json.dumps(stats)} [{card}]")
    short = tokens[:, :CHECK_LEN]
    routes = Routing(cfg)  # a MoE model's plain run takes the kernel run's choices
    with routes.record():
        (k_logits, _), k_counts = counted_all(
            f"{arch} prefill S={CHECK_LEN} (kernel)", expect, prefill, params, cfg, short
        )
    with plain_kernels(), routes.replay():
        (p_logits, _), _ = counted_all(f"{arch} prefill S={CHECK_LEN} (plain)", {}, prefill,
                                       params, cfg, short)
    routes.check(f"{arch} prefill S={CHECK_LEN} plain on the kernel's choices",
                 LIMITS[arch].get("route_flips", 0.0))
    logits_close(f"{arch} prefill S={CHECK_LEN} kernel vs plain", k_logits, p_logits,
                 LIMITS[arch]["prefill"], min_top1=1.0)
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
                          grids=GRID_KERNELS)
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
    # teacher-forced decode of one prompt against the kernel-path forward:
    # what ties the recurrent decode to the kernels
    t0 = time.perf_counter()
    toks = torch.tensor([requests[0].prompt], device=device)
    expect = FORWARD_LAUNCHES[arch]
    check = drop_free(cfg)
    routes = Routing(cfg)  # a MoE model's decode takes the forward's choices
    with routes.record():
        (fwd, _), f_counts = counted_all(f"{arch} forward S={toks.shape[1]}", expect, forward,
                                         params, check, toks)
    n = toks.shape[1]
    with routes.replay(per_token=True):
        dec = decode_logits(params, check, toks, device)
    routes.check(f"{arch} decode on the forward's choices", LIMITS[arch].get("route_flips", 0.0))
    logits_close(f"{arch} decode vs forward", dec, fwd, LIMITS[arch]["decode"],
                 min_top1=1 - LIMITS[arch]["flips"] / n)
    log(f"[time] {arch} decode vs forward check {time.perf_counter() - t0:.1f} s")
    # a window of steady serving: every slot busy, prefilling and decoding
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, slots=spec["slots"], max_len=spec["max_len"], device=device)
    for r in requests[: spec["slots"]]:
        eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    eng.tick()  # admit
    profile_window(f"{arch} serving, {PROFILE_TICKS} ticks", card,
                   lambda: [eng.tick() for _ in range(PROFILE_TICKS)])
    log(f"[time] {arch} serving profile window {time.perf_counter() - t0:.1f} s")
    return {name: {f"{arch}:serving": s_counts[name], f"{arch}:forward_{n}": f_counts[name]}
            for name in expect}


def decode_logits(params, cfg, toks, device):
    """Teacher-forced decode of ``toks`` (1, n) from an empty cache."""
    cache = init_cache(cfg, 1, toks.shape[1], device=device)
    outs = []
    for i in range(toks.shape[1]):
        step_logits, cache = decode_step(params, cfg, cache, toks[:, i : i + 1])
        outs.append(step_logits)
    return torch.cat(outs, 1)


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
    path's: the gap bf16 rounding alone makes. Returns each kernel's
    launches by path and the prefill's record."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if arch in F32_REPEATS:  # the first groups only: the f32 copy of all does not fit
        repeats = F32_REPEATS[arch]
        cfg32 = dataclasses.replace(cfg32, n_pattern_repeats=repeats)
        stack = dict(params["stack"], groups=params["stack"]["groups"][:repeats])
        params = dict(params, stack=stack)
        log(f"[f32] {arch}: {cfg32.n_layers} of {cfg.n_layers} layers, full width")
    p32 = tree_map(lambda t: t.float(), params)
    tokens = prompt_tokens(cfg, device)
    short = tokens[:, :CHECK_LEN]
    expect = F32_LAUNCHES[arch]
    routes = Routing(cfg)
    with routes.record():
        (k_logits, _), k_counts = counted_all(f"{arch} f32 prefill S={CHECK_LEN} (kernel)",
                                              expect, prefill, p32, cfg32, short)
    with plain_kernels(), routes.replay():
        (p_logits, _), _ = counted_all(f"{arch} f32 prefill S={CHECK_LEN} (plain)", {}, prefill,
                                       p32, cfg32, short)
    routes.check(f"{arch} f32 prefill S={CHECK_LEN} plain on the kernel's choices",
                 LIMITS[arch].get("route_flips", 0.0))
    logits_close(f"{arch} f32 prefill S={CHECK_LEN} kernel vs plain", k_logits, p_logits,
                 LIMITS[arch]["prefill_f32"], min_top1=1.0)
    if bf16_plain is not None:  # bf16 rounding alone: the bf16 plain path against the f32 one
        gap_share(f"{arch} bf16 plain vs f32 plain prefill S={CHECK_LEN}", bf16_plain, p_logits)
    calls = {name: COUNTERS[name].launches for name in GRID_KERNELS}
    prof = profile_window(f"{arch} f32 prefill S={CHECK_LEN}", card, prefill, p32, cfg32, short,
                          grids=GRID_KERNELS)
    for name in GRID_KERNELS:
        calls[name] = COUNTERS[name].launches - calls[name]
        if calls[name] and name in expect:
            GRIDS_PER_CALL[name] = prof["device_grids"][name] / calls[name]
            log(f"[profile] {name}: {prof['device_grids'][name]} grids in {calls[name]} calls")
    stats = {"arch": arch, "dtype": "float32", "seq": CHECK_LEN, "layers": cfg32.n_layers,
             "ms": time_call(prefill, (p32, cfg32, short), {}, reps=2, warm=0)}
    stats["tokens_per_s"] = CHECK_LEN / stats["ms"] * 1e3
    log(f"[prefill] {json.dumps(stats)} [{card}]")
    toks = tokens[:, :DECODE_LEN]
    cfg32 = drop_free(cfg32)  # decode against forward: as in the serving phase
    routes = Routing(cfg)  # decode and the plain forward take the kernel forward's choices
    with routes.record():
        (fwd, _), f_counts = counted_all(f"{arch} f32 forward S={DECODE_LEN}", expect, forward,
                                         p32, cfg32, toks)
    with routes.replay(per_token=True):
        dec = decode_logits(p32, cfg32, toks, device)
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
                                    p32, cfg32, toks)
    logits_close(f"{arch} f32 decode vs plain forward", dec, p_fwd, LIMITS[arch]["decode_f32"],
                 min_top1=1.0)
    logits_close(f"{arch} f32 forward S={DECODE_LEN} kernel vs plain", fwd, p_fwd,
                 LIMITS[arch]["decode_f32"], min_top1=1.0)
    scan_rows_vs_f64(arch, p32, cfg32, toks)
    del p32
    torch.cuda.empty_cache()
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
# the scans at tests/test_kernels.py's cases and the models' heads at S=4096
GRAD_SSD_SHAPES = [*SSD_CASES[:4], SSD_MODEL[1]]
# an SSD case past the cliff: dt 1.5-2.5 and A -8..-12 give log-decays of
# -12..-30 a step, a chunk of 64 sums them far past f32's exp range (88),
# where an unmasked exp's gradient is NaN; the plain gradient must be finite
GRAD_SSD_CLIFF = [(2, 256, 4, 64, 64, 64)]
GRAD_RWKV_SHAPES = [*RWKV_CASES, RWKV_MODEL[1]]
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
    ins = [a.detach().clone().requires_grad_() for a in args]
    out = function.apply(*ins, kw)
    with torch.no_grad():
        kernel_out = hsd(*args, **kw)
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    cot = torch.randn(out.shape, generator=gen, device=args[0].device).to(out.dtype)
    got = torch.autograd.grad(out, ins, cot)
    ref_in = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(plain(*ref_in, **kw), ref_in, cot)
    f32_in = [a.detach().float().requires_grad_() for a in args]
    f32 = torch.autograd.grad(plain(*f32_in, **kw), f32_in, cot.float())
    torch.cuda.synchronize()
    shares = [grad_row_share(g, w) for g, w in zip(got, f32)]
    rec = {"case": label, "output_equal": same_bits(out.detach(), kernel_out),
           "grads_equal": [same_bits(g, w) for g, w in zip(got, want)],
           "f32_row_share": max(s for s, _ in shares),
           "non_finite": sum(n for _, n in shares)}
    log(f"[grad] {json.dumps(rec)} [{card}]")
    assert rec["output_equal"], f"{label}: the Function's output is not the kernel's"
    assert all(rec["grads_equal"]), f"{label}: gradients differ from the plain version's"
    return rec


def grad_checks(device, card) -> int:
    """Every kernel Function's gradient check; returns the count of cases."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for B, S, H, KH, D, Dv, window in GRAD_FLASH_SHAPES:
            gen = torch.Generator(device=device).manual_seed(SEED + S + H + D)
            q = torch.randn((B, H, S, D), generator=gen, device=device).to(dtype)
            k = torch.randn((B, KH, S, D), generator=gen, device=device).to(dtype)
            v = torch.randn((B, KH, S, Dv), generator=gen, device=device).to(dtype)
            for causal, win, scale in ((True, window, None), (False, 0, 0.1)):
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


def train_batch(cfg, device) -> dict:
    """Step 0 of the synthetic data pipeline (seed 0) at the training shape."""
    dcfg = DataConfig(vocab=cfg.vocab, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)
    return {k: torch.from_numpy(v).to(device) for k, v in synthetic_batch(dcfg, 0).items()}


def train_opt(cfg) -> AdamWConfig:
    """``launch/train.py``'s AdamW settings for a TRAIN_STEPS run."""
    return AdamWConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 1),
                       total_steps=TRAIN_STEPS, moment_dtype=cfg.optimizer_state_dtype,
                       factored_second_moment=cfg.optimizer_factored)


def entry_point_run(device, card) -> tuple[dict, dict]:
    """``launch/train.py`` at full width for TRAIN_STEPS steps, exactly
    TRAIN_LAUNCHES bf16 flash launches a step: finite losses, the last below
    the first. Returns its record and its launches."""
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR), "--log-every", "1",
            "--seed", str(SEED)]
    expect = {k: n * TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out, counts = counted_all(f"{TRAIN_ARCH} launch.train.main, {TRAIN_STEPS} steps (main path)",
                              expect, train_driver.main, argv)
    seconds = time.perf_counter() - t0
    losses = out["losses"]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    steady = sorted(out["step_seconds"][1:])[len(out["step_seconds"][1:]) // 2]
    rec = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "lr": TRAIN_LR, "losses": losses, "call_s": seconds,
           "first_step_ms": out["step_seconds"][0] * 1e3, "ms_per_step": steady * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
           "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "launches": counts["flash_attention_wgmma"]}
    log(f"[train] {json.dumps(rec)} [{card}]")
    return rec, counts


def train_step_once(state, cfg, opt, batch):
    """One train step, keeping its gradients: what ``make_train_step``'s step
    runs (``loss_and_grads``, then ``apply_updates``)."""
    grads, metrics = loss_and_grads(state["params"], cfg, TrainConfig(), batch)
    _, state["opt"], opt_metrics = apply_updates(opt, state["params"], grads, state["opt"])
    return grads, {k: float(v) for k, v in {**metrics, **opt_metrics}.items()}


def kernel_vs_plain_step(device, card) -> dict:
    """One full-width step through the kernels and one, from a copy of the
    same state, through their plain versions: exactly TRAIN_LAUNCHES bf16
    flash launches on the first, none on the second; the loss and
    gradient-norm gaps held to TRAIN_LIMITS, the largest updated-parameter
    gap read; no gradient all zeros where the plain path's is not. Then one
    further kernel step profiled. Returns the launches by path."""
    cfg = get_config(TRAIN_ARCH)
    opt = train_opt(cfg)
    state = init_train_state(cfg, opt, SEED, device=device)
    # the training state the card holds (params, AdamW moments, steps): the
    # dry run's (1, 1)-mesh static bytes must equal it
    CARD_STATE_BYTES[TRAIN_ARCH] = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    batch = train_batch(cfg, device)
    plain_state = tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad), state)
    (k_grads, k_metrics), k_counts = counted_all(
        f"{TRAIN_ARCH} train step (kernel)", TRAIN_LAUNCHES, train_step_once, state, cfg, opt,
        batch)
    with plain_kernels():
        (p_grads, p_metrics), _ = counted_all(f"{TRAIN_ARCH} train step (plain)", {},
                                              train_step_once, plain_state, cfg, opt, batch)
    zero = [i for i, (g, w) in enumerate(zip(tree_leaves(k_grads), tree_leaves(p_grads)))
            if not bool(g.any()) and bool(w.any())]
    assert not zero, f"{len(zero)} gradients all zero on the kernel path only"
    grad_gap, grad_at = max(
        (float((g.float() - w.float()).abs().max()) / float(w.float().abs().max()), path)
        for (path, g), (_, w) in zip(tree_paths(k_grads), tree_paths(p_grads)))
    param_gap = max(float((a.detach().float() - b.detach().float()).abs().max()) for a, b in
                    zip(tree_leaves(state["params"]), tree_leaves(plain_state["params"])))
    gaps = {k: abs(k_metrics[k] - p_metrics[k]) / abs(p_metrics[k]) for k in TRAIN_LIMITS}
    rec = {"kernel": {k: k_metrics[k] for k in ("loss", "grad_norm", "clip_scale", "lr")},
           "plain": {k: p_metrics[k] for k in ("loss", "grad_norm")}, "gaps": gaps,
           "limits": TRAIN_LIMITS, "largest_grad_gap_share": grad_gap, "at": grad_at,
           "largest_param_gap": param_gap, "param_gap_over_lr": param_gap / k_metrics["lr"],
           "launches": k_counts["flash_attention_wgmma"]}
    log(f"[train] {TRAIN_ARCH} kernel vs plain step: {json.dumps(rec)} [{card}]")
    for k, limit in TRAIN_LIMITS.items():
        assert gaps[k] <= limit, f"{TRAIN_ARCH} train step: {k} gap {gaps[k]} > {limit}"
    del plain_state, p_grads, k_grads
    torch.cuda.empty_cache()
    profile_window(f"{TRAIN_ARCH} train step, B={TRAIN_BATCH} S={TRAIN_SEQ}", card,
                   train_step_once, state, cfg, opt, batch)
    del state
    torch.cuda.empty_cache()
    return {"flash_attention_wgmma": {f"{TRAIN_ARCH}:train_step": k_counts[
        "flash_attention_wgmma"], f"{TRAIN_ARCH}:train_step_plain": 0}}


def training_phase(device, card) -> dict:
    """The kernel Functions' gradients, the entry point at full width, and a
    kernel-path step against a plain-path step. Returns the launches by
    path."""
    t0 = time.perf_counter()
    n = grad_checks(device, card)
    log(f"[time] {n} kernel gradient checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec, counts = entry_point_run(device, card)
    log(f"[time] {TRAIN_ARCH} entry point {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = kernel_vs_plain_step(device, card)
    log(f"[time] {TRAIN_ARCH} kernel vs plain step and profile {time.perf_counter() - t0:.1f} s")
    paths["flash_attention_wgmma"][f"{TRAIN_ARCH}:train_main_{TRAIN_STEPS}_steps"] = counts[
        "flash_attention_wgmma"]
    return paths, rec


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
    """Records every (net, flows, capacity) solve request it serves."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.captured: list = []

    def _record(self, net, flows, capacity):
        self.captured.append((net, list(flows), None if capacity is None else capacity.copy()))

    def solve(self, net, flows, *, capacity=None, **kwargs):
        self._record(net, flows, capacity)
        return super().solve(net, flows, capacity=capacity, **kwargs)

    def solve_many(self, net, flow_sets, *, capacities=None, **kwargs):
        nets = [net] * len(flow_sets) if isinstance(net, NetworkGraph) else list(net)
        caps = capacities if capacities is not None else [None] * len(flow_sets)
        for g, fs, c in zip(nets, flow_sets, caps):
            self._record(g, fs, c)
        return super().solve_many(net, flow_sets, capacities=capacities, **kwargs)


def capture_stream(device, solver, *, seeds=(0, 1), n_jobs=8, n_iters=STREAM_ITERS) -> list:
    eng = CapturingEngine(k=K, n_iters=n_iters, solver=solver, device=device)
    for name in sorted(SCENARIOS):
        for seed in seeds:
            for policy in ("OTFS", "OTFA"):
                net, arrivals = SCENARIOS[name].build(seed=seed, n_jobs=n_jobs)
                OnlineScheduler(net, policy, k_paths=K, jrba_iters=n_iters, engine=eng).run(
                    arrivals
                )
    return eng.captured


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
    """Returns the kernel's record and the launches of each kernel path."""
    launches = {}
    t0 = time.perf_counter()
    stream, launches["scheduler"] = counted(
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
    t0 = time.perf_counter()
    (single_p, steps_p), _ = counted(
        f"stream single ({plain_solver})", False, replay_single, ep, stream
    )
    tp = time.perf_counter() - t0
    gap1 = compare("single", single_k, single_p)
    relaxed = sum(1 for s in steps_k if s)
    n_diff = sum(1 for a, b in zip(steps_k, steps_p) if a != b)
    log(
        f"[stream] single: {len(stream)} programs ({relaxed} relaxed, "
        f"{ek.stats.fast_path_solves} fast-path) identical records; worst relaxed-span "
        f"gap {gap1:.3g}; steps differ on {n_diff}; replay {tk:.2f} s kernel, {tp:.2f} s plain"
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
    model_paths: dict[str, dict] = {name: {} for name in COUNTERS}
    f32_prefills = {}
    for arch in FORWARD_LAUNCHES:  # one model on the card at a time
        cfg, params, by_path, bf16_plain = prefill_phase(arch, device, card)
        log(f"[time] after {arch} prefill phase {time.perf_counter() - t_start:.1f} s")
        f32_paths, f32_prefills[arch] = f32_phase(
            arch, cfg, params, device, card, None if arch in F32_REPEATS else bf16_plain)
        del bf16_plain
        log(f"[time] after {arch} f32 phase {time.perf_counter() - t_start:.1f} s")
        for paths in (by_path, serving_phase(arch, cfg, params, device, card), f32_paths):
            for name, counts in paths.items():
                model_paths[name].update(counts)
        del params
        torch.cuda.empty_cache()
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
