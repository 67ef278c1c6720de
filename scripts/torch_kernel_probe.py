#!/usr/bin/env python3
"""Probe the port's JRBA congestion kernel, bf16 SSD scan, flash attention
kernels and RWKV-6 scans on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 scripts/torch_kernel_probe.py [--parts jrba ssd ssd32 flash rwkv rwkv32]
        [--stream-seeds 0] [--out build/kernel_probe.json]

Builds the parts' libraries (``jrba_congestion``; ``ssd_scan_mma`` and
``ssd_scan``; ``flash_attention`` and ``flash_attention_wgmma``;
``rwkv6_scan_mma`` and ``rwkv6_scan``) from ``src/repro_torch/kernels/csrc``
(``nvcc -Xptxas -v``, all at once), prints their SASS and ptxas evidence,
then:

* JRBA: captures the programs the port's ``OnlineScheduler`` solves on the
  kernel (12 scenarios, OTFS and OTFA, ``--stream-seeds``), and on batches of
  that stream (as ``chip_smoke.py`` picks them) checks kernel against plain
  bit for bit and times both, with the slowest lane's steps, the time per
  step and the latency floor; the most common batch is timed again through
  the port's wrapper on its block instance (64 threads) and on its general
  instance beside its one-warp one, and through diagnostic builds of the same
  source with other nvcc flags (``--jrba-variants``: denormals flushed,
  approximate division and square root), whose bits are compared with the
  plain version's but which the port never builds;
* SSD: the bf16 kernel against its plain version at zamba2-7b's heads
  (S=32768 and 4096) and at ``tests/test_kernels.py``'s cases, timed, and
  through diagnostic builds that fix the value columns a block takes (16, 32
  or 64);
* flash: both kernels against their plain version, timed beside SDPA, at
  ``chip_smoke.py``'s S=4096 shapes in f32, gemma3-1b's S=32768 shapes in
  bf16, and the ``causal=False`` / ``scale`` cases; then the f32 kernel
  through diagnostic builds (rows a thread, row groups a block, kv tile,
  unrolling) at the S=4096 shapes; the f32 kernel's two products apart
  (builds that run S = Q K^T alone, P V alone, or neither) at D=112 and
  D=128, each with the SASS counts of its instance; and the card's SM clock
  and power while the kernel runs back to back;
* RWKV-6: both kernels against their plain version at rwkv6-3b's heads
  (S=32768 and 4096) and at ``tests/test_kernels.py``'s cases, timed, then
  the bf16 kernel at S=32768 and 4096 with the sequence cut into segments of other
  lengths (the port's plan replaced) and through diagnostic builds that fix
  the value columns a warp takes (16 or 64, with the segment plan counting
  that many warps);
* ssd32: the f32 SSD kernel alone, against its plain version at zamba2-7b's
  heads (S=32768 and 4096) and at ``chip_smoke.py``'s cases (the odd chunks
  included), timed; then at both lengths through diagnostic builds: 32
  value columns a block (``ssd.block_cols`` patched to match),
  __expf, the rows of y in warp order, no unrolling, and
  builds that skip the C B^T grid or empty one part (C H, W x, the state
  update, W), whose output is wrong: the time they leave is that part's;
* rwkv32: the f32 RWKV-6 kernel alone, against its plain version at
  rwkv6-3b's heads (S=32768 and 4096) and at ``tests/test_kernels.py``'s
  cases, timed; then at both lengths with other segment lengths, and through
  diagnostic builds of 16 and 64 value columns a warp (the plan counting
  that many warps).

A diagnostic build is the port's source with a few lines replaced, written
under the build directory and compiled there; the port's sources carry no
build options for it. Every such build is launched through the port's own
wrapper: the probe only swaps the library the wrapper loads, or the plan it
computes.
Every check runs and is reported; the script exits 1 if any failed. The card's
name and power limit are printed beside the numbers; the whole result goes to
``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import JRBAEngine  # noqa: E402
from repro_torch.core.jrba import sparse_batch_inputs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import jrba_congestion as jc  # noqa: E402
from repro_torch.kernels import rwkv6 as rw  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.obs.trace import dumps_strict  # noqa: E402

LIBRARIES = {"jrba": ("jrba_congestion",), "ssd": ("ssd_scan_mma", "ssd_scan"),
             "ssd32": ("ssd_scan",), "flash": ("flash_attention", "flash_attention_wgmma"),
             "rwkv": ("rwkv6_scan_mma", "rwkv6_scan"), "rwkv32": ("rwkv6_scan",)}
# diagnostic builds of the JRBA source: what each changes says what its
# arithmetic costs (the port builds only _build.NVCC_FLAGS)
JRBA_VARIANTS = {
    "ftz": ("-ftz=true",),
    "approx_div": ("-prec-div=false",),
    "approx_sqrt": ("-prec-sqrt=false",),
    "approx_div_sqrt": ("-prec-div=false", "-prec-sqrt=false"),
}
# Diagnostic builds: each is a list of (text, replacement) edits of the
# port's source, every text of which must occur in it.
# the bf16 SSD source at one block width each
SSD_ARGS = "(tile, x, dtf, Af, Bm, Cm, y, B, H, S, P, N, Q, st, vec, s);\n"
SSD_DISPATCH = "  if (P % 32 == 0)\n    return dispatch_q<32>" + SSD_ARGS
SSD_VARIANTS = {f"block_cols_{pb}": [(SSD_DISPATCH, f"  if (P % {pb} != 0) return 1;\n"
                                      f"  return dispatch_q<{pb}>" + SSD_ARGS)]
                for pb in (16, 32, 64)}
# the f32 SSD source at 32 value columns a block where P allows (the probe's
# plan counts those blocks), and without its C B^T grid (timing only)
SSD32_VARIANTS = {
    "block_cols_32": [("pb != (P % 64 == 0 ? 64 : 16)", "pb != (P % 64 == 0 ? 32 : 16)"),
                      ("  if (pb == 64) return launch<Q, 64>(",
                       "  if (pb == 32) return launch<Q, 32>(")],
    "no_gram": [("  ssd_gram_kernel<Q><<<", "  if (false) ssd_gram_kernel<Q><<<")],
}
SSD32_VARIANTS.update({
    "expf_fast": [("expf(", "__expf(")],
    "rows_in_order": [("const int rb = warp < WARPS / 2 ? warp : 3 * WARPS / 2 - 1 - warp;",
                       "const int rb = warp;")],
    "no_unroll_2": [("#pragma unroll 2\n", "")],
})
# the f32 SSD source with one part emptied (timing only): C H, W x, the
# state update's products, the W transform
SSD32_SPLIT = {
    "no_ch": [("for (int n = 0; n < n4; n += 4) {\n        float4 cv[TQ];",
               "for (int n = 0; n < 0; n += 4) {\n        float4 cv[TQ];")],
    "no_wx": [("for (int j = 0; j < jend; j += 4) {", "for (int j = 0; j < 0; j += 4) {")],
    "no_state": [("for (int j = 0; j < q4; ++j) {", "for (int j = 0; j < 0; ++j) {")],
    "no_w": [("        if (j < jl) {", "        if (false) {")],
}
# the bf16 RWKV-6 source with a warp width of 16 or 64 at P=64; the probe
# plans the segments for that many warps (rw.value_cols patched alike)
RWKV_COLS = (16, 64)
RWKV_VARIANTS = {f"cols_{nc}": [
    ("ncol != (P % 32 == 0 ? 32 : 16)", f"ncol != (P == 64 ? {nc} : P % 32 == 0 ? 32 : 16)"),
    ("default: return launch<64, 32>(", f"default: return launch<64, {nc}>("),
] for nc in RWKV_COLS}
# the same for the f32 RWKV-6 source
RWKV32_VARIANTS = {f"cols_{nc}": [
    ("ncol != (P % 32 == 0 ? 32 : 16)", f"ncol != (P == 64 ? {nc} : P % 32 == 0 ? 32 : 16)"),
    ("    default:\n      return launch<64, 32>(", f"    default:\n      return launch<64, {nc}>("),
] for nc in RWKV_COLS}
# the f32 RWKV-6 source with one part emptied (timing only): A, the y
# products, the state update's products; and with __expf for expf
RWKV32_SPLIT = {
    "no_a": [("        const float4 qv = *reinterpret_cast<const float4*>(rs + c * L::RS",
              "        if (true) break;\n        const float4 qv = "
              "*reinterpret_cast<const float4*>(rs + c * L::RS")],
    "no_y": [("          const float4 qv = *reinterpret_cast<const float4*>(rs + i * L::RS",
              "          if (true) break;\n          const float4 qv = "
              "*reinterpret_cast<const float4*>(rs + i * L::RS")],
    "no_state": [("        const float4 kd = *reinterpret_cast<const float4*>(ks + i * L::RS",
                  "        if (true) break;\n        const float4 kd = "
                  "*reinterpret_cast<const float4*>(ks + i * L::RS")],
    "expf_fast": [("expf(", "__expf(")],
}
# the f32 flash source: rows a thread, kv tile and row groups of the
# instances at D <= 128 and minicpm3-4b's (96, 64) (D = 256 and (192, 128)
# keep theirs: larger tiles would not fit), and the unrolling of both
# product loops
FLASH_TILE_DIMS = ((16, 16), (32, 32), (64, 64), (96, 96), (112, 112), (128, 128), (96, 64))


def flash_tile(rm: int, bk: int, rg: int) -> list:
    return [(f"<{d}, {dv}, 8, 64, 16>(", f"<{d}, {dv}, {rm}, {bk}, {rg}>(")
            for d, dv in FLASH_TILE_DIMS]


FLASH_UNROLL = {n: ("#pragma unroll 8\n", f"#pragma unroll {n}\n") for n in (2, 4)}
FLASH_VARIANTS = {
    "rm_4": flash_tile(4, 64, 16), "bk_32": flash_tile(8, 32, 16),
    "unroll_2": [FLASH_UNROLL[2]], "unroll_4": [FLASH_UNROLL[4]],
    "rg_24": flash_tile(8, 64, 24),
    "rg_24_unroll_4": [*flash_tile(8, 64, 24), FLASH_UNROLL[4]],
    "rg_24_unroll_2": [*flash_tile(8, 64, 24), FLASH_UNROLL[2]],
}
# the f32 flash source with a product loop emptied: S = Q K^T alone (P V
# skipped, the output wrong), P V alone (every score 0), neither (loads,
# softmax and barriers only)
FLASH_S_LOOP = ("for (int d = 0; d < D; d += 4) {", "for (int d = 0; d < 0; d += 4) {")
FLASH_PV_LOOP = ("for (int c2 = 0; c2 < BK; ++c2) {", "for (int c2 = 0; c2 < 0; ++c2) {")
FLASH_SPLIT = {"s_only": [FLASH_PV_LOOP], "pv_only": [FLASH_S_LOOP],
               "neither": [FLASH_S_LOOP, FLASH_PV_LOOP]}
# the shapes the split is timed at: zamba2-7b's D=112 and internlm2's D=128
FLASH_SPLIT_SHAPES = ((1, 4096, 32, 32, 112, 0), (1, 4096, 16, 8, 128, 0))
# SASS opcodes counted in each instance of a split build, by every width
# and modifier they come with (LDS and LDS.128 apart)
SPLIT_OPS = ("FFMA", "LDS", "LDGSTS", "BAR", "SHFL")
# segment lengths (chunks) the bf16 RWKV-6 kernel is timed at, beside the plan's
RWKV_SEGMENTS = (8, 12, 16, 32, 64, 128, 256)


def build_variant(name: str, label: str, edits: list) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with ``edits`` applied (each text replaced
    wherever it occurs), written and built in the build directory, and
    loaded."""
    src, _ = _build._target(name)
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{name} {label}: {old!r} is not in the source")
        text = text.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = _build.BUILD_DIR / f"{name}_variant_{label}.cu"
    variant.write_text(text)
    lib = variant.with_suffix(".so")
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", str(_build.CSRC), "-o", str(lib), str(variant)],
                         check=True, capture_output=True, text=True)
    spills = [e for e in cs.ptxas_entries(out.stdout + out.stderr)
              if e["spill_stores"] or e["spill_loads"]]
    print(f"[build] {name} {label}: {len(spills)} entries spill "
          f"{[(e['entry'][-40:], e['spill_stores']) for e in spills]}", flush=True)
    return ctypes.CDLL(str(lib))


def instance_sass(lib_path: Path, instance: str, ops: tuple) -> dict:
    """How often each SASS opcode whose base is in ``ops`` appears, with its
    suffixes (``LDS`` and ``LDS.128`` count apart), in the kernel whose
    mangled name holds ``instance``."""
    sass = subprocess.run([str(cs.cuobjdump_path()), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs[1:] if instance in f.split("\n", 1)[0])
    opcodes = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    counts: dict[str, int] = {}
    for o in opcodes:
        if o.split(".")[0] in ops:
            counts[o] = counts.get(o, 0) + 1
    return dict(sorted(counts.items()))


def build_variants(name: str, variants: dict) -> dict:
    """Every variant of ``name``, built at once."""
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        libs = pool.map(lambda kv: build_variant(name, *kv), variants.items())
        return dict(zip(variants, libs))


@contextlib.contextmanager
def wrappers_load(name: str, lib: ctypes.CDLL):
    """Within the block, the port's wrappers launch ``lib`` for ``name``."""
    load = _build.load
    _build.load = lambda n: lib if n == name else load(n)
    try:
        yield
    finally:
        _build.load = load


def wrapper_ms(args, reps: int = 20) -> tuple[float, dict]:
    """The batch through the port's wrapper, timed with CUDA events over
    ``reps`` launches; returns (ms, how its w, spans and steps compare with
    the plain version's)."""
    kw = dict(n_iters=cs.STREAM_ITERS)
    ms = cs.time_call(jc.sparse_congestion_solve, args, kw, reps=reps)
    w, span, steps = jc.sparse_congestion_solve(*args, **kw)
    w_p, span_p, steps_p = jc.sparse_congestion_plain(*args, **kw)
    torch.cuda.synchronize()
    same = {"w": torch.equal(w, w_p), "span": torch.equal(span, span_p),
            "steps": torch.equal(steps, steps_p), "max_steps": int(steps.max()),
            "w_max_abs_diff": float((w - w_p).abs().max())}
    return ms, same


def forced_plan(**override):
    """``launch_plan`` with the port's plan changed as ``override`` says
    (``general=True``: the general instance at the batch's threads)."""
    plan = jc.launch_plan

    def patched(B, Nf, K, P, La, n_iters):
        out = plan(B, Nf, K, P, La, n_iters)
        if override.get("general"):
            out.update(staged=False, workspace=jc.table_bytes(Nf, K, P),
                       smem=jc.kernel_smem_bytes(Nf, K, La, P, n_iters, staged=False))
        if "threads" in override:
            out["threads"] = override["threads"]
        return out

    return mock.patch.object(jc, "launch_plan", patched)


def jrba_probe(device, seeds: tuple, variants: bool) -> dict:
    """The scheduler's stream on the kernel, then chip_smoke's timed batches
    and the most common batch through the port's plan, its block and its
    general instance and, with ``variants``, the diagnostic builds."""
    t0 = time.perf_counter()
    stream, _ = cs.capture_stream(device, "cuda", seeds=seeds, n_jobs=8)
    print(f"[jrba] captured {len(stream)} programs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    eng = JRBAEngine(k=cs.K, n_iters=cs.STREAM_ITERS, solver="cuda", device=device)
    groups = cs.batch_groups(eng, stream)
    record = cs.kernel_record(eng, stream, groups, device)
    live = [g for g in groups if eng.build(*stream[g[0]][:2], capacity=stream[g[0]][2])]
    progs = [eng.build(*stream[i][:2], capacity=stream[i][2]) for i in max(live, key=len)]
    progs += [progs[-1]] * (cs.BATCH - len(progs))
    args = sparse_batch_inputs(progs, device)
    raw = {"port": wrapper_ms(args)}
    with forced_plan(threads=64):
        raw["block_64_threads"] = wrapper_ms(args)
    with forced_plan(general=True):
        raw["general"] = wrapper_ms(args)
    assert all(same["w"] and same["span"] and same["steps"] for _, same in raw.values()), (
        "a port instance differs")
    if variants:
        for name, lib in build_variants("jrba_congestion", JRBA_VARIANTS).items():
            with wrappers_load("jrba_congestion", lib):
                raw[name] = wrapper_ms(args)
    for name, (ms, same) in raw.items():
        print(f"[jrba] wrapper launch {name}: {ms:.4f} ms {dumps_strict(same)}", flush=True)
    record["wrapper_launch"] = raw
    return record


def ssd_block_cols(shape, device) -> dict:
    """The bf16 SSD kernel's milliseconds at each block width (diagnostic
    builds), and its largest difference from the port's build."""
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm = cs.scan_inputs("ssd_scan", shape, torch.bfloat16, device)
    hsd = (x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm)
    port = ssd.ssd_scan_hsd(*hsd, chunk=Q)
    out = {"port_ms": cs.time_call(ssd.ssd_scan_hsd, hsd, dict(chunk=Q), reps=5)}
    for name, lib in build_variants("ssd_scan_mma", SSD_VARIANTS).items():
        with wrappers_load("ssd_scan_mma", lib):
            ms = cs.time_call(ssd.ssd_scan_hsd, hsd, dict(chunk=Q), reps=5)
            diff = float((ssd.ssd_scan_hsd(*hsd, chunk=Q).float() - port.float()).abs().max())
        out[name] = {"ms": ms, "max_abs_diff_from_port": diff}
    print(f"[ssd] {list(shape)} by block columns: {dumps_strict(out)}", flush=True)
    return out


def flash_inputs(shape, device):
    B, S, H, KH, D, window = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(cs.SEED + sum(shape))
    return tuple(torch.randn(sz, generator=gen, device=device)
                 for sz in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))


def flash_split(device) -> dict:
    """The f32 flash kernel's two products timed apart: builds that run
    S = Q K^T alone, P V alone or neither, beside the port's build, at
    :data:`FLASH_SPLIT_SHAPES`, with each build's SASS counts of that
    shape's instance (FFMA, 32-bit and 128-bit shared loads, cp.async,
    barriers, shuffles)."""
    libs = build_variants("flash_attention", FLASH_SPLIT)
    paths = {"port": _build.build("flash_attention")[0],
             **{n: _build.BUILD_DIR / f"flash_attention_variant_{n}.so" for n in FLASH_SPLIT}}
    out = {}
    for shape in FLASH_SPLIT_SHAPES:
        B, S, H, KH, D, window = shape
        q, k, v = flash_inputs(shape, device)
        kw = dict(window=window)
        instance = f"flash_fwdILi{D}ELi{D}ELi8ELi64ELi16E"
        row = {"port": {"ms": cs.time_call(fa.flash_attention_hsd, (q, k, v), kw, reps=10),
                        "sass": instance_sass(paths["port"], instance, SPLIT_OPS)}}
        for name, lib in libs.items():
            with wrappers_load("flash_attention", lib):
                row[name] = {"ms": cs.time_call(fa.flash_attention_hsd, (q, k, v), kw, reps=10),
                             "sass": instance_sass(paths[name], instance, SPLIT_OPS)}
        # each product's share: the build with it alone less the build with neither
        for part in ("s_only", "pv_only"):
            row[f"{part}_less_neither"] = {
                "ms": row[part]["ms"] - row["neither"]["ms"],
                "sass": {op: row[part]["sass"].get(op, 0) - row["neither"]["sass"].get(op, 0)
                         for op in sorted({*row[part]["sass"], *row["neither"]["sass"]})}}
        out[str(list(shape))] = row
        print(f"[flash] {list(shape)} f32 products apart: {dumps_strict(row)}", flush=True)
    return out


def flash_variants(shapes, device) -> dict:
    """The f32 flash kernel's milliseconds through each diagnostic build at
    ``shapes``, beside the port's build, and its largest difference from the
    port's output."""
    out = {}
    for shape in shapes:
        q, k, v = flash_inputs(shape, device)
        kw = dict(window=shape[-1])
        port = fa.flash_attention_hsd(q, k, v, **kw)
        row = {"port_ms": cs.time_call(fa.flash_attention_hsd, (q, k, v), kw, reps=5)}
        for name, lib in built_flash.items():
            with wrappers_load("flash_attention", lib):
                row[name] = {
                    "ms": cs.time_call(fa.flash_attention_hsd, (q, k, v), kw, reps=5),
                    "max_abs_diff_from_port": float(
                        (fa.flash_attention_hsd(q, k, v, **kw) - port).abs().max()),
                }
        out[str(list(shape))] = row
        print(f"[flash] {list(shape)} f32 variants: {dumps_strict(row)}", flush=True)
    return out


built_flash: dict = {}


def clocks_under_load(shape, device, seconds: float = 3.0) -> dict:
    """The card's SM clock and power draw (``nvidia-smi``, every 100 ms)
    while the f32 flash kernel runs back to back at ``shape``, beside the
    kernel's time there: what the 67 TFLOP/s f32 peak (at the boost clock)
    assumes against what the card sustains."""
    B, S, H, KH, D, window = shape
    q, k, v = (torch.randn(sz, device=device)
               for sz in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))
    ms = cs.time_call(fa.flash_attention_hsd, (q, k, v), dict(window=window), reps=5)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(20):
                fa.flash_attention_hsd(q, k, v, window=window)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        lines = smi.communicate()[0].strip().splitlines()
    rows = [[float(x) for x in ln.split(",")] for ln in lines if ln.count(",") == 3]
    rows = rows[len(rows) // 4:]  # the steady part of the window
    out = {"shape": list(shape), "ms": ms, "samples": len(rows),
           "sm_clock_mhz_mean": sum(r[0] for r in rows) / max(len(rows), 1),
           "sm_clock_max_mhz": rows[0][1] if rows else None,
           "power_w_mean": sum(r[2] for r in rows) / max(len(rows), 1),
           "power_limit_w": rows[0][3] if rows else None}
    print(f"[flash] f32 clocks under load: {dumps_strict(out)}", flush=True)
    return out


def rwkv_variants(shape, device) -> dict:
    """The bf16 RWKV-6 kernel's milliseconds at other segment lengths and
    warp widths, and its largest difference from the port's plan and build."""
    B, S, H, P, Q = shape
    args = cs.scan_inputs("rwkv6_scan", shape, torch.bfloat16, device)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    hsd = (t(args[0]), t(args[1]), t(args[2]), t(args[3]), args[4])
    port = rw.rwkv6_scan_hsd(*hsd, chunk=Q)
    out = {"plan_segment_chunks": rw.segment_chunks(B, H, S, P, Q),
           "port_ms": cs.time_call(rw.rwkv6_scan_hsd, hsd, dict(chunk=Q), reps=5)}

    def measured():
        ms = cs.time_call(rw.rwkv6_scan_hsd, hsd, dict(chunk=Q), reps=5)
        diff = float((rw.rwkv6_scan_hsd(*hsd, chunk=Q).float() - port.float()).abs().max())
        return {"ms": ms, "max_abs_diff_from_port": diff}

    for seg in RWKV_SEGMENTS:
        if seg < S // Q:
            with mock.patch.object(rw, "segment_chunks", lambda *a, seg=seg: seg):
                out[f"segment_{seg}"] = measured()
    for (name, lib), nc in zip(build_variants("rwkv6_scan_mma", RWKV_VARIANTS).items(),
                               RWKV_COLS):
        with wrappers_load("rwkv6_scan_mma", lib), mock.patch.object(
                rw, "value_cols", lambda P, nc=nc: nc if P == 64 else 32 if P % 32 == 0 else 16):
            out[name] = {"segment_chunks": rw.segment_chunks(B, H, S, P, Q), **measured()}
    print(f"[rwkv] {list(shape)} variants: {dumps_strict(out)}", flush=True)
    return out


def scan_hsd(name: str, shape, dtype, device) -> tuple:
    """``chip_smoke.scan_inputs`` in the kernels' heads-major layout."""
    args = cs.scan_inputs(name, shape, dtype, device)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    if name == "ssd_scan":
        x, dt, A, Bm, Cm = args
        return t(x), t(dt), A, Bm, Cm
    return (*map(t, args[:4]), args[4])


def timed_against_port(fn, hsd, chunk: int, port) -> dict:
    ms = cs.time_call(fn, hsd, dict(chunk=chunk), reps=5)
    diff = float((fn(*hsd, chunk=chunk).float() - port.float()).abs().max())
    return {"ms": ms, "max_abs_diff_from_port": diff}


def ssd32_variants(shapes, device) -> dict:
    """The f32 SSD kernel's milliseconds through each diagnostic build
    (:data:`SSD32_VARIANTS`: 32 columns a block, __expf, no C B^T grid, the
    rows of y in warp order, no unrolling of the y products;
    :data:`SSD32_SPLIT`: one part emptied), beside the port's build."""
    libs = build_variants("ssd_scan", {**SSD32_VARIANTS, **SSD32_SPLIT})
    cols32 = mock.patch.object(ssd, "block_cols", lambda P: 32 if P % 64 == 0 else 16)
    out = {}
    for shape in shapes:
        Q = shape[-1]
        hsd = scan_hsd("ssd_scan", shape, torch.float32, device)
        port = ssd.ssd_scan_hsd(*hsd, chunk=Q)
        row = {"port_ms": cs.time_call(ssd.ssd_scan_hsd, hsd, dict(chunk=Q), reps=5)}
        for name, lib in libs.items():
            plan = cols32 if name == "block_cols_32" else contextlib.nullcontext()
            with wrappers_load("ssd_scan", lib), plan:
                row[name] = timed_against_port(ssd.ssd_scan_hsd, hsd, Q, port)
        row["gram_share_ms"] = row["port_ms"] - row["no_gram"]["ms"]
        out[str(list(shape))] = row
        print(f"[ssd32] {list(shape)} variants: {dumps_strict(row)}", flush=True)
    return out


def rwkv32_variants(shapes, device) -> dict:
    """The f32 RWKV-6 kernel's milliseconds at other segment lengths, warp
    widths (the plan counting that many warps) and through the diagnostic
    builds of :data:`RWKV32_SPLIT`, beside the port's plan and build."""
    libs = build_variants("rwkv6_scan", {**RWKV32_VARIANTS, **RWKV32_SPLIT})
    out = {}
    for shape in shapes:
        B, S, H, P, Q = shape
        hsd = scan_hsd("rwkv6_scan", shape, torch.float32, device)
        port = rw.rwkv6_scan_hsd(*hsd, chunk=Q)
        row = {"plan_segment_chunks": rw.segment_chunks(B, H, S, P, Q),
               "port_ms": cs.time_call(rw.rwkv6_scan_hsd, hsd, dict(chunk=Q), reps=5)}
        for seg in RWKV_SEGMENTS:
            if seg < S // Q:
                with mock.patch.object(rw, "segment_chunks", lambda *a, seg=seg: seg):
                    row[f"segment_{seg}"] = timed_against_port(rw.rwkv6_scan_hsd, hsd, Q, port)
        for name, lib in libs.items():
            plan = contextlib.nullcontext()
            if name.startswith("cols_"):
                nc = int(name[5:])
                plan = mock.patch.object(
                    rw, "value_cols", lambda P, nc=nc: nc if P == 64 else 32 if P % 32 == 0 else 16)
            with wrappers_load("rwkv6_scan", lib), plan:
                row[name] = {"segment_chunks": rw.segment_chunks(B, H, S, P, Q),
                             **timed_against_port(rw.rwkv6_scan_hsd, hsd, Q, port)}
        out[str(list(shape))] = row
        print(f"[rwkv32] {list(shape)} variants: {dumps_strict(row)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", nargs="+", choices=sorted(LIBRARIES), default=sorted(LIBRARIES))
    ap.add_argument("--stream-seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--jrba-variants", action="store_true",
                    help="also time diagnostic builds of the JRBA source")
    ap.add_argument("--out", default="build/kernel_probe.json")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    result: dict = {"card": card, "failed": []}

    def check(label, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
            result[label] = out
            return out
        except Exception:  # every check runs; the exit code reports any failure
            traceback.print_exc()
            result["failed"].append(label)
            return None

    names = sorted({n for part in opts.parts for n in LIBRARIES[part]})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(lambda n: _build.build(n, ptxas_verbose=True, force=True), names))
    ptxas = {n: out for n, (_, _, out) in zip(names, built)}
    for n, (lib, sec, out) in zip(names, built):
        warn = [ln for ln in out.splitlines() if "warning" in ln.lower()]
        print(f"[build] {n}: {lib.name} in {sec:.1f} s; warnings: {warn}", flush=True)
    result["build_s"] = time.perf_counter() - t0

    if "jrba" in opts.parts:
        check("jrba_evidence", cs.jrba_evidence, ptxas["jrba_congestion"])
        result["jrba_ptxas"] = cs.ptxas_entries(ptxas["jrba_congestion"], "jrba_")
        check("jrba", jrba_probe, device, tuple(opts.stream_seeds), opts.jrba_variants)
    if "ssd" in opts.parts:
        check("ssd_evidence", cs.ssd_mma_evidence, ptxas["ssd_scan_mma"])
        # the bf16 kernel against plain, timed; then each block width
        for shape in cs.SSD_MODEL:
            check(f"ssd bf16 {shape}", cs.scan_case, "ssd_scan", shape, torch.bfloat16, device,
                  5, False)
        for shape in cs.SSD_CASES:
            for dt in (torch.bfloat16, torch.float32):
                check(f"ssd {str(dt)[6:]} {shape}", cs.scan_case, "ssd_scan", shape, dt, device,
                      5, True)
        check("ssd block cols", ssd_block_cols, cs.SSD_MODEL[0], device)
    if "flash" in opts.parts:
        check("wgmma_evidence", cs.wgmma_evidence, ptxas["flash_attention_wgmma"])
        check("flash_f32_evidence", cs.flash_f32_evidence, ptxas["flash_attention"])
        for shape in cs.FLASH_SHAPES[-3:] + cs.ZAMBA_FLASH_SHAPES[:1]:
            check(f"flash f32 {shape}", cs.flash_case, shape, torch.float32, device, 5)
        for shape in cs.PREFILL_SHAPES:
            check(f"flash bf16 {shape}", cs.flash_case, shape, torch.bfloat16, device, 5)
        for shape, causal, scale in cs.FLASH_KEYWORD_CASES:
            for dt in (torch.bfloat16, torch.float32):
                check(f"flash {str(dt)[6:]} {shape} causal={causal} scale={scale}",
                      cs.flash_case, shape, dt, device, 5, causal, scale)
        check("flash variant builds", lambda: built_flash.update(
            build_variants("flash_attention", FLASH_VARIANTS)))
        check("flash variants", flash_variants, cs.FLASH_SHAPES[-3:] + cs.ZAMBA_FLASH_SHAPES[:1],
              device)
        check("flash split", flash_split, device)
        check("flash clocks", clocks_under_load, cs.ZAMBA_FLASH_SHAPES[0], device)
    if "rwkv" in opts.parts:
        check("rwkv_evidence", cs.rwkv6_mma_evidence, ptxas["rwkv6_scan_mma"])
        for shape in cs.RWKV_MODEL:
            for dt in (torch.bfloat16, torch.float32):
                check(f"rwkv {str(dt)[6:]} {shape}", cs.scan_case, "rwkv6_scan", shape, dt,
                      device, 5, False)
        for shape in cs.RWKV_CASES:
            for dt in (torch.bfloat16, torch.float32):
                check(f"rwkv {str(dt)[6:]} {shape}", cs.scan_case, "rwkv6_scan", shape, dt,
                      device, 5, True)
        for shape in cs.RWKV_MODEL:
            check(f"rwkv variants {shape}", rwkv_variants, shape, device)

    if "ssd32" in opts.parts:
        check("ssd32_evidence", cs.scan_f32_evidence, "ssd_scan", ptxas["ssd_scan"],
              cs.SSD_F32_KERNELS)
        for shape in cs.SSD_MODEL:
            check(f"ssd32 {shape}", cs.scan_case, "ssd_scan", shape, torch.float32, device, 5,
                  False)
        for shape in cs.SSD_CASES:
            check(f"ssd32 {shape}", cs.scan_case, "ssd_scan", shape, torch.float32, device, 5,
                  True)
        check("ssd32 variants", ssd32_variants, cs.SSD_MODEL, device)
    if "rwkv32" in opts.parts:
        check("rwkv32_evidence", cs.scan_f32_evidence, "rwkv6_scan", ptxas["rwkv6_scan"],
              cs.RWKV_F32_KERNELS)
        for shape in cs.RWKV_MODEL:
            check(f"rwkv32 {shape}", cs.scan_case, "rwkv6_scan", shape, torch.float32, device, 5,
                  False)
        for shape in cs.RWKV_CASES:
            check(f"rwkv32 {shape}", cs.scan_case, "rwkv6_scan", shape, torch.float32, device, 5,
                  True)
        check("rwkv32 variants", rwkv32_variants, cs.RWKV_MODEL, device)

    print(card, flush=True)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(dumps_strict(result, indent=1, default=str))
    summary = {k: v for k, v in result.items() if k not in ("jrba_ptxas",)}
    print(dumps_strict(summary, default=str)[-6000:], flush=True)
    print(f"[probe] failed: {result['failed']}", flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
