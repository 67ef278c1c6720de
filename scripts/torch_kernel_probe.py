#!/usr/bin/env python3
"""Probe the port's JRBA congestion kernel and bf16 SSD scan on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 scripts/torch_kernel_probe.py [--parts jrba ssd] [--stream-seeds 0]
        [--out build/kernel_probe.json]

Builds the parts' libraries (``jrba_congestion``; ``ssd_scan_mma`` and
``ssd_scan``) from ``src/repro_torch/kernels/csrc`` (``nvcc -Xptxas -v``, all
at once), prints their SASS and ptxas evidence, then:

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
  or 64, ``-DSSD_MMA_BLOCK_COLS``).

Every diagnostic build is launched through the port's own wrapper: the probe
only swaps the library the wrapper loads, or the launch plan it computes.
Every check runs and is reported; the script exits 1 if any failed. The card's
name and power limit are printed beside the numbers; the whole result goes to
``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
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
from repro_torch.kernels import jrba_congestion as jc  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.obs.trace import dumps_strict  # noqa: E402

LIBRARIES = {"jrba": ("jrba_congestion",), "ssd": ("ssd_scan_mma", "ssd_scan")}
# diagnostic builds of the JRBA source: what each changes says what its
# arithmetic costs (the port builds only _build.NVCC_FLAGS)
JRBA_VARIANTS = {
    "ftz": ("-ftz=true",),
    "approx_div": ("-prec-div=false",),
    "approx_sqrt": ("-prec-sqrt=false",),
    "approx_div_sqrt": ("-prec-div=false", "-prec-sqrt=false"),
}
# diagnostic builds of the bf16 SSD source at one block width each
SSD_VARIANTS = {f"block_cols_{pb}": (f"-DSSD_MMA_BLOCK_COLS={pb}",) for pb in (16, 32, 64)}


def build_variant(name: str, label: str, flags: tuple) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with ``flags`` added, into the build
    directory, and loaded."""
    src, _ = _build._target(name)
    lib = _build.BUILD_DIR / f"{name}_variant_{label}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


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
    stream = cs.capture_stream(device, "cuda", seeds=seeds, n_jobs=8)
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

    names = [n for part in opts.parts for n in LIBRARIES[part]]
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

    print(card, flush=True)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(dumps_strict(result, indent=1, default=str))
    summary = {k: v for k, v in result.items() if k not in ("jrba_ptxas",)}
    print(dumps_strict(summary, default=str)[-6000:], flush=True)
    print(f"[probe] failed: {result['failed']}", flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
