"""Hillclimb driver for the PyTorch port: run one cell's step once under a
named variant on the production mesh (16 x 16, a fake process group of 256
ranks), print the three roofline terms of an H100 and the top collective
contributors by (op, shape).

  PYTHONPATH=src python scripts/torch_hillclimb.py --arch internlm2-1.8b \
      --cell train_4k --variant baseline [--breakdown] [--device cpu]

The twin of ``scripts/hillclimb.py`` on ``repro_torch.launch.dryrun``: the
cell's counts come from ``lower_cell`` and ``analyze`` (per device, the
local ops DTensor lowers the step to), where the JAX script reads a
compiled module's ``cost_analysis`` and HLO text. The terms divide by one
H100's peaks (``core.profiler.H100``) and the collective term by
:data:`LINK_BW`. The port runs the model's layer stack as a Python loop, so
every layer is counted and the JAX script's ``_scan_corrected``
extrapolation from a scan body has no counterpart here. ``--breakdown``
lists the collectives' (op, dtype[shape]) by bytes from the dry run's
counter, in place of the JAX script's HLO text. ``--device`` is the mesh's
device type (default ``cuda``; no card is used: the shards are ``meta``
tensors).
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

from repro_torch.core.profiler import H100  # noqa: E402
from repro_torch.launch import variants  # noqa: E402
from repro_torch.launch.dryrun import COLLECTIVES, analyze, fake_world, lower_cell  # noqa: E402
from repro_torch.launch.mesh import batch_axes, make_production_mesh  # noqa: E402
from repro_torch.models import hints  # noqa: E402

# bytes/s a GPU sends to another node: 256 ranks are 32 eight-GPU nodes, and
# a DGX H100 has one 400 Gb/s ConnectX-7 InfiniBand port per GPU (NVIDIA DGX
# H100 data sheet), so the inter-node links, not NVLink, set the rate
LINK_BW = 400e9 / 8
RANKS = 256


def collective_breakdown(events, top: int = 12) -> list[tuple[int, str, str]]:
    """The ``top`` (bytes, op, dtype[shape]) by bytes, summed over the
    collectives of one (op, shape); prints them."""
    agg: collections.Counter = collections.Counter()
    for op, nbytes, shape in events:
        agg[(op, shape)] += nbytes
    rows = [(b, op, shape) for (op, shape), b in agg.most_common(top)]
    print("top collective contributors (bytes, op, shape) [every layer counted]:")
    for b, op, shape in rows:
        print(f"  {b/1e9:9.3f} GB  {op:19s} {shape}")
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", default="baseline", choices=sorted(variants.VARIANTS))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--device", default="cuda", help="the mesh's device type: cuda or cpu")
    args = ap.parse_args(argv)

    events: list = []
    variants.activate(args.variant)
    try:
        with fake_world(RANKS):
            mesh = make_production_mesh(device_type=args.device)
            run, aux = lower_cell(args.arch, args.cell, mesh)
            info = analyze(run, aux.pop("state"), batch_axes(mesh), events=events)
    finally:
        hints.set_activation_sharding(None)
        hints.set_moe_sharding(None)
        variants.activate("default")
    if info["reshard"]["batch_gathered"]:
        raise RuntimeError(f"refused ops gathered a batch dim: {info['reshard']}; the counts "
                           "are not per-device ones")
    print(f"=== {args.arch} x {args.cell} [{args.variant}] ===")
    print(f"static state/chip: {aux['static_state_bytes_per_device']/1e9:.2f} GB")
    terms = {
        "compute": info["flops"] / H100.peak_flops,
        "memory": info["bytes_accessed"] / H100.hbm_bw,
        "collective": info["collectives"]["total"] / LINK_BW,
    }
    dominant = max(terms.items(), key=lambda kv: kv[1])[0]
    print(f"compute {terms['compute']:.4f}s | memory {terms['memory']:.4f}s | collective "
          f"{terms['collective']:.4f}s | dominant={dominant}")
    per_op = {k: info["collectives"][k] for k in COLLECTIVES}
    print("collective bytes by op:", {k: f"{v/1e9:.1f}GB" for k, v in per_op.items() if v})
    out = {"arch": args.arch, "cell": args.cell, "variant": args.variant, "info": info,
           "static_state_bytes_per_device": aux["static_state_bytes_per_device"],
           "terms": terms, "dominant": dominant, "per_op": per_op}
    if args.breakdown:
        out["breakdown"] = collective_breakdown(events)
    return out


if __name__ == "__main__":
    main()
