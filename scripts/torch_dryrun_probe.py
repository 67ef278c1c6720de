#!/usr/bin/env python3
"""What the port's dry run counts, op by op, on the PyTorch at hand: a
diagnostic for per-device counts that differ between PyTorch versions or
from the JAX package's.

Usage, from the repository root (the dry run needs no card; ``--device``
only names the mesh's device type)::

    python3 scripts/torch_dryrun_probe.py [--device cuda] [--parts smoke ops events]
        [--events-cells zamba2-7b-smoke:prefill_b8 ...]

* ``smoke``: every smoke config's prefill and train cell (B=8, S=64) on a
  fake (2, 4) mesh: ``ok``, FLOPs and collective bytes a device, the
  ``reshard`` record and any error.
* ``ops``: internlm2-1.8b x train_4k on the single production mesh (256
  fake ranks), its FLOPs a device and peak memory, the 40 (aten op, local
  input shapes) pairs that count the most FLOPs, and the 20 largest local
  outputs (op, shape, dtype, bytes).
* ``events``: for each ``--events-cells`` cell on the (2, 4) mesh, every op
  DTensor refused (its operands' shapes and placements and the first line
  of the error), what the resharding made of it, every matmul's placements,
  every op whose output is whole on every rank (no ``Shard``) and holds at
  least ``--whole-numel`` elements, and an op that raised ``IndexError``
  inside DTensor.

Prints the PyTorch version, then the result as one JSON object on the last
line.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs.shapes import CELLS, ShapeCell  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh  # noqa: E402
from repro_torch.obs.trace import dumps_strict  # noqa: E402

SMOKE_CELLS = (ShapeCell("prefill_b8", "prefill", 64, 8), ShapeCell("train_b8", "train", 64, 8))
MATMULS = ("mm", "bmm", "addmm")


def _placed(tree) -> list[str]:
    return [f"{tuple(t.shape)}{[str(p) for p in t.placements]}" for t in dryrun._dtensors(tree)]


def smoke(device: str) -> dict:
    out = {}
    with dryrun.fake_world(8):
        mesh = make_debug_mesh((2, 4), device_type=device)
        for arch in ARCH_IDS:
            for cell in SMOKE_CELLS:
                rec = dryrun.run_cell(f"{arch}-smoke", cell.name, mesh, "debug")
                out[f"{arch} {cell.name}"] = {
                    "ok": rec["ok"], "flops": rec.get("flops"),
                    "collectives": rec.get("collectives", {}).get("total"),
                    "reshard": rec.get("reshard"), "error": rec.get("error")}
    return out


def ops(device: str) -> dict:
    by_op: collections.Counter = collections.Counter()
    largest: dict = {}
    counting = dryrun._CellCounter.__torch_dispatch__

    def attributed(self, func, types, args=(), kwargs=None):
        before, moved = self.flops, self.bytes_accessed
        out = counting(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = [tuple(t.shape) for t in dryrun._tensors((args, kwargs or {}))]
            by_op[(str(func), str(shapes))] += self.flops - before
        if self.bytes_accessed != moved:  # one of the cell's own local ops
            for t in dryrun._tensors(out):
                key = (str(func), str(tuple(t.shape)), str(t.dtype))
                largest[key] = t.numel() * t.element_size()
        return out

    dryrun._CellCounter.__torch_dispatch__ = attributed
    try:
        with dryrun.fake_world(256):
            mesh = make_production_mesh(device_type=device)
            t0 = time.perf_counter()
            rec = dryrun.run_cell("internlm2-1.8b", "train_4k", mesh, "single")
    finally:
        dryrun._CellCounter.__torch_dispatch__ = counting
    return {"ok": rec["ok"], "flops": rec.get("flops"), "memory": rec.get("memory"),
            "reshard": rec.get("reshard"), "error": rec.get("error"),
            "seconds": time.perf_counter() - t0,
            "top": [[op, shapes, n] for (op, shapes), n in by_op.most_common(40)],
            "largest": [[*k, n] for k, n in sorted(largest.items(), key=lambda kv: -kv[1])[:20]]}


def _whole(tree, numel: int) -> bool:
    return any(t.numel() >= numel and not any(p.is_shard() for p in t.placements)
               for t in dryrun._dtensors(tree))


def events(device: str, cells: list[str], whole_numel: int) -> dict:
    log: list = []
    resharding = dryrun._ReshardOnRefusal.__torch_dispatch__

    def logged(self, func, types, args=(), kwargs=None):
        if not any(issubclass(t, DTensor) for t in types):
            return resharding(self, func, types, args, kwargs)
        try:
            out = func(*args, **(kwargs or {}))
            if str(func).split(".")[1] in MATMULS:
                log.append(["op", str(func), _placed((args, kwargs)), _placed(out)])
            elif _whole(out, whole_numel):
                log.append(["whole", str(func), _placed((args, kwargs)), _placed(out)])
            return out
        except RuntimeError as e:
            log.append(["refused", str(func), _placed((args, kwargs)),
                        str(e).strip().splitlines()[0][:300]])
        except IndexError:
            log.append(["indexerror", str(func), _placed((args, kwargs)),
                        [str(a)[:80] for a in args if not isinstance(a, torch.Tensor)]])
            raise
        out = resharding(self, func, types, args, kwargs)
        log.append(["resharded", str(func), _placed(out), dict(self.moved), dict(self.gathered)])
        return out

    dryrun._ReshardOnRefusal.__torch_dispatch__ = logged
    res = {}
    try:
        with dryrun.fake_world(8):
            mesh = make_debug_mesh((2, 4), device_type=device)
            for spec in cells:
                arch, cell = spec.split(":")
                log.clear()
                rec = dryrun.run_cell(arch, cell, mesh, "debug")
                res[spec] = {"ok": rec["ok"], "flops": rec.get("flops"),
                             "error": rec.get("error"), "events": list(log)}
    finally:
        dryrun._ReshardOnRefusal.__torch_dispatch__ = resharding
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the meshes' device type: cuda or cpu")
    ap.add_argument("--parts", nargs="+", default=["smoke", "ops", "events"],
                    choices=["smoke", "ops", "events"])
    ap.add_argument("--events-cells", nargs="+",
                    default=["internlm2-1.8b-smoke:prefill_b8", "zamba2-7b-smoke:prefill_b8",
                             "rwkv6-3b-smoke:prefill_b8"])
    ap.add_argument("--whole-numel", type=int, default=1 << 17)
    args = ap.parse_args()
    for cell in SMOKE_CELLS:
        CELLS[cell.name] = cell
    print(f"torch {torch.__version__}", flush=True)
    out: dict = {"torch": torch.__version__}
    if "smoke" in args.parts:
        out["smoke"] = smoke(args.device)
    if "ops" in args.parts:
        out["ops"] = ops(args.device)
    if "events" in args.parts:
        out["events"] = events(args.device, args.events_cells, args.whole_numel)
    print(dumps_strict(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
