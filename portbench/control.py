"""The readings each limit of ``limits/<cell>.json`` is set from, on the
card, at the cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--program-seeds ...]
        [--steps N] [--faults half_batch loss_altered]

For each ``--program-seeds`` seed (and, in a training cell, each of
``--seeds``), the program's numbers as a run's check reads them: set-up,
``--steps`` batches or steps in the window's place, then the check. For each ``--seeds`` seed, the
control's: the reference computed with float8 operands
(``reference/lowp.py``) in the program's place, through the check's own
comparison, and, for a training cell, the program with each planted fault
(half of each batch left out, the mean taken over the rest; the reported loss
altered by 1%; a step that returns its state unchanged reads 1 by
construction and is not run). One JSON line a reading; the benchmark's own
runs never compute these.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.reference.lowp import Arith, exact_f32  # noqa: E402
from portbench.reference.train import train_steps  # noqa: E402

FAULTS = {"program": contextlib.nullcontext, "half_batch": faults.half_batch,
          "loss_altered": faults.loss_altered}


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def program_driver(cell, seed, device, steps, fault=contextlib.nullcontext):
    """The program as a run drives it, with ``steps`` items in the window's
    place, released and ready for its check."""
    drv = cell.driver().Driver(harness.Ctx(cell, seed, device))
    with fault():
        drv.setup()
        for i in range(steps):
            drv.prepare(i)
            drv.item(i)
        torch.cuda.synchronize()
        drv.release()
    torch.cuda.empty_cache()
    return drv


def prefill_readings(cell, device, program_seeds, seeds, steps, planted) -> None:
    for seed in sorted(set(program_seeds) | set(seeds)):
        t0 = time.perf_counter()
        if seed in program_seeds:
            drv = program_driver(cell, seed, device, steps)
            emit(cell=cell.name, seed=seed, side="program", **drv.check())
        if seed in seeds:
            drv = cell.driver().Driver(harness.Ctx(cell, seed, device))
            arch, config = drv.ctx.arch, cell.config
            spec, dtype = arch.spec_from_config(config), getattr(torch, config["torch_dtype"])
            for index, row in drv.picks(steps):
                tokens = torch.from_numpy(drv.prompt(index)[row : row + 1]).to(device)
                with exact_f32():
                    low = arch.prefill_logits(spec, seed, tokens, Arith(lowp=True), dtype)
                drv.sampled[index, row] = low[0]
            emit(cell=cell.name, seed=seed, side="control", **drv.check())
        emit(cell=cell.name, seed=seed, seconds=time.perf_counter() - t0)


def train_readings(cell, device, program_seeds, seeds, steps, planted) -> None:
    train = cell.driver()
    mix = cell.mix
    for seed in sorted(set(program_seeds) | set(seeds)):
        t0 = time.perf_counter()
        sides = ["program"] + (planted if seed in seeds else [])
        for side in sides:
            drv = program_driver(cell, seed, device, steps, FAULTS[side])
            emit(cell=cell.name, seed=seed, side=side, **drv.check())
            del drv
            torch.cuda.empty_cache()
        if seed in seeds:
            arch = cell.arch()
            spec = arch.spec_from_config(cell.config)
            batches = [{k: torch.from_numpy(v).to(device) for k, v in train.Driver(
                harness.Ctx(cell, seed, device)).host_batch(i).items()}
                for i in range(mix["check_steps"])]
            args = (arch, spec, seed, batches, mix["optimizer"],
                    mix["train"]["moe_balance_weight"], device)
            with exact_f32():
                ref = train_steps(*args, first_grad=lambda k, g: g.to("cpu", copy=True))
                first = ref.pop("first")
                low = train_steps(*args, Arith(lowp=True),
                                  first_grad=lambda k, g: train.distance(g, first.pop(k)))
            emit(cell=cell.name, seed=seed, side="control",
                 **train.compare(low, ref, low["first"]))
            del ref, low
        emit(cell=cell.name, seed=seed, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=["half_batch", "loss_altered"],
                    choices=["half_batch", "loss_altered"], help="a training cell's faults")
    ap.add_argument("--steps", type=int, default=1,
                    help="batches or steps in the window's place")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py reads the card; none found", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    emit(cell=cell.name, card=torch.cuda.get_device_name(device))
    read = {"prefill": prefill_readings, "train": train_readings}[cell.mix["kind"]]
    read(cell, device, args.program_seeds, args.seeds, args.steps, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
