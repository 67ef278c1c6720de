"""Traffic kind ``train``: training steps back to back, each on a new batch
of ``batch`` x ``seq_len`` Zipf(``zipf_a``) token ids with document breaks,
drawn from the seed on the host and copied to the card as the step's input,
through the step function of the port's
``repro_torch.train.train_step.make_train_step`` (``optimizer``: its AdamW
settings; ``train``: its ``TrainConfig``).

Set-up builds the training state from the seed (the port's
``init_train_state``) and drives it through its first ``check_steps`` steps
by the window's own call and feed; the window continues the same state. The
check holds those steps to the plain reference's (``reference/train.py``,
over the configuration's architecture module), from the same weights drawn
again and the same batches:

- ``loss``: the first step's loss, its gap over the reference's;
- ``grad_dir``: the first step's gradient as the optimizer took it (its
  first moment after one step over ``1 - beta1``, copied to the host before
  the second step), each leaf's distance from the reference's over the
  reference's norm; the median leaf counts;
- ``change``: each leaf's norm of its change over the steps, read before the
  window's first step, its gap over the larger of the reference's norm of
  that leaf and of the median leaf; the worst leaf counts.

The window's own steps are checked for finite losses only: the step after
the window, held to the reference's step from the same parameters, gave no
number that separates the program from the control (``PERF.md``).

Leaves whose first reference gradient is below a thousandth of the median
leaf's (moved by Adam's round-off alone) are left out of both. ``PERF.md`` gives the readings these numbers and their
limits were chosen from.
"""
from __future__ import annotations

import statistics
import time

import torch

from portbench import zipf
from portbench.harness import BenchError
from portbench.reference.lowp import exact_f32
from portbench.reference.train import train_steps

QUIET_LEAF = 1e-3  # of the median leaf's first gradient


def reference_name(path: str, prefix: int, pattern: int, repeats: int) -> str:
    """The reference's name of the port's parameter at ``path``."""
    parts = path.split("/")
    if parts[0] != "stack":
        return path
    if parts[1] == "prefix":
        layer, rest = int(parts[2]), parts[3:]
    elif parts[1] == "groups":
        layer, rest = prefix + int(parts[2]) * pattern + int(parts[3]), parts[4:]
    elif parts[1] == "suffix":
        layer, rest = prefix + repeats * pattern + int(parts[2]), parts[3:]
    else:
        raise BenchError(f"no reference leaf for {path}")
    return "/".join(["layers", str(layer), *rest])


def leaf_gap(got: dict[str, float], want: dict[str, float], names) -> float:
    names = list(names)
    median = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names)


class Driver:
    rate_metric = "train_tokens_per_s"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        mix = ctx.mix
        self.batch, self.seq = mix["batch"], mix["seq_len"]
        self.tokens_per_item = self.batch * self.seq
        self.requests_per_item = 1
        self.first = mix["check_steps"]
        self.losses: list[torch.Tensor] = []

    def host_batch(self, index: int) -> dict:
        mix = self.ctx.mix
        return zipf.train_batch(self.ctx.seed, index, self.batch, self.seq,
                                self.ctx.config["vocab_size"], mix["zipf_a"], mix["doc_len"])

    def prepare(self, index: int) -> None:
        self.next_host = self.host_batch(self.first + index)

    def run_step(self, host: dict) -> torch.Tensor:
        batch = {k: torch.from_numpy(v).to(self.ctx.device) for k, v in host.items()}
        self.state, metrics = self.step(self.state, batch)
        return metrics["loss"]

    def item(self, index: int) -> None:
        self.losses.append(self.run_step(self.next_host))

    def setup(self) -> None:
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import TrainConfig, init_train_state
        from repro_torch.train.train_step import make_train_step
        from repro_torch.tree import tree_paths

        cfg = self.ctx.port_config()
        if cfg.optimizer_state_dtype != "float32" or cfg.optimizer_factored:
            raise BenchError("the reference keeps whole float32 moments")
        mix = self.ctx.mix
        opt = AdamWConfig(**mix["optimizer"], moment_dtype="float32")
        train_cfg = TrainConfig(**mix["train"])
        if train_cfg.microbatches != 1 or train_cfg.mtp_weight:
            raise BenchError("the reference takes one microbatch and no MTP head")
        t0 = time.perf_counter()
        self.state = init_train_state(cfg, opt, self.ctx.seed, train_cfg=train_cfg,
                                      device=self.ctx.device)
        self.step = make_train_step(cfg, opt, train_cfg)
        float(self.state["params"]["final_norm"][0].detach())
        t1 = time.perf_counter()

        def named(tree) -> dict:
            return {reference_name(path, len(cfg.prefix), len(cfg.pattern),
                                   cfg.n_pattern_repeats): t for path, t in tree_paths(tree)}

        start = {k: t.detach().clone() for k, t in named(self.state["params"]).items()}
        self.readings = {"loss": []}
        for index in range(self.first):
            self.readings["loss"].append(float(self.run_step(self.host_batch(index))))
            if index == 0:
                moments = named(self.state["opt"]["m"])
                self.readings["grad"] = {
                    k: float(torch.linalg.vector_norm(m.float())) / (1 - opt.beta1)
                    for k, m in moments.items()}
                self.readings["first_m"] = {k: m.detach().float().to("cpu", copy=True)
                                            for k, m in moments.items()}
        self.readings["change"] = {
            k: float(torch.linalg.vector_norm(t.detach().float() - start[k].float()))
            for k, t in named(self.state["params"]).items()}
        del start
        self.phases = {"weights_s": t1 - t0, "check_steps_s": time.perf_counter() - t1}

    def failed(self, items: int) -> int:
        return int((~torch.stack(self.losses[:items]).isfinite()).sum())

    def release(self) -> None:
        del self.state, self.step
        self.losses = []

    def device_batch(self, index: int) -> dict:
        return {k: torch.from_numpy(v).to(self.ctx.device)
                for k, v in self.host_batch(index).items()}

    def check(self, arith=None) -> dict[str, float]:
        mix, arch = self.ctx.mix, self.ctx.arch
        spec = arch.spec_from_config(self.ctx.config)
        balance = mix["train"].get("moe_balance_weight", 0.01)
        batches = [self.device_batch(i) for i in range(self.first)]
        with exact_f32():
            ref = train_steps(arch, spec, self.ctx.seed, batches, mix["optimizer"], balance,
                              self.ctx.device, arith, getattr(torch, self.ctx.config["torch_dtype"]),
                              first_grad=distance_from(self.readings["first_m"],
                                                       mix["optimizer"]["beta1"]))
        return compare(self.readings, ref, ref["first"])


def distance(mine: torch.Tensor, g: torch.Tensor) -> float:
    """The program's gradient's distance from the reference's ``g``, over
    the norm of ``g``."""
    mine = mine.to(g.device).float()
    return float(torch.linalg.vector_norm(mine - g) / torch.linalg.vector_norm(g).clamp_min(1e-30))


def distance_from(first_m: dict, beta1: float):
    """Per leaf, the program's first gradient's distance from the
    reference's."""
    return lambda name, g: distance(first_m[name].float() / (1 - beta1), g)


def moved(ref: dict) -> list[str]:
    median = statistics.median(ref["grad_raw"].values())
    return [k for k, g in ref["grad_raw"].items() if g >= QUIET_LEAF * median]


def compare(got: dict, ref: dict, first: dict[str, float]) -> dict[str, float]:
    """The three numbers the check compares, from the program's readings,
    the reference's, and each leaf's first-gradient distance."""
    leaves = moved(ref)
    return {"loss": abs(got["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
            "grad_dir": statistics.median(first[k] for k in leaves),
            "change": leaf_gap(got["change"], ref["change"], leaves)}
