"""Traffic kind ``prefill``: a closed loop of batches of prompts, back to
back, each batch a new draw of ``batch`` x ``seq_len`` Zipf(``zipf_a``) token
ids from the seed, each through the port's
``repro_torch.models.model.prefill``, which returns every prompt's last
position's logits. A prompt is a request.

Set-up draws the weights on the device from the seed (the port's
``init_params``) and runs one warm-up batch of the cell's own shape. The
check compares two of the window's requests, drawn from the seed: one from
each half of a batch (of one batch, where the batch holds one prompt), so
that a batch computed only in part is caught. Each request's last-position
logits are held to the plain reference's over the same prompt
(``logit_gap``: the largest absolute difference over the reference's
largest absolute logit; the widest of the two).
"""
from __future__ import annotations

import time

import torch

from portbench import zipf
from portbench.reference.lowp import exact_f32


class Driver:
    rate_metric = "prefill_tokens_per_s"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        mix = ctx.mix
        self.batch, self.seq, self.a = mix["batch"], mix["seq_len"], mix["zipf_a"]
        self.tokens_per_item = self.batch * self.seq
        self.requests_per_item = self.batch
        self.outputs: list[torch.Tensor] = []
        self.sampled: dict[tuple[int, int], torch.Tensor] = {}

    def prompt(self, index: int, stream: int = zipf.PROMPTS):
        return zipf.prompt(self.ctx.seed, index, self.batch, self.seq,
                           self.ctx.config["vocab_size"], self.a, stream)

    def to_device(self, array) -> torch.Tensor:
        t = torch.from_numpy(array)
        if self.ctx.device.type == "cuda":
            self.pinned = t.pin_memory()  # held until the copy has run
            return self.pinned.to(self.ctx.device, non_blocking=True)
        return t

    def setup(self) -> None:
        from repro_torch.models import model

        self.model = model
        self.cfg = self.ctx.port_config()
        t0 = time.perf_counter()
        self.params = model.init_params(self.cfg, self.ctx.seed, device=self.ctx.device)
        float(self.params["final_norm"][0])
        t1 = time.perf_counter()
        warm = self.to_device(self.prompt(0, zipf.WARMUP))
        logits, _ = model.prefill(self.params, self.cfg, warm)
        float(logits[0, -1, 0])
        self.phases = {"weights_s": t1 - t0, "warmup_s": time.perf_counter() - t1}

    def prepare(self, index: int) -> None:
        self.next = self.to_device(self.prompt(index))

    def item(self, index: int) -> None:
        logits, _ = self.model.prefill(self.params, self.cfg, self.next)
        self.outputs.append(logits[:, -1])

    def failed(self, items: int) -> int:
        """Requests whose logits are not all finite."""
        finite = torch.cat(self.outputs[:items]).isfinite().all(dim=1)
        return int((~finite).sum())

    def picks(self, items: int) -> list[tuple[int, int]]:
        """(batch, row) of the requests the check compares: a batch drawn
        for each half of the rows, and a row in that half."""
        r = zipf.rng(self.ctx.seed, zipf.SAMPLE)
        half = self.batch // 2
        halves = [(0, half), (half, self.batch)] if half else [(0, 1)]
        return [(int(r.integers(items)), int(r.integers(lo, hi))) for lo, hi in halves]

    def release(self) -> None:
        """Keep the sampled requests' logits; free the weights."""
        self.sampled = {p: self.outputs[p[0]][p[1]] for p in self.picks(len(self.outputs))}
        self.outputs = []
        del self.params

    def check(self, arith=None) -> dict[str, float]:
        arch = self.ctx.arch
        spec = arch.spec_from_config(self.ctx.config)
        dtype = getattr(torch, self.ctx.config["torch_dtype"])
        gap = 0.0
        for (index, row), got in self.sampled.items():
            tokens = torch.from_numpy(self.prompt(index)[row : row + 1]).to(self.ctx.device)
            with exact_f32():
                want = arch.prefill_logits(spec, self.ctx.seed, tokens, arith, dtype)[0]
            gap = max(gap, float((got.float() - want).abs().max() / want.abs().max()))
        return {"logit_gap": gap}
