"""Continuous-batching serving engine.

Slot-based scheduler over the model's per-sequence-length decode step, tick
for tick the JAX package's engine: requests are admitted into free slots in
submission order, prefilling writes their prompt into the slot's cache region
(teacher-forced decode steps, one prompt token per tick), and every engine
tick advances *all* slots by one token — free slots too, whose cache lengths
are then frozen. Finished sequences free their slot immediately (no
head-of-line blocking).

ENTS integration: ``core/placement.py`` places a model's pipeline stages
with the ENTS scheduler (``examples/serve_cluster.py`` in the JAX package
shows the pairing); this engine then serves requests for the placed model.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..models import decode_step, init_cache
from ..models.transformer import layers

# the cache leaves that carry recurrent state (Mamba-2 and RWKV-6 mixers)
RECURRENT = ("ssm", "wkv", "conv", "x_prev")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    prefill_left: list[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.request is None


class ServingEngine:
    def __init__(
        self,
        cfg,
        params,
        *,
        slots: int = 8,
        max_len: int = 512,
        greedy: bool = True,
        device="cuda",
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.greedy = greedy  # stored as the reference stores it; decoding is argmax
        self.device = torch.device(device)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: deque[Request] = deque()
        self.cache = init_cache(cfg, slots, max_len, device=self.device)
        self.ticks = 0
        self._finished: list[Request] = []

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds engine max_len")
        self.queue.append(req)

    def run_until_drained(self, max_ticks: int = 100_000) -> list[Request]:
        for _ in range(max_ticks):
            if not self.tick():
                break
        return self._finished

    @property
    def active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    # -- engine loop ----------------------------------------------------------
    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                req = self.queue.popleft()
                slot.request = req
                slot.prefill_left = list(req.prompt)
                # reset this slot's cache region: zero length is sufficient
                # (stale K/V beyond `length` is masked out)
                self.cache["length"][i] = 0
                self._reset_recurrent_state(i)

    def _reset_recurrent_state(self, slot: int) -> None:
        """SSM states aren't length-masked (they're running sums), so zero
        them when a slot is recycled. Every cache leaf has the batch on axis 0
        (the JAX package's group-stacked leaves have it on axis 1)."""
        for layer in layers(self.cfg, self.cache["blocks"]):
            for name, leaf in layer.items():
                if name in RECURRENT:  # k/v caches are length-masked; no reset needed
                    leaf[slot] = 0

    def tick(self) -> bool:
        """One engine step: admit, build the token batch (prefill tokens for
        prefilling slots, last sampled token otherwise), decode, harvest."""
        self._admit()
        if all(s.free for s in self.slots) and not self.queue:
            return False
        tokens = np.zeros((len(self.slots), 1), np.int64)
        live = np.zeros(len(self.slots), bool)
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            live[i] = True
            if slot.prefill_left:
                tokens[i, 0] = slot.prefill_left.pop(0)
            elif slot.request.output:
                tokens[i, 0] = slot.request.output[-1]
            else:
                tokens[i, 0] = slot.request.prompt[-1]
        old_length = self.cache["length"]
        logits, new_cache = decode_step(
            self.params, self.cfg, self.cache, torch.from_numpy(tokens).to(self.device)
        )
        self.ticks += 1
        # freeze cache lengths for dead slots (masking correctness)
        new_cache["length"] = torch.where(
            torch.from_numpy(live).to(self.device), new_cache["length"], old_length
        )
        self.cache = new_cache
        # argmax over f32 logits; ties go to the first index, as jnp.argmax
        next_tokens = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        lengths = self.cache["length"].cpu().numpy()
        for i, slot in enumerate(self.slots):
            if slot.free or slot.prefill_left:
                continue  # still prefilling: ignore logits
            req = slot.request
            req.output.append(int(next_tokens[i]))
            total = int(lengths[i])
            if len(req.output) >= req.max_new_tokens or total >= self.max_len - 1:
                req.done = True
                self._finished.append(req)
                slot.request = None
        return True
