"""Deterministic synthetic data pipeline: the JAX package's
``data/pipeline.py``, kept as the port's own copy. It is numpy only, so the
same (seed, step, host) gives the same batch as the reference, bit for bit;
the driver (``launch/train.py``) moves each batch to the device.

Produces a Zipf-distributed token stream with document structure (EOS every
~doc_len tokens) — enough statistical texture for end-to-end training runs
and benchmarks without external data. Each batch is a pure function of
(seed, step, host_id), so:

  * multi-host loading is *sharded by construction* — every host generates
    only its slice of the global batch, no data redistribution needed;
  * fault-tolerant restart is trivial — resume at step k regenerates exactly
    the batches a failed run saw (no data-loader checkpointing).

A background-thread prefetcher overlaps host-side generation with device
compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "synthetic_batch", "data_iterator", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    doc_len: int = 512
    eos_id: int = 0
    frontend_tokens: int = 0  # for vlm/audio archs: prepended embeddings
    d_model: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _zipf(rng: np.random.RandomState, shape, vocab: int, a: float) -> np.ndarray:
    # inverse-CDF Zipf over a finite vocab (np.random.zipf is unbounded)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks**-a
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random_sample(shape)
    return np.searchsorted(cdf, u).astype(np.int32)


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    """Batch for this host at this step: tokens/labels (+ frontend embeds)."""
    per_host = cfg.global_batch // cfg.n_hosts
    rng = np.random.RandomState(
        (np.uint32(cfg.seed) * 1_000_003 + np.uint32(step) * 9_176 + cfg.host_id) % (2**31)
    )
    s_text = cfg.seq_len - cfg.frontend_tokens
    stream = _zipf(rng, (per_host, s_text + 1), cfg.vocab, cfg.zipf_a)
    # document boundaries
    doc_starts = rng.randint(1, cfg.doc_len, size=per_host)
    for b in range(per_host):
        stream[b, doc_starts[b] :: cfg.doc_len] = cfg.eos_id
    batch = {
        "tokens": stream[:, :-1],
        "labels": stream[:, 1:].astype(np.int32),
    }
    if cfg.frontend_tokens:
        batch["frontend_embeds"] = rng.standard_normal(
            (per_host, cfg.frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    return batch


def data_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step)
        step += 1


class Prefetcher:
    """Background-thread prefetch queue (overlaps host data generation with
    device compute — the CPU-side analogue of double buffering)."""

    def __init__(self, it: Iterator[dict], depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
