"""The benchmark's traffic: Zipf-distributed token ids from the seed.

A frozen copy of the port's synthetic data pipeline
(``src/repro_torch/data/pipeline.py:46`` ``_zipf``, ``:56``
``synthetic_batch``): inverse-CDF Zipf draws over the vocabulary and, for
training, an end-of-document id every ``doc_len`` tokens from a random start.
One change: each draw is seeded by ``numpy.random.default_rng([seed, stream,
index])``, so any whole seed, however large, gives its own independent
prompts and batches (the pipeline folds the seed and step into one 31-bit
seed).
"""
from __future__ import annotations

import functools

import numpy as np

PROMPTS, BATCHES, WARMUP, SAMPLE = 1, 2, 3, 4  # streams of one seed


@functools.lru_cache(maxsize=4)
def _cdf(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks**-a
    probs /= probs.sum()
    return np.cumsum(probs)


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream, int(index)])


def zipf(r: np.random.Generator, shape, vocab: int, a: float) -> np.ndarray:
    """Ids in [0, vocab): id i drawn with probability proportional to
    (i + 1) ** -a."""
    ids = np.searchsorted(_cdf(vocab, a), r.random(shape))
    return np.minimum(ids, vocab - 1).astype(np.int32)


def prompt(seed: int, index: int, batch: int, seq: int, vocab: int, a: float,
           stream: int = PROMPTS) -> np.ndarray:
    """Request ``index``'s prompts, (batch, seq) int32."""
    return zipf(rng(seed, stream, index), (batch, seq), vocab, a)


def train_batch(seed: int, index: int, batch: int, seq: int, vocab: int, a: float,
                doc_len: int, eos_id: int = 0) -> dict:
    """Step ``index``'s batch: ``tokens`` and next-token ``labels``, (batch,
    seq) int32 each, an ``eos_id`` every ``doc_len`` tokens."""
    r = rng(seed, BATCHES, index)
    stream = zipf(r, (batch, seq + 1), vocab, a)
    starts = r.integers(1, doc_len, size=batch)
    for b in range(batch):
        stream[b, starts[b]::doc_len] = eos_id
    return {"tokens": np.ascontiguousarray(stream[:, :-1]),
            "labels": np.ascontiguousarray(stream[:, 1:])}
