"""The yardstick's arithmetic: the chip's peaks, and the operations and bytes
a configuration's work needs, from its shapes alone. What depends on the
architecture (its layers' kinds, the operations a token needs in each, the
attention's shape) is its reference module's (``arch``, such as
``reference/mla.py``); this file adds them up.

Copied from ``chip_smoke.py``: the H100 peaks (``:324`` ``PEAK_BYTES``,
``:670`` ``PEAK_FLOPS``), ``:674`` ``live_pairs`` and ``flash_case``'s bound
(``:732-734``, ``:747``). A product of an (m, k) and a (k, n) matrix counts 2·m·k·n
operations. Attention counts the causal (q, k) pairs; a training step counts the forward three times (forward and backward),
not the recomputation of remat.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def live_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """(q, k) pairs inside the causal band (all keys when not causal) and the
    window, per batch and head."""
    q = np.arange(S, dtype=np.int64)
    last = q + 1 if causal else np.full(S, S, dtype=np.int64)
    first = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, dtype=np.int64)
    return int((last - first).sum())


def dtype(c: dict) -> str:
    return c.get("torch_dtype", "bfloat16")


def attention_flops(arch, c: dict, batch: int, seq: int) -> int:
    """Score and value products of one causal attention call."""
    H, Dk, Dv = arch.attention_shape(c)
    return (2 * Dk + 2 * Dv) * live_pairs(seq) * batch * H


def forward_flops(arch, c: dict, batch: int, seq: int, logit_rows: int) -> int:
    """A forward over (batch, seq) tokens that unembeds ``logit_rows``
    positions."""
    per = arch.token_flops(c)
    kinds = arch.layer_kinds(c)
    layers = sum(per[k] for k in kinds) * batch * seq
    return (layers + attention_layers(arch, c) * attention_flops(arch, c, batch, seq)
            + per["unembed"] * logit_rows)


def prefill_flops(arch, c: dict, batch: int, seq: int) -> int:
    """A prefill: the last position's logits only."""
    return forward_flops(arch, c, batch, seq, batch)


def train_step_flops(arch, c: dict, batch: int, seq: int) -> int:
    return 3 * forward_flops(arch, c, batch, seq, batch * seq)


def attention_bound_s(arch, c: dict, batch: int, seq: int) -> float:
    """The least time one causal attention call of the configuration can
    take: its score and value products at the peak, or q, k and v read once
    and the output written once at the memory's peak, whichever is longer."""
    H, Dk, Dv = arch.attention_shape(c)
    nbytes = batch * H * seq * (2 * Dk + 2 * Dv) * DTYPE_BYTES[dtype(c)]
    return max(attention_flops(arch, c, batch, seq) / PEAK_FLOPS[dtype(c)], nbytes / PEAK_BYTES)


def attention_layers(arch, c: dict) -> int:
    """Layers that run attention: those the architecture names, else all."""
    kinds = getattr(arch, "attention_layers", None)
    return kinds(c) if kinds else c["num_hidden_layers"]
