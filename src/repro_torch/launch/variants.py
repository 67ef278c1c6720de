"""Named sharding/layout variants (the JAX package's ``launch/variants.py``,
its knobs and ``activate`` verbatim).

``activate(name)`` flips module-level knobs consumed by the sharding rules
(``launch/sharding.py``: ``fsdp_params``) and by the dry run's model hints
(``launch/dryrun.py``: ``act_sharding``, ``moe_constraints``). The defaults
are the JAX package's production layout: FSDP weights, sequence-sharded
layer-boundary activations and expert-parallel pins on the MoE dispatch
buffers; ``baseline`` drops the pins.
"""
from __future__ import annotations

_DEFAULTS = {
    "fsdp_params": True,  # False => weights replicated across 'data' (pure TP+DP)
    "act_sharding": "seq",  # "seq" | "none" — layer-boundary activation layout
    "moe_constraints": True,  # EP layout pins on the dispatch buffers (§Perf.3)
}

KNOBS = dict(_DEFAULTS)

VARIANTS = {
    "default": {},
    "baseline": {"moe_constraints": False},  # the §Roofline baseline table
    "replicated-params": {"fsdp_params": False},
    "no-act-sharding": {"act_sharding": "none"},
    "moe-ep-pinned": {"moe_constraints": True},
    "replicated+moe": {"fsdp_params": False, "moe_constraints": True},
}


def activate(name: str) -> None:
    KNOBS.update(_DEFAULTS)
    KNOBS.update(VARIANTS[name])
