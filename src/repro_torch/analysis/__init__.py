"""repro_torch.analysis — the port's static-analysis suite and runtime
sanitizer, the counterpart of the JAX package's ``repro.analysis``.

Static half (stdlib-only, imports no torch): the AST lint framework
(:mod:`.framework`) with four passes under :mod:`.passes` — cache coherence
(CC1xx), host syncs (JP2xx), determinism (DT3xx) and telemetry strictness
(TS4xx) — driven by ``python -m repro_torch.analysis``. Each rule keeps the
id of its counterpart in the JAX package; the host-sync pass is the torch
counterpart of that package's JIT-purity pass.

Runtime half (:mod:`.sanitizer`, imports the core lazily): ``install()``
wraps every :class:`~repro_torch.core.graph.NetworkGraph` in a mutation
auditor that asserts each capacity/topology mutation bumped the matching
epoch counter, and arms a build-time check that
:class:`~repro_torch.core.jrba.JRBAEngine` never answers from a program cache
whose topology epoch is stale.
"""

from .framework import (
    Finding,
    LintPass,
    Rule,
    all_rules,
    default_passes,
    lint_paths,
    lint_source,
)

__all__ = [
    "Finding",
    "LintPass",
    "Rule",
    "all_rules",
    "default_passes",
    "lint_paths",
    "lint_source",
]
