"""Determinism pass (DT3xx) — the bit-identity contract on decision paths.

The JAX package's pass, carried over with its rule ids. Its scope is any
``core/`` or ``fleet/`` directory, which takes in the port's
``src/repro_torch/core`` and ``src/repro_torch/fleet`` as it does the
reference's (``applies``).

Scheduler records must be bit-identical across the dense, sparse and kernel
solvers, lockstep/async runtimes and speculative/sequential dispatch (every bench
section asserts record dev == 0). That only holds if nothing in ``core/`` or
``fleet/`` lets incidental orderings or ambient state leak into a decision:

* ``DT301`` — iteration over an unordered set feeding loop bodies: CPython
  set order is a hashing accident, not a contract. Wrap in ``sorted(...)``
  (dicts are insertion-ordered and exempt). The pass recognizes set
  literals/comprehensions, ``set()``/``frozenset()`` calls, ``.neighbors()``
  (returns the live adjacency set) and ``._adj[...]`` subscripts.
* ``DT302`` — ``id()``: keys derived from object identity are reuse-hazardous
  (CPython recycles addresses, so a dead flow's key can collide with a live
  one) and order-opaque. Key by stable indices instead — the online.py OTFA
  refresh once kept an ``id(flow)``-keyed lookup, the finding that seeded
  this rule.
* ``DT303`` — unseeded RNG: module-level ``np.random.*``/``random.*`` draws
  and zero-arg ``RandomState()``/``default_rng()`` read global or OS
  entropy. Thread an explicitly seeded generator instead.
* ``DT304`` — wall-clock reads (``time.time``/``datetime.now``): decision
  paths must be functions of the event clock, not the host's.
  ``perf_counter``/``monotonic`` stay legal — telemetry measures durations,
  it never decides.
"""
from __future__ import annotations

import ast

from ..framework import LintPass, Rule

SET_RETURNING_CALLS = frozenset({"set", "frozenset"})
KNOWN_SET_ACCESSORS = frozenset({"neighbors"})
WALLCLOCK = frozenset({"time.time", "time.localtime", "time.ctime", "time.gmtime"})
WALLCLOCK_DT = frozenset({"now", "today", "utcnow"})
RNG_FACTORIES = frozenset({"RandomState", "default_rng", "Generator", "PCG64"})
NP_RANDOM_FUNCS = frozenset(
    {
        "random",
        "rand",
        "randn",
        "randint",
        "normal",
        "uniform",
        "choice",
        "shuffle",
        "permutation",
        "exponential",
        "poisson",
        "seed",
    }
)


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_unordered_iterable(node: ast.AST) -> str | None:
    """A reason string when ``node`` provably evaluates to a set."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "set literal"
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if d in SET_RETURNING_CALLS:
            return f"{d}() result"
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in KNOWN_SET_ACCESSORS:
                return f".{node.func.attr}() result (live adjacency set)"
            # set-preserving chains: net.neighbors(u).copy(), set(...).copy()
            if node.func.attr in ("copy", "difference", "union", "intersection"):
                inner = _is_unordered_iterable(node.func.value)
                if inner:
                    return inner
    if isinstance(node, ast.Subscript):
        d = _dotted(node.value)
        if d is not None and d.split(".")[-1] == "_adj":
            return "._adj[...] adjacency set"
    if isinstance(node, ast.Attribute) and node.attr == "_adj":
        return "._adj adjacency dict-of-sets"
    return None


class DeterminismPass(LintPass):
    name = "determinism"
    rules = (
        Rule("DT301", "iteration over an unordered set on a decision path (wrap in sorted())"),
        Rule("DT302", "id()-derived key/lookup on a decision path (reuse-hazardous, order-opaque)"),
        Rule("DT303", "unseeded RNG on a decision path (thread an explicit seeded generator)"),
        Rule("DT304", "wall-clock read on a decision path (decisions follow the event clock)"),
    )

    def applies(self, relpath: str) -> bool:
        return "/core/" in f"/{relpath}" or "/fleet/" in f"/{relpath}"

    def run(self, tree: ast.Module, relpath: str) -> list[tuple[int, int, str, str]]:
        out: list[tuple[int, int, str, str]] = []
        imports = {
            alias.asname or alias.name
            for node in ast.walk(tree)
            if isinstance(node, ast.Import)
            for alias in node.names
        }
        has_random = "random" in imports
        for node in ast.walk(tree):
            if isinstance(node, ast.For):
                self._check_iter(node.iter, out)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    self._check_iter(gen.iter, out)
            elif isinstance(node, ast.Call):
                self._check_call(node, has_random, out)
        return out

    def _check_iter(self, it: ast.AST, out: list) -> None:
        reason = _is_unordered_iterable(it)
        if reason:
            msg = (
                f"iterating a {reason} — set order is a hashing accident; wrap in sorted() "
                "so scheduling order is a function of the inputs"
            )
            out.append((it.lineno, it.col_offset + 1, "DT301", msg))

    def _check_call(self, call: ast.Call, has_random: bool, out: list) -> None:
        d = _dotted(call.func)
        if d is None:
            return
        if d == "id":
            msg = (
                "id() on a decision path — identity keys are reuse-hazardous (CPython "
                "recycles addresses) and order-opaque; key by a stable index instead"
            )
            out.append((call.lineno, call.col_offset + 1, "DT302", msg))
            return
        parts = d.split(".")
        leaf = parts[-1]
        if len(parts) >= 2 and parts[-2] == "random" and parts[0] in ("np", "numpy", "random"):
            if leaf in NP_RANDOM_FUNCS:
                msg = (
                    f"module-level {d}() draws from the global RNG — thread a seeded "
                    "Generator/RandomState through instead"
                )
                out.append((call.lineno, call.col_offset + 1, "DT303", msg))
                return
        if leaf in RNG_FACTORIES and not call.args and not call.keywords:
            msg = f"{d}() without a seed reads OS entropy — pass an explicit seed"
            out.append((call.lineno, call.col_offset + 1, "DT303", msg))
            return
        if has_random and parts[0] == "random" and len(parts) == 2 and leaf in NP_RANDOM_FUNCS:
            msg = f"stdlib {d}() draws from the global RNG — use a seeded random.Random"
            out.append((call.lineno, call.col_offset + 1, "DT303", msg))
            return
        if d in WALLCLOCK or (
            len(parts) >= 2 and parts[-2] in ("datetime", "date") and leaf in WALLCLOCK_DT
        ):
            msg = (
                f"{d}() reads the wall clock on a decision path — simulated/event time is "
                "the only admissible clock (perf_counter for telemetry durations is fine)"
            )
            out.append((call.lineno, call.col_offset + 1, "DT304", msg))
