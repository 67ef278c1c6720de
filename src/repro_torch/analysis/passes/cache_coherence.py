"""Cache-coherence pass (CC1xx) — the stale-cache bug class.

The JAX package's pass, carried over with its rule ids: the port's
``repro_torch.core.graph.NetworkGraph`` keeps the same state and the same
churn API, and the pass keys on those names alone, so it patrols every file
of the port as it does the reference's.

Every derived-value cache in the scheduler (the avg-bandwidth path memo, the
engine's per-net path/program caches, recorded speculations) is keyed on
``NetworkGraph.capacity_version`` / ``topology_version``. A mutation that
forgets to bump the matching epoch — or to drop/prune the host-side memos on
an adjacency change — silently serves stale programs, which is exactly how
jobs once completed at full speed through a total outage. The invariants:

* ``CC101`` — a ``NetworkGraph`` method that writes capacity state
  (``self.capacity``/``self.bandwidth``) must bump ``capacity_version``.
* ``CC102`` — a method that mutates the adjacency or link liveness
  (``self._adj``/``self.link_alive``) must bump ``topology_version``.
* ``CC103`` — the same mutation must also call ``_drop_host_caches`` or
  ``_prune_host_caches`` (full vs footprint-scoped memo invalidation).
* ``CC104`` — no code outside the ``NetworkGraph`` class may write its
  capacity/adjacency state directly; mutate through the churn API
  (``set_link_capacity``/``fail_link``/…), which owns the epoch bumps.

``__init__`` is exempt (construction is epoch 0 by definition), and methods
that only *delegate* to other mutators (``fail_node`` -> ``fail_link``) carry
no direct obligation — the callee bumps.
"""
from __future__ import annotations

import ast

from ..framework import LintPass, Rule

CAP_ATTRS = frozenset({"capacity", "bandwidth"})
TOPO_ATTRS = frozenset({"_adj", "adj", "link_alive"})
SET_MUTATORS = frozenset(
    {"add", "discard", "remove", "clear", "update", "pop", "difference_update"}
)


def _is_self(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "self"


def _store_attr(target: ast.AST) -> ast.Attribute | None:
    """The Attribute being written by an assignment target: ``x.a = ``,
    ``x.a[i] = `` and ``x.a[:] = `` all write through attribute ``a``."""
    if isinstance(target, ast.Attribute):
        return target
    if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Attribute):
        return target.value
    return None


def _iter_store_attrs(node: ast.AST):
    """Attribute stores in one statement (plain, augmented or annotated)."""
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                attr = _store_attr(e)
                if attr is not None:
                    yield attr


def _set_mutation(node: ast.AST) -> ast.Attribute | None:
    """``<base>._adj[u].add(v)``-style mutation; returns the ``_adj``/``adj``
    attribute node, or the ``neighbors`` call's attribute for mutations of
    ``net.neighbors(u)`` (the same live set under an accessor)."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    if node.func.attr not in SET_MUTATORS:
        return None
    base = node.func.value
    if isinstance(base, ast.Subscript) and isinstance(base.value, ast.Attribute):
        if base.value.attr in TOPO_ATTRS:
            return base.value
    if (
        isinstance(base, ast.Call)
        and isinstance(base.func, ast.Attribute)
        and base.func.attr == "neighbors"
    ):
        return base.func
    return None


class CacheCoherencePass(LintPass):
    name = "cache-coherence"
    rules = (
        Rule("CC101", "NetworkGraph capacity write without a capacity_version bump"),
        Rule("CC102", "NetworkGraph adjacency/liveness write without a topology_version bump"),
        Rule("CC103", "NetworkGraph adjacency/liveness write without a host-cache drop/prune"),
        Rule(
            "CC104",
            "direct write to NetworkGraph capacity/adjacency state outside the class "
            "(mutate through the churn API, which owns the epoch bumps)",
        ),
    )

    def run(self, tree: ast.Module, relpath: str) -> list[tuple[int, int, str, str]]:
        out: list[tuple[int, int, str, str]] = []
        self._walk(tree, in_netgraph=False, out=out)
        return out

    # -- traversal ---------------------------------------------------------
    def _walk(self, node: ast.AST, *, in_netgraph: bool, out: list) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef) and child.name == "NetworkGraph":
                for item in child.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._check_method(item, out)
                    else:
                        self._walk(item, in_netgraph=True, out=out)
                continue
            if not in_netgraph:
                self._check_external(child, out)
            self._walk(child, in_netgraph=in_netgraph, out=out)

    # -- CC101/102/103: method-level obligations ---------------------------
    def _check_method(self, fn: ast.FunctionDef, out: list) -> None:
        if fn.name == "__init__":
            return
        cap_writes: list[tuple[int, int]] = []
        topo_writes: list[tuple[int, int]] = []
        cap_bump = topo_bump = cache_call = False
        for node in ast.walk(fn):
            for attr in _iter_store_attrs(node):
                if not _is_self(attr.value):
                    continue
                if attr.attr in CAP_ATTRS:
                    cap_writes.append((node.lineno, node.col_offset + 1))
                elif attr.attr in TOPO_ATTRS:
                    topo_writes.append((node.lineno, node.col_offset + 1))
                elif attr.attr == "capacity_version":
                    cap_bump = True
                elif attr.attr == "topology_version":
                    topo_bump = True
            mut = _set_mutation(node)
            if mut is not None and _is_self(mut.value):
                topo_writes.append((node.lineno, node.col_offset + 1))
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and _is_self(node.func.value)
                and node.func.attr in ("_drop_host_caches", "_prune_host_caches")
            ):
                cache_call = True
        if cap_writes and not cap_bump:
            line, col = cap_writes[0]
            msg = (
                f"method '{fn.name}' writes capacity state but never bumps "
                "self.capacity_version — epoch-keyed memos will serve stale values"
            )
            out.append((line, col, "CC101", msg))
        if topo_writes and not topo_bump:
            line, col = topo_writes[0]
            msg = (
                f"method '{fn.name}' mutates the adjacency/liveness but never bumps "
                "self.topology_version — path/program caches will serve stale topology"
            )
            out.append((line, col, "CC102", msg))
        if topo_writes and not cache_call:
            line, col = topo_writes[0]
            msg = (
                f"method '{fn.name}' mutates the adjacency/liveness but calls neither "
                "self._drop_host_caches() nor self._prune_host_caches() — pinned "
                "avg-bandwidth paths can cross dead links"
            )
            out.append((line, col, "CC103", msg))

    # -- CC104: external writes --------------------------------------------
    def _check_external(self, node: ast.AST, out: list) -> None:
        for attr in _iter_store_attrs(node):
            if attr.attr in TOPO_ATTRS or (attr.attr in CAP_ATTRS and not _is_self(attr.value)):
                msg = (
                    f"direct write to NetworkGraph state '.{attr.attr}' outside the class — "
                    "use the churn API (set_link_capacity/fail_link/…) so epochs bump"
                )
                out.append((node.lineno, node.col_offset + 1, "CC104", msg))
        mut = _set_mutation(node)
        if mut is not None:
            msg = (
                f"direct mutation of NetworkGraph state '.{mut.attr}' outside the class — "
                "use the churn API (fail_link/recover_link/…) so epochs bump"
            )
            out.append((node.lineno, node.col_offset + 1, "CC104", msg))
