"""Telemetry-strictness pass (TS4xx) — the non-RFC-8259 JSON bug class.

The JAX package's pass, carried over with its rule id; its one exempt
module is ``obs/trace.py``, which the port has at the same place.

Telemetry JSONL once shipped where an idle lane's infinite span serialized as
the bare ``Infinity`` token — legal for Python's ``json`` module, rejected by
every strict RFC 8259 parser (Perfetto, ``chrome://tracing``, jq, most
log pipelines). The shared sanitizer lives in ``repro_torch.obs.trace``
(``dumps_strict``/``sanitize_nonfinite``: non-finite floats -> ``null``,
``allow_nan=False``); this pass makes it the only serialization door:

* ``TS401`` — any ``json.dumps``/``json.dump`` call outside ``obs/trace.py``
  must route through ``dumps_strict`` (or pre-sanitize and pass
  ``allow_nan=False``, which the sanitizer already does in one place).

The dry run's results writer (``launch/dryrun.py::record_line``) is what
it guards: a failed cell's non-finite timings would make whole JSONL lines
unparseable.
"""
from __future__ import annotations

import ast

from ..framework import LintPass, Rule


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class TelemetryStrictnessPass(LintPass):
    name = "telemetry-strictness"
    rules = (
        Rule(
            "TS401",
            "raw json.dumps/json.dump outside obs/trace.py "
            "(route through repro_torch.obs.trace.dumps_strict)",
        ),
    )

    def applies(self, relpath: str) -> bool:
        return not relpath.endswith("obs/trace.py")

    def run(self, tree: ast.Module, relpath: str) -> list[tuple[int, int, str, str]]:
        out: list[tuple[int, int, str, str]] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d in ("json.dumps", "json.dump"):
                msg = (
                    f"raw {d}() can emit non-RFC-8259 Infinity/NaN tokens that strict "
                    "parsers reject — serialize through repro_torch.obs.trace.dumps_strict "
                    "(or sanitize_nonfinite + allow_nan=False)"
                )
                out.append((node.lineno, node.col_offset + 1, "TS401", msg))
        return out
