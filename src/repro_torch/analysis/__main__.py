"""reprolint for the port: ``python -m repro_torch.analysis``.

Runs the port's four passes (cache coherence CC1xx, host syncs JP2xx,
determinism DT3xx, telemetry strictness TS4xx) over the given paths and
reports findings ruff-style (``path:line:col: RULE message``). Exit code 1
when anything is found, 0 when clean.

Usage, from the repository root:
    python -m repro_torch.analysis                   # lint the port's package
    python -m repro_torch.analysis src/repro_torch/core
    python -m repro_torch.analysis --json out.json   # machine-readable findings
    python -m repro_torch.analysis --select JP201    # one rule only
    python -m repro_torch.analysis --list-rules      # the rule catalog

Suppressions: ``# reprolint: allow[RULE] -- reason`` on the flagged line or a
comment line directly above it; the reason is mandatory.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..obs.trace import dumps_strict
from . import all_rules, lint_paths

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the repro_torch package)")
    ap.add_argument("--json", metavar="OUT", help="also write findings as JSON ('-' for stdout)")
    ap.add_argument("--select", action="append", metavar="RULE", help="restrict to these rule ids")
    ap.add_argument("--root", default=os.getcwd(),
                    help="root that pass scoping sees paths from (default: the current directory)")
    ap.add_argument("--list-rules", action="store_true", help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.summary}")
        return 0

    paths = args.paths or [PACKAGE]
    findings = lint_paths(paths, root=args.root, select=args.select)

    def _relativize(f):
        path = os.path.relpath(os.path.abspath(f.path), args.root)
        return f.__class__(path, f.line, f.col, f.rule, f.message)

    rel = [_relativize(f) for f in findings]
    for f in rel:
        print(f.format())
    if args.json:
        payload = {
            "findings": [f.to_json() for f in rel],
            "n_findings": len(rel),
            "paths": [os.path.relpath(os.path.abspath(p), args.root) for p in paths],
        }
        if args.json == "-":
            print(dumps_strict(payload, indent=2))
        else:
            with open(args.json, "w") as fh:
                fh.write(dumps_strict(payload, indent=2) + "\n")
    if rel:
        print(f"reprolint: {len(rel)} finding(s)", file=sys.stderr)
        return 1
    print(f"reprolint: clean ({len(paths)} path(s))", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
