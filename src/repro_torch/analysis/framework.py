"""AST lint framework of the port's static-analysis suite.

The JAX package's ``repro.analysis.framework``, carried over as it is (the
port imports nothing of that package). The moving parts:

* :class:`Rule` — one checkable invariant with a stable id (``CC101`` …).
* :class:`Finding` — one violation at ``path:line:col``, ruff-style.
* :class:`LintPass` — a family of rules sharing one AST walk. A pass declares
  the *scope* it applies to (``applies(relpath)``) so repo-layout knowledge
  lives with the pass, not the caller: the determinism pass only patrols
  ``core/`` + ``fleet/`` decision paths, the telemetry pass everything except
  the one module allowed to call ``json.dumps``.
* Suppressions — ``# reprolint: allow[RULE] -- reason`` on the flagged line
  (or on its own comment line directly above; a block of comment-only lines
  counts as "directly above"). The reason text is mandatory: an allow without
  one does not suppress and is itself reported as ``RPL001``. Several ids may
  be listed comma-separated.

Everything here is stdlib-only: the passes reason about torch *syntax* and
never import it. ``python -m repro_torch.analysis`` is the entry point.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Sequence

__all__ = [
    "Finding",
    "LintPass",
    "Rule",
    "all_rules",
    "default_passes",
    "iter_python_files",
    "lint_paths",
    "lint_source",
]

PARSE_ERROR = "RPL000"
BAD_SUPPRESSION = "RPL001"

META_RULES = (
    ("RPL000", "file does not parse (syntax error)"),
    ("RPL001", "reprolint suppression without a reason (reason text after '--' is mandatory)"),
)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One checkable invariant."""

    id: str
    summary: str


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, sortable into stable report order."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class LintPass:
    """Base class: one AST walk covering a family of rules.

    Subclasses set ``name``/``rules`` and implement :meth:`run`, returning
    ``(line, col, rule_id, message)`` tuples; the framework stamps the path,
    applies suppressions and sorts. ``applies`` scopes the pass to the part
    of the repo whose contract it encodes (paths are repo-relative with
    forward slashes); fixture corpora bypass scoping via
    ``lint_source(..., scoped=False)``.
    """

    name: str = "base"
    rules: tuple[Rule, ...] = ()

    def applies(self, relpath: str) -> bool:
        return True

    def run(self, tree: ast.Module, relpath: str) -> list[tuple[int, int, str, str]]:
        raise NotImplementedError

    def rule_ids(self) -> set[str]:
        return {r.id for r in self.rules}


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------
_ALLOW_RE = re.compile(
    r"#\s*reprolint:\s*allow\[(?P<rules>[A-Za-z0-9_,\s]+)\]\s*(?:--\s*(?P<reason>\S.*))?"
)
_COMMENT_ONLY_RE = re.compile(r"^\s*#")


def _collect_suppressions(
    lines: Sequence[str],
) -> tuple[dict[int, set[str]], list[tuple[int, int]]]:
    """Map line number -> suppressed rule ids, plus reasonless-allow sites.

    A trailing allow covers its own line; an allow on a comment-only line
    covers the next non-comment-only line (so a multi-line comment block may
    carry the reason across lines below the allow itself).
    """
    allowed: dict[int, set[str]] = {}
    bad: list[tuple[int, int]] = []
    n = len(lines)
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        if not m.group("reason"):
            bad.append((i, m.start() + 1))
            continue
        ids = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        target = i
        if _COMMENT_ONLY_RE.match(text):
            target = None
            j = i + 1
            while j <= n:
                if not _COMMENT_ONLY_RE.match(lines[j - 1]) and lines[j - 1].strip():
                    target = j
                    break
                j += 1
        if target is not None:
            allowed.setdefault(target, set()).update(ids)
    return allowed, bad


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------
def lint_source(
    source: str,
    path: str,
    passes: Sequence[LintPass],
    *,
    relpath: str | None = None,
    scoped: bool = True,
) -> list[Finding]:
    """Lint one file's source. ``relpath`` (default: ``path``) is what pass
    scoping sees; ``scoped=False`` runs every pass regardless — the fixture
    corpus uses this so a snippet exercises a pass without living at the
    repo path the pass patrols."""
    rel = (relpath if relpath is not None else path).replace(os.sep, "/")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        msg = f"syntax error: {e.msg}"
        return [Finding(path, e.lineno or 1, e.offset or 1, PARSE_ERROR, msg)]
    lines = source.splitlines()
    allowed, bad_allows = _collect_suppressions(lines)
    findings = [
        Finding(path, line, col, BAD_SUPPRESSION, META_RULES[1][1]) for line, col in bad_allows
    ]
    for p in passes:
        if scoped and not p.applies(rel):
            continue
        for line, col, rule, message in p.run(tree, rel):
            if rule in allowed.get(line, ()):
                continue
            findings.append(Finding(path, line, col, rule, message))
    return sorted(findings)


def iter_python_files(paths: Iterable[str]) -> list[str]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
                out.extend(
                    os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return sorted(dict.fromkeys(out))


def lint_paths(
    paths: Iterable[str],
    passes: Sequence[LintPass] | None = None,
    *,
    root: str | None = None,
    select: Iterable[str] | None = None,
) -> list[Finding]:
    """Lint every ``.py`` file under ``paths``. Scoping sees each file's path
    relative to ``root`` (default: the current directory), so running from
    the repo root gives passes the layout they encode. ``select`` restricts
    output to the given rule ids (meta-rules always pass through)."""
    passes = default_passes() if passes is None else passes
    root = os.getcwd() if root is None else root
    keep = None if select is None else set(select) | {PARSE_ERROR, BAD_SUPPRESSION}
    findings: list[Finding] = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
        findings.extend(lint_source(source, path, passes, relpath=rel))
    if keep is not None:
        findings = [f for f in findings if f.rule in keep]
    return sorted(findings)


def default_passes() -> list[LintPass]:
    """The port's four passes, in report-prefix order: cache coherence
    (CC1xx), host syncs (JP2xx, the torch counterpart of the JAX package's
    JIT-purity pass), determinism (DT3xx) and telemetry strictness (TS4xx)."""
    from .passes.cache_coherence import CacheCoherencePass
    from .passes.determinism import DeterminismPass
    from .passes.host_sync import HostSyncPass
    from .passes.telemetry import TelemetryStrictnessPass

    return [CacheCoherencePass(), HostSyncPass(), DeterminismPass(), TelemetryStrictnessPass()]


def all_rules() -> list[Rule]:
    """Every rule the suite can report, meta-rules first."""
    rules = [Rule(i, s) for i, s in META_RULES]
    for p in default_passes():
        rules.extend(p.rules)
    return rules
