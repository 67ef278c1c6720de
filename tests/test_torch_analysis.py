"""The port's static-analysis suite and runtime sanitizer
(``repro_torch.analysis``), mirroring ``tests/test_analysis.py``.

Four layers:

* fixture corpora under ``tests/fixtures/reprolint_torch/`` — every rule
  fires on its flagged fixture and stays quiet on the clean one;
* the carried-over passes (CC, DT, TS) against the JAX package's: the same
  findings on the same sources;
* the CLI (``python -m repro_torch.analysis``) — non-zero on each flagged
  fixture, zero on the port's package, parseable ``--json``, ``--select``
  and ``--list-rules``;
* the sanitizer on the port's ``NetworkGraph`` and ``JRBAEngine`` — clean
  churn passes, a monkeypatched mutator that forgets its epoch bump raises,
  a missing topology bump raises, an engine build under a dodged epoch
  raises, and ``install`` is reversible.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.analysis.passes as ref_passes
import repro_torch.analysis.passes as port_passes
from repro.analysis import lint_source as ref_lint_source
from repro_torch.analysis import all_rules, lint_paths, lint_source
from repro_torch.analysis.framework import BAD_SUPPRESSION, PARSE_ERROR
from repro_torch.analysis.passes import (
    CacheCoherencePass,
    DeterminismPass,
    HostSyncPass,
    TelemetryStrictnessPass,
)
from repro_torch.analysis.sanitizer import SanitizerError, audit_graph, install
from repro_torch.core.graph import Flow, NetworkGraph, random_edge_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "reprolint_torch")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "reprolint")
PACKAGE = os.path.join(REPO, "src", "repro_torch")

PASSES = {
    "cc": CacheCoherencePass,
    "jp": HostSyncPass,
    "dt": DeterminismPass,
    "ts": TelemetryStrictnessPass,
}
FLAGGED = {
    "cc": ("cc_flagged.py", {"CC101", "CC102", "CC103", "CC104"}),
    "jp": ("hs_flagged.py", {"JP201", "JP202", "JP203", "JP204"}),
    "jp-kernels": (os.path.join("kernels", "hs_kernel_flagged.py"), {"JP201", "JP202"}),
    "jp-jrba": (os.path.join("core", "jrba.py"), {"JP201", "JP202"}),
    "dt": (os.path.join("core", "dt_flagged.py"), {"DT301", "DT302", "DT303", "DT304"}),
    "ts": ("ts_flagged.py", {"TS401"}),
}
CLEAN = {
    "cc": "cc_clean.py",
    "jp": "hs_clean.py",
    "jp-kernels": os.path.join("kernels", "hs_kernel_clean.py"),
    "dt": os.path.join("core", "dt_clean.py"),
    "ts": "ts_clean.py",
}


def lint_fixture(relname, pass_cls):
    path = os.path.join(FIXTURES, relname)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, path, [pass_cls()], scoped=False)


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )


# ---------------------------------------------------------------------------
# fixture corpora
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(FLAGGED))
def test_flagged_fixture_fires_every_rule(key):
    relname, expected = FLAGGED[key]
    found = {f.rule for f in lint_fixture(relname, PASSES[key.split("-")[0]])}
    assert expected <= found, f"missing rules: {expected - found}"


@pytest.mark.parametrize("key", sorted(CLEAN))
def test_clean_fixture_is_quiet(key):
    findings = lint_fixture(CLEAN[key], PASSES[key.split("-")[0]])
    assert findings == [], [f.format() for f in findings]


def test_host_sync_lines_are_the_marked_ones():
    """Each JP finding of the flagged fixture sits on a line whose comment
    names its rule, and every such line is found."""
    path = os.path.join(FIXTURES, "hs_flagged.py")
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    marked = {(i, r) for i, text in enumerate(lines, start=1)
              for r in ("JP201", "JP202", "JP203", "JP204") if f"# {r}" in text}
    found = {(f.line, f.rule) for f in lint_fixture("hs_flagged.py", HostSyncPass)}
    assert found == marked


def test_host_sync_patrols_only_the_listed_jrba_functions():
    funcs = {f.message.split("'")[-2] for f in lint_fixture(os.path.join("core", "jrba.py"),
                                                            HostSyncPass)}
    assert funcs == {"_to_host", "solve_relaxation_sparse"}


def test_findings_are_sorted_and_formatted():
    findings = lint_fixture(FLAGGED["dt"][0], DeterminismPass)
    assert findings == sorted(findings)
    f = findings[0]
    assert f.format().startswith(f"{f.path}:{f.line}:{f.col}: {f.rule} ")
    assert set(f.to_json()) == {"path", "line", "col", "rule", "message"}


@pytest.mark.parametrize("name, relname", [
    ("CacheCoherencePass", "cc_flagged.py"),
    ("CacheCoherencePass", "cc_clean.py"),
    ("DeterminismPass", os.path.join("core", "dt_flagged.py")),
    ("DeterminismPass", os.path.join("core", "dt_clean.py")),
    ("TelemetryStrictnessPass", "ts_flagged.py"),
    ("TelemetryStrictnessPass", "suppress_bad.py"),
])
def test_carried_passes_match_the_reference(name, relname):
    """On the JAX package's own corpus the port's copy of a pass reports
    exactly the reference's findings (rule, line, column)."""
    path = os.path.join(REF_FIXTURES, relname)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    ours = lint_source(source, path, [getattr(port_passes, name)()], scoped=False)
    ref = ref_lint_source(source, path, [getattr(ref_passes, name)()], scoped=False)
    assert [(f.line, f.col, f.rule) for f in ours] == [(f.line, f.col, f.rule) for f in ref]


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------
def test_reasoned_allow_suppresses():
    findings = lint_fixture("suppress_ok.py", TelemetryStrictnessPass)
    assert findings == [], [f.format() for f in findings]


def test_reasonless_allow_reports_and_does_not_suppress():
    rules = [f.rule for f in lint_fixture("suppress_bad.py", TelemetryStrictnessPass)]
    assert BAD_SUPPRESSION in rules
    assert "TS401" in rules


def test_allow_lists_several_rules():
    src = (
        "import torch\n"
        "class F(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def forward(ctx, x):\n"
        "        return float(x) if x > 0 else 0.0  # reprolint: allow[JP201,JP202] -- test\n"
    )
    assert lint_source(src, "x.py", [HostSyncPass()], scoped=False) == []


def test_allow_only_covers_its_line():
    src = (
        "import torch\n"
        "class F(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def forward(ctx, x):\n"
        "        a = x.item()  # reprolint: allow[JP201] -- test double\n"
        "        return x.item()\n"
    )
    findings = lint_source(src, "x.py", [HostSyncPass()], scoped=False)
    assert [f.line for f in findings] == [6]


def test_syntax_error_reports_parse_rule():
    findings = lint_source("def broken(:\n", "x.py", [HostSyncPass()])
    assert [f.rule for f in findings] == [PARSE_ERROR]


# ---------------------------------------------------------------------------
# scoping
# ---------------------------------------------------------------------------
def test_determinism_pass_scoped_to_the_ports_core_and_fleet():
    p = DeterminismPass()
    assert p.applies("src/repro_torch/core/online.py")
    assert p.applies("src/repro_torch/fleet/runtime.py")
    assert not p.applies("src/repro_torch/models/moe.py")
    assert not p.applies("src/repro_torch/obs/trace.py")


def test_telemetry_pass_exempts_the_ports_trace_module():
    p = TelemetryStrictnessPass()
    assert not p.applies("src/repro_torch/obs/trace.py")
    assert p.applies("src/repro_torch/launch/dryrun.py")


def test_kernel_regions_exempt_build_and_ref():
    src = "import torch\ndef f(x: torch.Tensor):\n    return x.item()\n"
    hs = HostSyncPass()
    for rel, n in [("src/repro_torch/kernels/ops.py", 1), ("src/repro_torch/kernels/ref.py", 0),
                   ("src/repro_torch/kernels/_build.py", 0), ("src/repro_torch/models/x.py", 0)]:
        assert len(lint_source(src, rel, [hs])) == n, rel


def test_rule_catalog_ids_are_unique_and_keep_the_references():
    ids = [r.id for r in all_rules()]
    assert len(ids) == len(set(ids))
    from repro.analysis import all_rules as ref_all_rules

    assert ids == [r.id for r in ref_all_rules()]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_clean_on_the_port():
    """The lint-clean contract: the port's package has zero findings."""
    res = run_cli("src/repro_torch")
    assert res.returncode == 0, res.stdout + res.stderr
    assert lint_paths([PACKAGE], root=REPO) == []


@pytest.mark.parametrize(
    "relname", [FLAGGED[k][0] for k in sorted(FLAGGED)] + ["suppress_bad.py"])
def test_cli_nonzero_on_each_flagged_fixture(relname):
    res = run_cli("--root", FIXTURES, os.path.join(FIXTURES, relname))
    assert res.returncode == 1, res.stdout + res.stderr
    assert res.stdout.strip(), "findings must print ruff-style"


def test_cli_json_output_parses():
    res = run_cli("--root", FIXTURES, "--json", "-", os.path.join(FIXTURES, "hs_flagged.py"))
    payload = json.loads(res.stdout[res.stdout.index("{"):])
    assert payload["n_findings"] == len(payload["findings"]) > 0
    assert {f["rule"] for f in payload["findings"]} == {"JP201", "JP202", "JP203", "JP204"}


def test_cli_select_restricts_rules():
    res = run_cli("--root", FIXTURES, "--select", "JP203", os.path.join(FIXTURES, "hs_flagged.py"))
    assert res.returncode == 1
    reported = {line.split(": ")[1].split()[0] for line in res.stdout.strip().splitlines()}
    assert reported == {"JP203"}


def test_cli_lists_rules():
    res = run_cli("--list-rules")
    assert res.returncode == 0
    listed = [line.split()[0] for line in res.stdout.strip().splitlines()]
    assert listed == [r.id for r in all_rules()]


# ---------------------------------------------------------------------------
# runtime sanitizer, on the port
# ---------------------------------------------------------------------------
def make_net():
    return NetworkGraph(
        [1.0, 1.0, 1.0], [4.0, 4.0, 4.0], [(0, 1, 10.0), (1, 2, 8.0), (0, 2, 5.0)]
    )


def test_sanitizer_clean_churn_passes():
    net = make_net()
    audit_graph(net)
    net.set_link_capacity(0, 1, 7.0)
    assert net.fail_link(0, 2)
    assert net.recover_link(0, 2)
    net.fail_node(1)
    net.recover_node(1)
    net.restore_topology()
    np.testing.assert_allclose(net.capacity, net.base_capacity)


def test_sanitizer_catches_monkeypatched_mutator(monkeypatch):
    def forgetful(self, u, v, bw):
        key = (min(u, v), max(u, v))
        self.bandwidth[key] = float(bw)
        self.capacity[self.link_index[key]] = bw  # no capacity_version bump

    net = make_net()
    audit_graph(net)
    monkeypatch.setattr(NetworkGraph, "set_link_capacity", forgetful)
    with pytest.raises(SanitizerError, match="capacity_version"):
        net.set_link_capacity(0, 1, 3.0)


def test_sanitizer_catches_missing_topology_bump(monkeypatch):
    def forgetful(self, u, v):
        self._adj[u].discard(v)
        self._adj[v].discard(u)
        return True

    net = make_net()
    audit_graph(net)
    monkeypatch.setattr(NetworkGraph, "fail_link", forgetful)
    with pytest.raises(SanitizerError, match="topology_version"):
        net.fail_link(0, 1)


def test_sanitizer_engine_refuses_dodged_epoch():
    from repro_torch.core.jrba import JRBAEngine

    uninstall = install()
    try:
        net = random_edge_network(6)
        eng = JRBAEngine(n_iters=20, device="cpu")
        flows = [Flow(src=0, dst=1, volume=5.0)]
        assert eng.solve(net, flows) is not None
        # dodge the epoch: sever adjacency directly, no topology_version bump
        net._adj[0].discard(1)
        net._adj[1].discard(0)
        with pytest.raises(SanitizerError, match="topology_version stayed"):
            eng.solve(net, flows)
    finally:
        uninstall()


def test_sanitizer_counts_audited_calls():
    from repro_torch.analysis import sanitizer

    sanitizer.reset_counts()
    net = make_net()
    audit_graph(net)
    net.set_link_capacity(0, 1, 7.0)
    net.fail_node(1)  # audited whole, and each of its two fail_link calls too
    assert sanitizer.AUDITED == {"mutations": 4, "builds": 0}


def test_sanitizer_install_is_reversible():
    from repro_torch.analysis import sanitizer
    from repro_torch.core.jrba import JRBAEngine

    uninstall = install()
    sanitized = make_net()
    assert getattr(sanitized, "_repro_sanitized", False)
    assert getattr(JRBAEngine(device="cpu"), "_repro_sanitized", False)
    uninstall()
    if not sanitizer.enabled():  # under REPRO_SANITIZE=1 a fixture's layer stays
        assert not getattr(make_net(), "_repro_sanitized", False)
        assert not getattr(JRBAEngine(device="cpu"), "_repro_sanitized", False)
