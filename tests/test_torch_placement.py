"""ENTS stage placement in the port (``repro_torch.core.placement``) against
the JAX package's, on the CPU: the stage graphs of the serving example's jobs
and their placement reports on an 8x8 torus, job after job with memory
committed in between, must be identical."""
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jget
from repro.core.placement import place_job as jplace
from repro.core.placement import stage_graph as jstage
from repro_torch.configs import get_config as tget
from repro_torch.core.placement import PlacementReport, place_job, stage_graph

# examples/serve_cluster.py's jobs: (arch, pipeline stages)
JOBS = [
    ("deepseek-v3-671b", 32),
    ("deepseek-v2-lite-16b", 4),
    ("gemma3-1b", 4),
    ("rwkv6-3b", 4),
    ("musicgen-medium", 4),
]


def _net(core):
    return core.torus_network(8, 8, link_bw=50.0e9, node_power=4 * 197e12, node_mem=4 * 16e9)


def _graph_record(job):
    return (
        job.name,
        [(t.name, t.workload, t.mem, t.pinned_node) for t in job.tasks],
        [tuple(e) for e in job.edges],
    )


@pytest.mark.parametrize("arch,n_stages", JOBS)
def test_stage_graphs_equal(arch, n_stages):
    for train in (False, True):
        a = jstage(jget(arch), n_stages=n_stages, microbatch_tokens=4096, train=train)
        b = stage_graph(tget(arch), n_stages=n_stages, microbatch_tokens=4096, train=train)
        assert _graph_record(a) == _graph_record(b)


def test_placement_reports_equal():
    jnet, tnet = _net(jcore), _net(tcore)
    placed = 0
    for arch, n_stages in JOBS:
        jjob = jstage(jget(arch), n_stages=n_stages, microbatch_tokens=4096, source_node=0)
        tjob = stage_graph(tget(arch), n_stages=n_stages, microbatch_tokens=4096, source_node=0)
        want = jplace(jnet, jjob)
        got = place_job(tnet, tjob, device="cpu")
        assert (want is None) == (got is None), arch
        if got is None:
            continue
        placed += 1
        assert isinstance(got, PlacementReport)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.routes == want.routes
        np.testing.assert_array_equal(got.bandwidths, want.bandwidths)
        assert (got.span, got.throughput) == (want.span, want.throughput)
        for net, job, rep in ((jnet, jjob, want), (tnet, tjob, got)):
            for t, n in zip(job.tasks, rep.assignment):
                if t.pinned_node is None:
                    net.mem_avail[int(n)] -= t.mem
    assert placed >= 3
    np.testing.assert_array_equal(tnet.mem_avail, jnet.mem_avail)
