"""ENTS-scheduled multi-engine serving cluster on the PyTorch port (the twin
of ``examples/serve_cluster.py``).

The assigned architectures' stage graphs become ENTS jobs; the placement
demo's network is the reference's own scenario, an 8x8 torus of 4-chip TPU
v5e groups (one 256-chip pod: 50 GB/s links, 4 x 197 TFLOP/s and 4 x 16 GB
a group). Those constants are the scenario's inputs, the same as the JAX
example's, not measurements of anything. The paper's scheduler (Algo 1 +
JRBA, the JRBA CUDA kernel on the card) decides stage placement, flow
routing and bandwidth, and a continuous-batching engine then serves requests
for the placed model (gemma3-1b-smoke). The engine prefills a prompt by
teacher-forced decode steps, tick for tick the JAX package's engine, and
decode is plain PyTorch, so serving launches no model kernel. Its weights
are the port's seeded init (``torch.Generator`` seed 0, where the JAX
example seeds ``PRNGKey(0)``).

  PYTHONPATH=src python examples/torch_serve_cluster.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import torus_network  # noqa: E402
from repro_torch.core.placement import place_job, stage_graph  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

# (arch, pipeline stages): the JAX example's jobs, placed in this order
JOBS = [
    ("deepseek-v3-671b", 32),  # 1.3 TB of weights: partitioning is forced
    ("deepseek-v2-lite-16b", 4),
    ("gemma3-1b", 4),
    ("rwkv6-3b", 4),
    ("musicgen-medium", 4),
]


def placement_demo(device: str = "cuda") -> list:
    """Places every job in turn, committing memory; returns each job's
    ``PlacementReport`` (None where infeasible)."""
    print("=== ENTS placement of assigned-arch stage graphs on a v5e pod ===")
    # an 8x8 torus of 4-chip groups = one 256-chip pod; units: FLOP/s, B/s, B
    net = torus_network(8, 8, link_bw=50.0e9, node_power=4 * 197e12, node_mem=4 * 16e9)
    reports = []
    for arch, n_stages in JOBS:
        cfg = get_config(arch)
        job = stage_graph(cfg, n_stages=n_stages, microbatch_tokens=4096, source_node=0)
        rep = place_job(net, job, device=device)
        reports.append(rep)
        if rep is None:
            print(f"{arch:22s}: infeasible on residual capacity (queues in OTFS/OTFA)")
            continue
        used = sorted({int(n) for t, n in zip(job.tasks, rep.assignment) if t.pinned_node is None})
        print(
            f"{arch:22s}: span {rep.span*1e3:8.3f} ms/microbatch "
            f"({rep.throughput:8.1f} mb/s) {n_stages} stages on {len(used)} node groups "
            f"{used[:8]}{'...' if len(used) > 8 else ''} | {len(rep.routes)} flows provisioned"
        )
        # commit memory so later jobs see residual capacity (multi-tenancy)
        for t, n in zip(job.tasks, rep.assignment):
            if t.pinned_node is None:
                net.mem_avail[int(n)] -= t.mem
    return reports


def serving_demo(device: str = "cuda", cfg=None, params=None) -> list:
    """Ten requests through the engine (4 slots); returns the finished
    requests. ``cfg`` and ``params`` replace gemma3-1b-smoke and its seeded
    init (the tests pass the JAX init at f32)."""
    print("\n=== Continuous-batching engine on the placed model (smoke scale) ===")
    cfg = cfg or get_config("gemma3-1b-smoke")
    params = params if params is not None else init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params, slots=4, max_len=96, device=device)
    rng = np.random.RandomState(3)
    for i in range(10):
        eng.submit(
            Request(
                uid=i,
                prompt=rng.randint(1, cfg.vocab, size=rng.randint(4, 10)).tolist(),
                max_new_tokens=int(rng.randint(4, 12)),
            )
        )
    done = eng.run_until_drained()
    print(f"served {len(done)} requests, outputs: {[len(r.output) for r in done]}")
    return done


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return {"placement": placement_demo(args.device), "served": serving_demo(args.device)}


if __name__ == "__main__":
    main()
