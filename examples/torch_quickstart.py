"""Quickstart on the PyTorch port: schedule a streaming job with ENTS and
compare policies (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given: there ``jrba`` and the
``OnlineScheduler``'s engine take the JRBA CUDA kernel
(``resolve_solver("auto", device)``; ``REPRO_TORCH_JRBA_SOLVER=sparse``
takes its plain version on the card), on the CPU the plain version. The
records, and so every printed line, are the same on both.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    OnlineScheduler,
    allocate_greedy,
    allocate_whole_job_lr,
    equal_share_bandwidth,
    fig2_instance,
    jrba,
    poisson_arrivals,
    random_edge_network,
    throughput,
)

POLICIES = ("LR", "TP", "OTFS", "OTFA", "OTFA+WF")


def single_job_demo(device: str = "cuda") -> dict:
    """Fig. 2: one streaming job under four policies; returns each policy's
    throughput and JRBA's flows, routes and bandwidths."""
    print("=== Fig. 2 motivating example: one streaming job, four policies ===")
    net, job = fig2_instance()
    out = {}

    alloc, flows = allocate_whole_job_lr(net, job, commit=False)
    _, bands = equal_share_bandwidth(net, flows)
    out["LR"] = throughput(net, alloc, flows, bands)
    print(f"LeastRequested (no partition): throughput {out['LR']:.2f}")

    alloc, flows = allocate_greedy(net, job, commit=False)
    _, bands = equal_share_bandwidth(net, flows)
    out["TP"] = throughput(net, alloc, flows, bands)
    print(f"Task partition + equal share:  throughput {out['TP']:.2f}")

    res = jrba(net, flows, k=4, device=device)
    out["ENTS"] = throughput(net, alloc, res.flows, res.bandwidth)
    print(f"ENTS (Algo 1 + JRBA):          throughput {out['ENTS']:.2f}")
    out["flows"] = []
    for f, route, b in zip(res.flows, res.routes, res.bandwidth):
        print(f"   flow {f.edge} vol={f.volume:g}: route {route}, bandwidth {b:.2f}")
        out["flows"].append((f.edge, f.volume, route, float(b)))
    return out


def online_demo(device: str = "cuda") -> dict:
    """12 jobs on a 16-node mesh under five policies; returns each policy's
    ``SimResult``."""
    print("\n=== Online scheduling: 12 video-analytics jobs on a 16-node edge mesh ===")
    out = {}
    for policy in POLICIES:
        net = random_edge_network(16, mean_bandwidth=1.0, rng=np.random.RandomState(4))
        arrivals = poisson_arrivals(12, 16, np.random.RandomState(5), total_units=20.0)
        res = OnlineScheduler(net, policy, jrba_iters=150, device=device).run(arrivals)
        out[policy] = res
        print(
            f"{policy:8s}: avg throughput {res.avg_throughput:.3f} units/s, "
            f"avg waiting {res.avg_waiting_time:.3f}s"
        )
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return {"single": single_job_demo(args.device), "online": online_demo(args.device)}


if __name__ == "__main__":
    main()
