"""Clean fixture: deterministic versions of the same moves — zero DT
findings."""
import time

import numpy as np


def choose(net, items, rng):
    for v in sorted(net.neighbors(0)):  # sorted(): order is a contract
        pass
    order = sorted(items)
    jitter = rng.uniform()  # threaded, caller-seeded generator
    seeded = np.random.RandomState(7)  # explicit seed
    t0 = time.perf_counter()  # duration telemetry, not a decision
    return order, jitter, seeded, t0
