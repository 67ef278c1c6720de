"""Flagged fixture: every DT3xx rule fires at least once.

Lives under ``core/`` because the determinism pass only patrols decision
paths (``core/`` + ``fleet/``)."""
import random
import time

import numpy as np


def choose(net, items):
    for v in net.neighbors(0):  # DT301: live adjacency set
        pass
    for x in {1, 2, 3}:  # DT301: set literal
        pass
    order = sorted(items, key=lambda f: id(f))  # DT302: identity key
    jitter = np.random.uniform()  # DT303: global numpy RNG
    coin = random.random()  # DT303: global stdlib RNG
    rng = np.random.RandomState()  # DT303: unseeded factory
    now = time.time()  # DT304: wall clock
    return order, jitter, coin, rng, now
