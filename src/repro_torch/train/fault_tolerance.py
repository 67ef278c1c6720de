"""Fault tolerance for multi-pod runs, the JAX package's
``train/fault_tolerance.py``: failure detection, elastic re-mesh,
checkpoint resharding and the straggler policy. The mechanisms run against a
simulated host set, so their logic is testable on the CPU:

  * ``HeartbeatMonitor`` declares hosts dead after ``timeout`` without a
    beat.
  * ``plan_elastic_remesh``: from the surviving chip count, the largest
    (pod, data, model) mesh that keeps the model-parallel degree.
  * ``reshard_like`` restores a checkpoint onto the devices of a live state:
    on one card, a move to its device with the shapes checked.
  * ``StragglerPolicy``: within a step, skip a data shard that keeps missing
    the deadline and rescale the gradient by the participating share.
"""
from __future__ import annotations

import dataclasses
import math

from ..tree import tree_map

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "plan_elastic_remesh", "reshard_like"]


class HeartbeatMonitor:
    """Tracks last-seen times per host; ``dead(now)`` lists failures."""

    def __init__(self, hosts: list[str], timeout: float = 60.0) -> None:
        self.timeout = timeout
        self.last_seen = {h: 0.0 for h in hosts}

    def beat(self, host: str, now: float) -> None:
        if host in self.last_seen:
            self.last_seen[host] = now

    def dead(self, now: float) -> list[str]:
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]

    def alive(self, now: float) -> list[str]:
        return [h for h, t in self.last_seen.items() if now - t <= self.timeout]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    pods: int
    dropped_chips: int  # surviving chips that do not fit the new rectangle

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_elastic_remesh(
    surviving_chips: int,
    *,
    model_parallel: int = 16,
    chips_per_pod: int = 256,
    min_data: int = 1,
) -> RemeshPlan:
    """The largest (pod, data, model) rectangle inside the surviving chips
    that keeps the model-parallel degree, so that a restart re-slices only
    the batch (the data axis, a power of two)."""
    if surviving_chips < model_parallel * min_data:
        raise ValueError(
            f"cannot build a mesh: {surviving_chips} chips < "
            f"{model_parallel}x{min_data} minimum"
        )
    pods = max(1, surviving_chips // chips_per_pod)
    while pods > 1:
        per_pod = surviving_chips // pods
        if per_pod >= model_parallel * min_data:
            break
        pods -= 1
    per_pod = surviving_chips // pods
    data = per_pod // model_parallel
    data = 2 ** int(math.log2(data)) if data else 0
    used = pods * data * model_parallel
    return RemeshPlan(
        data=data, model=model_parallel, pods=pods, dropped_chips=surviving_chips - used
    )


def reshard_like(tree, like):
    """Move a restored tree onto the devices of ``like``, a tree of the same
    structure: each tensor to its counterpart's device, its shape checked
    (logical shapes do not depend on the mesh)."""

    def move(x, ref):
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"shape {tuple(x.shape)} != expected {tuple(ref.shape)}")
        return x.to(ref.device)

    return tree_map(move, tree, like)


@dataclasses.dataclass
class StragglerPolicy:
    """If a data shard misses the step deadline ``patience`` times in a row,
    its contribution is skipped and the gradient rescaled by the
    participating share (bulk-synchronous training with backup workers)."""

    patience: int = 3
    min_participation: float = 0.75
    _strikes: dict[int, int] = dataclasses.field(default_factory=dict)

    def observe(self, shard: int, late: bool) -> None:
        self._strikes[shard] = self._strikes.get(shard, 0) + 1 if late else 0

    def skip_set(self) -> set[int]:
        return {s for s, k in self._strikes.items() if k >= self.patience}

    def grad_scale(self, n_shards: int) -> float:
        participating = n_shards - len(self.skip_set())
        frac = participating / n_shards
        if frac < self.min_participation:
            raise RuntimeError(
                f"participation {frac:.2f} below floor "
                f"{self.min_participation}: trigger elastic re-mesh instead"
            )
        return 1.0 / frac
