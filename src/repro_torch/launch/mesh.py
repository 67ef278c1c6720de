"""Production meshes over a process group the caller has initialised.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is pure data parallelism —
parameters are replicated across pods and only the gradient all-reduce
crosses them (optionally compressed, see ``optim/compression.py``). These
are the JAX package's meshes (``launch/mesh.py``) as ``DeviceMesh``es with
the same dimension names.

Nothing here initialises a process group: a mesh is built over the world
the caller set up (the dry run, ``launch/dryrun.py``, sets up a fake one of
256 or 512 ranks) and raises, as the reference does, when that world is
smaller than the mesh. The device type is ``"cuda"`` unless the caller asks
for ``"cpu"``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["batch_axes", "make_debug_mesh", "make_production_mesh"]


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str, what: str):
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the {what} mesh, have {have} — initialise a process group "
            "of that size first (launch/dryrun.py sets up a fake one)"
        )
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type, "production")


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), *, device_type: str = "cuda"):
    """A small mesh over the first ranks of the world (tests, the CPU)."""
    return _mesh(tuple(shape), tuple(axes), device_type, "debug")


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over: ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
