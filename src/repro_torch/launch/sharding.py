"""Partition specs for parameters, optimizer state, batches and caches, and
their DTensor placements.

The JAX package's rules (``launch/sharding.py``), over the port's trees. A
spec is a tuple shaped like a ``PartitionSpec``: one entry a tensor dim,
each ``None`` (replicated), a mesh dim's name, or a tuple of names (that dim
sharded over several mesh dims, major first):

  * parameters shard over ``data`` (FSDP / ZeRO-3 gather-on-use) and
    ``model`` (tensor parallel); never over ``pod`` (pure DP across pods);
  * expert weights (E, d, f) put ``model`` on E — expert parallelism — and
    ``data`` on the second dim;
  * embedding tables (V, d) put ``model`` on V so the logits product is
    communication-free into (batch->data, vocab->model) sharded logits;
  * 1-D leaves (norm scales, biases) replicate.

The JAX package stacks each pattern group's leaves over a leading G axis and
leaves that axis unsharded; the port keeps one tensor a group
(``models/transformer.py::reference_leaves``), so a port tensor's spec is
the reference leaf's spec with that entry removed — the same rules with no
leading axis. Optimizer moments inherit the parameter spec (ZeRO-1); the
factored second moment's vectors inherit it minus the reduced dimension, and
under ``factored_second_moment`` each group holds its own copy of a 1-D
leaf's shared column moment ``v_c`` (``optim/adamw.py``), each replicated.
A dim is sharded only if exactly divisible by the axis size — otherwise it
stays replicated (e.g. 8-KV-head caches on a 16-wide model axis).

A mesh is anything with ``shape`` (sizes) and ``mesh_dim_names``: a
``DeviceMesh``, or a stand-in when only the specs are wanted.
"""
from __future__ import annotations

from typing import Any

from torch.distributed.tensor import Replicate, Shard

from ..tree import tree_map_with_path
from .mesh import batch_axes

__all__ = [
    "Spec",
    "batch_specs",
    "cache_spec",
    "opt_state_specs",
    "param_spec",
    "spec_shards",
    "to_placements",
    "train_state_specs",
    "tree_cache_specs",
    "tree_param_specs",
    "with_specs",
]

EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


class Spec(tuple):
    """A partition spec: equal to the plain tuple of its entries, and a leaf
    (never a container) where spec trees are walked. As in a
    ``PartitionSpec``, an entry of one mesh dim's name in a tuple is that
    name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(name)]


def _fsdp_axes(mesh, over_pods: bool):
    """The axis (or axes) FSDP shards weights over."""
    if over_pods and "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def param_spec(mesh, names: list[str], shape: tuple[int, ...], *, fsdp=("data",)) -> tuple:
    """The spec of the port tensor at path ``names`` with ``shape``."""
    model = _axis_size(mesh, "model")
    fsdp = tuple(a for a in fsdp if a in mesh.mesh_dim_names)
    fsdp_size = 1
    for a in fsdp:
        fsdp_size *= _axis_size(mesh, a)
    fsdp_entry = (fsdp if len(fsdp) > 1 else fsdp[0]) if fsdp else None

    def fsdp_ok(d: int) -> bool:  # replicated-params variant: fsdp == ()
        return bool(fsdp) and d % fsdp_size == 0

    dims = list(shape)
    leaf = names[-1]
    spec: list[Any] = [None] * len(dims)
    if leaf in ("embed", "unembed"):
        if dims[0] % model == 0:
            spec[0] = "model"
        if fsdp_ok(dims[1]):
            spec[1] = fsdp_entry
        return Spec(*spec)
    if leaf in EXPERT_LEAVES and "moe" in names:
        # (E, a, b): E -> model (EP), a -> fsdp
        if dims[0] % model == 0:
            spec[0] = "model"
        if len(dims) > 1 and fsdp_ok(dims[1]):
            spec[1] = fsdp_entry
        return Spec(*spec)
    if len(dims) <= 1:
        return Spec()  # 1-D leaves replicate
    # model on the last dim, fsdp on the first shardable dim
    if dims[-1] % model == 0:
        spec[-1] = "model"
    for i in range(len(dims) - 1):
        if fsdp_ok(dims[i]):
            spec[i] = fsdp_entry
            break
    return Spec(*spec)


def tree_param_specs(mesh, tree, *, fsdp_over_pods: bool = False) -> Any:
    """Spec tree matching ``tree`` (tensors, on any device or ``meta``)."""
    from . import variants

    fsdp = _fsdp_axes(mesh, fsdp_over_pods) if variants.KNOBS["fsdp_params"] else ()

    def spec(path, leaf):
        return param_spec(mesh, path.split("/"), tuple(leaf.shape), fsdp=fsdp)

    return tree_map_with_path(spec, tree)


def opt_state_specs(mesh, param_specs: Any, opt_shapes: dict) -> dict:
    """Moments inherit the parameter spec (ZeRO-1); factored second-moment
    vectors inherit the spec minus the reduced dimension."""
    out = {"m": param_specs}
    if "v" in opt_shapes:
        return {**out, "v": param_specs, "step": Spec()}
    out["v_r"] = _map_specs(
        lambda s, shp: Spec(*s[: len(shp.shape)]),
        param_specs, opt_shapes["v_r"])
    out["v_c"] = _map_specs(
        lambda s, shp: Spec() if tuple(shp.shape) == (0,) else Spec(*s[:-2], *s[-1:]),
        param_specs, opt_shapes["v_c"])
    out["step"] = Spec()
    return out


def _map_specs(fn, specs, tensors):
    """``fn(spec, tensor)`` over a spec tree and the tensor tree of the same
    structure, matching dict entries by key."""
    if isinstance(specs, Spec):
        return fn(specs, tensors)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, tensors[k]) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, s, t) for s, t in zip(specs, tensors, strict=True))
    return None


def with_specs(fn, tree, specs):
    """``fn(tensor, spec)`` over a tensor tree and its spec tree, in a tree
    of the tensor tree's structure and order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_specs(fn, t, s) for t, s in zip(tree, specs, strict=True))
    return fn(tree, specs)


def train_state_specs(mesh, state_shapes, *, fsdp_over_pods: bool = False) -> dict:
    ps = tree_param_specs(mesh, state_shapes["params"], fsdp_over_pods=fsdp_over_pods)
    return {
        "params": ps,
        "opt": opt_state_specs(mesh, ps, state_shapes["opt"]),
        "step": Spec(),
    }


def batch_specs(mesh, batch_shapes) -> dict:
    b = batch_axes(mesh)
    bsz = 1
    for a in b:
        bsz *= _axis_size(mesh, a)
    out = {}
    for k, v in batch_shapes.items():
        spec: list[Any] = [None] * len(v.shape)
        if v.shape[0] % bsz == 0:
            spec[0] = b
        out[k] = Spec(*spec)
    return out


def cache_spec(mesh, names: list[str], shape: tuple[int, ...]) -> tuple:
    """Decode caches: batch -> (pod, data) when divisible; otherwise (the
    long_500k single-sequence cell) shard the sequence axis of KV caches
    over data. KV heads shard over model only when divisible."""
    b = batch_axes(mesh)
    bsz = 1
    for a in b:
        bsz *= _axis_size(mesh, a)
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    leaf = names[-1]
    spec: list[Any] = [None] * len(shape)
    if leaf == "length":
        return Spec()
    if shape[0] % bsz == 0:
        spec[0] = b if len(b) > 1 else b[0]
    elif leaf in ("k", "v", "ckv", "kpe") and shape[1] % data == 0:
        spec[1] = "data"  # long-context: shard the sequence
    if leaf in ("k", "v") and len(shape) > 2 and shape[2] % model == 0:
        spec[2] = "model"  # KV heads
    return Spec(*spec)


def tree_cache_specs(mesh, cache_shapes) -> Any:
    def spec(path, leaf):
        return cache_spec(mesh, path.split("/"), tuple(leaf.shape))

    return tree_map_with_path(spec, cache_shapes)


def to_placements(mesh, spec: tuple) -> list:
    """DTensor placements for ``spec``: a mesh dim named for tensor dim i
    gets ``Shard(i)`` (several names on one dim shard it over each, major
    first, as the mesh dims are ordered), every other mesh dim
    ``Replicate()``."""
    names = tuple(mesh.mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            placements[names.index(axis)] = Shard(i)
    return placements


def spec_shards(mesh, spec: tuple) -> int:
    """How many pieces ``spec`` cuts a tensor into (1 when replicated)."""
    shards = 1
    for entry in spec:
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            shards *= _axis_size(mesh, axis)
    return shards
