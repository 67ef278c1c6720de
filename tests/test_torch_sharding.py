"""The port's partition specs (``repro_torch.launch.sharding``) against the
JAX package's, leaf for leaf, and their DTensor placements.

The reference side is built shape-only with ``jax.eval_shape`` on a
stand-in mesh, as ``tests/test_placement_sharding.py`` builds it; the port
side with the dry run's shape-only init (``meta`` tensors). A port tensor
outside the pattern groups has its reference leaf's spec; a group's tensor
has the spec of the reference leaf that stacks it over the groups, with the
leading (unsharded) group entry removed. ``sharded_bytes`` is the same
integer, except for deepseek-v3-671b's factored optimizer state, where each
group keeps its own copy of a 1-D leaf's shared ``v_c``: the port holds
exactly (groups - 1) such copies more.
"""
import functools
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.sharding as ref_sharding
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch import variants as ref_variants
from repro.models import init_cache as ref_init_cache
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.train import init_train_state as ref_init_train_state
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, sharding
from repro_torch.launch import variants as port_variants
from repro_torch.launch.sharding import Spec, to_placements, with_specs
from repro_torch.models import init_cache
from repro_torch.models.transformer import reference_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state


def _ref_dryrun():
    """The JAX package's dry-run module, imported without letting its
    512-device ``XLA_FLAGS`` reach this process's JAX backend."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return ref_dryrun


MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
DECODE = {"B": 128, "S": 32768}  # the decode_32k cell


def ref_mesh(name):
    shape = MESHES[name]
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def port_mesh(name):
    shape = MESHES[name]
    return SimpleNamespace(shape=tuple(shape.values()), mesh_dim_names=tuple(shape))


@functools.lru_cache(maxsize=None)
def ref_state(arch):
    cfg = ref_get_config(arch)
    opt = RefAdamWConfig(moment_dtype=cfg.optimizer_state_dtype,
                         factored_second_moment=cfg.optimizer_factored)
    state = jax.eval_shape(functools.partial(ref_init_train_state, cfg, opt),
                           jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: ref_init_cache(cfg, DECODE["B"], DECODE["S"]))
    return state, cache


@functools.lru_cache(maxsize=None)
def port_state(arch):
    cfg = get_config(arch)
    opt = AdamWConfig(moment_dtype=cfg.optimizer_state_dtype,
                      factored_second_moment=cfg.optimizer_factored)
    state = dryrun.shape_only(init_train_state, cfg, opt)
    cache = init_cache(cfg, DECODE["B"], DECODE["S"], device="meta")
    return state, cache


def ref_leaf_specs(spec_tree) -> list:
    return jax.tree.leaves(spec_tree, is_leaf=lambda s: isinstance(s, P))


def port_spec_of(tree, specs) -> dict:
    """Each port tensor's spec, by the tensor's identity."""
    out = {}
    with_specs(lambda t, s: out.__setitem__(id(t), s), tree, specs)
    return out


def assert_tree_specs(port_tree, port_specs, ref_tree, ref_specs):
    """Every port tensor's spec is its reference leaf's (minus the group
    entry for a group's tensor), and the leaves' shapes agree."""
    of = port_spec_of(port_tree, port_specs)
    ref_leaves = jax.tree.leaves(ref_tree)
    ref_spec_list = ref_leaf_specs(ref_specs)
    ours = reference_leaves(port_tree)
    assert len(ours) == len(ref_leaves) == len(ref_spec_list)
    for (path, tensors, stacked), leaf, spec in zip(ours, ref_leaves, ref_spec_list):
        want = tuple(spec)
        if stacked:
            assert tuple(leaf.shape) == (len(tensors), *tensors[0].shape), path
            want = want[1:]
        else:
            assert tuple(leaf.shape) == tuple(tensors[0].shape), path
        for t in tensors:
            assert isinstance(of[id(t)], Spec), path
            assert tuple(of[id(t)]) == want, (path, of[id(t)], spec)


def activate(variant):
    ref_variants.activate(variant)
    port_variants.activate(variant)


@pytest.fixture(autouse=True)
def default_variant():
    yield
    activate("default")


@pytest.mark.parametrize("variant", sorted(ref_variants.VARIANTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_specs_match_the_reference(arch, mesh_name, variant):
    activate(variant)
    cfg = get_config(arch)
    (rstate, _), (pstate, _) = ref_state(arch), port_state(arch)
    rmesh, pmesh = ref_mesh(mesh_name), port_mesh(mesh_name)
    rspecs = ref_sharding.train_state_specs(rmesh, rstate, fsdp_over_pods=cfg.fsdp_over_pods)
    pspecs = sharding.train_state_specs(pmesh, pstate, fsdp_over_pods=cfg.fsdp_over_pods)
    assert_tree_specs(pstate["params"], pspecs["params"], rstate["params"], rspecs["params"])
    for key in rstate["opt"]:
        if key == "step":
            assert tuple(pspecs["opt"]["step"]) == tuple(rspecs["opt"]["step"]) == ()
            continue
        if key == "v_c":
            continue  # the group copies of a shared v_c: below
        assert_tree_specs(pstate["opt"][key], pspecs["opt"][key],
                          rstate["opt"][key], rspecs["opt"][key])
    if "v_c" in rstate["opt"]:
        _assert_v_c(pstate, pspecs, rstate, rspecs)

    ref_bytes = _ref_dryrun().sharded_bytes(rstate, rspecs, rmesh)
    port_bytes = dryrun.sharded_bytes(pstate, pspecs, pmesh)
    assert port_bytes == ref_bytes + _shared_v_c_copies_bytes(pstate, pspecs, pmesh)


def _assert_v_c(pstate, pspecs, rstate, rspecs):
    """Factored ``v_c``: a group's matrix keeps its own row of the stacked
    leaf (spec minus the group entry); a group's 1-D tensor holds a copy of
    the one shared vector, replicated as the reference's is."""
    of = port_spec_of(pstate["opt"]["v_c"], pspecs["opt"]["v_c"])
    ref_leaves = jax.tree.leaves(rstate["opt"]["v_c"])
    ref_specs = ref_leaf_specs(rspecs["opt"]["v_c"])
    for (path, tensors, stacked), leaf, spec in zip(
            reference_leaves(pstate["opt"]["v_c"]), ref_leaves, ref_specs, strict=True):
        shared = stacked and tuple(leaf.shape) == tuple(tensors[0].shape)
        want = tuple(spec)[1:] if stacked and not shared else tuple(spec)
        for t in tensors:
            assert tuple(of[id(t)]) == want, (path, of[id(t)], spec)


def _shared_v_c_copies_bytes(pstate, pspecs, pmesh) -> int:
    """Bytes of the (groups - 1) extra copies of every shared ``v_c``."""
    if "v_c" not in pstate["opt"]:
        return 0
    extra = 0
    params = {path: tensors for path, tensors, _ in reference_leaves(pstate["params"])}
    for path, tensors, stacked in reference_leaves(pstate["opt"]["v_c"]):
        if stacked and params[path][0].dim() == 1:
            t = tensors[0]
            assert tuple(t.shape) == tuple(params[path][0].shape)
            extra += (len(tensors) - 1) * t.numel() * t.element_size()
    assert extra > 0
    return extra


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_the_reference(arch, mesh_name):
    (_, rcache), (_, pcache) = ref_state(arch), port_state(arch)
    rmesh, pmesh = ref_mesh(mesh_name), port_mesh(mesh_name)
    rspecs = ref_sharding.tree_cache_specs(rmesh, rcache)
    pspecs = sharding.tree_cache_specs(pmesh, pcache)
    assert tuple(pspecs["length"]) == tuple(rspecs["length"]) == ()
    # the blocks' layout is the stack's (prefix, groups, suffix)
    assert_tree_specs({"stack": pcache["blocks"]}, {"stack": pspecs["blocks"]},
                      {"stack": rcache["blocks"]}, {"stack": rspecs["blocks"]})
    ref_dr = _ref_dryrun()
    assert dryrun.sharded_bytes(pcache, pspecs, pmesh) == ref_dr.sharded_bytes(
        rcache, rspecs, rmesh)
    for cell in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        ins = dryrun.input_specs(arch, cell)
        ref_ins = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32) for k, v in ins.items()
                   if k != "cache"}
        ours = sharding.batch_specs(pmesh, {k: v for k, v in ins.items() if k != "cache"})
        theirs = ref_sharding.batch_specs(rmesh, ref_ins)
        assert {k: tuple(v) for k, v in ours.items()} == {k: tuple(v) for k, v in theirs.items()}


def test_param_spec_rules_on_the_ports_layout():
    """The JAX package's rule table, on port tensors (no group axis)."""
    m = port_mesh("single")
    assert sharding.param_spec(m, ["stack", "mlp", "up"], (2048, 8192)) == ("data", "model")
    # a group's tensor: the reference's (24, 2048, 2048) leaf minus its G entry
    assert sharding.param_spec(m, ["stack", "groups", "0", "0", "mixer", "wq"],
                               (2048, 2048)) == ("data", "model")
    assert sharding.param_spec(m, ["stack", "groups", "0", "0", "moe", "w_up"],
                               (256, 7168, 2048)) == ("model", "data", None)
    assert sharding.param_spec(m, ["embed"], (129280, 7168)) == ("model", "data")
    assert sharding.param_spec(m, ["stack", "norm1"], (2048,)) == ()
    pod = port_mesh("multi")
    assert sharding.param_spec(pod, ["stack", "mlp", "up"], (7168, 18432),
                               fsdp=("pod", "data")) == (("pod", "data"), "model")


@pytest.fixture(scope="module")
def fake_mesh():
    with dryrun.fake_world(4):
        from repro_torch.launch.mesh import make_debug_mesh

        yield make_debug_mesh((2, 2), device_type="cpu")


@pytest.mark.parametrize("spec", [
    Spec("data", "model"), Spec(None, "model"), Spec(("data", "model"), None),
    Spec("model", "data", None), Spec(), Spec(None, None, "data"),
])
def test_to_placements_round_trips(fake_mesh, spec):
    """A tensor distributed by ``to_placements(spec)`` on the fake (2, 2)
    mesh (every rank simulated in this process by ``LocalTensorMode``) holds
    on each rank the block the spec names, and ``full_tensor()`` gives the
    input back on every rank."""
    from torch.distributed._local_tensor import LocalTensor, LocalTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    shape = (8, 12, 4)[: max(len(spec), 2)]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    placements = to_placements(fake_mesh, spec)
    names = fake_mesh.mesh_dim_names
    for m, name in enumerate(names):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        assert placements[m] == (Shard(dims[0]) if dims else Replicate())
    with LocalTensorMode(4):
        d = distribute_tensor(x, fake_mesh, placements)
        assert tuple(d.placements) == tuple(placements)
        local, full = d.to_local(), d.full_tensor()

    def on(t, rank):  # a rank's tensor (a replicated result is one plain tensor)
        return t._local_tensors[rank] if isinstance(t, LocalTensor) else t

    for rank in range(4):
        coord = dict(zip(names, divmod(rank, 2)))
        block = x
        for i, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    block = block.tensor_split(2, dim=i)[coord[axis]]
        assert torch.equal(on(local, rank), block), rank
        assert torch.equal(on(full, rank), x), rank
