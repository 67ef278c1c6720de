"""The port's data pipeline, checkpointing and fault-tolerance logic against
the JAX package's, on the CPU: the same batches bit for bit, the checkpoint
format each package reads from the other, and the same host-side
decisions."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.train as jtrain
import repro_torch.data as tdata
import repro_torch.train as ttrain
from repro.train import fault_tolerance as jft
from repro_torch.train import fault_tolerance as tft

CASES = [  # (seed, step, host, n_hosts, frontend tokens)
    (0, 0, 0, 1, 0), (0, 7, 0, 1, 0), (3, 2, 1, 2, 0), (5, 11, 3, 4, 8), (2**20, 123, 0, 1, 4),
]


def _dcfg(pkg, seed, host, n_hosts, frontend):
    return pkg.DataConfig(vocab=1000, global_batch=8, seq_len=96, seed=seed, doc_len=32,
                          frontend_tokens=frontend, d_model=16 if frontend else 0,
                          n_hosts=n_hosts, host_id=host)


@pytest.mark.parametrize("seed,step,host,n_hosts,frontend", CASES)
def test_synthetic_batch_matches_reference(seed, step, host, n_hosts, frontend):
    want = jdata.synthetic_batch(_dcfg(jdata, seed, host, n_hosts, frontend), step)
    got = tdata.synthetic_batch(_dcfg(tdata, seed, host, n_hosts, frontend), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("frontend_embeds" in got) == bool(frontend)


def test_prefetcher_gives_the_reference_stream():
    """The background prefetcher over ``data_iterator`` from step 5 yields
    the reference's batches of steps 5, 6, ... in order."""
    cfg = _dcfg(tdata, 1, 0, 1, 0)
    pre = tdata.Prefetcher(tdata.data_iterator(cfg, 5), depth=2)
    try:
        for step in range(5, 11):
            got = next(pre)
            want = jdata.synthetic_batch(_dcfg(jdata, 1, 0, 1, 0), step)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
    finally:
        pre.close()


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "embed": torch.randn(16, 8, generator=g).to(torch.bfloat16).requires_grad_(),
        "stack": {"groups": [({"norm1": torch.randn(8, generator=g)},),
                             ({"norm1": torch.randn(8, generator=g)},)],
                  "shared_attn": None},
        "step": torch.tensor(3, dtype=torch.int32),
    }


def _equal(a, b) -> None:
    for (pa, x), (pb, y) in zip(ttrain.checkpoint.tree_paths(a), ttrain.checkpoint.tree_paths(b)):
        assert pa == pb and x.dtype == y.dtype and x.requires_grad == y.requires_grad, pa
        assert torch.equal(x.detach(), y.detach()), pa


def test_checkpoint_round_trip_with_bf16_leaves(tmp_path):
    """bf16, f32 and int32 leaves come back bit for bit, in the structure,
    dtypes and requires_grad of ``like``; ``meta.json`` and the COMPLETE flag
    are written."""
    tree = _tree()
    path = ttrain.save(str(tmp_path), 3, tree)
    assert path.endswith(os.path.join("step_00000003", "shard_0.ckpt"))
    assert os.path.exists(tmp_path / "step_00000003" / "COMPLETE")
    assert os.path.exists(tmp_path / "step_00000003" / "meta.json")
    like = ttrain.checkpoint.tree_map_with_path(lambda _, t: torch.zeros_like(t), tree)
    like["embed"].requires_grad_()
    _equal(ttrain.restore(str(tmp_path), 3, like), tree)


def test_latest_step_ignores_an_incomplete_snapshot(tmp_path):
    ttrain.save(str(tmp_path), 2, _tree())
    ttrain.save(str(tmp_path), 4, _tree())
    os.remove(tmp_path / "step_00000004" / "COMPLETE")  # a crash before the flag
    os.makedirs(tmp_path / "step_00000009")  # a crash before anything
    assert ttrain.latest_step(str(tmp_path)) == 2
    assert ttrain.latest_step(str(tmp_path / "missing")) is None


def test_restore_rejects_a_shape_mismatch_and_a_missing_leaf(tmp_path):
    ttrain.save(str(tmp_path), 1, _tree())
    like = _tree()
    like["embed"] = torch.zeros(16, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        ttrain.restore(str(tmp_path), 1, like)
    like = _tree()
    like["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="missing"):
        ttrain.restore(str(tmp_path), 1, like)


def test_async_checkpointer_snapshots_before_the_next_step(tmp_path):
    """``save`` copies the tree before returning: a later in-place update does
    not reach the snapshot; ``wait`` joins the writer."""
    tree = _tree()
    ck = ttrain.AsyncCheckpointer(str(tmp_path))
    ck.save(5, tree)
    want = ttrain.checkpoint.tree_map_with_path(lambda _, t: t.detach().clone(), tree)
    with torch.no_grad():
        tree["stack"]["groups"][0][0]["norm1"].add_(1.0)
    ck.wait()
    assert ttrain.latest_step(str(tmp_path)) == 5
    got = ttrain.restore(str(tmp_path), 5, want)
    _equal(got, want)


def test_checkpoint_format_is_the_reference_format(tmp_path):
    """A flat tree of f32, int32 and bf16 leaves written by either package
    reads back in the other bit for bit: the same paths, dtype names, bytes
    and layout."""
    g = torch.Generator().manual_seed(1)
    tree = {"a": torch.randn(4, 3, generator=g), "b": [torch.arange(5, dtype=torch.int32)],
            "c": torch.randn(6, generator=g).to(torch.bfloat16)}
    ttrain.save(str(tmp_path / "port"), 1, tree)
    jlike = {"a": jnp.zeros((4, 3), jnp.float32), "b": [jnp.zeros((5,), jnp.int32)],
             "c": jnp.zeros((6,), jnp.bfloat16)}
    back = jtrain.restore(str(tmp_path / "port"), 1, jlike)
    np.testing.assert_array_equal(np.asarray(back["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(back["b"][0]), tree["b"][0].numpy())
    np.testing.assert_array_equal(np.asarray(back["c"]).view(np.uint16),
                                  tree["c"].view(torch.int16).numpy().view(np.uint16))
    jtrain.save(str(tmp_path / "jax"), 1, back)
    like = {"a": torch.zeros(4, 3), "b": [torch.zeros(5, dtype=torch.int32)],
            "c": torch.zeros(6, dtype=torch.bfloat16)}
    _equal(ttrain.restore(str(tmp_path / "jax"), 1, like), tree)


def test_heartbeat_monitor_matches_reference():
    hosts = [f"h{i}" for i in range(5)]
    mons = [pkg.HeartbeatMonitor(hosts, timeout=10.0) for pkg in (jft, tft)]
    beats = [("h0", 3.0), ("h1", 5.0), ("h3", 12.0), ("h9", 4.0), ("h0", 14.0)]
    for host, now in beats:
        for m in mons:
            m.beat(host, now)
    for now in (5.0, 13.0, 16.0, 30.0):
        assert mons[0].dead(now) == mons[1].dead(now)
        assert mons[0].alive(now) == mons[1].alive(now)


@pytest.mark.parametrize("chips,kw", [
    (512, {}), (500, {}), (300, {}), (255, {}), (64, dict(model_parallel=8)),
    (1000, dict(chips_per_pod=128, model_parallel=4)), (40, dict(min_data=2)),
])
def test_plan_elastic_remesh_matches_reference(chips, kw):
    want = jft.plan_elastic_remesh(chips, **kw)
    got = tft.plan_elastic_remesh(chips, **kw)
    assert (got.data, got.model, got.pods, got.dropped_chips, got.chips) == (
        want.data, want.model, want.pods, want.dropped_chips, want.chips)


def test_plan_elastic_remesh_refuses_too_few_chips():
    for pkg in (jft, tft):
        with pytest.raises(ValueError, match="cannot build a mesh"):
            pkg.plan_elastic_remesh(8, model_parallel=16)


def test_straggler_policy_matches_reference():
    pols = [jft.StragglerPolicy(patience=2), tft.StragglerPolicy(patience=2)]
    events = [(0, True), (1, True), (0, True), (2, False), (1, False), (3, True), (3, True)]
    for shard, late in events:
        for p in pols:
            p.observe(shard, late)
        assert pols[0].skip_set() == pols[1].skip_set()
        assert pols[0].grad_scale(8) == pols[1].grad_scale(8)
    for p in pols:
        with pytest.raises(RuntimeError, match="participation"):
            p.grad_scale(4)


def test_reshard_like_moves_and_checks_shapes():
    tree = {"a": torch.ones(2, 3), "b": [torch.zeros(4)]}
    like = {"a": torch.empty(2, 3, device="meta"), "b": [torch.empty(4, device="meta")]}
    out = tft.reshard_like(tree, like)
    assert out["a"].device.type == "meta" and out["b"][0].shape == (4,)
    with pytest.raises(ValueError, match="shape"):
        tft.reshard_like(tree, {"a": torch.empty(3, 2), "b": [torch.empty(4)]})
