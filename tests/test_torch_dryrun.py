"""The port's dry run (``repro_torch.launch.dryrun``) over a fake process
group, its mesh helpers, the variant knobs and the model hints, held to the
JAX package where it has a counterpart.

* every smoke config's train, prefill and decode cells run ``ok`` on a fake
  (2, 2) debug mesh at ``--device cpu``, MoE included, and leave no group up;
* prefill FLOPs lie within a stated band of the JAX package's
  scan-corrected ``cost_analysis`` FLOPs (``FlopCounterMode``'s rules count
  products and attention; XLA counts the elementwise ops too);
* the (1, 1) mesh's static training-state bytes equal the bytes of a real
  state the port's trainer builds;
* ``record_line`` writes strict JSON; ``input_specs`` matches the JAX
  package's shapes and dtypes; the CLI writes records;
* the hints are no-ops with nothing installed and redistribute a DTensor to
  the installed layout otherwise; the variant knobs reset as the JAX
  package's do;
* a refused op moves its shard to another dim before it gathers, and a cell
  whose refused ops gather the batch fails; the kernel wrappers take the
  plain versions on ``meta`` shards and launch nothing.

The per-device counts on a sharded mesh: ``test_torch_dryrun_sharded.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.configs import ARCH_IDS
from repro.configs import shapes as ref_shapes
from repro_torch.configs import get_config
from repro_torch.configs.shapes import CELLS, ShapeCell
from repro_torch.launch import dryrun, variants
from repro_torch.launch.mesh import batch_axes, make_debug_mesh, make_production_mesh
from repro_torch.models import hints
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = [f"{a}-smoke" for a in ARCH_IDS]
# cells cut to smoke size, registered beside the reference's for a test:
# the dry run's cost is the number of ops it places, not their size, but
# the CPU pays for each op's propagation
SMOKE_CELLS = {
    "train": ShapeCell("train_smoke", "train", 64, 4),
    "prefill": ShapeCell("prefill_smoke", "prefill", 64, 4),
    "decode": ShapeCell("decode_smoke", "decode", 64, 4),
}
PREFILL_B2 = ShapeCell("prefill_b2", "prefill", 64, 2)
# port prefill FLOPs over the JAX package's scan-corrected ones at B=2,
# S=64 on a (1, 1) mesh, read on this CPU: attention models 0.900-0.927
# (internlm2-1.8b-smoke 0.924), the SSM hybrids lower (zamba2-7b-smoke
# 0.733, rwkv6-3b-smoke 0.863), whose scans the JAX package's count fills
# with elementwise FLOPs that FlopCounterMode's rules leave out
FLOP_BAND = (0.88, 0.95)
FLOP_BAND_SSM = (0.70, 0.90)
SSM = ("zamba2-7b-smoke", "rwkv6-3b-smoke")


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


@pytest.fixture(autouse=True)
def smoke_cells(monkeypatch):
    for cell in (*SMOKE_CELLS.values(), PREFILL_B2):
        monkeypatch.setitem(CELLS, cell.name, cell)


@pytest.fixture
def debug_mesh():
    with dryrun.fake_world(4):
        yield make_debug_mesh((2, 2), device_type="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_cells_run_ok(debug_mesh, arch):
    for kind, cell in SMOKE_CELLS.items():
        rec = dryrun.run_cell(arch, cell.name, debug_mesh, "debug")
        assert rec["ok"], (kind, rec.get("error"), rec.get("traceback"))
        assert rec["cell"] == cell.name and rec["mesh"] == "debug"
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0, kind
        assert rec["static_state_bytes_per_device"] > 0, kind
        assert rec["memory"]["peak_bytes"] >= rec["static_state_bytes_per_device"], kind
        coll = rec["collectives"]
        assert coll["total"] == sum(coll[k] for k in dryrun.COLLECTIVES)
        assert rec["corrected"]["flops"] == rec["flops"]
        assert rec["reshard"]["batch_gathered"] == 0, kind
        assert json.loads(dryrun.record_line(rec))["ok"] is True
    assert hints._ACTIVATION_SHARDING is None and hints._MOE_SHARDING is None


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_flops_within_band_of_the_reference(arch, monkeypatch):
    ref_dr = _ref_dryrun()
    from repro.launch.mesh import make_debug_mesh as ref_debug_mesh

    monkeypatch.setitem(ref_shapes.CELLS, PREFILL_B2.name,
                        ref_shapes.ShapeCell(*dataclasses.astuple(PREFILL_B2)))
    ref = ref_dr._scan_corrected(arch, PREFILL_B2.name, ref_debug_mesh())
    if ref:
        want = ref["corrected"]["flops"]
    else:  # no pattern groups: nothing to correct
        lowered, _ = ref_dr.lower_cell(arch, PREFILL_B2.name, ref_debug_mesh())
        want = ref_dr.analyze(lowered, lowered.compile())["flops"]
    with dryrun.fake_world(1):
        rec = dryrun.run_cell(arch, PREFILL_B2.name, make_debug_mesh((1, 1), device_type="cpu"),
                              "debug")
    assert rec["ok"], rec.get("error")
    lo, hi = FLOP_BAND_SSM if arch in SSM else FLOP_BAND
    assert lo <= rec["flops"] / want <= hi, (rec["flops"], want)


def test_static_bytes_equal_the_trainers_state():
    """On a (1, 1) mesh the dry run's static training-state bytes are the
    bytes of the state ``init_train_state`` builds (params, AdamW moments,
    steps), exactly."""
    arch = "internlm2-1.8b-smoke"
    cfg = get_config(arch)
    state = init_train_state(cfg, AdamWConfig(moment_dtype=cfg.optimizer_state_dtype,
                                              factored_second_moment=cfg.optimizer_factored),
                             0, device="cpu")
    real = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    with dryrun.fake_world(1):
        mesh = make_debug_mesh((1, 1), device_type="cpu")
        _, aux = dryrun.lower_cell(arch, SMOKE_CELLS["train"].name, mesh)
    assert aux["static_state_bytes_per_device"] == real


def test_fake_world_refuses_a_live_group_and_tears_down():
    with dryrun.fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(4):
                pass
        with pytest.raises(RuntimeError, match="need 256 ranks"):
            make_production_mesh(device_type="cpu")
    assert not dist.is_initialized()
    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert batch_axes(mesh) == ("pod", "data")
        assert batch_axes(make_production_mesh(device_type="cpu")) == ("data",)
    assert not dist.is_initialized()


def test_input_specs_match_the_reference():
    ref_dr = _ref_dryrun()
    for arch in ARCH_IDS:
        for cell in ref_shapes.CELLS:
            ours, theirs = dryrun.input_specs(arch, cell), ref_dr.input_specs(arch, cell)
            assert sorted(ours) == sorted(theirs)
            for key in ours:
                if key == "cache":
                    continue  # the cache leaves: tests/test_torch_sharding.py
                assert tuple(ours[key].shape) == tuple(theirs[key].shape), (arch, cell, key)
                assert str(ours[key].dtype).split(".")[-1] == str(theirs[key].dtype), key
            assert all(t.device.type == "meta" for t in tree_leaves(ours))


def test_record_line_is_strict_json():
    rec = {"arch": "x", "ok": False, "compile_s": float("inf"), "flops": float("nan"),
           "nested": {"lower_s": float("-inf")}}
    line = dryrun.record_line(rec)
    assert line.endswith("\n")
    assert "Infinity" not in line and "NaN" not in line
    back = json.loads(line)
    assert back["compile_s"] is None and back["flops"] is None
    assert back["nested"]["lower_s"] is None
    ok = {"arch": "x", "ok": True, "compile_s": 1.25}
    assert json.loads(dryrun.record_line(ok)) == ok


def test_collective_bytes_sums_by_kind():
    out = dryrun.collective_bytes([("all-gather", 100), ("all-reduce", 8), ("all-gather", 4)])
    assert out["all-gather"] == 104 and out["counts"]["all-gather"] == 2
    assert out["all-reduce"] == 8 and out["reduce-scatter"] == 0
    assert out["total"] == 112
    assert set(out["counts"]) == set(dryrun.COLLECTIVES)


def test_a_failing_cell_is_a_record(debug_mesh, monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError("no such layout")

    monkeypatch.setattr(dryrun, "lower_cell", broken)
    rec = dryrun.run_cell("internlm2-1.8b-smoke", "prefill_smoke", debug_mesh, "debug")
    assert rec["ok"] is False and rec["error"] == "ValueError: no such layout"
    assert "traceback" in rec


def test_cli_writes_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-3b",
           "--cell", "long_500k", "--device", "cpu", "--out", str(tmp_path)]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = (tmp_path / "dryrun_single.jsonl").read_text().splitlines()
    rec = json.loads(lines[0])
    assert rec["ok"] and rec["arch"] == "rwkv6-3b" and rec["mesh"] == "single"
    for key in ("static_state_bytes_per_device", "flops", "bytes_accessed", "memory",
                "collectives", "corrected", "lower_s", "compile_s"):
        assert key in rec, key
    res = subprocess.run([*cmd, "--resume"], capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert "already done" in res.stdout
    skip = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
            "--cell", "long_500k", "--device", "cpu", "--out", str(tmp_path)]
    res = subprocess.run(skip, capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0 and "SKIP" in res.stdout


# ---------------------------------------------------------------------------
# variants and hints
# ---------------------------------------------------------------------------
def test_variants_reset_between_activations():
    from repro.launch import variants as ref_variants

    assert variants.VARIANTS == ref_variants.VARIANTS
    assert variants._DEFAULTS == ref_variants._DEFAULTS
    variants.activate("no-act-sharding")
    assert variants.KNOBS["act_sharding"] == "none"
    variants.activate("baseline")
    assert variants.KNOBS["act_sharding"] == "seq"
    assert variants.KNOBS["moe_constraints"] is False
    variants.activate("default")
    assert variants.KNOBS["moe_constraints"] is True


def test_hints_noop_when_unset():
    hints.set_activation_sharding(None)
    hints.set_moe_sharding(None)
    x = torch.ones((2, 4, 8))
    assert hints.constrain_activation(x) is x
    b = torch.ones((2, 4, 8, 16))
    assert hints.constrain_moe_buffer(b) is b


def test_hints_leave_plain_tensors_and_3d_buffers(debug_mesh):
    layout = (debug_mesh, [Shard(0), Shard(1)])
    hints.set_moe_sharding(layout)
    hints.set_activation_sharding(layout)
    try:
        x = torch.ones((4, 4, 8))
        assert hints.constrain_activation(x) is x  # not a DTensor
        d3 = distribute_tensor(torch.ones((4, 4, 8)), debug_mesh, [Replicate(), Replicate()])
        assert hints.constrain_moe_buffer(d3) is d3  # the pin is for 4-D buffers
    finally:
        hints.set_moe_sharding(None)
        hints.set_activation_sharding(None)


def test_hints_redistribute_a_dtensor(debug_mesh):
    d = distribute_tensor(torch.ones((4, 8, 6)), debug_mesh, [Replicate(), Replicate()])
    with hints.activation_sharding((debug_mesh, [Shard(0), Shard(1)])):
        out = hints.constrain_activation(d)
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert hints.constrain_activation(out) is out  # already there
        # a dim the mesh does not divide stays whole (a decode group of one)
        odd = distribute_tensor(torch.ones((1, 8, 6)), debug_mesh, [Replicate(), Replicate()])
        assert tuple(hints.constrain_activation(odd).placements) == (Replicate(), Shard(1))
    assert hints._ACTIVATION_SHARDING is None


def test_activation_context_manager_restores():
    hints.set_activation_sharding(None)
    with hints.activation_sharding("something"):
        assert hints._ACTIVATION_SHARDING == "something"
    x = torch.ones((2, 2, 2))
    assert hints.constrain_activation(x) is x


def test_dry_run_takes_the_plain_kernels_on_dtensors(debug_mesh):
    """The kernel wrappers route a ``meta`` tensor, and so a DTensor whose
    shards are ``meta`` tensors (the dry run's), to the plain version, as
    the JAX package's dry run lowers its jnp twins, and count no launch; a
    DTensor on the CPU takes the plain version as a CPU tensor does."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rwkv6, ssd

    counters = (fa.flash_attention_hsd, ssd.ssd_scan_hsd, rwkv6.rwkv6_scan_hsd)
    for c in counters:
        c.launches = 0
    rep = [Replicate(), Replicate()]

    def meta_dtensor(*shape):
        return DTensor.from_local(torch.empty(shape, device="meta"), debug_mesh, rep,
                                  run_check=False)

    q = torch.empty((1, 16, 2, 8), device="meta")
    assert ops.flash_attention(q, q, q).shape == q.shape
    with implicit_replication():
        dq = meta_dtensor(1, 16, 2, 8)
        out = ops.flash_attention(dq, dq, dq)
        assert isinstance(out, DTensor) and out.to_local().device.type == "meta"
        x = meta_dtensor(1, 16, 2, 8)
        y = ops.ssd_scan(x, meta_dtensor(1, 16, 2), meta_dtensor(2), meta_dtensor(1, 16, 4),
                         meta_dtensor(1, 16, 4), chunk=8)
        assert isinstance(y, DTensor) and tuple(y.shape) == (1, 16, 2, 8)
        w = ops.rwkv6_scan(x, x, x, x, meta_dtensor(2, 8))
        assert isinstance(w, DTensor) and tuple(w.shape) == (1, 16, 2, 8)
        cq = distribute_tensor(torch.randn(1, 16, 2, 8), debug_mesh, rep)
        assert isinstance(ops.flash_attention(cq, cq, cq), DTensor)
    assert [c.launches for c in counters] == [0, 0, 0]


# ---------------------------------------------------------------------------
# resharding a refused op, and per-device counts on a sharded mesh
# ---------------------------------------------------------------------------
def _refused_view(mesh, shape, placements, view):
    """``x.view(view)`` of a meta-shard DTensor of ``shape`` placed by
    ``placements``, under the dry run's resharding; returns the output and
    the record of what the resharding did."""
    local = list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(m)
    x = DTensor.from_local(torch.empty(local, device="meta"), mesh, placements,
                           run_check=False, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    mode = dryrun._ReshardOnRefusal(batch_axes(mesh))
    with mode:
        out = x.view(view)
    return out, mode.record()


def test_a_refused_view_moves_its_shard_before_it_gathers(debug_mesh):
    """(B, S, KH * D) sharded over ``model`` on its last dim, viewed as
    KH = 3 heads, which ``model`` does not divide: the resharding moves the
    ``model`` shard to the lowest dim that takes it, the batch dim, nested
    under the batch shard, so the work stays split."""
    out, rec = _refused_view(debug_mesh, (4, 8, 12), [Shard(0), Shard(2)], (4, 8, 3, 4))
    assert tuple(out.shape) == (4, 8, 3, 4)
    assert tuple(out.placements) == (Shard(0), Shard(0))
    assert tuple(out.to_local().shape) == (1, 8, 3, 4)
    assert rec == {"refused": 1, "moved": {"model": 1}, "gathered": {}, "copied": 0, "local": 0,
                   "batch_gathered": 0}
    # a batch of 2 cannot take both shards: the sequence dim does
    out, rec = _refused_view(debug_mesh, (2, 8, 12), [Shard(0), Shard(2)], (2, 8, 3, 4))
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert rec["moved"] == {"model": 1} and rec["gathered"] == {}


def test_a_refused_view_gathers_where_its_shard_cannot_move(debug_mesh):
    out, rec = _refused_view(debug_mesh, (2, 6), [Shard(0), Shard(1)], (2, 3, 2))
    assert tuple(out.shape) == (2, 3, 2)
    assert out.placements[0] == Shard(0)
    assert rec["gathered"] == {"model": 1} and rec["batch_gathered"] == 0


def test_a_cell_that_gathers_its_batch_fails(debug_mesh, monkeypatch):
    """A refused op that only runs with its batch dim gathered replicates
    the batch: the record's counts are not per-device ones, so the cell
    fails, and says why."""
    _, rec = _refused_view(debug_mesh, (6,), [Shard(0), Replicate()], (3, 2))
    assert rec["batch_gathered"] == 1 and rec["gathered"] == {"data": 1}

    real = dryrun.analyze

    def gathering(run, state=None, batch=()):
        info = real(run, state, batch)
        info["reshard"] = dict(info["reshard"], batch_gathered=3)
        return info

    monkeypatch.setattr(dryrun, "analyze", gathering)
    bad = dryrun.run_cell("internlm2-1.8b-smoke", "prefill_smoke", debug_mesh, "debug")
    assert bad["ok"] is False and "3 refused ops gathered a batch dim" in bad["error"]


# ---------------------------------------------------------------------------
# the peak from the cell's local ops, and ops without a DTensor strategy
# ---------------------------------------------------------------------------
def test_the_peak_counts_the_cells_local_ops(debug_mesh):
    """``memory`` is the most the state's local shards and the cell's local
    ops held at once: a tensor of DTensor's propagation (under a nested fake
    mode) and a host tensor are not the cell's and do not count, as PyTorch
    2.11's ``MemTracker`` counted the first."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def meta(*local):  # f32 shards of (2 * local[0], ...) split over "data"
        return DTensor.from_local(torch.empty(local, device="meta"), debug_mesh,
                                  [Shard(0), Replicate()], run_check=False)

    state = {"w": meta(8, 16), "x": meta(4, 16)}  # 512 + 256 bytes a device

    def run():
        y = state["x"] * 2.0  # 256 bytes
        z = (y + 1.0) * y  # 256 and 256, the first freed after the product
        del y
        with FakeTensorMode():
            torch.empty(1 << 20)  # a propagation tensor
        torch.ones(1 << 20)  # a host tensor
        return z

    info = dryrun.analyze(run, state, ("data",))
    assert info["memory"]["by_kind"] == {"state": 768, "ops": 768}
    assert info["memory"]["peak_bytes"] == 1536


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1, 1) mesh over a real one-rank ``gloo`` group: values move."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _without_strategy(monkeypatch, op):
    """``op`` as on a PyTorch whose DTensor has no strategy for it."""
    prop = DTensor._op_dispatcher.sharding_propagator
    tables = [t for t in vars(prop).values() if isinstance(t, dict) and op in t]
    assert tables, op
    for t in tables:
        monkeypatch.delitem(t, op)


def test_flip_without_a_strategy_runs_shard_by_shard(one_rank_mesh, monkeypatch):
    """PyTorch 2.11's DTensor has no strategy for ``aten.flip`` (the backward
    of ``cumsum``): the dry run flips each local shard, after moving a shard
    off a flipped dim, and gives the flip's values."""
    _without_strategy(monkeypatch, torch.ops.aten.flip.default)
    data = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    x = distribute_tensor(data, one_rank_mesh, [Shard(0), Shard(2)])
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        x.flip([2])
    mode = dryrun._ReshardOnRefusal(("data",))
    with mode:
        out = x.flip([-1])
    assert torch.equal(out.full_tensor(), data.flip([2]))
    assert out.placements[1] != Shard(2)
    rec = mode.record()
    assert rec["local"] == 1 and rec["refused"] == 1 and rec["moved"] == {"model": 1}
    assert rec["batch_gathered"] == 0
