"""Dry run over a fake process group: place every (arch x shape x mesh)
cell's state as DTensors on the production mesh, run the cell's step once
without allocating anything, and record its state bytes, FLOPs, bytes
accessed, peak memory and collectives (the JAX package's
``launch/dryrun.py``, whose ``.lower().compile()`` over 512 host devices has
no torch counterpart).

How a cell runs:

* a ``"fake"`` process group of 256 (single pod) or 512 (multi-pod) ranks
  (``FakeStore``: collectives return at once and move nothing) is set up for
  the run and torn down after (:func:`fake_world`); the dry run refuses to
  start while another group is up;
* the state is built shape-only, the counterpart of
  ``jax.eval_shape(init_params)``: the port's own init on the ``meta``
  device with the random fills skipped (:func:`shape_only`), so
  deepseek-v3-671b's state costs no memory. Each tensor becomes a
  ``DTensor`` placed by ``launch/sharding.py`` whose local shard is a
  ``meta`` tensor of the shard's shape. (``FakeTensorMode`` is not used: its
  fake tensors break DTensor's propagation of strided shards, which reads a
  tensor of offsets on the host);
* the cell's step — ``make_train_step``, ``prefill`` or ``decode_step`` —
  runs once inside ``implicit_replication()`` (the models mix plain tensors,
  such as masks, positions and RoPE tables, with DTensors), under
  ``MemTracker`` and :class:`_CellCounter`, a dispatch mode that lets
  DTensor lower each op to its local ops and functional collectives first
  and then counts those: per device, as the JAX package's SPMD-partitioned
  module counts. The model kernels' wrappers take their plain versions on
  these tensors (``kernels/ops.py::_route``), as the JAX package's dry run
  lowers its jnp twins;
* ``models/hints.py`` gets the layouts ``lower_cell`` installs in the JAX
  package (sequence-sharded activations for train and prefill, the MoE
  dispatch buffers' expert-parallel pin, per ``launch/variants.py``).

A record has the reference's keys: ``static_state_bytes_per_device``;
``flops`` (by ``FlopCounterMode``'s rules: matrix products and attention,
no elementwise ops); ``bytes_accessed`` (the convention here: every local aten
op that is not a view or a collective counts the logical bytes of each
tensor it reads and each it writes, unfused, so a fused kernel on the card
moves fewer); ``memory`` (``MemTracker``'s peak over the run, the state
included) or ``memory_error``; ``collectives`` (output bytes by kind, their
``counts`` and ``total``); ``corrected``, which here is the direct count:
the port's stack is a Python loop and is counted whole, where XLA counts a
scan body once and the reference extrapolates; ``lower_s`` (building and
placing the state), ``compile_s`` (the counted run), ``ok`` and ``error``.

Usage (``--device cpu`` where there is no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \
      --cell train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --out benchmarks/results_torch
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch._guards import active_fake_mode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, get_config
from ..configs.shapes import CELLS, applicable
from ..models import decode_step, hints, init_cache, init_params, prefill
from ..obs.trace import dumps_strict
from ..optim import AdamWConfig
from ..train import TrainConfig, init_train_state, make_train_step
from ..tree import tree_leaves
from .mesh import batch_axes, make_production_mesh
from .sharding import (
    Spec,
    batch_specs,
    spec_shards,
    to_placements,
    train_state_specs,
    tree_cache_specs,
    tree_param_specs,
    with_specs,
)

__all__ = [
    "analyze",
    "collective_bytes",
    "fake_world",
    "input_specs",
    "lower_cell",
    "main",
    "record_line",
    "run_cell",
    "shape_only",
    "sharded_bytes",
]

META = torch.device("meta")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# functional-collective op names (``_c10d_functional``) by the JAX package's
# HLO kinds; DTensor's redistributions use these four
_KIND_OF = (
    ("all_reduce", "all-reduce"),
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
)


def record_line(rec: dict) -> str:
    """One dry-run result as an RFC-8259-strict JSONL line. A failed cell can
    carry non-finite timings, which bare ``json.dumps`` would emit as the
    non-standard ``Infinity`` token that strict parsers reject — route
    through the shared sanitizer instead."""
    return dumps_strict(rec) + "\n"


# ---------------------------------------------------------------------------
# the fake world and the shape-only state
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks (this process is
    rank 0) for the block; refuses to start while a group is up."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised; the dry run sets up and tears down "
            "its own fake one"
        )
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _SkipFills(TorchFunctionMode):
    """Skips the initializers' random fills: on ``meta`` they only cost."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.init.trunc_normal_:
            return args[0]
        return func(*args, **(kwargs or {}))


class _ReshardOnRefusal(TorchDispatchMode):
    """Where DTensor refuses an op it cannot propagate a sharding for (a
    (B, S, KH * D) projection sharded 16 ways viewed as KH = 8 heads, or a
    strategy that fails on the PyTorch at hand), reshard the operands over
    one mesh dim at a time and run it again, until it runs: the model dims
    first, the batch dims (``batch``) last. Over each mesh dim the shard is
    first moved to another tensor dim that the mesh dims divide, the lowest
    that lets the op run (an all-to-all; the leading dim first, nested under
    the batch shard), and only if none does gathered (an all-gather), so
    that the work stays split across the devices where it can. That is the
    resharding GSPMD inserts on its own, though GSPMD may find a cheaper
    one. Where a redistribution left a local shard in another memory order
    than the DTensor's strides say, so that a view of it fails, copy the
    shard contiguous and run the op again. The moves, gathers and copies
    are the run's and are counted; so are, for the record, the refusals
    (``refused``), the moves and gathers that made an op run, by mesh dim
    (``moved``, ``gathered``), and the copies (``copied``). A dispatch
    mode, so it reaches the backward pass and remat's recompute too."""

    def __init__(self, batch: tuple[str, ...]):
        super().__init__()
        self.batch = batch
        self.refused = 0
        self.moved: dict[str, int] = {}
        self.gathered: dict[str, int] = {}
        self.copied = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if _contiguity(e):
                self.copied += 1
                return func(*_deep(_contiguous, args), **_deep(_contiguous, kwargs))
            if not _refusal(e):
                raise
            err = e
        self.refused += 1
        mesh = _dtensors((args, kwargs))[0].device_mesh
        names = mesh.mesh_dim_names or tuple(str(m) for m in range(mesh.ndim))
        order = sorted(range(mesh.ndim), key=lambda m: (names[m] in self.batch, -m))
        gathered = []
        for m in order:
            before = _dtensors((args, kwargs))
            if not any(isinstance(t.placements[m], Shard) for t in before):
                continue
            ndim = max(t.ndim for t in before)
            for to in (*range(ndim), None):  # a tensor dim to move to, then None: gather
                fix = functools.partial(_reshard, m, to)
                tried = _deep(fix, args), _deep(fix, kwargs)
                if to is not None and all(a is b for a, b in zip(_dtensors(tried), before)):
                    continue  # no shard over m can go to that dim
                try:
                    out = func(*tried[0], **tried[1])
                except RuntimeError as e:
                    if not _refusal(e):
                        raise
                    err = e
                    continue
                for n in gathered + ([] if to is not None else [names[m]]):
                    self.gathered[n] = self.gathered.get(n, 0) + 1
                if to is not None:
                    self.moved[names[m]] = self.moved.get(names[m], 0) + 1
                return out
            args, kwargs = tried  # gathered over m; go on to the next mesh dim
            gathered.append(names[m])
        raise err

    def record(self) -> dict:
        """The record's ``reshard``: ``refused``, ``moved`` and ``gathered``
        by mesh dim, ``copied``, and ``batch_gathered``, the gathers over a
        batch dim (the batch then replicated, the counts no longer split)."""
        return {"refused": self.refused, "moved": dict(self.moved),
                "gathered": dict(self.gathered), "copied": self.copied,
                "batch_gathered": sum(n for d, n in self.gathered.items() if d in self.batch)}


def _refusal(e: RuntimeError) -> bool:
    """DTensor's "Sharding propagation failed ..." or "... redistribute the
    input first" (worded differently by PyTorch version)."""
    return "Sharding propagation failed" in str(e) or "redistribut" in str(e)


def _contiguity(e: RuntimeError) -> bool:
    return "view size is not compatible" in str(e)


def _dtensors(tree) -> list[DTensor]:
    if isinstance(tree, DTensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _dtensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _dtensors(x)]
    return []


def _deep(fix, tree):
    """``fix`` over the DTensors of an op's arguments, lists included (the
    indices of ``index_put``)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_deep(fix, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _deep(fix, v) for k, v in tree.items()}
    return fix(tree)


def _contiguous(x):
    """A DTensor whose local shard is contiguous, as its strides say;
    anything else as it is."""
    if not isinstance(x, DTensor) or x._local_tensor.is_contiguous():
        return x
    return DTensor.from_local(x._local_tensor.contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def _reshard(m: int, to: int | None, x):
    """``x`` with its ``Shard`` on mesh dim ``m`` moved to tensor dim
    ``to`` (nested under any other mesh dim sharding it), or made
    ``Replicate`` when ``to`` is None; a DTensor, its local shard
    contiguous. Anything else, or a shard that cannot go to ``to`` (its own
    dim, or one the mesh dims would not divide evenly), as it is."""
    if not isinstance(x, DTensor) or not isinstance(x.placements[m], Shard):
        return x
    mesh, placements = x.device_mesh, list(x.placements)
    if to is None:
        placements[m] = Replicate()
    else:
        ways = math.prod(mesh.size(i) for i, p in enumerate(placements)
                         if i != m and isinstance(p, Shard) and p.dim == to)
        if to >= x.ndim or placements[m].dim == to or x.shape[to] % (ways * mesh.size(m)):
            return x
        placements[m] = Shard(to)
    return _contiguous(x.redistribute(mesh, placements))


def shape_only(fn, *args, **kwargs):
    """``fn`` (an init taking ``generator`` and ``device``) on the ``meta``
    device with its random fills skipped: the state's shapes and dtypes,
    nothing allocated."""
    with _SkipFills():
        return fn(*args, generator=torch.Generator(), device=META, **kwargs)


def input_specs(arch: str, cell_name: str, cfg=None) -> dict:
    """``meta`` tensors for every model input of this (arch, cell)."""
    cfg = cfg or get_config(arch)
    cell = CELLS[cell_name]
    B = cell.global_batch
    s_text = cell.seq_len - (cfg.frontend_tokens if cfg.frontend else 0)

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    if cell.kind in ("train", "prefill"):
        out = {"tokens": sds((B, s_text), torch.int32)}
        if cell.kind == "train":
            out["labels"] = sds((B, s_text), torch.int32)
        if cfg.frontend:
            out["frontend_embeds"] = sds((B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        return out
    if cell.kind == "decode":
        cache = init_cache(cfg, B, cell.seq_len, device=META)
        return {"tokens": sds((B, 1), torch.int32), "cache": cache}
    raise ValueError(cell.kind)


def _opt_cfg(cfg) -> AdamWConfig:
    return AdamWConfig(
        moment_dtype=cfg.optimizer_state_dtype,
        factored_second_moment=cfg.optimizer_factored,
    )


def sharded_bytes(shape_tree, spec_tree, mesh) -> int:
    """Static per-device bytes of a sharded tree (params/opt/cache)."""
    sizes = with_specs(
        lambda t, spec: t.numel() * t.element_size() // max(spec_shards(mesh, spec), 1),
        shape_tree, spec_tree)
    return sum(tree_leaves(sizes))


def _place(mesh, tensor: torch.Tensor, spec: Spec) -> DTensor:
    """A ``DTensor`` of ``tensor``'s global shape placed by ``spec``, its
    local shard a ``meta`` tensor (every sharded dim divides evenly)."""
    local = list(tensor.shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            local[i] //= spec_shards(mesh, Spec(entry))
    shard = torch.empty(local, dtype=tensor.dtype, device=META)
    out = DTensor.from_local(shard, mesh, to_placements(mesh, spec), run_check=False,
                             shape=tensor.shape, stride=tensor.stride())
    return out.requires_grad_() if tensor.requires_grad else out


def _place_tree(mesh, tree, specs):
    return with_specs(lambda t, spec: _place(mesh, t, spec), tree, specs)


# ---------------------------------------------------------------------------
# lowering: the placed state and the step that runs on it
# ---------------------------------------------------------------------------
def _install_hints(mesh, kind: str) -> None:
    from . import variants

    b = batch_axes(mesh)
    act = (mesh, to_placements(mesh, Spec(b, "model", None)))
    use_act = kind in ("train", "prefill") and variants.KNOBS["act_sharding"] == "seq"
    hints.set_activation_sharding(act if use_act else None)
    moe = (mesh, to_placements(mesh, Spec(b, "model", None, None)))
    hints.set_moe_sharding(moe if variants.KNOBS["moe_constraints"] else None)


def lower_cell(arch: str, cell_name: str, mesh, cfg=None):
    """Returns ``(run, aux)``: ``run()`` takes the cell's step once on the
    placed state; ``aux`` holds ``static_state_bytes_per_device`` and the
    placed state. ``cfg`` overrides the registered config."""
    cfg = cfg or get_config(arch)
    cell = CELLS[cell_name]
    ins = input_specs(arch, cell_name, cfg)
    _install_hints(mesh, cell.kind)

    if cell.kind == "train":
        opt_cfg = _opt_cfg(cfg)
        state_shapes = shape_only(init_train_state, cfg, opt_cfg)
        st_specs = train_state_specs(mesh, state_shapes, fsdp_over_pods=cfg.fsdp_over_pods)
        state = _place_tree(mesh, state_shapes, st_specs)
        batch = _place_tree(mesh, ins, batch_specs(mesh, ins))
        step = make_train_step(cfg, opt_cfg, TrainConfig())
        aux = {"static_state_bytes_per_device": sharded_bytes(state_shapes, st_specs, mesh)}
        return (lambda: step(state, batch)), dict(aux, state=state)

    params_shapes = shape_only(init_params, cfg)
    p_specs = tree_param_specs(mesh, params_shapes, fsdp_over_pods=cfg.fsdp_over_pods)
    params = _place_tree(mesh, params_shapes, p_specs)
    static_bytes = sharded_bytes(params_shapes, p_specs, mesh)

    if cell.kind == "prefill":
        batch = _place_tree(mesh, ins, batch_specs(mesh, ins))
        aux = {"static_state_bytes_per_device": static_bytes}
        return (lambda: prefill(params, cfg, batch["tokens"], batch.get("frontend_embeds"))), \
            dict(aux, state=params)

    # decode
    cache_shapes = ins["cache"]
    c_specs = tree_cache_specs(mesh, cache_shapes)
    cache = _place_tree(mesh, cache_shapes, c_specs)
    tokens = _place(mesh, ins["tokens"], batch_specs(mesh, {"tokens": ins["tokens"]})["tokens"])
    static_bytes += sharded_bytes(cache_shapes, c_specs, mesh)
    aux = {"static_state_bytes_per_device": static_bytes}
    return (lambda: decode_step(params, cfg, cache, tokens)), dict(aux, state=(params, cache))


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------
def _kind(op_name: str) -> str | None:
    for prefix, kind in _KIND_OF:
        if op_name.startswith(prefix):
            return kind
    return None


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _logical_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CellCounter(TorchDispatchMode):
    """Counts the local ops DTensor lowers each op to (returning
    ``NotImplemented`` for a DTensor op lets DTensor run first; its local
    ops and collectives come back here): their FLOPs by
    ``FlopCounterMode``'s rules (``torch.utils.flop_counter.flop_registry``),
    their bytes and the collectives' bytes. Only the cell's own ops count:
    ops on ``meta`` tensors outside a fake mode. DTensor's sharding
    propagation runs ops of its own, under a nested fake mode and on host
    tensors, the first time it meets an op; ``FlopCounterMode`` entered
    around the run counts those too (up to 1.39x the smoke prefill's FLOPs,
    by how cold the propagation cache is)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if active_fake_mode() is not None or not any(
                t.device.type == "meta" for t in (*ins, *outs)):
            return out
        ns = getattr(func, "namespace", "")
        name = getattr(func, "__name__", str(func)).split(".")[0]
        if ns == "_c10d_functional":
            kind = _kind(name)
            if kind is not None:
                self.collectives.append((kind, sum(_logical_bytes(t) for t in outs)))
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if not getattr(func, "is_view", False):
            self.bytes_accessed += sum(_logical_bytes(t) for t in (*ins, *outs))
        return out


def collective_bytes(events) -> dict:
    """Sum the output bytes of each collective, by kind, from ``(kind,
    bytes)`` pairs; ``counts`` a kind, ``total`` over the kinds."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in events:
        out[kind] += nbytes
        counts[kind] += 1
    out["counts"] = counts
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def analyze(run, state=None, batch: tuple[str, ...] = ()) -> dict:
    """Run the cell once under the counters; returns the record's
    ``flops``, ``bytes_accessed``, ``memory`` (or ``memory_error``),
    ``collectives`` and ``reshard`` (what :class:`_ReshardOnRefusal` did;
    ``batch`` names the mesh's batch dims)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    counter = _CellCounter()
    reshard = _ReshardOnRefusal(batch)
    mem = MemTracker()
    info: dict = {}
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(state)]
    try:
        mem.track_external(*local)
        mem_cm = mem
    except Exception as e:  # noqa: BLE001 - the record says why memory is missing
        info["memory_error"] = f"{type(e).__name__}: {e}"
        mem_cm = contextlib.nullcontext()
    with implicit_replication(), mem_cm, counter, reshard:
        run()
    info["flops"] = float(counter.flops)
    info["bytes_accessed"] = float(counter.bytes_accessed)
    if "memory_error" not in info:
        try:
            peak = mem.get_tracker_snapshot("peak")
            by_kind: dict = {}
            for per_device in peak.values():
                for kind, nbytes in per_device.items():
                    key = getattr(kind, "value", str(kind))
                    by_kind[key] = by_kind.get(key, 0) + int(nbytes)
            info["memory"] = {
                "peak_bytes": by_kind.pop("Total", sum(by_kind.values())),
                "by_kind": by_kind,
            }
        except Exception as e:  # noqa: BLE001
            info["memory_error"] = f"{type(e).__name__}: {e}"
    info["collectives"] = collective_bytes(counter.collectives)
    info["reshard"] = reshard.record()
    return info


def run_cell(arch: str, cell_name: str, mesh, mesh_name: str) -> dict:
    """One cell's record; a cell that fails records ``ok: false`` and its
    error. ``corrected`` is the direct count (the Python-loop stack is
    counted whole). A cell whose refused ops had to gather a batch dim
    fails: its counts are then those of a replicated batch, not the
    reference's per-device ones."""
    t0 = time.perf_counter()
    rec: dict = {"arch": arch, "cell": cell_name, "mesh": mesh_name}
    try:
        run, aux = lower_cell(arch, cell_name, mesh)
        t1 = time.perf_counter()
        state = aux.pop("state")
        info = analyze(run, state, batch_axes(mesh))
        t2 = time.perf_counter()
        rec.update(aux)
        rec.update(info)
        rec["corrected"] = {
            "flops": info["flops"],
            "bytes_accessed": info["bytes_accessed"],
            "collectives": {k: info["collectives"][k] for k in (*COLLECTIVES, "total")},
        }
        rec["lower_s"] = round(t1 - t0, 1)
        rec["compile_s"] = round(t2 - t1, 1)
        n = info["reshard"]["batch_gathered"]
        if n:
            raise RuntimeError(f"{n} refused ops gathered a batch dim: the counts are not "
                               "per-device ones")
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - a failed cell is a record, as in the reference
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        hints.set_activation_sharding(None)
        hints.set_moe_sharding(None)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--cell", choices=list(CELLS))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="benchmarks/results_torch")
    ap.add_argument("--resume", action="store_true", help="skip cells already recorded")
    ap.add_argument("--device", default="cuda", help="the mesh's device type: cuda or cpu")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]]
    if args.all:
        cells = [(a, c) for a in ARCH_IDS for c in CELLS if applicable(a, c)]
    else:
        if not (args.arch and args.cell):
            ap.error("--arch/--cell or --all")
        if not applicable(args.arch, args.cell):
            print(f"SKIP {args.arch} x {args.cell}: inapplicable (sub-quadratic only)")
            return
        cells = [(args.arch, args.cell)]

    names = [n for n in ("single", "multi") if args.mesh in (n, "both")]
    os.makedirs(args.out, exist_ok=True)
    for mesh_name in names:
        multi = mesh_name == "multi"
        path = os.path.join(args.out, f"dryrun_{mesh_name}.jsonl")
        done = set()
        if args.resume and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["cell"]))
        with fake_world(math.prod((2, 16, 16) if multi else (16, 16))), open(path, "a") as f:
            mesh = make_production_mesh(multi_pod=multi, device_type=args.device)
            for arch, cell in cells:
                if (arch, cell) in done:
                    print(f"[{mesh_name}] {arch} x {cell}: already done")
                    continue
                rec = run_cell(arch, cell, mesh, mesh_name)
                tb = rec.pop("traceback", None)
                if rec["ok"]:
                    print(
                        f"[{mesh_name}] {arch} x {cell}: OK lower={rec['lower_s']}s "
                        f"run={rec['compile_s']}s flops={rec['flops']:.3e} "
                        f"coll={rec['collectives']['total']:.3e}B"
                    )
                else:
                    print(f"[{mesh_name}] {arch} x {cell}: FAIL ({rec.get('error')})")
                    print(tb)
                f.write(record_line(rec))
                f.flush()


if __name__ == "__main__":
    main()
