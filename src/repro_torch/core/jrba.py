"""JRBA — Joint Routing and Bandwidth Allocation (paper Algorithm 2), PyTorch.

The paper relaxes P3 (route + bandwidth per flow, min of max V_i/b_i) to the
convex program P3-RELAX-CVX (Eqs. 10-14) and solves it with an off-the-shelf
convex optimizer, then rounds (k* = argmax_k m_i^k) and recovers bandwidths
via Eq. 15.

Eliminating ``q_i`` at its optimum (q_i = V_i: shrinking q only loosens
Eq. 11) leaves the classic *maximum concurrent flow / minimum congestion* LP:

    min_{w_i in simplex}  max_l ( sum_i V_i w_i^k [l in P_i^k] / B_l )

It is solved natively in PyTorch: Adam on per-flow path logits against a
temperature-annealed logsumexp smoothing of the max. Rounding and Eq. 15
follow the paper verbatim; the optional water-filling top-up (beyond-paper,
see DESIGN.md §4) redistributes capacity stranded by Eq. 15 and is reported
separately.

Three solver formulations share that math (``SOLVERS``):

* **dense** — the reference: a ``(Nf, K, L)`` usage contraction per Adam
  step, autograd gradient, fixed ``n_iters`` schedule. Kept as the
  cross-check oracle.
* **sparse** — the plain-PyTorch twin of the production path (its code sits
  beside the kernel's wrapper, in ``repro_torch.kernels.jrba_congestion``,
  because it sums in the kernel's order): each candidate
  path crosses only a handful of links, so the congestion vector is
  supported on the *active link set* (every link on any candidate path,
  derived from the padded path->link index tensor ``FlowProgram.link_idx``).
  The solver runs on tensors compressed to ``La_pad`` active-link slots
  (power-of-two bucketed; the L - La_pad inactive links contribute exactly
  ``exp(-max_c/tau)`` each to the softmax denominator, folded in as one
  scalar correction, so the objective equals the dense one), with a
  hand-fused gradient (no autograd tape) and a convergence-adaptive
  schedule: the tau anneal runs in chunks and a lane exits once its
  rounding is stable and its exact span plateaus.
* **cuda** — the same sparse math as one hand-written CUDA kernel launch per
  batch (``repro_torch.kernels.jrba_congestion``): one thread block per lane
  runs the whole chunk schedule, early exit included, on the card.

``JRBAEngine`` runs on an explicit device (CUDA unless the caller passes
``device="cpu"``) and picks the formulation from it (``solver="auto"``: the
CUDA kernel on a CUDA device, the sparse twin on the CPU;
``REPRO_TORCH_JRBA_SOLVER`` overrides). It adds a per-program tensor cache so
repeated solves of the same flow set — the OTFS re-solve loop — rebuild
nothing and re-upload only capacity.

All solver arithmetic is float32. The anneal schedule is float32
``geomspace(1, 1e-3, n)``, computed in float64 and rounded once.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import os
import time
import weakref
from typing import Sequence

import numpy as np
import torch

from .graph import Flow, NetworkGraph
from .paths import k_shortest_paths, path_link_index, path_links
from ..obs.trace import NULL_TRACER

__all__ = [
    "EngineStats",
    "FlowProgram",
    "JRBAEngine",
    "JRBAResult",
    "build_program",
    "solve_relaxation",
    "solve_relaxation_batch",
    "solve_relaxation_sparse",
    "solve_relaxation_sparse_batch",
    "jrba",
    "link_load_fits",
    "water_fill",
    "brute_force_span",
]

SOLVERS = ("dense", "sparse", "cuda")
NEG_INF = -1e9


def resolve_solver(solver: str = "auto", device: str | torch.device = "cuda") -> str:
    """Map ``"auto"`` (after the ``REPRO_TORCH_JRBA_SOLVER`` env override) to
    the formulation for ``device``: the CUDA kernel on a CUDA device, the
    plain sparse twin on the CPU. The choice follows the caller's device,
    never whether a card happens to be present. ``"cuda"`` on a CPU device
    raises; ``"sparse"`` on a CUDA device is the plain version on the card."""
    dev = torch.device(device)
    if solver == "auto":
        solver = os.environ.get("REPRO_TORCH_JRBA_SOLVER", "auto")
    if solver == "auto":
        solver = "cuda" if dev.type == "cuda" else "sparse"
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {('auto', *SOLVERS)}")
    if solver == "cuda" and dev.type != "cuda":
        raise ValueError(f"solver 'cuda' needs a CUDA device, got {dev}")
    return solver


def resolve_device(device: str | torch.device) -> torch.device:
    """The solver device, checked: a CUDA device without a usable card raises
    instead of quietly running on the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "JRBA solver asked for a CUDA device but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain solver on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported solver device {dev}; use 'cuda' or 'cpu'")
    return dev


@functools.lru_cache(maxsize=32)
def _schedule(n_iters: int) -> np.ndarray:
    """Per-step constants ``(n_iters, 3)`` f32: the anneal temperature tau
    and Adam's two bias corrections ``1 - beta^(t+1)``. Read-only (cached)."""
    taus = np.geomspace(1.0, 1e-3, n_iters).astype(np.float32)
    t1 = np.arange(1, n_iters + 1, dtype=np.float32)
    one = np.float32(1.0)
    bc1 = one - np.power(np.float32(0.9), t1)
    bc2 = one - np.power(np.float32(0.999), t1)
    out = np.stack([taus, bc1, bc2], axis=1).astype(np.float32)
    out.setflags(write=False)
    return out


def _schedule_tensor(n_iters: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_schedule(n_iters).copy()).to(device)


def _clamp_capacity(net: NetworkGraph, capacity: np.ndarray | None) -> np.ndarray:
    """Solver-facing capacity vector: f32, floored at 1e-9. One definition,
    shared by :func:`build_program` and the engine's program-cache hit path —
    the OTFS speculation staleness check (``online.spec_exact``) compares
    residuals through this exact clamp, so the two construction paths must
    never diverge."""
    cap = (net.capacity if capacity is None else capacity).astype(np.float32)
    return np.maximum(cap, 1e-9)


def _link_slots(ridx: np.ndarray, la_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-link slot lists (CSR) of the active-compressed index tensor.
    ``slot[ptr[l]:ptr[l+1]]`` are the flattened ``i*K + k`` path slots that
    cross active link ``l``, ascending; sentinel entries are dropped. The
    CUDA kernel sums link loads in exactly this order, so the scatter needs
    no atomics and its result does not depend on thread timing."""
    nf, k, p = ridx.shape
    flat = ridx.reshape(nf * k * p)
    order = np.argsort(flat, kind="stable")
    order = order[flat[order] < la_pad]
    counts = np.bincount(flat[order], minlength=la_pad)
    ptr = np.zeros(la_pad + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(counts)
    return ptr, (order // p).astype(np.int32)


@dataclasses.dataclass
class FlowProgram:
    """Tensorized P3 instance over K candidate paths per flow.

    Rows may be padded with zero-volume dummy flows (``n_real`` marks the
    real prefix) so the solver sees shape-stable inputs and programs with
    different flow counts stack into one batch.

    Alongside the dense ``usage`` tensor the program carries the sparse
    formulation: ``link_idx`` (the padded path->link index tensor), the
    active link set, the active-compressed usage/index tensors the sparse
    solver consumes, and the per-link slot lists the CUDA kernel scatters
    through. Everything except ``capacity``, ``volumes`` and ``flows``
    depends only on topology + candidate paths, so the engine's program
    cache shares these tensors (and their device mirrors in ``dev``) across
    every re-solve of the same flow set."""

    usage: np.ndarray  # (Nf, K, L) 0/1 — path k of flow i crosses link l
    valid: np.ndarray  # (Nf, K) bool
    volumes: np.ndarray  # (Nf,)
    capacity: np.ndarray  # (L,)
    paths: list[list[list[int]]]  # node paths, paths[i][k]
    flows: list[Flow]
    n_real: int
    link_idx: np.ndarray  # (Nf, K, Pmax) int32; padding slots hold L
    active_links: np.ndarray  # (La,) int32 — links on any candidate path
    usage_active: np.ndarray  # (Nf, K, La_pad) — usage gathered to active slots
    ridx: np.ndarray  # (Nf, K, Pmax) int32 remapped to [0, La_pad]
    csr_ptr: np.ndarray  # (La_pad + 1,) int32 — per-link offsets into csr_slot
    csr_slot: np.ndarray  # (nnz,) int32 — flattened i*K + k slots, by link
    # lazily-populated device mirrors of the solve-invariant tensors above,
    # keyed by (name, device); shared (same dict object) across
    # cache-replayed copies of this program
    dev: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def device(self, name: str, device: torch.device) -> torch.Tensor:
        """Device-resident mirror of a solve-invariant tensor, uploaded once
        per program signature and device (not once per solve)."""
        key = (name, str(device))
        arr = self.dev.get(key)
        if arr is None:
            arr = self.dev[key] = torch.from_numpy(getattr(self, name)).to(device)
        return arr

    @property
    def la_pad(self) -> int:
        return self.usage_active.shape[-1]

    def capacity_active(self) -> np.ndarray:
        """Current capacity gathered to the active-link slots (padding slots
        get capacity 1 and zero usage, i.e. exactly zero congestion)."""
        cap = np.ones(self.la_pad, dtype=np.float32)
        cap[: len(self.active_links)] = self.capacity[self.active_links]
        return cap


def build_program(
    net: NetworkGraph,
    flows: list[Flow],
    *,
    k: int = 4,
    capacity: np.ndarray | None = None,
    pad: bool = True,
    pad_to: int | None = None,
    path_cache: dict | None = None,
) -> FlowProgram | None:
    """Enumerate P_i^k and build the (Nf, K, L) usage tensor. Colocated flows
    (src == dst) never reach here — they cost nothing and are dropped by the
    allocator. Returns None when Nf == 0. ``pad_to`` pins the padded row count
    to an exact bucket size (used by the batched engine so instances with
    different flow counts stack into one tensor). ``path_cache`` memoizes
    Yen's enumeration per (src, dst) — sound because candidate paths depend
    only on topology and static bandwidth, not on residual capacity."""
    flows = [f for f in flows if f.src != f.dst and f.volume > 0]
    if not flows:
        return None
    L = len(net.links)
    all_paths: list[list[list[int]]] = []
    for f in flows:
        key = (f.src, f.dst, k)
        ps = None if path_cache is None else path_cache.get(key)
        if ps is None:
            ps = k_shortest_paths(net, f.src, f.dst, k)
            if path_cache is not None:
                path_cache[key] = ps
        all_paths.append(ps)
    n_real = len(flows)
    if pad_to is not None:
        if pad_to < n_real:
            raise ValueError(f"pad_to={pad_to} < {n_real} real flows")
        Nf = pad_to
    else:
        Nf = -(-n_real // 8) * 8 if pad else n_real  # round up to a multiple of 8
    usage = np.zeros((Nf, k, L), dtype=np.float32)
    valid = np.zeros((Nf, k), dtype=bool)
    valid[n_real:, 0] = True  # dummies: one no-op path
    for i, ps in enumerate(all_paths):
        for kk, path in enumerate(ps[:k]):
            valid[i, kk] = True
            for l in path_links(net, path):
                usage[i, kk, l] = 1.0
    volumes = np.zeros((Nf,), dtype=np.float32)
    volumes[:n_real] = [f.volume for f in flows]
    cap = _clamp_capacity(net, capacity)
    # sparse formulation: padded path->link index tensor + active-link
    # compression (see module docstring). La pads to a power of two (capped
    # at L) so the solver sees O(log L) distinct shapes.
    link_idx = path_link_index(net, all_paths, k=k, rows=Nf)
    active = np.unique(link_idx[link_idx < L]).astype(np.int32)
    la = int(active.size)
    la_pad = 8
    while la_pad < la:
        la_pad *= 2
    la_pad = min(la_pad, L)
    remap = np.full(L + 1, la_pad, dtype=np.int32)
    remap[active] = np.arange(la, dtype=np.int32)
    usage_active = np.zeros((Nf, k, la_pad), dtype=np.float32)
    usage_active[:, :, :la] = usage[:, :, active]
    ridx = remap[link_idx]
    csr_ptr, csr_slot = _link_slots(ridx, la_pad)
    return FlowProgram(
        usage=usage,
        valid=valid,
        volumes=volumes,
        capacity=cap,
        paths=all_paths,
        flows=flows,
        n_real=n_real,
        link_idx=link_idx,
        active_links=active,
        usage_active=usage_active,
        ridx=ridx,
        csr_ptr=csr_ptr,
        csr_slot=csr_slot,
    )


# ---------------------------------------------------------------------------
# The PyTorch solvers for P3-RELAX-CVX
# ---------------------------------------------------------------------------
def _mask(valid: torch.Tensor) -> torch.Tensor:
    """0 on valid paths, -1e9 on invalid ones (f32)."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def _adam(logits, m, v, g, row, lr):
    """One Adam step (0.9/0.999/1e-8); ``row`` holds (tau, 1-0.9^t, 1-0.999^t)."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mh = m / row[1]
    vh = v / row[2]
    return logits - lr * mh / (torch.sqrt(vh) + 1e-8), m, v


@torch.no_grad()
def _solve_md_batched(
    usage: torch.Tensor,  # (B, Nf, K, L)
    valid: torch.Tensor,  # (B, Nf, K)
    volumes: torch.Tensor,  # (B, Nf)
    capacity: torch.Tensor,  # (B, L) — per-instance (OTFS solves on residuals)
    n_iters: int = 400,
    lr: float = 0.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B independent dense relaxations; returns ``(w, relaxed_span)``: w is
    the per-flow path distribution, relaxed_span the exact (unsmoothed)
    congestion ``max_l load_l/B_l`` of w. The lanes share no term, so one
    summed objective gives every lane its own gradient."""
    B, Nf, K, L = usage.shape
    mask = _mask(valid)
    u2 = usage.reshape(B, Nf * K, L)

    def congestion(w):
        load = torch.bmm((volumes[:, :, None] * w).reshape(B, 1, Nf * K), u2)
        return load.reshape(B, L) / capacity

    sched = _schedule_tensor(n_iters, usage.device)
    logits = torch.zeros_like(mask)
    m = torch.zeros_like(mask)
    v = torch.zeros_like(mask)
    for t in range(n_iters):
        tau = sched[t, 0]
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            c = congestion(torch.softmax(lg + mask, dim=-1))
            obj = (tau * torch.logsumexp(c / tau, dim=-1)).sum()
            (g,) = torch.autograd.grad(obj, lg)
        logits, m, v = _adam(logits, m, v, g, sched[t], lr)
    w = torch.softmax(logits + mask, dim=-1)
    return w, congestion(w).amax(-1)


# ---------------------------------------------------------------------------
# Sparse congestion solver: active-link compression + fused gradient +
# convergence-adaptive chunked schedule
# ---------------------------------------------------------------------------
def probe_schedule(n_iters: int) -> tuple[int, int]:
    """Chunk layout ``(n_chunks, chunk_steps)`` for the adaptive solver: the
    most chunks (<= 16) that divide ``n_iters`` evenly while keeping >= 25
    steps per chunk — the granularity the early-exit criterion was validated
    at. A run that never converges walks every chunk and matches the dense
    schedule step for step (best case: ``(stable_chunks + 1) * chunk_steps``
    steps)."""
    best = 1
    for c in range(1, min(16, n_iters) + 1):
        if n_iters % c == 0 and n_iters // c >= 25:
            best = c
    return best, n_iters // best


def _converged(ci_next, stable, span, prev_span, span_rtol, min_chunks, stable_chunks):
    """Chunk-boundary early-exit criterion, shared by the plain sparse solver
    (``kernels/jrba_congestion.py``) and, in C, by the CUDA kernel — the two
    must agree on when a solve is allowed to stop or they would round
    differently. Elementwise over lanes:
    converged iff enough chunks ran, the argmax rounding was stable for
    ``stable_chunks`` consecutive boundaries, and the exact span plateaued
    within ``span_rtol``."""
    plateau = (span - prev_span).abs() <= span_rtol * span.clamp_min(1e-12)
    return plateau & (stable >= stable_chunks) & (ci_next >= min_chunks)


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


def solve_relaxation(
    prog: FlowProgram, *, n_iters: int = 400, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, float]:
    """Solve P3-RELAX-CVX densely; returns (m_i^k = V_i w_i^k, relaxed span TH*)."""
    dev = resolve_device(device)
    w, span = _solve_md_batched(
        prog.device("usage", dev)[None],
        prog.device("valid", dev)[None],
        prog.device("volumes", dev)[None],
        torch.from_numpy(prog.capacity).to(dev)[None],
        n_iters=n_iters,
    )
    w, span = _to_host(w[0], span[0])
    return w * prog.volumes[:, None], float(span)


def _sparse_solver(backend: str):
    """The sparse lane solver for ``backend``, a solver name: ``"cuda"`` is
    the CUDA kernel, ``"sparse"`` its plain PyTorch version; both take the
    same inputs."""
    from ..kernels import jrba_congestion as jc

    if backend == "cuda":
        return jc.sparse_congestion_solve
    if backend == "sparse":
        return jc.sparse_congestion_plain
    raise ValueError(f"unknown sparse backend {backend!r}; 'sparse' or 'cuda'")


def _solver_kwargs(n_iters, early_exit, span_rtol, stable_chunks) -> dict:
    return dict(
        n_iters=n_iters, early_exit=early_exit, span_rtol=span_rtol, stable_chunks=stable_chunks
    )


def solve_relaxation_sparse(
    prog: FlowProgram,
    *,
    n_iters: int = 400,
    early_exit: bool = True,
    span_rtol: float = 2e-2,
    stable_chunks: int = 2,
    backend: str = "sparse",
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, float, int]:
    """Sparse solve of one program; returns ``(m, relaxed_span, steps)``.

    ``backend="cuda"`` runs the CUDA kernel (a CUDA ``device`` only);
    ``"sparse"`` is its plain version. Both consume the program's
    device-memoized solve-invariant tensors — only capacity is uploaded per
    solve. The B == 1 lane of the batched solver IS the scalar path, so
    scalar and batched solves share one code path."""
    dev = resolve_device(device)
    solver = _sparse_solver(backend)
    cap_a = torch.from_numpy(prog.capacity_active()).to(dev)
    n_out = torch.tensor([len(prog.capacity) - prog.la_pad], dtype=torch.float32, device=dev)
    w, span, steps = solver(
        prog.device("ridx", dev)[None],
        prog.device("valid", dev)[None],
        prog.device("volumes", dev)[None],
        cap_a[None],
        n_out,
        prog.device("csr_ptr", dev)[None],
        prog.device("csr_slot", dev),
        **_solver_kwargs(n_iters, early_exit, span_rtol, stable_chunks),
    )
    w, span, steps = _to_host(w[0], span[0], steps[0])
    return w * prog.volumes[:, None], float(span), int(steps)


def _stacked_csr(progs: list[FlowProgram]) -> tuple[np.ndarray, np.ndarray]:
    """Batch the per-program slot lists: one flat slot array and per-lane
    pointer rows shifted to absolute offsets into it."""
    ptrs, off = [], 0
    for p in progs:
        ptrs.append(p.csr_ptr + np.int32(off))
        off += len(p.csr_slot)
    return np.stack(ptrs), np.concatenate([p.csr_slot for p in progs])


def sparse_batch_inputs(progs: list[FlowProgram], device: torch.device) -> list[torch.Tensor]:
    """The batched sparse solver's positional inputs on ``device``: ridx,
    valid, volumes, active capacity, the inactive-link counts and the
    stacked slot lists. Programs must share the (Nf, K, La_pad, Pmax)
    bucket."""
    shapes = {p.ridx.shape + (p.la_pad,) for p in progs}
    if len(shapes) != 1:
        raise ValueError(f"programs span multiple sparse buckets: {sorted(shapes)}")

    # host-side stack + one upload per operand: stacking device-resident
    # mirrors costs a launch per operand, which for these small tensors is
    # slower than the copy (the device memo pays off on the scalar paths)
    def up(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    ptr, slot = _stacked_csr(progs)
    return [
        up([p.ridx for p in progs]),
        up([p.valid for p in progs]),
        up([p.volumes for p in progs]),
        up([p.capacity_active() for p in progs]),
        up([np.float32(len(p.capacity) - p.la_pad) for p in progs]),
        torch.from_numpy(ptr).to(device),
        torch.from_numpy(slot).to(device),
    ]


def solve_relaxation_sparse_batch(
    progs: list[FlowProgram],
    *,
    n_iters: int = 400,
    early_exit: bool = True,
    span_rtol: float = 2e-2,
    stable_chunks: int = 2,
    backend: str = "sparse",
    device: str | torch.device = "cuda",
) -> list[tuple[np.ndarray, float, int]]:
    """Sparse twin of :func:`solve_relaxation_batch`; one batched call (one
    kernel launch for ``backend="cuda"``) for N same-bucket programs (see
    :func:`sparse_batch_inputs`), one device sync for all results."""
    dev = resolve_device(device)
    solver = _sparse_solver(backend)
    args = sparse_batch_inputs(progs, dev)
    w, spans, steps = solver(*args, **_solver_kwargs(n_iters, early_exit, span_rtol, stable_chunks))
    w, spans, steps = _to_host(w, spans, steps)
    return [
        (w[i] * p.volumes[:, None], float(spans[i]), int(steps[i]))
        for i, p in enumerate(progs)
    ]


def solve_relaxation_batch(
    progs: list[FlowProgram], *, n_iters: int = 400, device: str | torch.device = "cuda"
) -> list[tuple[np.ndarray, float]]:
    """Solve N same-shape programs densely in one batched call.

    All programs must already be padded to a common (Nf, K, L) bucket (the
    engine guarantees this); raises on shape mismatch rather than silently
    re-padding, so callers control bucketing policy."""
    shapes = {p.usage.shape for p in progs}
    if len(shapes) != 1:
        raise ValueError(f"programs span multiple shape buckets: {sorted(shapes)}")
    dev = resolve_device(device)

    def up(arrays):
        return torch.from_numpy(np.stack(arrays)).to(dev)

    w, spans = _solve_md_batched(
        up([p.usage for p in progs]),
        up([p.valid for p in progs]),
        up([p.volumes for p in progs]),
        up([p.capacity for p in progs]),
        n_iters=n_iters,
    )
    w, spans = _to_host(w, spans)
    return [(w[i] * p.volumes[:, None], float(spans[i])) for i, p in enumerate(progs)]


# ---------------------------------------------------------------------------
# Rounding + Eq. 15 + (beyond-paper) water-filling
# ---------------------------------------------------------------------------
def _eq15_bandwidth(sel_usage: np.ndarray, volumes: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    """Paper Eq. 15: on each link, capacity splits across crossing flows in
    proportion to volume; a flow gets the min share along its route.
    Vectorized masked min (it runs on every finalize): flows crossing no
    link get an infinite share, matching the per-flow loop it replaced."""
    crossing = sel_usage.T @ volumes  # (L,) total volume through each link
    with np.errstate(divide="ignore", invalid="ignore"):
        share = np.where(crossing > 0, capacity / crossing, np.inf)  # (L,) per-unit-volume
    row_share = np.where(sel_usage > 0, share[None, :], np.inf).min(axis=1, initial=np.inf)
    return (volumes * row_share).astype(np.float64)


def water_fill(
    sel_usage: np.ndarray, volumes: np.ndarray, capacity: np.ndarray
) -> np.ndarray:
    """Weighted (by V_i) max-min progressive filling on fixed routes.

    Level 1 equals Eq. 15 at the global bottleneck (so the paper-faithful
    span is preserved); later levels lift flows Eq. 15 leaves stranded,
    which raises *per-job* throughput in multi-job rounds (OTFA+WF)."""
    Nf = len(volumes)
    rate = np.zeros(Nf)
    frozen = np.zeros(Nf, dtype=bool)
    residual = capacity.astype(np.float64).copy()
    for _ in range(Nf + 1):
        if frozen.all():
            break
        active_vol = sel_usage.T @ (volumes * ~frozen)  # (L,)
        # links carrying at least one active flow constrain the increment
        constrained = active_vol > 1e-12
        if not constrained.any():
            break
        theta = np.min(residual[constrained] / active_vol[constrained])
        theta = max(theta, 0.0)
        rate[~frozen] += theta * volumes[~frozen]
        residual -= theta * active_vol
        saturated = constrained & (residual <= 1e-9 * np.maximum(capacity, 1e-12))
        hit = (sel_usage[:, saturated].sum(axis=1) > 0) & ~frozen
        if not hit.any():  # numerical guard
            break
        frozen |= hit
    return rate


@dataclasses.dataclass
class JRBAResult:
    routes: list[list[int]]  # chosen node path per flow
    bandwidth: np.ndarray  # b_i per flow
    span: float  # exact max_i V_i / b_i under the rounded solution
    relaxed_span: float  # LP lower-bound certificate (TH of the relaxation)
    flows: list[Flow]
    link_load: np.ndarray  # consumed bandwidth per link
    # links on ANY candidate path of ANY real flow — the solver's output is a
    # function of capacity on exactly these links (zero-usage links contribute
    # exact zeros to the congestion vector), so speculative intra-round
    # batching can accept a stale solve whenever the residual is unchanged on
    # this mask (see OnlineScheduler's repair pass)
    candidate_links: np.ndarray | None = None

    @property
    def throughput_bound(self) -> float:
        return 1.0 / self.span if self.span > 0 else float("inf")


def link_load_fits(
    link_load: np.ndarray, residual: np.ndarray, *, rel_eps: float = 1e-9
) -> bool:
    """Overcommit detector: does ``link_load`` fit within ``residual`` on every
    link? The speculative OTFS repair pass runs this before committing an
    accepted solve, so a bad speculation can never oversubscribe a link; tests
    craft deliberate two-job conflicts against it."""
    slack = rel_eps * np.maximum(np.abs(residual), 1.0)
    return bool(np.all(link_load <= residual + slack))


def _greedy_ks(prog: FlowProgram) -> np.ndarray:
    """Deterministic sequential rounding start: flows in volume-descending
    order (stable sort — deterministic on ties) each take the path that
    minimizes the resulting link congestion given the flows already placed.
    A pure function of the program — no solver output involved — so every
    solver formulation derives the identical start from the same program."""
    Nf, K, L = prog.usage.shape
    ks = np.zeros(Nf, dtype=np.int64)
    load = np.zeros(L)
    for i in np.argsort(-prog.volumes, kind="stable"):
        cand = load[None, :] + prog.usage[i] * prog.volumes[i]  # (K, L)
        cong = np.max(cand / prog.capacity[None, :], axis=1)
        cong = np.where(prog.valid[i], cong, np.inf)
        ks[i] = int(np.argmin(cong))
        load = load + prog.usage[i, ks[i]] * prog.volumes[i]
    return ks


def _rounding_span(prog: FlowProgram, ks: np.ndarray) -> float:
    """Exact congestion span of a rounded route choice (the quantity the
    refinement minimizes) — pure numpy on program tensors, so identical
    across solver formulations."""
    Nf = prog.usage.shape[0]
    sel = prog.usage[np.arange(Nf), ks]
    return float(np.max((sel.T @ prog.volumes) / prog.capacity))


def _round_and_refine(prog: FlowProgram, m: np.ndarray) -> np.ndarray:
    """Solver-robust rounding: best-response sweeps from a deterministic
    portfolio of starts, with the relaxation's argmax start consulted last.

    On symmetric programs — a job's parallel flows between one node pair,
    the common shape in scheduler streams — the relaxed optimum splits each
    flow near-uniformly across its candidate paths, so per-flow
    ``argmax_k m_i^k`` is numerical noise: two numerically different solver
    trajectories (dense vs sparse, scalar vs batched) land on different
    all-same-path vertices and the sweeps repair them into *different* local
    optima. The portfolio makes rounding start-independent exactly there:
    sweep from the greedy sequential start and from every uniform all-k
    start (both pure functions of the program), keep the best, and let the
    argmax start win only when *strictly* better. Any all-same-path argmax
    vertex is already in the portfolio, so in the degenerate regime every
    formulation returns the identical (and never worse) solution — the
    property the churn benchmark asserts as zero record deviation."""
    Nf, K = prog.valid.shape
    first_valid = np.argmax(prog.valid, axis=1)
    best_ks: np.ndarray | None = None
    best = np.inf
    starts = [_greedy_ks(prog)]
    for k in range(K):
        starts.append(np.where(prog.valid[:, k], k, first_valid).astype(np.int64))
    seen: list[np.ndarray] = []
    for start in starts:
        if any(np.array_equal(start, s) for s in seen):
            continue  # duplicate start -> identical sweep; skip the chain
        seen.append(start)
        ks = _best_response_sweeps(prog, start)
        span = _rounding_span(prog, ks)
        if span < best:
            best_ks, best = ks, span
    start_w = np.argmax(np.where(prog.valid, m, -1.0), axis=1)
    if any(np.array_equal(start_w, s) for s in seen):
        # the argmax start is one of the portfolio starts (the degenerate
        # all-same-path case): its sweep was already scored into best_ks
        return best_ks
    ks_w = _best_response_sweeps(prog, start_w)
    return ks_w if _rounding_span(prog, ks_w) < best else best_ks


def _best_response_sweeps(
    prog: FlowProgram, ks: np.ndarray, *, sweeps: int = 5
) -> np.ndarray:
    """Vertex-recovery refinement after argmax rounding.

    The paper rounds ``k* = argmax_k m_i^k`` from a *simplex* LP solution,
    which sits on a vertex (near-integral y). The Adam solver converges to
    interior points of the optimal face, where argmax can pick a congested
    path (e.g. it loses Fig. 2(f)). Best-response sweeps — each flow re-picks
    the path minimizing the resulting congestion with the others fixed —
    monotonically reduce the span and recover vertex quality.
    """
    Nf, K, L = prog.usage.shape
    order = np.argsort(-prog.volumes)
    load = prog.usage[np.arange(Nf), ks].T @ prog.volumes  # (L,)
    for _ in range(sweeps):
        changed = False
        for i in order:
            load = load - prog.usage[i, ks[i]] * prog.volumes[i]
            cand = load[None, :] + prog.usage[i] * prog.volumes[i]  # (K, L)
            cong = np.max(cand / prog.capacity[None, :], axis=1)
            cong = np.where(prog.valid[i], cong, np.inf)
            new_k = int(np.argmin(cong))
            if new_k != ks[i]:
                ks[i] = new_k
                changed = True
            load = load + prog.usage[i, ks[i]] * prog.volumes[i]
        if not changed:
            break
    return ks


def _finalize(
    prog: FlowProgram,
    m: np.ndarray,
    relaxed: float,
    *,
    water_filling: bool = False,
    refine: bool = True,
) -> JRBAResult:
    """Rounding (k* = argmax), vertex-recovery refinement, Eq. 15 bandwidth
    recovery and the optional water-filling top-up — the host-side half of
    Algorithm 2, shared by the single and batched solve paths. With
    ``refine`` the rounding runs through the start-portfolio refinement
    (:func:`_round_and_refine`), which is deterministic across solver
    formulations on degenerate symmetric programs."""
    if refine:
        ks = _round_and_refine(prog, m)
    else:
        ks = np.argmax(np.where(prog.valid, m, -1.0), axis=1)  # k* = argmax_k m_i^k
    n = prog.n_real  # drop shape-padding dummies
    sel_usage = prog.usage[np.arange(n), ks[:n]]  # (n_real, L)
    vols = prog.volumes[:n]
    b = _eq15_bandwidth(sel_usage, vols, prog.capacity)
    if water_filling:
        b = np.maximum(b, water_fill(sel_usage, vols, prog.capacity))
    # a real flow with no candidate path (its endpoints are partitioned by
    # link/node failures) has an all-zero usage row, which Eq. 15 would read
    # as "crosses no link" and award infinite bandwidth; it is unroutable, so
    # it gets zero bandwidth and drives the span infinite until the network
    # heals and the scheduler re-solves
    has_path = prog.valid[:n].any(axis=1)
    b = np.where(has_path, b, 0.0)
    with np.errstate(divide="ignore"):
        span = float(np.max(np.where(b > 0, vols / b, np.inf)))
    routes = [prog.paths[i][int(ks[i])] if has_path[i] else [] for i in range(n)]
    link_load = sel_usage.T @ b
    return JRBAResult(
        routes=routes,
        bandwidth=b,
        span=span,
        relaxed_span=relaxed,
        flows=prog.flows,
        link_load=link_load,
        candidate_links=(prog.usage > 0).any(axis=(0, 1)),
    )


def jrba(
    net: NetworkGraph,
    flows: list[Flow],
    *,
    k: int = 4,
    capacity: np.ndarray | None = None,
    n_iters: int = 400,
    water_filling: bool = False,
    refine: bool = True,
    solver: str = "auto",
    device: str | torch.device = "cuda",
) -> JRBAResult | None:
    """Algorithm 2. ``capacity`` overrides link capacity (the online scheduler
    passes residual capacity for OTFS and full capacity for OTFA re-runs).
    ``solver`` follows the engine's resolution for ``device``; pass
    ``"dense"`` for the reference formulation."""
    dev = resolve_device(device)
    solver = resolve_solver(solver, dev)
    prog = build_program(net, flows, k=k, capacity=capacity)
    if prog is None:
        return None
    if solver == "dense":
        m, relaxed = solve_relaxation(prog, n_iters=n_iters, device=dev)
    else:
        m, relaxed, _ = solve_relaxation_sparse(
            prog, n_iters=n_iters, backend=solver, device=dev
        )
    return _finalize(prog, m, relaxed, water_filling=water_filling, refine=refine)




# ---------------------------------------------------------------------------
# Fleet engine: shape buckets, program cache and batched solves
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineStats:
    """Observability for the solver's shape signatures (`hits`/`misses` count
    shape-bucket signatures: a miss is the first solve of a new batch shape,
    a hit reuses one) and the convergence-adaptive sparse solver (per-lane
    semantic steps vs the fixed budget the dense schedule would have burned —
    a batch's device work is governed by its slowest live lane, and
    batch-padding lanes are excluded; ``fast_path_solves`` are single-flow
    programs rounded host-side with no relaxation at all)."""

    single_solves: int = 0
    batched_solves: int = 0  # batched solver calls
    batched_instances: int = 0  # programs solved through batch calls
    cache_hits: int = 0
    cache_misses: int = 0
    solve_seconds: float = 0.0
    # phase split of the engine's wall-clock. ``solve_seconds`` keeps its
    # historical meaning (relaxation dispatch + analytic fast-path time, the
    # quantity every benchmark baseline records); the phases decompose where
    # an engine call actually spends: host program build (path enumeration +
    # tensor assembly), program-cache hit replay, device relaxation dispatch
    # (upload, solve, download), and host rounding/refine/Eq. 15. Identity:
    # solve_seconds == dispatch_seconds + (the fast-path share of
    # finalize_seconds).
    build_seconds: float = 0.0  # build_program: path enum + program tensors
    cache_seconds: float = 0.0  # program-cache hits: capacity-only replay
    dispatch_seconds: float = 0.0  # relaxation calls (device dispatch + sync)
    finalize_seconds: float = 0.0  # host rounding / refine / water-filling
    solver_steps: int = 0  # relaxation steps actually run (early exit counted)
    solver_step_budget: int = 0  # n_iters * relaxation solves (the dense cost)
    fast_path_solves: int = 0  # single-flow programs solved analytically
    prog_cache_hits: int = 0  # program-tensor cache: no rebuild, no re-upload
    prog_cache_misses: int = 0
    # invalidation traffic (see JRBAEngine.invalidate): full drops vs
    # footprint-scoped prunes, and how many cached entries each scoped call
    # kept alive vs evicted — the churn-resilience observable
    invalidations_full: int = 0
    invalidations_scoped: int = 0
    progs_pruned: int = 0  # program-cache entries evicted by scoped calls
    progs_kept: int = 0  # program-cache entries a scoped call left valid
    paths_pruned: int = 0  # path-cache entries evicted by scoped calls

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class JRBAEngine:
    """Cached, batched JRBA solver for fleet-scale scheduling.

    Two ideas:

    * **Shape buckets** — flow programs are padded so Nf lands on a power-of
      -two bucket (min 8), so the solver sees O(log N) distinct shapes
      instead of one per flow count.
    * **Batched solves** — ``solve_many`` stacks same-bucket programs into
      one batch and runs one relaxation call for all of them (one kernel
      launch under ``solver="cuda"``); per-instance rounding/Eq. 15 stays on
      host. N independent instances (a fleet of jobs, or OTFS solves across
      simulations) cost one dispatch instead of N.

    The engine is deliberately topology-agnostic: programs built on different
    networks (different L) simply land in different buckets.

    ``device`` is where relaxations run: CUDA by default, and the engine
    raises when no card is usable rather than falling back to the host;
    ``device="cpu"`` is the explicit host mode. ``solver`` picks the
    relaxation formulation (see module docstring): ``"auto"`` resolves via
    :func:`resolve_solver` (``REPRO_TORCH_JRBA_SOLVER`` env override, then
    the CUDA kernel on a CUDA device / the sparse twin on the CPU);
    ``"dense"`` forces the reference. Sparse modes additionally take the
    analytic fast path for single-flow programs — the best-response sweep
    finds the global min-congestion path from any start when there is only
    one flow, so the rounded result provably equals the dense pipeline's
    with zero relaxation steps.

    A per-network **program cache** (keyed by the kept flows' (src, dst,
    volume) signature and shape bucket) replays the solve-invariant tensors
    — dense/sparse usage, index tensors, slot lists, candidate paths, and
    their device mirrors — so the OTFS re-solve loop (same job, shrinking
    residual) rebuilds nothing and re-uploads only the capacity vector.
    """

    def __init__(
        self,
        *,
        k: int = 4,
        n_iters: int = 400,
        min_bucket: int = 8,
        solver: str = "auto",
        device: str | torch.device = "cuda",
        early_exit: bool = True,
        span_rtol: float = 2e-2,
        stable_chunks: int = 2,
        prog_cache_size: int = 256,
    ) -> None:
        self.k = k
        self.n_iters = n_iters
        self.min_bucket = min_bucket
        self.device = resolve_device(device)
        self.solver = resolve_solver(solver, self.device)
        self.early_exit = early_exit
        self.span_rtol = span_rtol
        self.stable_chunks = stable_chunks
        self.prog_cache_size = prog_cache_size
        self.stats = EngineStats()
        # observability: the fleet runtime points this at its Tracer so
        # engine dispatches land on one shared "engine" timeline track
        # (every lane's solves funnel through the same engine); the default
        # null tracer keeps the solve paths branch-cheap
        self.tracer = NULL_TRACER
        self.trace_track = "engine"
        self._seen_shapes: set[tuple] = set()
        # per-network (src, dst, k) -> candidate paths; weak keys so dropping
        # a topology frees its cache
        self._paths: "weakref.WeakKeyDictionary[NetworkGraph, dict]" = (
            weakref.WeakKeyDictionary()
        )
        # per-network LRU of solve-invariant program tensors
        self._progs: "weakref.WeakKeyDictionary[NetworkGraph, collections.OrderedDict]" = (
            weakref.WeakKeyDictionary()
        )
        # topology epoch each net's caches were built in (see _check_topology)
        self._topo_seen: "weakref.WeakKeyDictionary[NetworkGraph, int]" = (
            weakref.WeakKeyDictionary()
        )

    def bucket(self, n_real: int) -> int:
        """Smallest power-of-two bucket (>= min_bucket) holding n_real rows."""
        b = self.min_bucket
        while b < n_real:
            b *= 2
        return b

    def _note_shape(self, key: tuple) -> None:
        if key in self._seen_shapes:
            self.stats.cache_hits += 1
        else:
            self._seen_shapes.add(key)
            self.stats.cache_misses += 1

    def bucket_key(self, net: NetworkGraph, flows: list[Flow]) -> tuple:
        """Cheap dispatch-grouping key for a (net, flows) pair — the key the
        async fleet dispatcher queues :class:`~repro_torch.core.SolveRequest`s
        under, computed WITHOUT enumerating paths or building the program
        (both of which ``build`` pays exactly once at solve time).

        For the dense solver the key — ``(Nf bucket, k, L)`` — is exactly the
        batch-shape signature, so one queued bucket is one batched call.
        Sparse/CUDA signatures additionally depend on the active-link
        compression (``La_pad``, ``Pmax``), which only the built program
        knows; there the key is a *proxy* — programs sharing it usually share
        a batch shape, and ``solve_many`` re-buckets exactly inside the
        dispatch, so a mixed bucket costs extra solver calls, never a wrong
        result. Empty programs (colocated-only / zero-volume flows) collapse
        to ``("empty",)``: they never reach the solver and any driver can
        answer them in any grouping."""
        kept = sum(1 for f in flows if f.src != f.dst and f.volume > 0)
        if not kept:
            return ("empty",)
        return (self.bucket(kept), self.k, len(net.links))

    def _shape_key(self, prog: FlowProgram) -> tuple:
        """Batch-signature key of one program under the active solver.
        Sparse solves never see L, so instances from different topologies
        share a signature whenever their active-compressed shapes agree; both
        sparse solvers (the CUDA kernel and its plain version) take the hop
        axis (Pmax) of the index tensor too."""
        if self.solver == "dense":
            return prog.usage.shape
        return ("sp", *prog.valid.shape, prog.la_pad, prog.ridx.shape[-1])

    def build(
        self,
        net: NetworkGraph,
        flows: list[Flow],
        *,
        capacity: np.ndarray | None = None,
    ) -> FlowProgram | None:
        # mirror build_program's flow filter so the bucket is known up front
        # and the program is built exactly once
        t0 = time.perf_counter()
        self._check_topology(net)
        kept = [f for f in flows if f.src != f.dst and f.volume > 0]
        if not kept:
            return None
        bucket = self.bucket(len(kept))
        progs = self._progs.get(net)
        if progs is None:
            progs = self._progs.setdefault(net, collections.OrderedDict())
        key = (tuple((f.src, f.dst, f.volume) for f in kept), bucket)
        ent = progs.get(key)
        if ent is not None:
            progs.move_to_end(key)
            self.stats.prog_cache_hits += 1
            cap = _clamp_capacity(net, capacity)
            # share every solve-invariant tensor (and the device-mirror dict)
            # with the cached program; only capacity and the caller's Flow
            # objects are fresh
            out = dataclasses.replace(ent, capacity=cap, flows=kept)
            self.stats.cache_seconds += time.perf_counter() - t0
            return out
        paths = self._paths.get(net)
        if paths is None:
            paths = self._paths.setdefault(net, {})
        prog = build_program(
            net,
            flows,
            k=self.k,
            capacity=capacity,
            pad_to=bucket,
            path_cache=paths,
        )
        self.stats.prog_cache_misses += 1
        progs[key] = prog
        while len(progs) > self.prog_cache_size:
            progs.popitem(last=False)
        self.stats.build_seconds += time.perf_counter() - t0
        return prog

    def invalidate(self, net: NetworkGraph, links: np.ndarray | None = None) -> None:
        """The one invalidation surface for ``net``'s per-network caches
        (candidate paths and solve-invariant program tensors).

        ``links=None`` — **full topology invalidation**: drop everything.
        Required when the adjacency *gained* links (a recovery can create a
        shorter path between any pair, so no cached enumeration is provably
        still the top-k) and after ``restore_topology`` (drift-era caches
        tie-break on live bandwidth and are not the pristine-network ones).

        ``links=<bool mask over link ids>`` — **footprint-scoped
        invalidation**: drop only cache entries whose recorded link footprint
        intersects the mask. Sound for link *failures* and capacity changes:
        removing (or drifting) a link that lies on none of an entry's
        candidate paths cannot change Yen's top-k for that entry — deletion
        only removes longer paths, and costs of the surviving paths are
        untouched — so the cached paths, the program's usage/index tensors,
        and its device mirrors all stay valid; the program-cache hit path
        refreshes capacity on every build anyway. Path-cache entries record
        their footprint as the union of their paths' links; cached programs
        record theirs as ``active_links``.

        Pure capacity drift needs no call at all (the hit path re-reads
        capacity); the online scheduler calls ``invalidate(net, touched)``
        for failure-only churn steps and ``invalidate(net)`` when a step
        recovered links.

        Either form syncs the engine's topology epoch for ``net``. Every
        cache access still self-checks ``net.topology_version``
        (:meth:`_check_topology`), so a missed explicit call degrades to a
        lazy *full* invalidation rather than a stale solve."""
        if links is None:
            self._paths.pop(net, None)
            self._progs.pop(net, None)
            self.stats.invalidations_full += 1
            self._topo_seen[net] = net.topology_version
            return
        mask = np.asarray(links, dtype=bool)
        self.stats.invalidations_scoped += 1
        if mask.any():
            paths = self._paths.get(net)
            if paths:
                stale = [
                    key
                    for key, ps in paths.items()
                    if any(mask[l] for p in ps for l in path_links(net, p))
                ]
                for key in stale:
                    del paths[key]
                self.stats.paths_pruned += len(stale)
            progs = self._progs.get(net)
            if progs:
                stale = [
                    key for key, ent in progs.items() if mask[ent.active_links].any()
                ]
                for key in stale:
                    del progs[key]
                self.stats.progs_pruned += len(stale)
                self.stats.progs_kept += len(progs)
        self._topo_seen[net] = net.topology_version

    def _check_topology(self, net: NetworkGraph) -> None:
        """Lazy safety net behind :meth:`invalidate`: drop caches whose
        topology epoch is stale (a full drop — the touched-link mask is
        unknown by the time the staleness is noticed)."""
        seen = self._topo_seen.get(net)
        if seen is None:
            self._topo_seen[net] = net.topology_version
        elif seen != net.topology_version:
            self.invalidate(net)

    def candidate_links(self, net: NetworkGraph, flows: list[Flow]) -> np.ndarray:
        """Bool mask over links of every candidate path of ``flows`` — the
        footprint a JRBA solve of them could touch (and the only capacity
        entries its output depends on). Served from the per-net path cache, so
        after warm-up this is a cheap host-side lookup; the speculative OTFS
        repair pass uses it to decide which queued speculations an admission
        can invalidate."""
        self._check_topology(net)
        cache = self._paths.get(net)
        if cache is None:
            cache = self._paths.setdefault(net, {})
        mask = np.zeros(len(net.links), dtype=bool)
        for f in flows:
            if f.src == f.dst or f.volume <= 0:
                continue
            key = (f.src, f.dst, self.k)
            ps = cache.get(key)
            if ps is None:
                ps = cache[key] = k_shortest_paths(net, f.src, f.dst, self.k)
            for path in ps:
                mask[path_links(net, path)] = True
        return mask

    def _use_fast_path(self, prog: FlowProgram, refine: bool) -> bool:
        return self.solver != "dense" and refine and prog.n_real == 1

    def _fast_single(self, prog: FlowProgram, water_filling: bool) -> JRBAResult:
        """Analytic single-flow solve: with one flow the best-response sweep
        in :func:`_finalize` picks the globally min-congestion candidate path
        from any starting ``k`` (first argmin on ties), which is exactly
        where the dense argmax-round-then-refine pipeline lands — so skip
        the relaxation entirely. The span certificate equals the rounded
        span (the LP could split traffic lower; nothing downstream consumes
        the certificate)."""
        m0 = np.where(prog.valid, prog.volumes[:, None], -1.0)
        res = _finalize(prog, m0, 0.0, water_filling=water_filling, refine=True)
        res.relaxed_span = res.span
        self.stats.fast_path_solves += 1
        return res

    def _sparse_kwargs(self) -> dict:
        return dict(
            n_iters=self.n_iters,
            early_exit=self.early_exit,
            span_rtol=self.span_rtol,
            stable_chunks=self.stable_chunks,
            backend=self.solver,
            device=self.device,
        )

    def _relax_one(self, prog: FlowProgram) -> tuple[np.ndarray, float]:
        """Solver-mode dispatch for one program (stats included)."""
        if self.solver == "dense":
            m, relaxed = solve_relaxation(prog, n_iters=self.n_iters, device=self.device)
            steps = self.n_iters
        else:
            m, relaxed, steps = solve_relaxation_sparse(prog, **self._sparse_kwargs())
        self.stats.solver_steps += steps
        self.stats.solver_step_budget += self.n_iters
        return m, relaxed

    def _relax_group(
        self, progs: list[FlowProgram], n_real: int | None = None
    ) -> list[tuple[np.ndarray, float]]:
        """Solver-mode dispatch for one same-bucket batch (stats included).
        ``n_real`` excludes batch-dimension padding lanes (repeats of the
        last program) from the step counters; note the per-lane step counts
        are the *semantic* early-exit points — a batch's device work is
        governed by its slowest live lane."""
        n_real = len(progs) if n_real is None else n_real
        if self.solver == "dense":
            solved = solve_relaxation_batch(progs, n_iters=self.n_iters, device=self.device)
            self.stats.solver_steps += self.n_iters * n_real
            self.stats.solver_step_budget += self.n_iters * n_real
            return solved
        solved3 = solve_relaxation_sparse_batch(progs, **self._sparse_kwargs())
        self.stats.solver_steps += sum(s for _, _, s in solved3[:n_real])
        self.stats.solver_step_budget += self.n_iters * n_real
        return [(m, relaxed) for m, relaxed, _ in solved3]

    def solve(
        self,
        net: NetworkGraph,
        flows: list[Flow],
        *,
        capacity: np.ndarray | None = None,
        water_filling: bool = False,
        refine: bool = True,
    ) -> JRBAResult | None:
        """Drop-in replacement for :func:`jrba` with bucketing + cache stats."""
        prog = self.build(net, flows, capacity=capacity)
        if prog is None:
            return None
        if self._use_fast_path(prog, refine):
            t0 = time.perf_counter()
            res = self._fast_single(prog, water_filling)
            dt = time.perf_counter() - t0
            self.stats.solve_seconds += dt
            self.stats.finalize_seconds += dt
            return res
        self._note_shape(("single", self._shape_key(prog), self.n_iters))
        t0 = time.perf_counter()
        m, relaxed = self._relax_one(prog)
        dt = time.perf_counter() - t0
        self.stats.solve_seconds += dt
        self.stats.dispatch_seconds += dt
        self.stats.single_solves += 1
        tracer = self.tracer
        if tracer.enabled:
            tracer.complete(
                "engine/relax", track=self.trace_track, cat="engine", ts=tracer.now() - dt, dur=dt
            )
        t0 = time.perf_counter()
        res = _finalize(prog, m, relaxed, water_filling=water_filling, refine=refine)
        self.stats.finalize_seconds += time.perf_counter() - t0
        return res

    def solve_many(
        self,
        net: NetworkGraph | Sequence[NetworkGraph],
        flow_sets: list[list[Flow]],
        *,
        capacities: list[np.ndarray] | None = None,
        water_filling: bool | Sequence[bool] = False,
        refine: bool = True,
    ) -> list[JRBAResult | None]:
        """Solve N independent JRBA instances; same-shape instances share one
        batched solver call. Result list aligns with ``flow_sets`` (None for
        empty/colocated-only instances).

        ``net`` may be a single network or one per instance — the fleet
        co-scheduling path, where every simulation owns its own topology.
        Network identity only matters host-side (path enumeration and the
        per-net path cache); the relaxation sees pure tensors, so programs
        from *different* networks batch together whenever they land in the
        same shape bucket.

        ``water_filling`` may likewise be per-instance (rounding and the
        top-up are host-side, so mixed fleets of ``…+WF`` and plain policies
        share one batched solve).

        The batch dimension is padded up to a power of two (repeating the
        last program; padded lanes are discarded) so a draining fleet —
        16 live simulations, then 15, then 14… — stays on O(log N) batch
        shapes.
        """
        n = len(flow_sets)
        nets = [net] * n if isinstance(net, NetworkGraph) else list(net)
        if len(nets) != n:
            raise ValueError(f"nets ({len(nets)}) must align with flow_sets ({n})")
        wf = [water_filling] * n if isinstance(water_filling, bool) else list(water_filling)
        if len(wf) != n:
            raise ValueError(f"water_filling ({len(wf)}) must align with flow_sets ({n})")
        if capacities is None:
            capacities = [None] * n
        elif len(capacities) != n:
            raise ValueError(
                f"capacities ({len(capacities)}) must align with flow_sets ({n})"
            )
        progs: list[FlowProgram | None] = [
            self.build(g, fs, capacity=cap)
            for g, fs, cap in zip(nets, flow_sets, capacities)
        ]
        results: list[JRBAResult | None] = [None] * n
        by_bucket: dict[tuple, list[int]] = {}
        for i, p in enumerate(progs):
            if p is None:
                continue
            if self._use_fast_path(p, refine):
                t0 = time.perf_counter()
                results[i] = self._fast_single(p, wf[i])
                dt = time.perf_counter() - t0
                self.stats.solve_seconds += dt
                self.stats.finalize_seconds += dt
            else:
                by_bucket.setdefault(self._shape_key(p), []).append(i)
        tracer = self.tracer
        for shape, idxs in by_bucket.items():
            group = [progs[i] for i in idxs]
            b_pad = 1
            while b_pad < len(group):
                b_pad *= 2
            # the signature includes the (padded) batch size; padding keeps
            # the set of B values seen logarithmic
            self._note_shape(("batch", b_pad, shape, self.n_iters))
            padded = group + [group[-1]] * (b_pad - len(group))
            t0 = time.perf_counter()
            solved = self._relax_group(padded, n_real=len(group))[: len(group)]
            dt = time.perf_counter() - t0
            self.stats.solve_seconds += dt
            self.stats.dispatch_seconds += dt
            self.stats.batched_solves += 1
            self.stats.batched_instances += len(group)
            if tracer.enabled:
                tracer.complete(
                    "engine/batch",
                    track=self.trace_track,
                    cat="engine",
                    ts=tracer.now() - dt,
                    dur=dt,
                    instances=len(group),
                    batch_pad=b_pad,
                )
            t0 = time.perf_counter()
            for i, prog, (m, relaxed) in zip(idxs, group, solved):
                results[i] = _finalize(
                    prog, m, relaxed, water_filling=wf[i], refine=refine
                )
            self.stats.finalize_seconds += time.perf_counter() - t0
        return results


# ---------------------------------------------------------------------------
# Exact reference for tests: enumerate all path combinations
# ---------------------------------------------------------------------------
def brute_force_span(prog: FlowProgram) -> float:
    """min over route choices of max_l (crossing volume / capacity): the true
    optimum of P3 (optimal bandwidths for fixed routes are proportional
    fills, so the span closed-form is the link-congestion max)."""
    Nf = prog.usage.shape[0]
    choices = [list(np.flatnonzero(prog.valid[i])) for i in range(Nf)]
    best = float("inf")
    for combo in itertools.product(*choices):
        sel = prog.usage[np.arange(Nf), list(combo)]  # (Nf, L)
        crossing = sel.T @ prog.volumes
        span = float(np.max(crossing / prog.capacity))
        best = min(best, span)
    return best
