"""Sparse JRBA congestion solve: the CUDA kernel's wrapper and its plain version.

``sparse_congestion_solve`` runs the whole convergence-adaptive sparse
relaxation of a batch of JRBA programs: ``n_iters`` annealed Adam steps of
the min-congestion objective over the active links, in ``probe_schedule``
chunks with per-lane early exit. It returns ``(w, span, steps)``.

On a CUDA tensor it launches ``csrc/jrba_congestion.cu`` once — one thread
block per lane, the chunk loop and the early-exit test inside the kernel —
and raises on any input the kernel does not take. On a CPU tensor it runs the
plain PyTorch version, :func:`sparse_congestion_plain`, which takes the same
inputs and sums in the kernel's order, so that on the card the two agree bit
for bit. This module owns that order on the PyTorch side; the engine's
``"sparse"`` solver is :func:`sparse_congestion_plain`. The kernel replaces
the TPU kernel ``_congestion_chunk_kernel`` and its chunk driver; its source
note says what bounds it on Hopper and how the design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.jrba import _adam, _converged, _mask, _schedule_tensor, probe_schedule
from . import _build

__all__ = ["sparse_congestion_plain", "sparse_congestion_solve", "kernel_smem_bytes"]

LIBRARY = "jrba_congestion"
# K is a template parameter of the kernel; it is the engine's k, which callers
# set freely (JRBAEngine and OnlineScheduler default to 4, the fleet smoke run
# uses 3)
MAX_K = 8
MAX_THREADS = 1024
MAX_SMEM = 48 * 1024  # static launch limit without an opt-in attribute


def _threads(nf: int, la: int) -> int:
    """One thread per flow row and per active link, in whole warps."""
    return -(-max(nf, la, 1) // 32) * 32


def kernel_smem_bytes(nf: int, k: int, la: int) -> int:
    """Dynamic shared memory of one block: vol*w slots, link gradients and
    two 32-entry reduction buffers (f32)."""
    return 4 * (nf * k + la + 64)


# The sparse solver's sums run in the CUDA kernel's order, so that on the card
# the kernel and this plain version produce the same bits (and the same
# rounded records) from the same inputs:
#   * over the K paths of a flow: left to right;
#   * over a link's path slots and over a path's hops: pairwise, adjacent
#     pairs first (a list padded with zeros to a power of two);
#   * over the active links: halves within each 32-link group (a warp's
#     butterfly), then halves across the group totals.
def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Adjacent-pairs tree over the last axis (a power of two)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _halves_sum(x: torch.Tensor) -> torch.Tensor:
    """First-half-plus-second-half tree over the last axis (a power of two)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _link_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, La) -> (B,): the kernel's block reduction over links."""
    B, La = x.shape
    groups = 1
    while 32 * groups < La:
        groups *= 2
    x = torch.nn.functional.pad(x, (0, 32 * groups - La)).reshape(B, groups, 32)
    return _halves_sum(_halves_sum(x))


def _slot_table(csr_ptr: torch.Tensor, csr_slot: torch.Tensor, nk: int) -> torch.Tensor:
    """(B, La, D) path-slot index per link, in slot-list order, padded to a
    power-of-two width D with the sentinel ``nk`` (a zero entry)."""
    lo = csr_ptr[:, :-1].long()
    deg = csr_ptr[:, 1:].long() - lo
    dmax = int(deg.max()) if deg.numel() else 0
    width = 1
    while width < dmax:
        width *= 2
    j = torch.arange(width, device=csr_ptr.device)
    idx = (lo[..., None] + j).clamp(max=max(csr_slot.numel() - 1, 0))
    slots = csr_slot.long()[idx] if csr_slot.numel() else torch.zeros_like(idx)
    return torch.where(j < deg[..., None], slots, torch.full_like(slots, nk))


@torch.no_grad()
def sparse_congestion_plain(
    ridx: torch.Tensor,  # (B, Nf, K, P) int32 — active link per hop, sentinel La
    valid: torch.Tensor,  # (B, Nf, K)
    volumes: torch.Tensor,  # (B, Nf)
    cap_a: torch.Tensor,  # (B, La) — capacity on active slots (padding: 1)
    n_outside: torch.Tensor,  # (B,): L - La inactive links (denominator fold)
    csr_ptr: torch.Tensor,  # (B, La + 1) int32 — absolute offsets into csr_slot
    csr_slot: torch.Tensor,  # (nnz,) int32 — flattened i*K + k slots, by link
    n_iters: int = 400,
    lr: float = 0.25,
    early_exit: bool = True,
    span_rtol: float = 2e-2,
    stable_chunks: int = 2,
    min_chunks: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the CUDA kernel, on its inputs: the sparse
    twin of ``core.jrba._solve_md_batched`` (B lanes; the scalar path is just
    B == 1).
    Same Adam-on-logits math, but:

    * congestion lives on the La active-link slots only — each step is
      O(Nf*K*P) instead of O(Nf*K*L): the load scatter gathers each link's
      path slots through its slot list, the gradient gathers each path's
      hops through ``ridx``, and the L - La zero-congestion links enter the
      softmax denominator as one closed-form scalar (``n_outside *
      exp(-max_c / tau)``), so the objective is exactly the dense one;
    * the gradient is hand-fused (softmax-of-congestion gathered back onto
      the usage support) instead of an autograd tape over the smoothed
      objective;
    * the schedule is convergence-adaptive (see :func:`probe_schedule` and
      :func:`_converged`): a lane exits at a chunk boundary once the
      rounding ``argmax_k w`` was unchanged across ``stable_chunks``
      consecutive chunk boundaries (at warm tau ``w`` is near-uniform and a
      single agreement is stable-looking noise) and the exact span plateaued
      within ``span_rtol``. Converged lanes freeze (masked updates) and no
      operation mixes lanes, so each lane's result is its B == 1 result bit
      for bit; the loop ends when every lane converged or the budget is
      spent.

    Returns ``(w, exact_span, steps_taken)`` with per-lane step counts."""
    B, Nf, K, P = ridx.shape
    La = cap_a.shape[-1]
    NK = Nf * K
    dev = ridx.device
    mask = _mask(valid)
    vol3 = volumes[:, :, None]
    nout = n_outside[:, None]
    zero = torch.zeros(B, 1, dtype=torch.float32, device=dev)
    table = _slot_table(csr_ptr, csr_slot, NK)  # (B, La, D)
    width = table.shape[-1]
    table = table.reshape(B, La * width)
    hops = ridx.reshape(B, NK * P).long()

    def softmax(x):
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / _seq_sum(e)[..., None]

    def congestion(w):  # (B, Nf, K) -> (B, La)
        vw = torch.cat([(vol3 * w).reshape(B, NK), zero], dim=1)
        return _pairwise_sum(vw.gather(1, table).reshape(B, La, width)) / cap_a

    pc, ps = probe_schedule(n_iters)
    sched = _schedule_tensor(n_iters, dev)

    def step(logits, m, v, row):
        tau = row[0]
        w = softmax(logits + mask)
        c = congestion(w)
        maxc = c.amax(-1, keepdim=True)  # (B, 1)
        e = torch.exp((c - maxc) / tau)
        denom = _link_sum(e)[:, None] + nout * torch.exp(-maxc / tau)
        # d obj / d load_l = softmax(c/tau)_l / B_l, gathered onto the usage
        # support; then the softmax Jacobian maps it back to logits
        glink = torch.cat([(e / denom) / cap_a, zero], dim=1)
        gw = vol3 * _pairwise_sum(glink.gather(1, hops).reshape(B, Nf, K, P))
        g = w * (gw - _seq_sum(w * gw)[..., None])
        return _adam(logits, m, v, g, row, lr)

    logits = torch.zeros_like(mask)
    m = torch.zeros_like(mask)
    v = torch.zeros_like(mask)
    span = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    ks = torch.full((B, Nf), -1, dtype=torch.int64, device=dev)
    stable = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    ci = 0
    while ci < pc and not bool(done.all()):
        l2, m2, v2 = logits, m, v
        for s in range(ci * ps, (ci + 1) * ps):
            l2, m2, v2 = step(l2, m2, v2, sched[s])
        keep = done[:, None, None]
        logits = torch.where(keep, logits, l2)
        m = torch.where(keep, m, m2)
        v = torch.where(keep, v, v2)
        sp = congestion(softmax(logits + mask)).amax(-1)
        new_span = torch.where(done, span, sp)
        new_ks = torch.argmax(logits + mask, dim=-1)
        stable = torch.where((new_ks == ks).all(-1), stable + 1, torch.zeros_like(stable))
        steps = torch.where(done, steps, torch.full_like(steps, (ci + 1) * ps))
        if early_exit:
            conv = _converged(ci + 1, stable, new_span, span, span_rtol, min_chunks, stable_chunks)
            done = done | conv
        span, ks = new_span, new_ks
        ci += 1
    steps = torch.where(done, steps, torch.full_like(steps, n_iters))
    return softmax(logits + mask), span, steps


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launcher():
    fn = _build.load(LIBRARY).jrba_congestion_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def sparse_congestion_solve(
    ridx: torch.Tensor,  # (B, Nf, K, P) int32, sentinel La
    valid: torch.Tensor,  # (B, Nf, K) bool
    volumes: torch.Tensor,  # (B, Nf) f32
    cap_a: torch.Tensor,  # (B, La) f32
    n_outside: torch.Tensor,  # (B,) f32
    csr_ptr: torch.Tensor,  # (B, La + 1) int32, absolute offsets into csr_slot
    csr_slot: torch.Tensor,  # (nnz,) int32, flattened i*K + k per link entry
    *,
    n_iters: int = 400,
    lr: float = 0.25,
    early_exit: bool = True,
    span_rtol: float = 2e-2,
    stable_chunks: int = 2,
    min_chunks: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Convergence-adaptive sparse relaxation of B lanes; returns
    ``(w (B,Nf,K) f32, span (B,) f32, steps (B,) int32)``. A CUDA ``ridx``
    launches the kernel (one launch, counted in ``launches``); a CPU one
    runs :func:`sparse_congestion_plain`."""
    kwargs = dict(
        n_iters=n_iters, lr=lr, early_exit=early_exit, span_rtol=span_rtol,
        stable_chunks=stable_chunks, min_chunks=min_chunks,
    )
    if ridx.device.type == "cpu":
        return sparse_congestion_plain(
            ridx, valid, volumes, cap_a, n_outside, csr_ptr, csr_slot, **kwargs
        )
    if ridx.device.type != "cuda":
        raise ValueError(f"unsupported device {ridx.device}")
    if ridx.dim() != 4:
        raise ValueError(f"ridx must be (B, Nf, K, P), got shape {tuple(ridx.shape)}")
    B, Nf, K, P = ridx.shape
    La = cap_a.shape[-1]
    dev = ridx.device
    _check("ridx", ridx, torch.int32, None, dev)
    _check("valid", valid, torch.bool, (B, Nf, K), dev)
    _check("volumes", volumes, torch.float32, (B, Nf), dev)
    _check("cap_a", cap_a, torch.float32, (B, La), dev)
    _check("n_outside", n_outside, torch.float32, (B,), dev)
    _check("csr_ptr", csr_ptr, torch.int32, (B, La + 1), dev)
    _check("csr_slot", csr_slot, torch.int32, None, dev)
    if csr_slot.dim() != 1:
        raise ValueError("csr_slot must be 1-D")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} paths per flow; the kernel takes 1..{MAX_K}")
    if B < 1 or Nf < 1 or La < 1 or P < 1 or n_iters < 1:
        raise ValueError(f"empty problem: B={B} Nf={Nf} La={La} P={P} n_iters={n_iters}")
    threads = _threads(Nf, La)
    if threads > MAX_THREADS:
        raise ValueError(f"Nf={Nf}, La={La}: needs {threads} threads > {MAX_THREADS} a block")
    smem = kernel_smem_bytes(Nf, K, La)
    if smem > MAX_SMEM:
        raise ValueError(f"Nf={Nf}, K={K}, La={La}: {smem} B shared memory > {MAX_SMEM}")
    n_chunks, chunk_steps = probe_schedule(n_iters)
    sched = _schedule_tensor(n_iters, dev)
    mask = _mask(valid)
    w = torch.empty((B, Nf, K), dtype=torch.float32, device=dev)
    span = torch.empty((B,), dtype=torch.float32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            ridx.data_ptr(), mask.data_ptr(), volumes.data_ptr(), cap_a.data_ptr(),
            n_outside.data_ptr(), csr_ptr.data_ptr(), csr_slot.data_ptr(), sched.data_ptr(),
            w.data_ptr(), span.data_ptr(), steps.data_ptr(),
            B, Nf, K, P, La, n_chunks, chunk_steps,
            float(lr), int(early_exit), float(span_rtol), int(stable_chunks), int(min_chunks),
            threads, smem, stream,
        )
    if err != 0:
        raise RuntimeError(f"jrba_congestion launch failed: CUDA error {err}")
    sparse_congestion_solve.launches += 1
    return w, span, steps


sparse_congestion_solve.launches = 0
