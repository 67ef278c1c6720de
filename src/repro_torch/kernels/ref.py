"""Dense and sequential oracles for the port's kernels (the allclose targets
of the tests) and the comparison that holds a kernel to its plain version.

``flash_attention_ref`` follows the kernels' heads-major convention; the
sequential scans are the model layout's ``(B, S, H, P)`` ground-truth
recurrences, the torch twins of the JAX model's ``ssd_sequential`` and
``rwkv6_sequential``. Nothing on the model path calls these.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "row_limit_ratio", "rwkv6_sequential", "same_bits",
           "ssd_sequential"]


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KH, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Full-matrix softmax attention in f32, causal unless ``causal=False``,
    scores scaled by ``scale`` (``D**-0.5`` when None); the causal mask is
    right-aligned when Sq < Skv."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = D**-0.5 if scale is None else scale
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhid,bhjd->bhij", q.float(), kk) * scale
    i = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, vv).to(q.dtype)


@torch.no_grad()
def ssd_sequential(x, dt, A, Bm, Cm, *, init_state=None, acc=torch.float32):
    """Mamba-2 ground truth, one step at a time: ``h_t = exp(dt_t A) h_{t-1}
    + dt_t B_t x_t``, ``y_t = C_t . h_t``. x (B, S, H, P), dt (B, S, H), A (H,),
    B/C (B, S, N); returns (y in x's dtype, final state (B, H, N, P) in
    ``acc``, the dtype every step computes in)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, N, P), dtype=acc, device=x.device) if init_state is None \
        else init_state.to(acc)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].to(acc), dt[:, t].to(acc)
        bt, ct = Bm[:, t].to(acc), Cm[:, t].to(acc)
        a = torch.exp(dtt * A.to(acc))  # (B, H)
        h = h * a[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dtt, bt, xt)
        ys.append(torch.einsum("bn,bhnp->bhp", ct, h))
    return torch.stack(ys, dim=1).to(x.dtype), h


@torch.no_grad()
def rwkv6_sequential(r, k, v, logw, u, *, init_state=None, acc=torch.float32):
    """RWKV-6 ground truth, one step at a time: ``y_t = r_t . (S_{t-1} +
    diag(u) k_t v_t^T)``, ``S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T``.
    r, k, v, logw (B, S, H, P), u (H, P); returns (y in r's dtype, final state
    (B, H, P, P) in ``acc``, the dtype every step computes in)."""
    B, S, H, P = r.shape
    s = torch.zeros((B, H, P, P), dtype=acc, device=r.device) if init_state is None \
        else init_state.to(acc)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (a[:, t].to(acc) for a in (r, k, v, logw))
        kv = torch.einsum("bhp,bhq->bhpq", kt, vt)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt, s + u.to(acc)[None, :, :, None] * kv))
        s = s * torch.exp(wt)[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def row_limit_ratio(
    got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float | None = None
) -> float:
    """Largest ``|got - want|`` over its limit ``rtol * |want| + atol * rms``,
    where ``rms`` is the root mean square of ``want``'s row (over the last
    axis) and ``atol`` defaults to ``rtol``. Each row is held to the tolerance
    of its own scale: an attention row over n live keys of unit-variance
    values shrinks like ``n**-0.5``, and a scan's rows grow with the state, so
    a fixed atol would be as large as some rows or far below others. The
    outputs agree when the ratio is at most 1."""
    atol = rtol if atol is None else atol
    got, want = got.float(), want.float()
    rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    limit = (rtol * want.abs() + atol * rms).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / limit).max())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns (NaNs included) in the same dtype and shape."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
