"""RWKV-6 (Finch) wkv scan: the CUDA kernel's wrapper and its plain version.

:func:`rwkv6_chunked` is the plain version, the torch twin of the JAX model's
``models/ssm.py::rwkv6_chunked``: ``y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)``,
``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` with ``w = exp(logw)``, computed chunk
by chunk. The pairwise in-chunk decay factorizes against the chunk start: the
q side ``exp(cw_prev) <= 1``, the k side ``exp(-cw) <= e^(Q |logw|_max)``.
Under the model's clamp ``|logw| <= e`` that is e^43.5 at Q=16, inside f32;
at Q=64 it would be e^174, which overflows. So chunks are at most 16 long:
every function here defaults to 16 and :func:`rwkv6_scan_hsd` raises above
it. It returns ``(y, final_state)``.

:func:`rwkv6_scan_hsd` takes heads-major ``r, k, v, logw (B, H, S, P)`` and
``u (H, P)`` and returns ``y (B, H, S, P)`` in r's dtype. On a CUDA tensor it
launches ``csrc/rwkv6_scan.cu`` once (counted in ``rwkv6_scan_hsd.launches``)
and raises on any input the kernel does not take; the kernel reads strided
views, so ``ops.rwkv6_scan`` hands it transposed model-layout tensors without
a copy. On a CPU tensor it runs the plain version. The kernel replaces the
TPU kernel ``_rwkv6_kernel`` / ``rwkv6_scan_hsd`` of the JAX package and,
like it, returns ``y`` only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ssd import check_operand, empty_in_layout

__all__ = ["MAX_CHUNK", "rwkv6_chunked", "rwkv6_scan_hsd", "rwkv6_scan_plain"]

LIBRARY = "rwkv6_scan"
MAX_CHUNK = 16  # exp(-cw) stays finite in f32 only up to Q=16
MAX_HEAD = 64  # P: the kernel's shared-memory tiles are sized for P <= 64
DTYPES = (torch.bfloat16, torch.float32)


@torch.no_grad()
def rwkv6_chunked(
    r: torch.Tensor,  # (B, S, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, S, H, P)  log decay in [-e, 0)
    u: torch.Tensor,  # (H, P) bonus
    *,
    chunk: int = MAX_CHUNK,
    init_state: torch.Tensor | None = None,  # (B, H, P, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in r's dtype, final_state (B, H, P, P) f32)."""
    B, S, H, P = r.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    f32 = torch.float32
    rc = r.reshape(B, nc, Q, H, P).to(f32)
    kc = k.reshape(B, nc, Q, H, P).to(f32)
    vc = v.reshape(B, nc, Q, H, P).to(f32)
    lw = logw.reshape(B, nc, Q, H, P).to(f32)
    cw = torch.cumsum(lw, dim=2)  # inclusive
    cw_prev = cw - lw  # exclusive (cw_{i-1}; 0 at i=0)

    qn = rc * torch.exp(cw_prev)  # <= 1
    kn = kc * torch.exp(-cw)  # <= e^(Q |logw|_max), f32-safe for Q <= 16
    A = torch.einsum("bcihp,bcjhp->bchij", qn, kn)  # strict lower part is valid
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device), diagonal=-1)
    A = torch.where(strict[None, None, None], A, 0.0)
    bonus = torch.einsum("bcihp,hp,bcihp->bchi", rc, u.to(f32), kc)  # diagonal (j == i)
    A = A + bonus[..., :, None] * torch.eye(Q, dtype=f32, device=r.device)[None, None, None]
    y_intra = torch.einsum("bchij,bcjhq->bcihq", A, vc)

    # chunk boundary states
    kdec = kc * torch.exp(cw[:, :, -1:, :, :] - cw)  # decay to chunk end (exps <= 0)
    right = torch.einsum("bcjhp,bcjhq->bchpq", kdec, vc)
    chunk_decay = torch.exp(cw[:, :, -1])  # (B, nc, H, P)
    s = torch.zeros((B, H, P, P), dtype=f32, device=r.device) if init_state is None \
        else init_state.to(f32)
    s_prev = []
    for c in range(nc):  # the JAX twin's lax.scan over chunks
        s_prev.append(s)
        s = s * chunk_decay[:, c, ..., None] + right[:, c]
    s_prev = torch.stack(s_prev, dim=1)  # (B, nc, H, P, P)
    y_inter = torch.einsum("bcihp,bchpq->bcihq", rc * torch.exp(cw_prev), s_prev)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(r.dtype), s


def rwkv6_scan_plain(r, k, v, logw, u, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """:func:`rwkv6_chunked` in the kernel's heads-major layout, ``y`` only."""
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    y, _ = rwkv6_chunked(t(r), t(k), t(v), t(logw), u, chunk=chunk)
    return t(y)


def _launcher():
    fn = _build.load(LIBRARY).rwkv6_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def rwkv6_scan_hsd(
    r: torch.Tensor,  # (B, H, S, P)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, H, S, P) f32
    u: torch.Tensor,  # (H, P) f32
    *,
    chunk: int = MAX_CHUNK,
) -> torch.Tensor:
    """The wkv scan, heads-major; ``y (B, H, S, P)`` in r's dtype, with chunk
    length ``min(chunk, S)``. Raises for ``chunk > 16`` on every device. A
    CUDA ``r`` launches the kernel; a CPU one runs the plain version."""
    if chunk > MAX_CHUNK:
        raise ValueError(
            f"chunk {chunk} > {MAX_CHUNK}: exp(-cumsum(logw)) overflows f32 beyond Q={MAX_CHUNK}"
        )
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D, got {tuple(r.shape)}")
    B, H, S, P = r.shape
    Q = min(chunk, S)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if r.dtype not in DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; the kernel takes {DTYPES}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        check_operand(name, t, r.device, r.dtype, (B, H, S, P))
    check_operand("logw", logw, r.device, torch.float32, (B, H, S, P))
    check_operand("u", u, r.device, torch.float32, (H, P))
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if Q < 1 or S % Q:
        raise ValueError(f"chunk {Q} does not divide seq {S}")
    if P % 16 or P > MAX_HEAD:
        raise ValueError(f"P={P}: the kernel takes P a multiple of 16, at most {MAX_HEAD}")
    y = empty_in_layout(r)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, logw, y) for s in t.stride()[:3])
    )
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _launcher()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            y.data_ptr(), B, H, S, P, Q, strides, int(r.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    rwkv6_scan_hsd.launches += 1
    return y


rwkv6_scan_hsd.launches = 0
