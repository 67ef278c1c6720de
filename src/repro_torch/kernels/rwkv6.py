"""RWKV-6 (Finch) wkv scan: the CUDA kernels' wrapper and their plain version.

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
launches one kernel, by dtype, and raises on any input the kernels do not
take:

* bf16 -> ``csrc/rwkv6_scan_mma.cu`` (:func:`rwkv6_scan_mma`): the chunk's
  products on the tensor cores (``mma.sync``, operands built in f32 as bf16
  hi + lo pairs, the state f32 in registers), a warp per (b, h, segment of
  the sequence, value columns), the segments' states passed along between
  grids (:func:`segment_chunks` plans the segments);
* f32 -> ``csrc/rwkv6_scan.cu`` (:func:`rwkv6_scan_f32`): the same
  decomposition (a warp per (b, h, segment, value columns), the state in
  registers, the same segment plan) with exact f32 FMAs on the CUDA cores;
  a head's warps form one block and share the chunk's loads and decays.

Each launcher counts its own launches, one a call however many grids it
runs (``rwkv6_scan_mma.launches``, ``rwkv6_scan_f32.launches``), and
``rwkv6_scan_hsd.launches`` counts both. The kernels read strided views, so
``ops.rwkv6_scan`` hands them transposed model-layout tensors without a copy.
On a CPU tensor the wrapper runs the plain version. :class:`RWKV6Scan` adds the
gradient for training: the kernel's forward, the plain version's backward (the
JAX package has no backward kernel). The kernels replace the TPU kernel
``_rwkv6_kernel`` / ``rwkv6_scan_hsd`` of the JAX package and, like it, return
``y`` only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .grad import plain_gradients
from .ssd import check_operand, empty_in_layout, rows_16b

__all__ = [
    "MAX_CHUNK", "RWKV6Scan", "check_chunk", "rwkv6_chunked", "rwkv6_scan_f32",
    "rwkv6_scan_hsd", "rwkv6_scan_mma", "rwkv6_scan_plain", "segment_chunks", "value_cols",
]

MAX_CHUNK = 16  # exp(-cw) stays finite in f32 only up to Q=16
MAX_HEAD = 64  # P: the kernels' tiles are sized for P <= 64
DTYPES = (torch.bfloat16, torch.float32)
# warps each kernel aims to run at once: the sequence is cut into as many
# segments as it takes (B * H * P / value_cols(P) warps a segment), each at
# least MIN_SEGMENT_CHUNKS chunks long
TARGET_WARPS = 2048
MIN_SEGMENT_CHUNKS = 16


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


def check_chunk(r: torch.Tensor, chunk: int) -> None:
    """Raise for a chunk above :data:`MAX_CHUNK` (on every device) or an r
    that is not 4-D."""
    if chunk > MAX_CHUNK:
        raise ValueError(
            f"chunk {chunk} > {MAX_CHUNK}: exp(-cumsum(logw)) overflows f32 beyond Q={MAX_CHUNK}"
        )
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D, got {tuple(r.shape)}")


def rwkv6_scan_plain(r, k, v, logw, u, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """:func:`rwkv6_chunked` in the kernel's heads-major layout, ``y`` only,
    with the wrappers' chunk limit; differentiable, its gradient is the
    kernel's (:class:`RWKV6Scan`)."""
    check_chunk(r, chunk)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    y, _ = rwkv6_chunked(t(r), t(k), t(v), t(logw), u, chunk=chunk)
    return t(y)


def value_cols(P: int) -> int:
    """Value columns a warp of either kernel takes: 32 where they divide P,
    else 16 (32 ran faster than 16 and 64 at rwkv6-3b's P = 64; PERF.md)."""
    return 32 if P % 32 == 0 else 16


def segment_chunks(B: int, H: int, S: int, P: int, Q: int) -> int:
    """Chunks of one segment of either kernel's sequence split: enough
    segments for about :data:`TARGET_WARPS` warps (a warp per (b, h, segment,
    :func:`value_cols` value columns)), none shorter than
    :data:`MIN_SEGMENT_CHUNKS` chunks. A sequence of one segment runs a
    single grid."""
    nchunks = S // Q
    per_segment = B * H * (P // value_cols(P))
    nseg = max(1, min(-(-TARGET_WARPS // per_segment), nchunks // MIN_SEGMENT_CHUNKS))
    return -(-nchunks // nseg)


def _strides(r, k, v, logw, y):
    return (ctypes.c_longlong * 15)(*(s for t in (r, k, v, logw, y) for s in t.stride()[:3]))


def _launch(name: str, r, k, v, logw, u, y, Q: int) -> None:
    """Launch ``csrc/<name>.cu`` on checked CUDA tensors, writing ``y``. A
    sequence of more than one segment (:func:`segment_chunks`) runs three
    grids: the segments' end states into a workspace, the states passed
    along, then y. Rows that are 16-byte aligned load by 16-byte
    ``cp.async``; any other strided view loads element by element."""
    B, H, S, P = r.shape
    seg = segment_chunks(B, H, S, P, Q)
    nseg = -(-(S // Q) // seg)
    state = decay = None
    if nseg > 1:
        state = torch.empty((B, H, nseg, P, P), dtype=torch.float32, device=r.device)
        decay = torch.empty((B, H, nseg, P), dtype=torch.float32, device=r.device)
    vec = all(rows_16b(t, 3) for t in (r, k, v, logw))
    fn = _build.launcher(name, [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                 y.data_ptr(), None if state is None else state.data_ptr(),
                 None if decay is None else decay.data_ptr(), B, H, S, P, Q, value_cols(P), seg,
                 _strides(r, k, v, logw, y), int(vec),
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def rwkv6_scan_mma(r, k, v, logw, u, y, Q: int) -> None:
    """Launch ``csrc/rwkv6_scan_mma.cu`` on checked bf16 CUDA tensors,
    writing ``y``; counts one launch a call, however many grids it runs."""
    _launch("rwkv6_scan_mma", r, k, v, logw, u, y, Q)
    rwkv6_scan_mma.launches += 1


def rwkv6_scan_f32(r, k, v, logw, u, y, Q: int) -> None:
    """Launch ``csrc/rwkv6_scan.cu`` on checked f32 CUDA tensors, writing
    ``y``; counts one launch a call, however many grids it runs."""
    _launch("rwkv6_scan", r, k, v, logw, u, y, Q)
    rwkv6_scan_f32.launches += 1


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
    CUDA ``r`` launches the bf16 or the f32 kernel; a CPU one runs the plain
    version."""
    check_chunk(r, chunk)
    B, H, S, P = r.shape
    Q = min(chunk, S)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if r.dtype not in DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; the kernels take {DTYPES}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        check_operand(name, t, r.device, r.dtype, (B, H, S, P))
    check_operand("logw", logw, r.device, torch.float32, (B, H, S, P))
    check_operand("u", u, r.device, torch.float32, (H, P))
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if Q < 1 or S % Q:
        raise ValueError(f"chunk {Q} does not divide seq {S}")
    if P % 16 or P > MAX_HEAD:
        raise ValueError(f"P={P}: the kernels take P a multiple of 16, at most {MAX_HEAD}")
    y = empty_in_layout(r)
    if r.dtype == torch.bfloat16:
        rwkv6_scan_mma(r, k, v, logw, u, y, Q)
    else:
        rwkv6_scan_f32(r, k, v, logw, u, y, Q)
    rwkv6_scan_hsd.launches += 1
    return y


class RWKV6Scan(torch.autograd.Function):
    """:func:`rwkv6_scan_hsd`'s forward (the same checks, launch and counts)
    with :func:`rwkv6_scan_plain`'s gradient for r, k, v, logw and u,
    recomputed from the saved inputs in their own dtypes (logw and u f32;
    ``kernels/grad.py``). ``kw`` holds ``chunk``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, kw: dict):
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.kw = kw
        return rwkv6_scan_hsd(r, k, v, logw, u, **kw)

    @staticmethod
    def backward(ctx, grad_y):
        return plain_gradients(ctx, rwkv6_scan_plain, grad_y)


rwkv6_scan_hsd.launches = 0  # both kernels
rwkv6_scan_mma.launches = 0
rwkv6_scan_f32.launches = 0
