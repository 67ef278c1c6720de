"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

:func:`ssd_chunked` is the plain version, the torch twin of the JAX model's
``models/ssm.py::ssd_chunked``: ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
``y_t = C_t . h_t``, computed chunk by chunk (the intra-chunk masked
"attention" form, then the chunk boundary states carried across chunks by a
Python loop where the JAX twin runs ``lax.scan``). It returns
``(y, final_state)``.

:func:`ssd_scan_hsd` takes heads-major ``x (B, H, S, P)``, ``dt (B, H, S)``,
``A (H,)``, ``B/C (B, S, N)`` and returns ``y (B, H, S, P)`` in x's dtype. On
a CUDA tensor it launches one kernel, by dtype, and raises on any input the
kernels do not take:

* bf16 -> ``csrc/ssd_scan_mma.cu``: the four products of a chunk on the
  tensor cores (``mma.sync``, f32 accumulators, the state f32 across
  chunks), the next chunk's loads by ``cp.async`` behind the current one;
* f32 -> ``csrc/ssd_scan.cu``: exact f32 FMAs on the CUDA cores in SGEMM
  register tiles; ``C B^T`` once per (b, chunk) by a grid of its own, then a
  block per (b, h, :func:`block_cols` value columns) that walks every chunk.

Both take any chunk length ``1 <= Q <= 128`` that divides S, as the JAX twin
does: a chunk runs in the kernel's tile instance of the smallest of
:data:`CHUNKS` rows at least Q (:func:`chunk_tile`), its padding rows zero.

Each launcher counts its own launches (``ssd_scan_mma.launches``,
``ssd_scan_f32.launches``), and ``ssd_scan_hsd.launches`` counts both. The
kernels read strided views (only the last axis must be dense), so the
model-layout wrapper ``ops.ssd_scan`` hands them transposed views and no copy
is made. On a CPU tensor the wrapper runs the plain version.
:class:`SSDScan` adds the gradient for training: the kernel's forward, the
plain version's backward (the JAX package has no backward kernel). The kernels
replace the TPU kernel ``_ssd_kernel`` / ``ssd_scan_hsd`` of the JAX package
and, like it, return ``y`` only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .grad import plain_gradients

__all__ = [
    "CHUNKS", "SSDScan", "block_cols", "check_ranks", "chunk_tile", "empty_in_layout",
    "ssd_chunked", "ssd_scan_f32", "ssd_scan_hsd", "ssd_scan_mma", "ssd_scan_plain",
]

CHUNKS = (16, 32, 64, 128)  # the kernels' tile instances, in rows
MAX_STATE = 64  # N: both kernels pad the state's rows to 64
DTYPES = (torch.bfloat16, torch.float32)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  (post-softplus)
    A: torch.Tensor,  # (H,)  negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final_state (B, H, N, P) f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    f32 = torch.float32
    xc = x.reshape(B, nc, Q, H, P).to(f32)
    dtc = dt.reshape(B, nc, Q, H).to(f32)
    Bc = Bm.reshape(B, nc, Q, N).to(f32)
    Cc = Cm.reshape(B, nc, Q, N).to(f32)
    la = dtc * A.to(f32)  # (B, nc, Q, H) log-decay, <= 0
    cum = torch.cumsum(la, dim=2)  # inclusive

    # intra-chunk (masked "attention" form); exp only where j <= i: the
    # masked entries may be +inf, and the select drops them
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H) cum_i - cum_j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    # the JAX twin's four-operand einsums, two operands at a time: torch's
    # einsum would otherwise materialize (B, nc, Q, Q, H, P)
    W = G[..., None] * L * dtc[:, :, None, :, :]  # (B, nc, Q, Q, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk boundary states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    right = torch.einsum("bcjn,bcjhp->bchnp", Bc, (dtc * decay_to_end)[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    h = torch.zeros((B, H, N, P), dtype=f32, device=x.device) if init_state is None \
        else init_state.to(f32)
    h_prev = []
    for c in range(nc):  # the JAX twin's lax.scan over chunks
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + right[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, H, N, P) state entering each chunk

    # inter-chunk contribution
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, h_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(x.dtype), h


def check_ranks(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor) -> None:
    """Raise unless x, dt and B are 4-, 3- and 3-D (heads-major)."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"x, dt and B must be 4-, 3- and 3-D, got {x.dim()}, {dt.dim()}, "
                         f"{Bm.dim()}")


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 64) -> torch.Tensor:
    """:func:`ssd_chunked` in the kernel's heads-major layout, ``y`` only;
    differentiable, its gradient is the kernel's (:class:`SSDScan`)."""
    check_ranks(x, dt, Bm)
    y, _ = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm, chunk=chunk)
    return y.transpose(1, 2)


def empty_in_layout(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of x's shape and dtype whose memory is dense in
    x's own axis order (by decreasing stride): the output of a kernel that was
    handed a transposed view then transposes back into a contiguous tensor."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    out = torch.empty([x.shape[d] for d in order], dtype=x.dtype, device=x.device)
    return out.permute(*sorted(range(x.dim()), key=order.__getitem__))


def chunk_tile(Q: int) -> int:
    """The tile instance a chunk of ``Q`` rows runs in: the smallest of
    :data:`CHUNKS` at least ``Q``."""
    for tile in CHUNKS:
        if Q <= tile:
            return tile
    raise ValueError(f"chunk {Q}: the kernels take chunks of at most {CHUNKS[-1]}")


def block_cols(P: int) -> int:
    """Value columns a block of the f32 kernel takes: the whole of 64 where
    they divide P, else 16."""
    return 64 if P % 64 == 0 else 16


def check_operand(
    name: str, t: torch.Tensor, device, dtype, shape: tuple, *, dense_last: bool = True
) -> None:
    """Raise unless ``t`` is on ``device`` with ``dtype`` and ``shape`` and,
    with ``dense_last``, a dense last axis (the scan kernels take any other
    strides)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if dense_last and t.stride(-1) != 1 and shape[-1] != 1:
        raise ValueError(f"{name} must have a dense last axis, has strides {t.stride()}")


def _strides(x, dt, Bm, Cm, y):
    return (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3]
    )


def rows_16b(t: torch.Tensor, n_strided: int) -> bool:
    """Whether every row of ``t`` starts 16-byte aligned: an aligned base
    and the first ``n_strided`` strides multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:n_strided])


def ssd_scan_mma(x, dt, A, Bm, Cm, y, Q: int) -> None:
    """Launch ``csrc/ssd_scan_mma.cu`` on checked bf16 CUDA tensors, writing
    ``y``, with a chunk of ``Q`` rows in its :func:`chunk_tile` instance;
    counts its launches. Rows of x, B and C that are 16-byte aligned, with N
    a multiple of 8, load by 16-byte ``cp.async``; any other strided view
    loads element by element."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    vec = N % 8 == 0 and rows_16b(x, 3) and rows_16b(Bm, 2) and rows_16b(Cm, 2)
    fn = _build.launcher("ssd_scan_mma", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), B, H, S, P, N, Q, chunk_tile(Q), _strides(x, dt, Bm, Cm, y),
                 int(vec), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_mma launch failed: CUDA error {err}")
    ssd_scan_mma.launches += 1


def ssd_scan_f32(x, dt, A, Bm, Cm, y, Q: int) -> None:
    """Launch ``csrc/ssd_scan.cu`` on checked f32 CUDA tensors, writing
    ``y``, with a chunk of ``Q`` rows in its :func:`chunk_tile` instance;
    counts one launch a call. The call runs ``C B^T`` of every (b, chunk)
    into a workspace, then y, a block per (b, h, :func:`block_cols` value
    columns). Rows of x, B and C that are 16-byte aligned, with N a multiple
    of 4, load by 16-byte ``cp.async``; any other strided view loads element
    by element."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    gram = torch.empty((B, S // Q, Q, -(-Q // 4) * 4), dtype=torch.float32, device=x.device)
    vec = N % 4 == 0 and rows_16b(x, 3) and rows_16b(Bm, 2) and rows_16b(Cm, 2)
    fn = _build.launcher("ssd_scan", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), gram.data_ptr(), B, H, S, P, N, Q, chunk_tile(Q), block_cols(P),
                 _strides(x, dt, Bm, Cm, y), int(vec),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan_f32.launches += 1


@torch.no_grad()
def ssd_scan_hsd(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S) f32
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """The SSD scan, heads-major; ``y (B, H, S, P)`` in x's dtype. A CUDA
    ``x`` launches the bf16 or the f32 kernel with chunk length
    ``min(chunk, S)``, any length up to 128 that divides S (the JAX twin's
    contract: S % Q raises there too); a CPU one runs the plain version."""
    check_ranks(x, dt, Bm)
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes {DTYPES}")
    check_operand("x", x, x.device, x.dtype, (B, H, S, P))
    check_operand("dt", dt, x.device, torch.float32, (B, H, S), dense_last=False)
    check_operand("A", A, x.device, torch.float32, (H,))
    check_operand("B", Bm, x.device, x.dtype, (B, S, N))
    check_operand("C", Cm, x.device, x.dtype, (B, S, N))
    if not 1 <= Q <= CHUNKS[-1] or S % Q:
        raise ValueError(f"chunk {Q} for seq {S}: the kernels take chunks of 1 to {CHUNKS[-1]} "
                         "that divide S")
    if not 1 <= N <= MAX_STATE or P % 16:
        raise ValueError(f"N={N}, P={P}: the kernel takes N <= {MAX_STATE} and P a multiple of 16")
    y = empty_in_layout(x)
    if x.dtype == torch.bfloat16:
        ssd_scan_mma(x, dt, A, Bm, Cm, y, Q)
    else:
        ssd_scan_f32(x, dt, A, Bm, Cm, y, Q)
    ssd_scan_hsd.launches += 1
    return y


class SSDScan(torch.autograd.Function):
    """:func:`ssd_scan_hsd`'s forward (the same checks, launch and counts)
    with :func:`ssd_scan_plain`'s gradient for x, dt, A, B and C, recomputed
    from the saved inputs in their own dtypes (dt and A f32;
    ``kernels/grad.py``). ``kw`` holds ``chunk``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, kw: dict):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.kw = kw
        return ssd_scan_hsd(x, dt, A, Bm, Cm, **kw)

    @staticmethod
    def backward(ctx, grad_y):
        return plain_gradients(ctx, ssd_scan_plain, grad_y)


ssd_scan_hsd.launches = 0  # both kernels
ssd_scan_mma.launches = 0
ssd_scan_f32.launches = 0
