"""GQA flash attention: the two CUDA kernels' wrapper and their plain version.

:func:`flash_attention_hsd` takes heads-major q ``(B, H, S, D)``, k ``(B, KH,
S, D)`` and v ``(B, KH, S, Dv)`` and returns ``(B, H, S, Dv)`` in q's dtype:
attention that is causal (``causal=True``, the default: ``pos_k <= pos_q``)
or not, with an optional sliding window (``pos_k > pos_q - window``), kv head
``h // (H // KH)``, the f32 scores multiplied by ``scale`` (``D**-0.5`` when
None), softmax in f32. The keywords are the JAX package's ``flash_attention_hsd``'s.

On a CUDA tensor it launches one kernel, by dtype, and raises on any input
the kernels do not take; both are built for the ``(D, Dv)`` pairs of
:data:`HEAD_DIMS` (Dv == D, and MLA's (96, 64) and (192, 128)):

- bf16: ``csrc/flash_attention_wgmma.cu`` (:func:`flash_attention_wgmma`),
  both products on the tensor cores with bf16 operands and f32 sums, P
  rounded to bf16 for P.V, tiles loaded by TMA. Its host-side plan (padded
  head dims, box sizes, stages, shared memory, grid) is :func:`wgmma_plan`.
- f32: ``csrc/flash_attention.cu`` (:func:`flash_attention_f32`), exact f32
  products on the CUDA cores: the yardstick of the f32 model checks.

Each launcher counts its own launches (``.launches``), and
``flash_attention_hsd.launches`` counts both. On a CPU tensor the wrapper runs
the plain version, :func:`blockwise_attention`, the online-softmax twin that
the JAX model runs where the TPU would run the kernel. :class:`FlashAttention`
adds the gradient for training: the kernel's forward, the plain version's
backward (the JAX package has no backward kernel). Both kernels replace
the TPU kernel ``_flash_kernel`` / ``flash_attention_hsd`` of the JAX
package; their source notes say what bounds them on Hopper and how the
designs answer that.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .grad import plain_gradients

__all__ = [
    "FlashAttention",
    "HEAD_DIMS",
    "WgmmaPlan",
    "blockwise_attention",
    "check_shapes",
    "flash_attention_f32",
    "flash_attention_hsd",
    "flash_attention_plain",
    "flash_attention_wgmma",
    "wgmma_plan",
]

NEG_INF = -1e30
# the (D, Dv) head-dim pairs both kernels take: q's and k's D, v's Dv
HEAD_DIMS = (
    (16, 16), (32, 32), (64, 64), (96, 96), (112, 112), (128, 128), (256, 256),
    (96, 64),  # minicpm3-4b's MLA: qk_nope 64 + qk_rope 32, v 64
    (192, 128),  # deepseek-v2's MLA: qk_nope 128 + qk_rope 64, v 128
)
DTYPES = (torch.bfloat16, torch.float32)
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100
BLOCK_Q = 128  # query rows of a wgmma CTA: two consumer warpgroups of 64
BOX_COLS = 64  # bf16 columns of one 128-byte swizzled TMA box


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """Host-side plan of one bf16 kernel launch; the launcher checks it
    against the compiled instance (``csrc/flash_attention_wgmma.cu``,
    ``Layout``)."""

    head_dim: int
    v_head_dim: int
    d_pad: int  # q's and k's head dim padded to whole 64-column boxes (zero columns)
    dv_pad: int  # v's and o's, the same way
    block_k: int  # keys of a K/V tile
    stages: int  # K/V slots in the ring

    @property
    def box_q(self) -> tuple[int, int]:
        """(columns, rows) of one Q box; ``d_pad // BOX_COLS`` boxes a tile."""
        return BOX_COLS, BLOCK_Q

    @property
    def box_kv(self) -> tuple[int, int]:
        """(columns, rows) of one K or V box; ``d_pad // BOX_COLS`` K boxes
        and ``dv_pad // BOX_COLS`` V boxes a tile."""
        return BOX_COLS, self.block_k

    @property
    def smem_bytes(self) -> int:
        """Q, the K and V ring, the mbarriers (q, and k full, v full, empty
        per slot) and 1024 bytes of slack to align the swizzled tiles."""
        q = BLOCK_Q * self.d_pad * 2
        kv = self.stages * self.block_k * (self.d_pad + self.dv_pad) * 2
        return 1024 + q + kv + 8 * (1 + 3 * self.stages)

    def grid(self, B: int, H: int, S: int) -> int:
        """CTAs: one per (128-row q tile, head, batch)."""
        return -(-S // BLOCK_Q) * H * B


def _pad(D: int) -> int:
    return -(-D // BOX_COLS) * BOX_COLS


def wgmma_plan(D: int, Dv: int) -> WgmmaPlan:
    """The bf16 kernel's plan for head dims ``D`` (q, k) and ``Dv`` (v, o):
    64-key tiles at Dv=256 (the f32 accumulator of 64 x 256 takes 128
    registers a thread), 128-key tiles below; two slots each."""
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head dims ({D}, {Dv}); the kernels are built for {HEAD_DIMS}")
    dv_pad = _pad(Dv)
    return WgmmaPlan(head_dim=D, v_head_dim=Dv, d_pad=_pad(D), dv_pad=dv_pad,
                     block_k=64 if dv_pad == 256 else 128, stages=2)


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, Dk)
    k: torch.Tensor,  # (B, S, KH, Dk)
    v: torch.Tensor,  # (B, S, KH, Dv)
    *,
    window: int = 0,  # 0 = no window; >0 sliding window
    chunk: int = 1024,
    scale: float | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Blockwise attention, causal or not, with an online softmax over
    (chunk, chunk) tiles, skipping kv tiles outside the causal/window band;
    model layout ``(B, S, H, D)``. The plain version of the kernel, and
    differentiable: its gradient is the kernel's (:class:`FlashAttention`)."""
    B, S, H, Dk = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    G = H // KH
    scale = scale if scale is not None else Dk**-0.5
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nq = S // chunk
    qc = q.reshape(B, nq, chunk, KH, G, Dk)
    kc = k.reshape(B, nq, chunk, KH, Dk)
    vc = v.reshape(B, nq, chunk, KH, Dv)
    span = nq if window == 0 else min(nq, (window + chunk - 1) // chunk + 1)
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for qi in range(nq):
        qblk = qc[:, qi].float() * scale  # (B, C, KH, G, Dk)
        pos_q = qi * chunk + ar
        m = torch.full((B, chunk, KH, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, chunk, KH, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, chunk, KH, G, Dv), dtype=torch.float32, device=q.device)
        # the band: the tiles before the diagonal as far as the window
        # reaches, and, when not causal, every tile after it (the window
        # bounds keys from below only)
        last = qi if causal else nq - 1
        for kj in range(max(0, qi - span + 1), last + 1):
            s = torch.einsum("bikgd,bjkd->bikgj", qblk, kc[:, kj].float())
            pos_k = kj * chunk + ar
            live = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
            if causal:
                live &= pos_k[None, :] <= pos_q[:, None]
            if window > 0:
                live &= pos_k[None, :] > pos_q[:, None] - window
            s = torch.where(live[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bikgj,bjkd->bikgd", p, vc[:, kj].float())
            m = m_new
        outs.append(acc / l[..., None].clamp_min(1e-30))
    out = torch.stack(outs, dim=1)  # (B, nq, C, KH, G, Dv)
    return out.reshape(B, S, H, Dv).to(q.dtype)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """:func:`blockwise_attention` in the kernel's heads-major layout, on the
    inputs the kernels take (:func:`check_shapes`)."""
    check_shapes(q, k, v)
    out = blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=window, chunk=chunk, scale=scale, causal=causal,
    )
    return out.transpose(1, 2)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k and v are 4-D, heads-major, with Sq == Skv and H a
    multiple of KH: what the kernels and, on every device, the wrappers
    take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    S, H, KH = q.shape[2], q.shape[1], k.shape[1]
    if k.shape[2] != S:
        # the TPU kernel aligns the causal mask top-left, its dense oracle
        # bottom-right; the model only attends with Sq == Skv
        raise ValueError(f"Sq={S} != Skv={k.shape[2]}: the kernel takes Sq == Skv only")
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")


def _check(name: str, x: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, expected {like.device}")
    if x.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {like.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention_wgmma(q, k, v, out, *, causal: bool, window: int, scale: float) -> None:
    """Launch ``csrc/flash_attention_wgmma.cu`` on checked bf16 CUDA tensors,
    writing ``out``; counts its launches."""
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    plan = wgmma_plan(D, Dv)
    fn = _build.launcher("flash_attention_wgmma", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, k.shape[1], S, D, Dv, int(window), int(causal), scale,
            plan.d_pad, plan.dv_pad, plan.block_k, plan.stages, plan.smem_bytes,
            plan.grid(B, H, S), _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_wgmma launch failed: error {err}")
    flash_attention_wgmma.launches += 1


def flash_attention_f32(q, k, v, out, *, causal: bool, window: int, scale: float) -> None:
    """Launch ``csrc/flash_attention.cu`` on checked f32 CUDA tensors,
    writing ``out``; counts its launches."""
    B, H, S, D = q.shape
    vec = all(x.data_ptr() % 16 == 0 for x in (q, k, v))  # else loads element by element
    fn = _build.launcher("flash_attention", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], S,
                 D, v.shape[-1], int(window), int(causal), scale, int(vec), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_f32.launches += 1


@torch.no_grad()
def flash_attention_hsd(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,  # (B, KH, S, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """GQA attention, heads-major, ``(B, H, S, Dv)``: causal unless
    ``causal=False``, within a sliding window when ``window > 0``, scores
    scaled by ``scale`` (``D**-0.5`` when None). A CUDA ``q`` launches the
    bf16 or the f32 kernel; a CPU one runs the plain version with tiles of
    ``chunk`` (which must divide S; the kernels ignore it)."""
    check_shapes(q, k, v)
    B, H, S, D = q.shape
    KH, Dv = k.shape[1], v.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                     chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernels take {DTYPES}")
    _check("q", q, q, (B, H, S, D))
    _check("k", k, q, (B, KH, S, D))
    _check("v", v, q, (B, KH, S, Dv))
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head dims ({D}, {Dv}); the kernels are built for {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = q.new_empty((B, H, S, Dv))
    if q.dtype == torch.bfloat16:
        # TMA reads each tensor from its base address: 16-byte alignment
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
        flash_attention_wgmma(q, k, v, out, causal=bool(causal), window=window, scale=scale)
    else:
        flash_attention_f32(q, k, v, out, causal=bool(causal), window=window, scale=scale)
    flash_attention_hsd.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_hsd`'s forward (the same checks, launch and
    counts) with :func:`flash_attention_plain`'s gradient, recomputed from
    the saved inputs (``kernels/grad.py``). ``kw`` holds ``causal``,
    ``window``, ``scale`` and ``chunk``."""

    @staticmethod
    def forward(ctx, q, k, v, kw: dict):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return flash_attention_hsd(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_gradients(ctx, flash_attention_plain, grad_out)


flash_attention_hsd.launches = 0  # both kernels
flash_attention_wgmma.launches = 0
flash_attention_f32.launches = 0
