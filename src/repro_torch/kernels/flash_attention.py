"""Causal GQA flash attention: the CUDA kernel's wrapper and its plain version.

:func:`flash_attention_hsd` takes heads-major q ``(B, H, S, D)`` and k/v
``(B, KH, S, D)`` and returns ``(B, H, S, D)`` in q's dtype: causal
attention with an optional sliding window (``pos_k > pos_q - window``), kv
head ``h // (H // KH)``, products and softmax in f32.

On a CUDA tensor it launches ``csrc/flash_attention.cu`` once (counted in
``flash_attention_hsd.launches``) and raises on any input the kernel does not
take. On a CPU tensor it runs the plain version, :func:`blockwise_attention`,
the online-softmax twin that the JAX model runs where the TPU would run the
kernel. The kernel replaces the TPU kernel ``_flash_kernel`` /
``flash_attention_hsd`` of the JAX package; its source note says what bounds
it on Hopper and how the design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "HEAD_DIMS",
    "blockwise_attention",
    "flash_attention_hsd",
    "flash_attention_plain",
]

LIBRARY = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)  # the kernel's template instances
DTYPES = (torch.bfloat16, torch.float32)


@torch.no_grad()
def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, Dk)
    k: torch.Tensor,  # (B, S, KH, Dk)
    v: torch.Tensor,  # (B, S, KH, Dv)
    *,
    window: int = 0,  # 0 = full causal; >0 sliding window
    chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Blockwise causal attention with an online softmax over (chunk, chunk)
    tiles, skipping kv tiles outside the causal/window band; model layout
    ``(B, S, H, D)``. The plain version of the kernel."""
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
        for kj in range(max(0, qi - span + 1), qi + 1):
            s = torch.einsum("bikgd,bjkd->bikgj", qblk, kc[:, kj].float())
            pos_k = kj * chunk + ar
            live = pos_k[None, :] <= pos_q[:, None]
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0, chunk: int = 1024
) -> torch.Tensor:
    """:func:`blockwise_attention` in the kernel's heads-major layout."""
    out = blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=window, chunk=chunk
    )
    return out.transpose(1, 2)


def _check(name: str, x: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, expected {like.device}")
    if x.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {like.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launcher():
    fn = _build.load(LIBRARY).flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def flash_attention_hsd(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,  # (B, KH, S, D)
    *,
    window: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Causal (sliding-window when ``window > 0``) GQA attention, heads-major,
    scaled by ``D**-0.5``. A CUDA ``q`` launches the kernel; a CPU one runs
    the plain version with tiles of ``chunk`` (which must divide S; the
    kernel ignores it)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and {tuple(k.shape)}")
    B, H, S, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if Skv != S:
        # the TPU kernel aligns the causal mask top-left, its dense oracle
        # bottom-right; the model only attends with Sq == Skv
        raise ValueError(f"Sq={S} != Skv={Skv}: the kernel takes Sq == Skv only")
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes {DTYPES}")
    _check("q", q, q, (B, H, S, D))
    _check("k", k, q, (B, KH, S, D))
    _check("v", v, q, (B, KH, S, D))
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}; the kernel is built for {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KH, S, D, int(window), D**-0.5, int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_hsd.launches += 1
    return out


flash_attention_hsd.launches = 0
