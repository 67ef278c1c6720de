"""Clean fixture: a kernel wrapper that reads only metadata."""
import torch


def launch(x: torch.Tensor, n: int, *, chunk: int = 16, device=None) -> torch.Tensor:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError("wrong operand")
    if chunk > n or x.numel() == 0 or x.stride(-1) != 1:
        raise ValueError("wrong shape")
    return torch.where(x < 0, -x, x)
