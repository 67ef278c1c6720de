"""Clean fixture: the same shapes with no host sync — zero JP findings."""
import torch


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(s)
        if x.dim() > 2 and x.device.type == "cuda":  # metadata, not data
            return torch.where(s > 0, x * s, x)
        return x

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        if ctx.needs_input_grad[0] and grad is not None:  # host flags, identity test
            return grad * s, None
        return None, None


@torch.compile
def compiled(x, scale: float = 1.0, sizes=(1, 2)):
    return x * scale


def passed(x):
    def inner(y):
        return torch.clamp(y, max=1.0)

    return torch.compile(inner)(x)


def host_side(x):
    # not a region: the host may read values outside them
    return float(x.sum())
