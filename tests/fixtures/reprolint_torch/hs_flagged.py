"""Flagged fixture: every JP2xx rule of the host-sync pass fires at least once.

Pure syntax — never imported, so the torch calls never run."""
import torch

CACHE = {}


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        if s > 0:  # JP202: Python branch on a tensor
            return x * float(s)  # JP201: host cast
        return x

    @staticmethod
    def backward(ctx, grad):
        print(grad.sum().item())  # JP201: .item()
        return grad, None


@torch.compile
def compiled(x, sizes=[1, 2]):  # JP204: unhashable default in a compiled region
    return x * CACHE.get("scale", 1.0)  # JP203: module-level mutable read


class Runner:
    scale = 2.0

    def capture(self, g, x):
        def body(y):
            torch.cuda.synchronize()  # JP201: a sync inside a capture
            return y * self.scale  # JP203: instance state baked into the graph

        with torch.cuda.graph(g):
            return body(x)


def passed(x):
    def inner(y):
        while y.max() > 1:  # JP202: loop on a tensor value
            y = y / 2
        return y

    return torch.compile(inner)(x)
