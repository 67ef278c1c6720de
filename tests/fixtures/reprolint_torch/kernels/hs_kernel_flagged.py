"""Flagged fixture: a module under ``kernels/`` is patrolled function by
function, so a wrapper's host read fires JP201 and JP202."""
import torch


def launch(x: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    if n > 4 and x.shape[0] == n:  # an int parameter and metadata: clean
        pass
    width = int(x.max())  # JP201: the host waits for the widest row
    if (x < 0).any():  # JP202: a branch on a tensor value
        x = x.abs()
    return x[:width]
