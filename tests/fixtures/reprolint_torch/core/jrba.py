"""Flagged fixture: the JRBA engine's dispatch functions in ``core/jrba.py``
are patrolled by name; a function not on the list is not."""
import numpy as np
import torch


def _to_host(*tensors: torch.Tensor) -> list:
    return [t.cpu().numpy() for t in tensors]  # JP201: the readback


def solve_relaxation_sparse(prog, solver, dev):
    cap = torch.from_numpy(prog.capacity).to(dev)
    if (cap > 0).all():  # JP202: a branch on a device value
        return solver(cap)
    return None


def finalize(w: torch.Tensor) -> float:
    return float(w.sum())  # host-side finalize: not a dispatch function


def rounding(m: np.ndarray) -> np.ndarray:
    return m.round()
