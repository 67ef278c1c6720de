"""A rank of the two-process ``gloo`` group that ``test_torch_optim.py``
starts: it runs the port's ``cross_pod_allreduce`` on its own gradients and
error state and saves what comes back. Imports neither JAX nor the JAX
package, so a spawned process starts quickly."""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.compression import cross_pod_allreduce


def run(rank: int, world: int, init_method: str, directory: str, codec: str) -> None:
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        inputs = np.load(os.path.join(directory, f"in_{rank}.npz"))
        n = len(inputs.files) // 2
        grads = {f"g{i}": torch.from_numpy(inputs[f"g{i}"]) for i in range(n)}
        err = {f"g{i}": torch.from_numpy(inputs[f"e{i}"]) for i in range(n)}
        summed, new_err = cross_pod_allreduce(grads, err, codec=codec)
        out = {f"s{i}": summed[f"g{i}"].numpy() for i in range(n)}
        out.update({f"e{i}": new_err[f"g{i}"].numpy() for i in range(n)})
        np.savez(os.path.join(directory, f"out_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
