"""PyTorch/CUDA port of the ENTS scheduler (see ``repro_torch.core`` and
``repro_torch.fleet``).

The scheduling control plane (graphs, paths, allocation, the online
scheduler, the fleet runtimes) is host-side numpy; the JRBA relaxation runs
in PyTorch, on an NVIDIA GPU through a hand-written CUDA kernel
(``repro_torch.kernels``) unless the caller asks for the CPU.
"""
