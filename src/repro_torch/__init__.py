"""PyTorch/CUDA port of the ENTS scheduler (see ``repro_torch.core`` and
``repro_torch.fleet``) and of its model-serving path (``repro_torch.models``,
``repro_torch.serving``, ``repro_torch.core.placement``).

The scheduling control plane (graphs, paths, allocation, the online
scheduler, the fleet runtimes) is host-side numpy; the JRBA relaxation runs
in PyTorch, on an NVIDIA GPU through a hand-written CUDA kernel
(``repro_torch.kernels``) unless the caller asks for the CPU. The dense
attention models run on the card too, their prefill attention through the
hand-written flash-attention kernel.
"""
