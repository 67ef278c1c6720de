"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``jrba_congestion`` runs the sparse JRBA relaxation (the scheduler's solver
loop) as one CUDA kernel launch per batch. Sources live in ``csrc/`` and are
compiled for Hopper on first use (``_build``); importing this package builds
nothing and needs no CUDA toolkit.
"""
