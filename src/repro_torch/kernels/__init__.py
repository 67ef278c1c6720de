"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``jrba_congestion`` runs the sparse JRBA relaxation (the scheduler's solver
loop) as one CUDA kernel launch per batch; ``flash_attention`` runs causal GQA
attention with an optional sliding window (the models' prefill attention,
through the layout wrapper in ``ops``) in a bf16 tensor-core kernel (wgmma and
TMA) or an f32 CUDA-core kernel, by dtype; ``ssd`` and ``rwkv6`` run the Mamba-2
and RWKV-6 chunked scans (the SSM mixers' prefill, through ``ops`` too), the
SSD scan in a bf16 tensor-core kernel (mma.sync, cp.async) or an f32
CUDA-core kernel, by dtype. Sources live in ``csrc/`` and are
compiled for Hopper on first use (``_build``); importing this package builds
nothing and needs no CUDA toolkit.
"""
