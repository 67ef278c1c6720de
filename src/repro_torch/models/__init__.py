"""Model substrate of the port: one composable decoder over the configs in
``repro_torch.configs``. The port runs the dense attention architectures
(GQA / sliding-window attention with dense MLPs), the Mamba-2 hybrid with
shared attention (zamba2) and RWKV-6; prefill attention and the two SSM scans
run hand-written kernels on the card."""
from .model import decode_step, forward, init_cache, init_params, prefill

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill"]
