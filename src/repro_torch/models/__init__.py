"""Model substrate of the port: one composable decoder over the configs in
``repro_torch.configs``. The port runs every architecture there: GQA /
sliding-window attention, MLA (minicpm3, deepseek-v2/v3), dense and MoE MLPs,
the Mamba-2 hybrid with shared attention (zamba2) and RWKV-6; prefill
attention and the two SSM scans run hand-written kernels on the card."""
from .model import decode_step, forward, init_cache, init_params, prefill

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill"]
