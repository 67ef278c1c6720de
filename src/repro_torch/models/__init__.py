"""Model substrate of the port: one composable decoder over the configs in
``repro_torch.configs``. This slice runs the dense attention architectures
(GQA / sliding-window attention with dense MLPs); prefill attention runs the
hand-written flash-attention kernel on the card."""
from .model import decode_step, forward, init_cache, init_params, prefill

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill"]
