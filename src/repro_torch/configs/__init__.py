"""Assigned-architecture configs (``--arch <id>``) + input-shape cells.

Each module registers one exact published configuration plus a reduced
``<id>-smoke`` variant for CPU tests. ``shapes.py`` defines the four input
cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from .base import Block, ModelConfig, get_config, list_configs, register

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        deepseek_v2_lite_16b,
        deepseek_v3_671b,
        gemma3_1b,
        internlm2_1_8b,
        minicpm3_4b,
        musicgen_medium,
        phi_3_vision_4_2b,
        rwkv6_3b,
        starcoder2_7b,
        zamba2_7b,
    )


ARCH_IDS = (
    "phi-3-vision-4.2b",
    "zamba2-7b",
    "deepseek-v3-671b",
    "deepseek-v2-lite-16b",
    "internlm2-1.8b",
    "starcoder2-7b",
    "gemma3-1b",
    "minicpm3-4b",
    "rwkv6-3b",
    "musicgen-medium",
)

__all__ = ["ARCH_IDS", "Block", "ModelConfig", "get_config", "list_configs", "register"]
