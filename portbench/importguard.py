"""The run may not load the JAX package or JAX: the measured program is the
PyTorch port. Names are compared whole, by the part before the first dot, so
``repro_torch`` passes where ``repro`` and ``repro.core`` do not."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
