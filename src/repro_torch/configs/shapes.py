"""Input-shape cells (assignment):

  train_4k     seq 4,096   global_batch 256   train_step
  prefill_32k  seq 32,768  global_batch 32    serve prefill
  decode_32k   cache 32,768 global_batch 128  serve decode (1 new token)
  long_500k    cache 524,288 global_batch 1   long-context decode

``long_500k`` runs only for sub-quadratic archs (rwkv6 linear, zamba2
hybrid-SSM, gemma3 5:1 sliding-window); pure full-attention archs skip it
(DESIGN.md §5). ``seq_len`` is the TOTAL backbone sequence: frontend archs
(phi-3-vision, musicgen) spend ``frontend_tokens`` of it on the stubbed
modality prefix.
"""
from __future__ import annotations

import dataclasses

SUBQUADRATIC = ("rwkv6-3b", "zamba2-7b", "gemma3-1b")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


CELLS = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(arch: str, cell_name: str) -> bool:
    if cell_name == "long_500k":
        return arch in SUBQUADRATIC
    return True


def all_cells(archs) -> list[tuple[str, str]]:
    out = []
    for a in archs:
        for c in CELLS:
            if applicable(a, c):
                out.append((a, c))
    return out
