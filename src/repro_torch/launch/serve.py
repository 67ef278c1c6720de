"""Serving entry point: continuous-batching engine over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b-smoke \
      --requests 16 --slots 4 --device cpu

Every architecture of ``repro_torch.configs`` runs, full size or ``-smoke``:
the dense attention models, the MLA models (minicpm3-4b; deepseek-v2-lite-16b
and deepseek-v3-671b with MoE MLPs), zamba2-7b and rwkv6-3b; e.g. on the card
``--arch deepseek-v2-lite-16b --requests 8 --slots 4``.

Weights are the port's seeded random init; nothing is downloaded. Runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import init_params
from ..serving import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    params = init_params(cfg, args.seed, device=args.device)
    eng = ServingEngine(cfg, params, slots=args.slots, max_len=args.max_len, device=args.device)
    rng = np.random.RandomState(args.seed)
    for i in range(args.requests):
        prompt = rng.randint(1, cfg.vocab, size=rng.randint(3, 12)).tolist()
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=int(rng.randint(4, 16))))
    t0 = time.time()
    done = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(
        f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens / max(dt, 1e-9):.1f} tok/s, slots={args.slots}, "
        f"ticks={eng.ticks}, device={eng.device})"
    )
    return {"requests": len(done), "tokens": total_tokens, "seconds": dt, "ticks": eng.ticks}


if __name__ == "__main__":
    main()
