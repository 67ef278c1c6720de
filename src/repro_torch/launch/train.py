"""Training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b-smoke \
      --steps 5 --device cpu

Trains on the card unless ``--device cpu`` is given, every architecture of
``repro_torch.configs`` (``--arch internlm2-1.8b --batch 4 --seq 2048`` at full
width on one H100): the seeded random init, the synthetic data pipeline with
prefetch, AdamW with the config's moment dtype and factoring, remat as the
config says, and checkpoint save and resume with ``--ckpt-dir`` (which needs
``msgpack`` and ``zstandard``). The arguments, the AdamW settings and the log
lines are the JAX package's ``launch/train.py``'s; there is no ``jit``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..data import DataConfig, Prefetcher, data_iterator
from ..optim import AdamWConfig
from ..train import AsyncCheckpointer, TrainConfig, init_train_state, latest_step, make_train_step
from ..train import restore as ckpt_restore


def _to_device(batch: dict, device) -> dict:
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if "frontend_embeds" in out:  # as the JAX driver feeds them
        out["frontend_embeds"] = out["frontend_embeds"].to(torch.bfloat16)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    opt_cfg = AdamWConfig(
        lr=args.lr,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        moment_dtype=cfg.optimizer_state_dtype,
        factored_second_moment=cfg.optimizer_factored,
    )
    train_cfg = TrainConfig(microbatches=args.microbatches)
    state = init_train_state(cfg, opt_cfg, args.seed, train_cfg=train_cfg, device=args.device)
    start_step = 0
    ck = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck is not None:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = ckpt_restore(args.ckpt_dir, last, state)
            start_step = last
            print(f"resumed from step {last}")

    dcfg = DataConfig(
        vocab=cfg.vocab,
        global_batch=args.batch,
        seq_len=args.seq + (cfg.frontend_tokens if cfg.frontend else 0),
        seed=args.seed,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model,
    )
    data = Prefetcher(data_iterator(dcfg, start_step))
    step_fn = make_train_step(cfg, opt_cfg, train_cfg)

    losses, step_seconds = [], []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            t_step = time.perf_counter()
            state, metrics = step_fn(state, _to_device(next(data), args.device))
            losses.append(float(metrics["loss"]))  # waits for the step
            step_seconds.append(time.perf_counter() - t_step)
            if (step + 1) % args.log_every == 0:
                dt = (time.time() - t0) / (step + 1 - start_step)
                print(
                    f"step {step + 1:5d}  loss {losses[-1]:.4f}  ce {float(metrics['ce']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f}  lr {float(metrics['lr']):.2e} "
                    f"({dt:.2f}s/step)"
                )
            if ck is not None and (step + 1) % args.ckpt_every == 0:
                ck.save(step + 1, state)
        if ck is not None:
            ck.save(args.steps, state)
            ck.wait()
    finally:
        data.close()
    return {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "losses": losses,
        "step_seconds": step_seconds,
    }


if __name__ == "__main__":
    out = main()
    print(f"done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")
