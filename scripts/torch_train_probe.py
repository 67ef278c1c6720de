#!/usr/bin/env python3
"""Where the port's kernel-vs-plain training gradient gap comes from, and
how far the loss falls over a short run, on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 scripts/torch_train_probe.py [--arch internlm2-1.8b] [--batch 4]
        [--seq 2048] [--logit-stds 0 1] [--seeds 0 1] [--steps 8] [--lr 3e-3]

From ``init_train_state`` (seed 0) and step 0 of the synthetic pipeline, as
``chip_smoke.py``'s training phase builds them, it takes the gradient of one
step (``loss_and_grads``) four times: twice through the kernels and twice
through their plain versions. For each pair (kernel twice, plain twice,
kernel against plain) it prints each leaf's largest gap as a share of the
second's largest entry, the leaves with the largest shares, and for the
embedding the row with the largest gap, its token's count in the batch and
the gap as a share of that row's largest entry. For kernel against plain it
also reads the gradient at the embedding's output, one vector a position,
which the embedding's backward sums into its token's row: its gap as a share
of its largest entry, the largest row share among tokens seen once and among
tokens seen 100 times or more, and at the worst row's worst column how far
the summed terms cancel (|sum| over the sum of |terms|), with the entry of
each path's embedding gradient beside the f32 sum of its terms and beside the
backward's ``index_put_`` redone on the plain path's terms. It does so at the init's
unembedding scale (``--logit-stds 0``) and with the unembedding table scaled
so that the logits' standard deviation is each other value given. Then it
runs ``repro_torch.launch.train`` for ``--steps`` steps at ``--lr`` from
each ``--seeds`` seed and prints the losses and the margin of the last below
the first. The last line is the result as one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.obs.trace import dumps_strict  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the flash kernel's plain version."""
    saved = model_attention.flash_attention

    def attention(q, k, v, *, causal=True, window=0, scale=None, chunk=1024):
        return fa.blockwise_attention(q, k, v, window=window, chunk=chunk, scale=scale,
                                      causal=causal)

    model_attention.flash_attention = attention
    try:
        yield
    finally:
        model_attention.flash_attention = saved


@contextlib.contextmanager
def embedding_output_grad(store: list):
    """Keep the gradient at the embedding's output in ``store``."""
    saved = model_mod.embed_apply

    def embed(table, tokens):
        out = saved(table, tokens)
        if out.requires_grad:
            out.register_hook(lambda g: store.append(g.detach().clone()))
        return out

    model_mod.embed_apply = embed
    try:
        yield
    finally:
        model_mod.embed_apply = saved


def grads_of(params, cfg, batch, *, plain: bool, n_layers: int) -> tuple[dict, float]:
    """(path -> gradient, loss) of one step, the gradient at the embedding's
    output under ``"embed_out"``; the kernel path launches the bf16 flash
    kernel twice a layer (forward and remat's recompute), the plain path
    never."""
    before = fa.flash_attention_wgmma.launches
    store: list = []
    with plain_attention() if plain else contextlib.nullcontext(), embedding_output_grad(store):
        grads, metrics = loss_and_grads(params, cfg, TrainConfig(), batch)
    launches = fa.flash_attention_wgmma.launches - before
    assert launches == (0 if plain else 2 * n_layers), launches
    assert len(store) == 1, len(store)
    return {**dict(tree_paths(grads)), "embed_out": store[0]}, float(metrics["loss"])


def cancellation(got: dict, want: dict, tokens: torch.Tensor) -> dict:
    """The embedding's gradient rows as sums of the per-position gradients at
    its output: where the kernel-vs-plain gap sits, and how far the worst
    row's terms cancel."""
    g_out, w_out = got["embed_out"].float(), want["embed_out"].float()
    flat = tokens.reshape(-1)
    g_out, w_out = g_out.reshape(flat.numel(), -1), w_out.reshape(flat.numel(), -1)
    gap = (got["embed"].float() - want["embed"].float()).abs()
    row_share = gap.amax(dim=1) / want["embed"].float().abs().amax(dim=1).clamp_min(1e-30)
    counts = torch.bincount(flat, minlength=gap.shape[0])
    row = int(gap.amax(dim=1).argmax())
    col = int(gap[row].argmax())
    terms, gterms = w_out[flat == row, col], g_out[flat == row, col]
    def largest(mask):
        return float(row_share[mask].max()) if bool(mask.any()) else None

    return {"out_share": float((g_out - w_out).abs().max()) / float(w_out.abs().max()),
            "row_share_seen_once": largest(counts == 1),
            "row_share_seen_100_plus": largest(counts >= 100),
            "rows_seen_100_plus": int((counts >= 100).sum()),
            "worst": {"token": row, "column": col, "terms": int(terms.numel()),
                      "sum": float(terms.sum()), "sum_abs": float(terms.abs().sum()),
                      "cancel": float(terms.sum().abs() / terms.abs().sum()),
                      "sum_gap": float((gterms - terms).sum().abs()),
                      "sum_abs_gap": float((gterms - terms).abs().sum()),
                      "leaf_kernel": float(got["embed"][row, col]),
                      "leaf_plain": float(want["embed"][row, col]),
                      "f32_sum_kernel": float(gterms.sum()), "f32_sum_plain": float(terms.sum()),
                      "index_put_plain": index_put_entry(want, flat, row, col)}}


def index_put_entry(grads: dict, flat: torch.Tensor, row: int, col: int) -> float:
    """Entry (row, col) of the embedding's backward redone on ``grads``'
    per-position gradients: ``index_put_`` with accumulation into a zero table
    of the gradient's dtype."""
    out = grads["embed_out"].reshape(flat.numel(), -1)
    table = torch.zeros_like(grads["embed"]).index_put_((flat.long(),), out, accumulate=True)
    return float(table[row, col])


def compare(got: dict, want: dict, tokens: torch.Tensor, top: int = 3) -> dict:
    """Each leaf's largest gap over ``want``'s largest entry; the ``top``
    leaves, the embedding's share and its worst row."""
    shares = {}
    for path, g in ((p, g) for p, g in got.items() if p != "embed_out"):
        w = want[path].float()
        shares[path] = float((g.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    ranked = sorted(shares.items(), key=lambda e: -e[1])[:top]
    rec = {"equal_leaves": sum(torch.equal(got[p], want[p]) for p in shares),
           "leaves": len(shares), "top": ranked, "embed": shares.get("embed")}
    if "embed" in got:
        gap = (got["embed"].float() - want["embed"].float()).abs().amax(dim=1)
        row = int(gap.argmax())
        row_max = float(want["embed"][row].float().abs().max())
        rec["embed_row"] = {"token": row, "count_in_batch": int((tokens == row).sum()),
                            "gap": float(gap[row]), "share_of_row_max": float(gap[row]) /
                            max(row_max, 1e-30)}
    return rec


def logit_stats(params, cfg, tokens) -> dict:
    with torch.no_grad():
        logits, _ = forward(params, cfg, tokens)
        top = torch.softmax(logits, dim=-1).amax(dim=-1)
        rec = {"logit_std": float(logits.std()), "mean_top_prob": float(top.mean()),
               "share_top_prob_over_0.99": float((top > 0.99).float().mean())}
    del logits, top
    torch.cuda.empty_cache()
    return rec


def gap_study(args, card: str) -> list:
    cfg = get_config(args.arch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps, moment_dtype=cfg.optimizer_state_dtype,
                      factored_second_moment=cfg.optimizer_factored)
    state = init_train_state(cfg, opt, 0, device="cuda")
    params = state["params"]
    del state
    dcfg = DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(dcfg, 0).items()}
    n_layers = sum(1 for b in cfg.blocks if b.mixer in ("gqa", "swa"))
    out = []
    for target in args.logit_stds:
        stats = logit_stats(params, cfg, batch["tokens"])
        if target > 0:
            with torch.no_grad():
                params["unembed"].mul_(target / stats["logit_std"])
            stats = logit_stats(params, cfg, batch["tokens"])
        k1, loss_k = grads_of(params, cfg, batch, plain=False, n_layers=n_layers)
        k2, _ = grads_of(params, cfg, batch, plain=False, n_layers=n_layers)
        p1, loss_p = grads_of(params, cfg, batch, plain=True, n_layers=n_layers)
        p2, _ = grads_of(params, cfg, batch, plain=True, n_layers=n_layers)
        rec = {"target_logit_std": target or "init", **stats, "loss_kernel": loss_k,
               "loss_plain": loss_p,
               "kernel_twice": compare(k1, k2, batch["tokens"]),
               "plain_twice": compare(p1, p2, batch["tokens"]),
               "kernel_vs_plain": compare(k1, p1, batch["tokens"]),
               "kernel_vs_plain_rows": cancellation(k1, p1, batch["tokens"])}
        print(f"[gaps] {dumps_strict(rec)} [{card}]", flush=True)
        out.append(rec)
        del k1, k2, p1, p2
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def loss_runs(args, card: str) -> list:
    out = []
    for seed in args.seeds:
        res = train_driver.main(["--arch", args.arch, "--batch", str(args.batch), "--seq",
                                 str(args.seq), "--steps", str(args.steps), "--lr",
                                 str(args.lr), "--log-every", str(args.steps), "--seed",
                                 str(seed)])
        losses = res["losses"]
        rec = {"seed": seed, "lr": args.lr, "losses": losses,
               "margin": losses[0] - losses[-1],
               "margin_share": (losses[0] - losses[-1]) / losses[0]}
        print(f"[losses] {dumps_strict(rec)} [{card}]", flush=True)
        out.append(rec)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--logit-stds", type=float, nargs="*", default=[0.0, 1.0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    result = {"card": card, "gaps": gap_study(args, card), "losses": loss_runs(args, card)}
    print(dumps_strict(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
