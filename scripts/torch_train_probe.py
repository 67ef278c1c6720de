#!/usr/bin/env python3
"""Where the port's kernel-vs-plain training gap comes from, and how far the
loss falls over a short run, on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card::

    python3 scripts/torch_train_probe.py [--arch internlm2-1.8b] [--batch 4]
        [--seq 2048] [--seeds 0 1] [--logit-stds 0 1] [--f32] [--positions]
        [--group-norm] [--steps 8] [--lr 3e-3]

``--arch`` is one of ``chip_smoke.py``'s ``TRAIN_RUNS``, at that run's depth.
For each seed, from ``init_params`` and step 0 of the synthetic pipeline at
that seed, it takes the gradient of one step (``loss_and_grads``) four times:
twice through the kernels (exactly the run's launches) and twice through
their plain versions (none). For each pair (kernel twice, plain twice, kernel
against plain) it prints the gradient norms and their distance, each leaf's
largest gap as a share of the second's largest entry and the leaves with the
largest shares, and for the embedding the row with the largest gap, its
token's count in the batch and the gap as a share of that row's largest
entry. For kernel against plain it also reads the gradient at the
embedding's output, one vector a position, which the embedding's backward
sums into its token's row: its gap as a share of its largest entry, the
largest row share among tokens seen once and among tokens seen 100 times or
more, and at the worst row's worst column how far the summed terms cancel
(|sum| over the sum of |terms|), with the entry of each path's embedding
gradient beside the f32 sum of its terms and beside the backward's
``index_put_`` redone on the plain path's terms. It does so at the init's
unembedding scale (``--logit-stds 0``) and with the unembedding table scaled
so that the logits' standard deviation is each other value given.

``--f32`` adds the gradient with the weights upcast to f32 through both
paths and holds each bf16 path against the f32 plain one. ``--positions``
reads, without a gradient, each position's loss through the bf16 kernels,
their bf16 plain versions and the f32 plain versions (the mean, spread and
first-position share of each pair's per-position gap), and at every kernel
call of the bf16 kernel forward the kernel's output and the bf16 plain
version's against the f32 plain version's on the same inputs (relative RMS
error and signed bias, over all rows and over the first positions).
``--group-norm`` reads, for an RWKV-6 model's bf16 paths, each layer's
group-norm input ``y`` (rows of 64 channels: the smallest variance, the
share of rows whose variance is below ``norm_eps``) and the gradient at
``y``: its norm, the shares of its square held by the rows below
``norm_eps`` and by the first position of each sequence, and the row of the
largest entry with that row's variance and position.

Then it runs ``repro_torch.launch.train`` for ``--steps`` steps (0: none) at
``--lr`` from each seed and prints the losses and the margin of the last
below the first. ``--device cpu`` runs the same study on the arch's smoke
config, where both paths are the plain versions. The last line is the
result as one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import forward, init_params, ssm  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.obs.trace import dumps_strict  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402


@contextlib.contextmanager
def patched(module, name: str, make):
    """``module.name`` replaced by ``make(saved)`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def embedding_output_grad(store: list):
    """Keep the gradient at the embedding's output in ``store``."""
    def make(saved):
        def embed(table, tokens):
            out = saved(table, tokens)
            if out.requires_grad:
                out.register_hook(lambda g: store.append(g.detach().clone()))
            return out
        return embed
    return patched(model_mod, "embed_apply", make)


def group_norm_reads(cfg, store: list):
    """Each RWKV-6 layer's group-norm input statistics and, in the backward,
    its gradient's, appended to ``store`` (one dict a layer call)."""
    eps = cfg.norm_eps

    def make(saved):
        def out(p, cfg_, y, g, B, S, d):
            with torch.no_grad():
                var = y.reshape(B, S, d // 64, 64).float().var(dim=-1, correction=0)
                rec = {"var_min": float(var.min()), "var_median": float(var.median()),
                       "rows_below_eps": float((var < eps).float().mean())}
            store.append(rec)
            if y.requires_grad:
                def hook(grad, rec=rec, var=var):
                    sq = grad.reshape(var.shape + (64,)).float().square().sum(dim=-1)
                    b, t, h = (int(i) for i in torch.unravel_index(sq.argmax(), sq.shape))
                    rec.update(grad_norm=float(sq.sum().sqrt()),
                               grad_share_below_eps=float(sq[var < eps].sum() / sq.sum()),
                               grad_share_first_position=float(sq[:, 0].sum() / sq.sum()),
                               grad_max_row={"b": b, "t": t, "h": h, "var": float(var[b, t, h]),
                                             "share": float(sq[b, t, h] / sq.sum())})
                y.register_hook(hook)
            return saved(p, cfg_, y, g, B, S, d)
        return out
    return patched(ssm, "_rwkv6_out", make)


def kernel_reads(store: list):
    """At each kernel call, the kernel's output and the bf16 plain
    version's, each against the f32 plain version's on the same inputs."""
    plain = {"attention": lambda q, k, v, *, causal=True, window=0, scale=None, chunk=1024:
             cs.fa.blockwise_attention(q, k, v, window=window, chunk=chunk, scale=scale,
                                       causal=causal),
             "ssd_scan": cs.SCANS["ssd_scan"][1], "rwkv6_scan": cs.SCANS["rwkv6_scan"][1]}

    def read(name, got, args, kw):
        want = plain[name](*args, **kw).float()
        f32 = plain[name](*(a.float() for a in args), **kw)
        rms = float(f32.square().mean().sqrt())
        rec = {"call": name, "differ": float((got != want.to(got.dtype)).float().mean())}
        for key, y in (("kernel", got.float()), ("plain", want)):
            err = y - f32
            rec[key] = {"rel_rms": float(err.square().mean().sqrt()) / rms,
                        "bias": float((err * f32.sign()).sum() / f32.abs().sum()),
                        "first_rel_rms": float(err[:, 0].square().mean().sqrt()) /
                        max(float(f32[:, 0].square().mean().sqrt()), 1e-30)}
        store.append(rec)

    def make(name):
        def wrap(saved):
            def call(*args, **kw):
                out = saved(*args, **kw)
                read(name, out, args, kw)
                return out
            return call
        return wrap

    stack = contextlib.ExitStack()
    stack.enter_context(patched(model_attention, "flash_attention", make("attention")))
    for name in ("ssd_scan", "rwkv6_scan"):
        stack.enter_context(patched(ops, name, make(name)))
    return stack


def grads_of(params, cfg, batch, *, plain: bool, expect: dict | None, gn: list | None = None
             ) -> tuple[dict, float]:
    """(path -> gradient, loss) of one step, the gradient at the embedding's
    output under ``"embed_out"``; ``expect``: the kernel launches the path
    must show (None on the CPU, which launches none)."""
    store: list = []
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(cs.plain_kernels())
        if gn is not None:
            stack.enter_context(group_norm_reads(cfg, gn))
        stack.enter_context(embedding_output_grad(store))
        fn = lambda: loss_and_grads(params, cfg, TrainConfig(), batch)  # noqa: E731
        if expect is None:
            grads, metrics = fn()
        else:
            (grads, metrics), _ = cs.counted_all(f"{cfg.name} step ({'plain' if plain else
                                                 'kernel'})", {} if plain else expect, fn)
    assert len(store) == 1, len(store)
    return {**dict(tree_paths(grads)), "embed_out": store[0]}, float(metrics["loss"])


def as_f32(launches: dict) -> dict:
    """The f32 kernels' launches of a path whose bf16 launches are given."""
    f32 = {"flash_attention_wgmma": "flash_attention", "ssd_scan_mma": "ssd_scan",
           "rwkv6_scan_mma": "rwkv6_scan"}
    return {f32[k]: n for k, n in launches.items()}


def norm(g: dict) -> float:
    return float(sum(t.double().square().sum() for k, t in g.items() if k != "embed_out")
                 ** 0.5)


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
    """Both norms and the distance over ``want``'s norm; each leaf's largest
    gap over ``want``'s largest entry; the ``top`` leaves, the embedding's
    share and its worst row."""
    shares, dist = {}, 0.0
    for path, g in ((p, g) for p, g in got.items() if p != "embed_out"):
        w = want[path].float()
        shares[path] = float((g.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        dist += float((g.double() - w.double()).square().sum())
    ranked = sorted(shares.items(), key=lambda e: -e[1])[:top]
    rec = {"norms": [norm(got), norm(want)], "distance": dist ** 0.5 / norm(want),
           "equal_leaves": sum(torch.equal(got[p], want[p]) for p in shares),
           "leaves": len(shares), "top": ranked, "embed": shares.get("embed")}
    if "embed" in got:
        gap = (got["embed"].float() - want["embed"].float()).abs().amax(dim=1)
        row = int(gap.argmax())
        row_max = float(want["embed"][row].float().abs().max())
        rec["embed_row"] = {"token": row, "count_in_batch": int((tokens == row).sum()),
                            "gap": float(gap[row]), "share_of_row_max": float(gap[row]) /
                            max(row_max, 1e-30)}
    return rec


def logit_stats(params, cfg, batch) -> dict:
    with torch.no_grad():
        logits, _ = forward(params, cfg, batch["tokens"], batch.get("frontend_embeds"))
        top = torch.softmax(logits, dim=-1).amax(dim=-1)
        rec = {"logit_std": float(logits.std()), "mean_top_prob": float(top.mean()),
               "share_top_prob_over_0.99": float((top > 0.99).float().mean())}
    del logits, top
    empty_cache()
    return rec


def position_losses(params, cfg, batch, reads: list | None = None) -> torch.Tensor:
    """Each position's CE (B, S) in f64 from one forward, no gradient."""
    with torch.no_grad(), kernel_reads(reads) if reads is not None else contextlib.nullcontext():
        logits, _ = forward(params, cfg, batch["tokens"], batch.get("frontend_embeds"))
        logits = logits.float()
        labels = batch["labels"].long()
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    del logits
    empty_cache()
    return ce.double()


def position_pair(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Per-position loss gap ``a - b``: the loss gap relative to ``b``'s
    loss, the gaps' spread and the mean over its standard error, and the
    shares of the summed gap and of the summed |gap| at the first position
    of each sequence and at the 1% largest |gap|."""
    d = (a - b).reshape(a.shape[0], -1)
    n, flat = d.numel(), d.reshape(-1).abs()
    top = flat.topk(max(n // 100, 1)).values.sum()
    b_, t_ = (int(i) for i in torch.unravel_index(d.abs().argmax(), d.shape))
    return {"loss_gap": float(d.mean() / b.mean()), "mean": float(d.mean()),
            "std": float(d.std()), "z": float(d.mean() / (d.std() / n ** 0.5)),
            "first_share_of_sum": float(d[:, 0].sum() / d.sum()),
            "first_share_of_abs": float(d[:, 0].abs().sum() / flat.sum()),
            "top1pct_share_of_abs": float(top / flat.sum()),
            "largest": {"b": b_, "t": t_, "gap": float(d[b_, t_])}}


def positions_study(params, cfg, batch, card: str) -> dict:
    reads: list = []
    kernel = position_losses(params, cfg, batch, reads)
    with cs.plain_kernels():
        plain = position_losses(params, cfg, batch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda t: t.detach().float(), params)
        f32 = position_losses(p32, cfg32, batch)
    del p32
    empty_cache()
    for rec in reads:
        print(f"[kernel call] {dumps_strict(rec)}", flush=True)
    calls = {}
    for rec in reads:
        c = calls.setdefault(rec["call"], {"calls": 0, "differ": 0.0, "kernel": {}, "plain": {}})
        c["calls"] += 1
        c["differ"] = max(c["differ"], rec["differ"])
        for key in ("kernel", "plain"):
            for stat, x in rec[key].items():
                c[key][stat] = max(c[key].get(stat, x), x, key=abs)
    rec = {"kernel_vs_plain": position_pair(kernel, plain),
           "plain_vs_f32": position_pair(plain, f32),
           "kernel_vs_f32": position_pair(kernel, f32),
           "calls_largest": calls}
    print(f"[positions] {dumps_strict(rec)} [{card}]", flush=True)
    return rec


def gap_study(args, cfg, seed: int, device, card: str) -> list:
    params = tree_map(lambda t: t.requires_grad_(), init_params(cfg, seed, device=device))
    batch = cs.train_batch(cfg, device, args.batch, args.seq, seed)
    expect = cs.TRAIN_RUNS[args.arch].launches if device.type == "cuda" else None
    rwkv = args.group_norm and any(b.mixer == "rwkv6" for b in cfg.blocks)
    out = []
    for target in args.logit_stds:
        stats = logit_stats(params, cfg, batch)
        if target > 0:
            with torch.no_grad():
                params["unembed"].mul_(target / stats["logit_std"])
            stats = logit_stats(params, cfg, batch)
        gn: dict = {"kernel": [], "plain": []} if rwkv else {}
        k1, loss_k = grads_of(params, cfg, batch, plain=False, expect=expect,
                              gn=gn.get("kernel"))
        k2, _ = grads_of(params, cfg, batch, plain=False, expect=expect)
        p1, loss_p = grads_of(params, cfg, batch, plain=True, expect=expect, gn=gn.get("plain"))
        p2, _ = grads_of(params, cfg, batch, plain=True, expect=expect)
        rec = {"seed": seed, "target_logit_std": target or "init", **stats,
               "loss_kernel": loss_k, "loss_plain": loss_p,
               "kernel_twice": compare(k1, k2, batch["tokens"]),
               "plain_twice": compare(p1, p2, batch["tokens"]),
               "kernel_vs_plain": compare(k1, p1, batch["tokens"]),
               "kernel_vs_plain_rows": cancellation(k1, p1, batch["tokens"])}
        del k2, p2
        empty_cache()
        if args.f32:
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            p32 = tree_map(lambda t: t.detach().float().requires_grad_(), params)
            k32, rec["loss_kernel_f32"] = grads_of(p32, cfg32, batch, plain=False, expect=None
                                                   if expect is None else as_f32(expect))
            g32, rec["loss_plain_f32"] = grads_of(p32, cfg32, batch, plain=True, expect=expect)
            del p32
            rec.update({"kernel_f32_vs_plain_f32": compare(k32, g32, batch["tokens"]),
                        "plain_vs_plain_f32": compare(p1, g32, batch["tokens"]),
                        "kernel_vs_plain_f32": compare(k1, g32, batch["tokens"])})
            del k32, g32
        del k1, p1
        empty_cache()
        for key, store in gn.items():  # remat runs each layer twice; the gradient reaches one
            store = [r for r in store if "grad_norm" in r]
            print(f"[group norm] {key} bf16 by layer: {dumps_strict(store)}", flush=True)
            rec[f"group_norm_{key}"] = {
                "grad_share_below_eps_max": max(r["grad_share_below_eps"] for r in store),
                "grad_share_first_position_min": min(r["grad_share_first_position"]
                                                     for r in store),
                "largest_grad": max(store, key=lambda r: r["grad_norm"])}
        if args.positions:
            rec["positions"] = positions_study(params, cfg, batch, card)
        print(f"[gaps] {dumps_strict(rec)} [{card}]", flush=True)
        out.append(rec)
    del params
    empty_cache()
    return out


def loss_runs(args, card: str) -> list:
    out = []
    for seed in args.seeds:
        res = cs.train_driver.main(["--arch", args.arch, "--batch", str(args.batch), "--seq",
                                    str(args.seq), "--steps", str(args.steps), "--lr",
                                    str(args.lr), "--log-every", str(args.steps), "--seed",
                                    str(seed)])
        losses = res["losses"]
        rec = {"seed": seed, "lr": args.lr, "losses": losses,
               "margin": losses[0] - losses[-1],
               "margin_share": (losses[0] - losses[-1]) / losses[0]}
        print(f"[losses] {dumps_strict(rec)} [{card}]", flush=True)
        out.append(rec)
        empty_cache()
    return out


def empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> dict | int:
    """Runs the probe; returns the result (1 without a card on ``cuda``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list(cs.TRAIN_RUNS))
    ap.add_argument("--batch", type=int, default=cs.TRAIN_BATCH)
    ap.add_argument("--seq", type=int, default=cs.TRAIN_SEQ)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--logit-stds", type=float, nargs="*", default=[0.0, 1.0])
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--positions", action="store_true")
    ap.add_argument("--group-norm", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 1
        card = cs.card_line()
        cfg = cs.train_config(args.arch)
    else:
        card = "cpu"
        cfg = get_config(f"{args.arch}-smoke")
    print(card, flush=True)
    result = {"arch": args.arch, "layers": cfg.n_layers, "card": card,
              "gaps": [g for seed in args.seeds for g in gap_study(args, cfg, seed, device, card)],
              "losses": loss_runs(args, card) if args.steps and device.type == "cuda" else []}
    print(dumps_strict(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if isinstance(main(), dict) else 1)
