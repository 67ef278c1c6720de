"""The port's train step (``repro_torch.train``) against the JAX package's
``make_train_step`` on the CPU, dense attention models: one step from the
JAX ``init_train_state`` carried across, the same batch, f32 (tolerances in
``_torch_train_common``); the microbatched step; one bf16 step; and the loss
falling over steps, as the reference's own ``TestTrainStep`` holds it. The
SSM and MoE models are in ``test_torch_train_mixers.py`` and
``test_torch_train_mla_moe.py``."""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import _torch_train_common as common
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as model_attention
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.train_step import loss_and_grads
from repro_torch.tree import tree_leaves, tree_map

OPT = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50)


def one_step_matches(arch: str, train_cfg: TrainConfig, opt: AdamWConfig = OPT) -> None:
    """Metrics, every gradient leaf and the updated parameters of one f32
    step; the step counters advance by one."""
    jc, tc = common.configs(arch, "float32")
    jstate, tstate = common.states(jc, tc, opt, train_cfg)
    b = common.batch(jc)
    jnew, jmetrics, jgrads = common.jax_step(jc, opt, train_cfg, jstate, b)
    grads, _ = common.port_grads(tc, train_cfg, tstate, b)
    common.check_grads(common.flat_port(grads), common.flat_jax(jgrads), arch)
    before = common.flat_port(tstate["params"])
    new, metrics = make_train_step(tc, opt, train_cfg)(tstate, common.torch_batch(b))
    common.check_metrics(metrics, jmetrics)
    lr = float(jmetrics["lr"])
    common.check_params(common.flat_port(new["params"]), common.flat_jax(jnew["params"]), lr,
                        before)
    assert int(new["step"]) == 1 and int(new["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke", "gemma3-1b-smoke",
                                  "starcoder2-7b-smoke", "phi-3-vision-4.2b-smoke",
                                  "musicgen-medium-smoke"])
def test_train_step_matches_reference(arch):
    """starcoder2 and musicgen train the ungated MLP; phi-3-vision's and
    musicgen's batches carry frontend embeddings."""
    one_step_matches(arch, TrainConfig())


def test_microbatched_step_matches_reference():
    """Two microbatches: f32 gradient accumulation divided by 2, against the
    reference's ``microbatches=2``."""
    one_step_matches("internlm2-1.8b-smoke", TrainConfig(microbatches=2))


# the bf16 gradient tolerance (rtol, and atol as a share of each leaf's
# largest entry): 2e-2, the port's bf16 logit tolerance, except where the JAX
# package's own bf16 gradient is farther than that from its f32 gradient on
# these inputs: zamba2-7b-smoke's reads 4.1e-2 (the Mamba-2 ``D`` leaf; the
# port's bf16 gradient is 4.1e-2 from the JAX package's there too), and
# deepseek-v2-lite-16b-smoke's 3.45e-2 (the dense layer's ``kv_up``; both
# runs on the JAX run's expert choices, the f32 one the port's). Where
# neither is, but their two gaps add up past it, the sum, rounded up: XLA
# keeps some of the JAX package's bf16 chains in f32 (its excess precision,
# ``test_torch_models.bf16_tol``) and PyTorch rounds each op, so the two bf16
# gradients miss the f32 one apart; minicpm3-4b-smoke's embedding reads
# 1.72e-2 (JAX) and 2.15e-2 (the port) from the f32 gradient, 2.93e-2
# from each other
BF16_GRAD_TOL = {"zamba2-7b-smoke": 5e-2, "deepseek-v2-lite-16b-smoke": 5e-2,
                 "minicpm3-4b-smoke": 4e-2}


def bf16_step_matches(arch: str, in_jax=contextlib.nullcontext,
                      in_port=contextlib.nullcontext) -> None:
    """One bf16 step of ``arch`` against the JAX package's, as
    :func:`test_bf16_step_matches_reference` holds it; the JAX step runs
    inside ``in_jax()`` and the port's two gradients (``loss_and_grads``,
    then ``make_train_step``) inside ``in_port()``, where a MoE model
    replays the JAX run's expert choices."""
    jc, tc = common.configs(arch, "bfloat16")
    train_cfg = TrainConfig()
    jstate, tstate = common.states(jc, tc, OPT, train_cfg)
    b = common.batch(jc)
    with in_jax():
        _, jmetrics, jgrads = common.jax_step(jc, OPT, train_cfg, jstate, b)
    with in_port():
        grads, _ = common.port_grads(tc, train_cfg, tstate, b)
        for g, p in zip(tree_leaves(grads), tree_leaves(tstate["params"])):
            assert g.dtype == p.dtype  # bf16 matrices, f32 norms
        got, want = common.flat_port(grads), common.flat_jax(jgrads)
        tol = BF16_GRAD_TOL.get(arch, 2e-2)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol * float(np.abs(w).max()),
                                       err_msg=k)
        _, metrics = make_train_step(tc, OPT, train_cfg)(tstate, common.torch_batch(b))
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-2, err_msg=k)


@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke", "gemma3-1b-smoke", "rwkv6-3b-smoke",
                                  "zamba2-7b-smoke", "starcoder2-7b-smoke",
                                  "phi-3-vision-4.2b-smoke", "musicgen-medium-smoke"])
def test_bf16_step_matches_reference(arch):
    """bf16 matrices (norms f32): loss, CE and the gradient norm within the
    port's bf16 logit tolerance (rtol 2e-2, ``test_torch_models.bf16_tol``),
    every gradient leaf within rtol 2e-2 and 2e-2 of its largest entry (the
    model's ``BF16_GRAD_TOL`` where the JAX package's bf16 gradient is
    farther from its own f32 gradient: zamba2-7b-smoke, 5e-2 against a
    witness of 4.1e-2); each gradient in its parameter's dtype. rwkv6-3b-smoke
    and zamba2-7b-smoke run the SSM scans' plain versions under autograd, as
    the kernels' Functions do in their backward."""
    bf16_step_matches(arch)


def test_loss_decreases_on_smoke_model():
    """The reference's TestTrainStep on the port: 8 steps from the port's own
    init, lr 3e-3, no warmup or decay; the loss falls by more than 0.25."""
    cfg = common.configs("internlm2-1.8b-smoke", "bfloat16")[1]
    opt = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=50, weight_decay=0.0)
    state = init_train_state(cfg, opt, 0, device="cpu")
    step = make_train_step(cfg, opt)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (4, 32)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.25, losses
    assert int(state["step"]) == 8


def test_remat_gives_the_same_gradient():
    """``cfg.remat`` (each pattern group rematerialized in the backward, as
    the JAX package's ``jax.checkpoint``) changes no bit of the gradient."""
    cfg = common.configs("internlm2-1.8b-smoke", "float32")[1]
    state = init_train_state(cfg, OPT, 0, device="cpu")
    batch = common.torch_batch(common.batch(cfg))
    on, _ = loss_and_grads(state["params"], cfg, TrainConfig(), batch)
    off, _ = loss_and_grads(state["params"], dataclasses.replace(cfg, remat=False),
                            TrainConfig(), batch)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)
        assert bool(a.abs().max() > 0)  # no parameter cut off from the graph


def test_remat_only_where_a_gradient_can_flow(monkeypatch):
    """The stack rematerializes its units (one a prefix or suffix block, one
    a pattern group) only when a gradient can flow: an inference forward in
    grad mode with no parameter requiring a gradient checkpoints nothing."""
    from repro_torch.models import forward

    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or checkpoint(*a, **kw))
    cfg = common.configs("internlm2-1.8b-smoke", "float32")[1]
    assert cfg.remat
    state = init_train_state(cfg, OPT, 0, device="cpu")
    batch = common.torch_batch(common.batch(cfg))
    frozen = tree_map(lambda t: t.detach(), state["params"])
    logits, _ = forward(frozen, cfg, batch["tokens"])
    assert not calls and not logits.requires_grad
    loss_and_grads(state["params"], cfg, TrainConfig(), batch)
    assert len(calls) == len(cfg.prefix) + cfg.n_pattern_repeats + len(cfg.suffix)


def test_init_train_state_defaults_to_the_card():
    """No CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = common.configs("internlm2-1.8b-smoke", "float32")[1]
    with pytest.raises((RuntimeError, AssertionError)):
        init_train_state(cfg, OPT, 0)


# the kernel each mixer kind reaches
KERNEL_OF = {"gqa": "flash", "swa": "flash", "mla": "flash", "mamba2": "ssd", "rwkv6": "rwkv6"}


def kernel_layers(cfg) -> dict:
    """How many of the config's layers reach each kernel."""
    return dict(collections.Counter(KERNEL_OF[b.mixer] for b in cfg.blocks))


@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke", "gemma3-1b-smoke", "rwkv6-3b-smoke",
                                  "zamba2-7b-smoke", "starcoder2-7b-smoke",
                                  "phi-3-vision-4.2b-smoke", "musicgen-medium-smoke",
                                  "minicpm3-4b-smoke", "deepseek-v2-lite-16b-smoke"])
def test_step_reaches_each_kernel_twice_a_layer(arch, monkeypatch):
    """A train step with remat calls each kernel's wrapper twice for every
    layer that reaches it: once in the forward and once in remat's recompute
    (the Functions' backward runs the plain versions and launches nothing).
    On the card each call is one launch: chip_smoke's launches a step."""
    cfg = common.configs(arch, "bfloat16")[1]
    assert cfg.remat
    calls = collections.Counter()

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(model_attention, "flash_attention",
                        counting("flash", model_attention.flash_attention))
    monkeypatch.setattr(ops, "ssd_scan", counting("ssd", ops.ssd_scan))
    monkeypatch.setattr(ops, "rwkv6_scan", counting("rwkv6", ops.rwkv6_scan))
    state = init_train_state(cfg, OPT, 0, device="cpu")
    loss_and_grads(state["params"], cfg, TrainConfig(), common.torch_batch(common.batch(cfg)))
    assert dict(calls) == {k: 2 * n for k, n in kernel_layers(cfg).items()}


def test_full_width_runs_kernel_layers():
    """The models chip_smoke trains at full width, and their kernel layers:
    rwkv6-3b 32 RWKV-6, gemma3-1b 26 attention (22 windowed at 512),
    zamba2-7b cut to 4 of its 13 groups and its 3 last blocks: 23 Mamba-2
    and 4 uses of the shared attention, and musicgen-medium 48 attention
    (an ungated MLP, 64 frontend embeddings), minicpm3-4b 62 MLA attention
    at (96, 64), deepseek-v2-lite-16b cut to its dense layer and 3 of
    its 26 MoE layers: 4 MLA attention at (192, 128), phi-3-vision-4.2b 32
    attention at (96, 96) after 256 frontend embeddings, and starcoder2-7b
    cut to 12 of its 32 layers: 12 attention with a GQA group of 9 (36/4
    heads) and an ungated MLP; with the parameter counts the training state
    follows from."""
    rwkv, gemma = get_config("rwkv6-3b"), get_config("gemma3-1b")
    zamba = dataclasses.replace(get_config("zamba2-7b"), n_pattern_repeats=4)
    music = get_config("musicgen-medium")
    mini = get_config("minicpm3-4b")
    deep = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_pattern_repeats=3)
    phi = get_config("phi-3-vision-4.2b")
    star = dataclasses.replace(get_config("starcoder2-7b"), n_pattern_repeats=12)
    assert kernel_layers(rwkv) == {"rwkv6": 32}
    assert kernel_layers(gemma) == {"flash": 26}
    assert sum(b.window == 512 for b in gemma.blocks) == 22
    assert kernel_layers(zamba) == {"ssd": 23, "flash": 4} and zamba.n_layers == 27
    assert kernel_layers(music) == {"flash": 48}
    assert not music.mlp_gated and music.frontend_tokens == 64
    assert kernel_layers(mini) == {"flash": 62}
    assert mini.head_dim + mini.qk_rope_head_dim == 96 and mini.v_head_dim == 64
    assert kernel_layers(deep) == {"flash": 4} and deep.n_layers == 4
    assert [b.mlp for b in deep.blocks] == ["dense", "moe", "moe", "moe"]
    assert deep.head_dim + deep.qk_rope_head_dim == 192 and deep.v_head_dim == 128
    assert kernel_layers(phi) == {"flash": 32} and phi.frontend_tokens == 256
    assert phi.head_dim == 96 and phi.n_heads == phi.n_kv_heads == 32
    assert kernel_layers(star) == {"flash": 12} and star.n_layers == 12
    assert star.n_heads == 9 * star.n_kv_heads == 36 and star.head_dim == 128
    assert not star.mlp_gated
    assert [c.param_count() for c in (rwkv, gemma, zamba, music, mini, deep, phi, star)] == [
        2_863_516_160, 999_812_736, 2_690_678_832, 1_365_394_944, 4_261_902_848,
        2_254_983_168, 3_821_079_552, 3_057_762_816]


# the models chip_smoke prefills and serves at full width, one at a time
CHIP_MODELS = ["gemma3-1b", "zamba2-7b", "rwkv6-3b", "minicpm3-4b", "deepseek-v2-lite-16b",
               "starcoder2-7b", "phi-3-vision-4.2b", "musicgen-medium", "deepseek-v3-671b"]
# chip_smoke's counter of the bf16 kernel each kind of kernel layer reaches
SMOKE_KERNEL = {"flash": "flash_attention_wgmma", "ssd": "ssd_scan_mma",
                "rwkv6": "rwkv6_scan_mma"}


@pytest.mark.parametrize("arch", CHIP_MODELS)
def test_chip_smoke_launches_follow_the_config(arch):
    """chip_smoke's ``FORWARD_LAUNCHES``, ``SERVING`` and ``LIMITS`` name the
    same nine models, and a model's launches a forward are its kernel
    layers, one launch each, as its config gives them at the depth
    ``PREFILL_REPEATS`` cuts it to: the weights laid out on the meta device
    (no storage) hold one layer per block. So a row cannot drift from its
    config."""
    from chip_smoke import FORWARD_LAUNCHES, LIMITS, PREFILL_REPEATS, SERVING
    from repro_torch.models import init_params
    from repro_torch.models import transformer

    assert list(FORWARD_LAUNCHES) == list(SERVING) == list(LIMITS) == CHIP_MODELS
    cfg = get_config(arch)
    if arch in PREFILL_REPEATS:
        cfg = dataclasses.replace(cfg, n_pattern_repeats=PREFILL_REPEATS[arch])
    params = init_params(cfg, torch.Generator(), device="meta")
    assert len(transformer.layers(cfg, params["stack"])) == len(cfg.blocks) == cfg.n_layers
    want = {SMOKE_KERNEL[k]: n for k, n in kernel_layers(cfg).items()}
    assert FORWARD_LAUNCHES[arch] == want


def test_train_probe_runs_on_the_cpu():
    """``scripts/torch_train_probe.py`` on rwkv6-3b's smoke config, every
    study on: both paths are the plain versions on the CPU, so the kernel
    and plain gradients and per-position losses are the same, the f32
    gradients finite, and the scan's bf16 output as far from its f32 output
    on both paths."""
    from chip_smoke import load_script
    probe = load_script("scripts/torch_train_probe.py")
    out = probe.main(["--arch", "rwkv6-3b", "--device", "cpu", "--batch", "2", "--seq", "32",
                      "--seeds", "0", "--logit-stds", "0", "--f32", "--positions",
                      "--group-norm", "--steps", "0"])
    (rec,) = out["gaps"]
    assert rec["kernel_vs_plain"]["distance"] == 0.0
    assert rec["kernel_vs_plain"]["equal_leaves"] == rec["kernel_vs_plain"]["leaves"]
    assert np.isfinite(rec["plain_vs_plain_f32"]["distance"])
    assert rec["positions"]["kernel_vs_plain"]["std"] == 0.0
    calls = rec["positions"]["calls_largest"]["rwkv6_scan"]
    assert calls["calls"] == 2 and calls["kernel"] == calls["plain"]
    assert len(rec["group_norm_kernel"]["largest_grad"]) > 0
