"""Shared by the port's training tests: one train step of the JAX package and
of the port from the same state and batch, and the comparisons. The JAX
``init_train_state`` is carried to the port by ``params_from_jax``, its zero
AdamW state made anew by the port's ``init_state``; batches come from numpy
seeds."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
import repro.optim as joptim
import repro.train as jtrain
import repro_torch.configs as tconfigs
import repro_torch.optim as toptim
import repro_torch.train as ttrain
from repro.train.train_step import _loss_fn as jax_loss_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import reference_leaves
from repro_torch.train.train_step import loss_and_grads
from repro_torch.tree import tree_map

# the reference's own smoke test batch (tests/test_substrate.py::TestTrainStep)
B, S = 4, 32
METRIC_RTOL = 1e-4
GRAD_RTOL = 1e-4
# atol, as a share of each gradient leaf's largest entry: 1e-6, or the JAX
# package's own spread where that is larger: the largest gap, as such a share,
# between its jitted gradient and the same gradient run op by op
# (``jax.disable_jit()``) on these inputs, measured once and rounded up
GRAD_ATOL = 1e-6
SELF_SPREAD = {"internlm2-1.8b-smoke": 1.3e-6, "gemma3-1b-smoke": 5.7e-7,
               "zamba2-7b-smoke": 2.9e-6, "rwkv6-3b-smoke": 1.6e-5,
               "deepseek-v3-671b-smoke": 1.8e-6}
# AdamW's first steps move an entry by lr * m / (sqrt(v) + eps), about lr *
# sign(g) where |g| >> eps: a gradient entry near zero whose sign the two
# packages round apart moves by up to 2 lr. Updated parameters agree within
# PARAM_ATOL of lr elsewhere, and at most SIGN_SHARE of a leaf's entries may
# differ by up to 2 lr.
PARAM_ATOL = 1e-3
SIGN_SHARE = 0.01


def configs(arch: str, dtype: str):
    jc = dataclasses.replace(jconfigs.get_config(arch), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_config(arch), dtype=dtype)
    return jc, tc


def batch(cfg, seed: int = 0, shape=(B, S)) -> dict:
    """tokens from a seed, labels the next token (rolled), as TestTrainStep;
    for a frontend model (phi-3-vision, musicgen) also ``frontend_embeds``
    (batch, frontend_tokens, d_model), standard normal from the same seed,
    which both packages prepend to the ``shape[1]`` text tokens."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, shape).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if cfg.frontend:
        embeds = rng.standard_normal((shape[0], cfg.frontend_tokens, cfg.d_model))
        out["frontend_embeds"] = embeds.astype(np.float32)
    return out


def states(jc, tc, opt: toptim.AdamWConfig, train_cfg: ttrain.TrainConfig, seed: int = 0):
    """(JAX train state, the port's) from the JAX init."""
    jopt = joptim.AdamWConfig(**dataclasses.asdict(opt))
    jtc = jtrain.TrainConfig(**dataclasses.asdict(train_cfg))
    jstate = jtrain.init_train_state(jc, jopt, jax.random.PRNGKey(seed), train_cfg=jtc)
    params = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), tc, "cpu")
    params = tree_map(lambda t: t.requires_grad_(), params)
    tstate = {"params": params, "opt": toptim.init_state(opt, params),
              "step": torch.zeros((), dtype=torch.int32)}
    return jstate, tstate


def jax_step(jc, opt, train_cfg, jstate, jbatch, *, with_grads: bool = True):
    """The JAX package's ``make_train_step`` (jitted) on ``jbatch``; with
    ``with_grads`` also the gradient its step takes at the state's params:
    with ``microbatches`` n > 1, each microbatch's gradient accumulated in
    f32 and divided by n, as its step accumulates them (the MoE terms are
    not linear in the batch, so that is not the whole batch's gradient)."""
    jopt = joptim.AdamWConfig(**dataclasses.asdict(opt))
    jtc = jtrain.TrainConfig(**dataclasses.asdict(train_cfg))
    step = jtrain.make_train_step(jc, jopt, jtc)
    n = train_cfg.microbatches

    def grad(params, b):
        return jax.grad(lambda p: jax_loss_fn(p, jc, jtc, b)[0])(params)

    def both(state, b):
        new_state, metrics = step(state, b)
        if not with_grads:
            return new_state, metrics, None
        if n == 1:
            return new_state, metrics, grad(state["params"], b)
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), state["params"])
        for i in range(n):
            mb = jax.tree.map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i], b)
            grads = jax.tree.map(lambda a, g: a + g.astype(jnp.float32) / n, grads,
                                 grad(state["params"], mb))
        return new_state, metrics, grads

    return jax.jit(both)(jstate, {k: jnp.asarray(v) for k, v in jbatch.items()})


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_grads(tc, train_cfg, tstate, b):
    return loss_and_grads(tstate["params"], tc, train_cfg, torch_batch(b))


def flat_jax(tree) -> dict:
    """Each leaf of a JAX tree by its path, as numpy (f32 for bf16)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf).astype(np.float32)
    return out


def flat_port(tree) -> dict:
    """Each reference leaf of a port tree by its path, a group leaf stacked
    over the groups, as f32 numpy."""
    return {path: np.stack([t.detach().float().numpy() for t in ts]) if stacked
            else ts[0].detach().float().numpy()
            for path, ts, stacked in reference_leaves(tree)}


def check_metrics(got: dict, want: dict, rtol: float = METRIC_RTOL) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(np.asarray(want[k]))
        assert np.isfinite(g), k
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7, err_msg=k)


def check_grads(got: dict, want: dict, arch: str) -> None:
    """Every gradient leaf within GRAD_RTOL, and GRAD_ATOL (or the
    reference's own spread, SELF_SPREAD, where the arch has an entry) of its
    largest entry."""
    assert set(got) == set(want)
    share = max(GRAD_ATOL, SELF_SPREAD.get(arch, 0.0))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        atol = share * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL, atol=atol, err_msg=k)


def check_params(got: dict, want: dict, lr: float, before: dict) -> float:
    """Updated parameters within the sign-noise allowance (SIGN_SHARE of a
    leaf's entries up to 2 lr apart, the rest within PARAM_ATOL * lr);
    returns the largest share of a leaf that used the allowance."""
    assert set(got) == set(want)
    worst = 0.0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        scale = np.abs(before[k]) * 1e-6  # an f32 ulp or two of the parameter
        loose = diff > PARAM_ATOL * lr + scale
        share = float(loose.mean())
        worst = max(worst, share)
        assert share <= SIGN_SHARE, (k, share)
        assert float(diff.max()) <= 2 * lr * (1 + 1e-3) + float(scale.max()), (k, diff.max())
    return worst
