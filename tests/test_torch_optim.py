"""The port's optimizer (``repro_torch.optim``) against the JAX package's on
the CPU: AdamW's ``apply_updates`` over three steps from the same numpy
parameters, gradients and state, leaf by leaf; ``schedule``; the decay of the
pattern groups' stacked norms; and the gradient codecs and the cross-pod
all-reduce over a two-process ``gloo`` group."""
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _gloo_worker
import repro.configs as jconfigs
import repro.models as jm
import repro.optim as joptim
import repro_torch.optim as toptim
from repro.optim import compression as jcomp
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import reference_leaves
from repro_torch.optim import compression as tcomp

ARCH = "internlm2-1.8b-smoke"
RTOL = 1e-6  # f32 parameters and moments, from the same inputs


def _params():
    """The JAX smoke init at f32, the group norms among its (R, d) leaves,
    and the port's tree carried from it."""
    cfg = dataclasses.replace(jconfigs.get_config(ARCH), dtype="float32")
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def _grads(jp, cfg, seed: int, scale: float):
    """The same random gradient for both packages (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    jg = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), jp)
    return jax.tree.map(jnp.asarray, jg), params_from_jax(jg, cfg, "cpu")


def _flat_jax(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = (
            np.asarray(leaf).astype(np.float32))
    return out


def _flat_port(tree, params=None) -> dict:
    """The port tree by reference leaf. With ``params`` (for ``v_c``), a
    group of 1-D parameters' ``v_c`` copies must agree and stand for the
    reference's one (d,) leaf."""
    out = {}
    for (path, ts, stacked), p in zip(reference_leaves(tree),
                                      reference_leaves(params or tree)):
        arrays = [t.float().numpy() for t in ts]
        if params is not None and stacked and p[1][0].dim() == 1:
            assert all(np.array_equal(a, arrays[0]) for a in arrays), path
            out[path] = arrays[0]
        else:
            out[path] = np.stack(arrays) if stacked else arrays[0]
    return out


def _close(got: dict, want: dict, what: str, rtol: float, atol: float = 0.0,
           leaf_atol: float = 0.0) -> None:
    """Each leaf within ``rtol`` and ``atol`` plus ``leaf_atol`` of the
    leaf's largest entry."""
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=atol + leaf_atol * float(np.abs(w).max(initial=0.0)),
                                   err_msg=f"{what} {k}")


CASES = [dict(factored_second_moment=f, moment_dtype=m, clip_norm=c)
         for f in (False, True) for m in ("float32", "bfloat16") for c in (1.0, 1e9)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_apply_updates_matches_reference(case):
    """Three steps, plain and factored second moments, f32 and bf16 moments,
    with clipping (gradient norms of 3-10, clip 1) and without (clip 1e9):
    the metrics, the parameters and every moment, leaf by leaf. f32: rtol
    1e-6, and an atol of 1e-6 of the leaf's largest entry (a moment is a
    running sum that cancels to near zero; the packages contract a * b + c * d
    into FMAs differently); a parameter moves by about lr a step, so its atol
    is 1e-6 lr. bf16 moments: each moment within one bf16 ulp (rtol 2^-7),
    the parameters within that share of an update (atol 2^-7 lr)."""
    opt = toptim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, **case)
    jopt = joptim.AdamWConfig(**dataclasses.asdict(opt))
    cfg, jp, tp = _params()
    jstate, tstate = joptim.init_state(jopt, jp), toptim.init_state(opt, tp)
    bf16 = case["moment_dtype"] == "bfloat16"
    moment_rtol, param_atol = (2**-7, 2**-7 * opt.lr) if bf16 else (RTOL, RTOL * opt.lr)
    for step in range(3):
        jg, tg = _grads(jp, cfg, seed=step, scale=0.02 * (step + 1))
        jp, jstate, jmetrics = joptim.apply_updates(jopt, jp, jg, jstate)
        tp, tstate, tmetrics = toptim.apply_updates(opt, tp, tg, tstate)
        for k in ("grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=RTOL,
                                       err_msg=k)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        what = f"step {step + 1}"
        _close(_flat_port(tp), _flat_jax(jp), f"params, {what}", RTOL, atol=param_atol)
        for key in ("m", "v", "v_r", "v_c"):
            assert (key in jstate) == (key in tstate), key
            if key in jstate:
                got = _flat_port(tstate[key], tp if key == "v_c" else None)
                _close(got, _flat_jax(jstate[key]), f"{key}, {what}",
                       moment_rtol if key in ("m", "v") else RTOL, leaf_atol=RTOL)
    assert (float(jmetrics["clip_scale"]) < 1.0) == (case["clip_norm"] == 1.0)


def test_stacked_group_norms_are_decayed_as_in_the_reference():
    """The JAX package stacks a pattern group's RMSNorm scales into an (R, d)
    leaf and decays every leaf of two dims or more: the groups' ``norm1`` is
    weight-decayed, ``final_norm`` (1-D) is not. With a zero gradient only
    the decay moves a parameter: p <- p (1 - lr wd)."""
    opt = toptim.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1)
    jopt = joptim.AdamWConfig(**dataclasses.asdict(opt))
    cfg, jp, tp = _params()
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jp1, _, _ = joptim.apply_updates(jopt, jp, zeros, joptim.init_state(jopt, jp))
    tzeros = params_from_jax(jax.tree.map(np.asarray, zeros), cfg, "cpu")
    before = [t.clone() for t in (tp["final_norm"], tp["stack"]["groups"][0][0]["norm1"])]
    tp1, _, _ = toptim.apply_updates(opt, tp, tzeros, toptim.init_state(opt, tp))
    decayed = 1 - float(toptim.schedule(opt, torch.tensor(1))) * opt.weight_decay
    assert torch.equal(tp1["final_norm"], before[0])  # 1-D in the reference: no decay
    for g, group in enumerate(tp1["stack"]["groups"]):
        np.testing.assert_allclose(group[0]["norm1"].numpy(), before[1].numpy() * decayed,
                                   rtol=RTOL)
        np.testing.assert_array_equal(
            group[0]["norm1"].numpy(), np.asarray(jp1["stack"]["groups"][0]["norm1"][g]))
    np.testing.assert_array_equal(tp1["final_norm"].numpy(), np.asarray(jp1["final_norm"]))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 40, 100, 150])
def test_schedule_matches_reference(step):
    """Warmup (steps 0 and 5), its end (10), the cosine (40), the total
    (100) and past it (150)."""
    opt = toptim.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = joptim.schedule(joptim.AdamWConfig(**dataclasses.asdict(opt)), jnp.asarray(step))
    got = toptim.schedule(opt, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_ef_compress_matches_reference_bit_for_bit(codec):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    err = rng.standard_normal((64, 48)).astype(np.float32) * 1e-3
    jp, je, js = jcomp.ef_compress(jnp.asarray(g), jnp.asarray(err), codec)
    tp, te, ts = tcomp.ef_compress(torch.from_numpy(g), torch.from_numpy(err), codec)
    want = np.asarray(jp.astype(jnp.float32))
    np.testing.assert_array_equal(tp.float().numpy(), want)
    assert str(tp.dtype).endswith(str(np.asarray(jp).dtype))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    if codec == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        assert ts is None and js is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("codec", ["bf16", "int8", "none"])
def test_cross_pod_allreduce_over_gloo(codec, tmp_path):
    """Two processes of a gloo group, each with its own gradients and error
    state: every rank gets the sum of the reference's decompressed payloads
    (numpy), bit for bit, and its own new error state, the reference's."""
    rng = np.random.default_rng(11)
    shapes = [(32, 16), (40,)]
    ranks = []
    for r in range(2):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        e = [rng.standard_normal(s).astype(np.float32) * 1e-3 for s in shapes]
        np.savez(tmp_path / f"in_{r}.npz", **{f"g{i}": a for i, a in enumerate(g)},
                 **{f"e{i}": a for i, a in enumerate(e)})
        ranks.append((g, e))
    init = f"tcp://127.0.0.1:{_free_port()}"
    torch.multiprocessing.spawn(_gloo_worker.run, args=(2, init, str(tmp_path), codec), nprocs=2,
                                join=True)
    for i in range(len(shapes)):
        restored, errors = [], []
        for g, e in ranks:
            if codec == "none":
                restored.append(g[i])
                errors.append(e[i])
                continue
            payload, new_err, scale = jcomp.ef_compress(jnp.asarray(g[i]), jnp.asarray(e[i]),
                                                        codec)
            restored.append(np.asarray(jcomp.decompress_bf16(payload)) if codec == "bf16"
                            else np.asarray(jcomp.decompress_int8(payload, scale)))
            errors.append(np.asarray(new_err))
        total = restored[0] + restored[1]
        for r in range(2):
            out = np.load(tmp_path / f"out_{r}.npz")
            np.testing.assert_array_equal(out[f"s{i}"], total)
            np.testing.assert_array_equal(out[f"e{i}"], errors[r])
