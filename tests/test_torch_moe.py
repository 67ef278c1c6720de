"""The port's MoE channel mixer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU: the capacity rule, each group's
dispatch (rank-in-expert destinations, kept choices, the scattered buffer)
and ``moe_apply``'s output and aux, from the same parameters (the JAX init
carried over) and the same inputs, made with numpy from a seed. Cases: one
group a sequence (prefill), a capacity so small that choices are dropped,
and the whole slot batch as one group (decode); then deepseek-v3-671b's
router widths (256 experts, top-8) at smoke width, each case keeping some
choices and dropping others."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import tensor_from_numpy

ARCH = "deepseek-v2-lite-16b-smoke"  # 8 experts, top-2, 2 shared, d=64
# (G, T, capacity_factor): sequences as groups at the configured capacity,
# the same at a capacity that drops choices, the decode batch as one group
CASES = [(2, 32, 1.25), (2, 32, 0.25), (1, 4, 1.25), (3, 17, 0.5)]
V3 = "deepseek-v3-671b-smoke"
# the full config's router widths on the smoke config (d=64, 1 shared expert)
ROUTER = {V3: dict(n_experts=256, top_k=8)}
# (G, T, capacity_factor) at those widths: the capacity's floor of 4 with
# two and three groups, a prefill-like group of 1024 (C = 40), and a
# capacity half the choices' even share (C = 8 for 16 a expert)
V3_CASES = [(2, 64, 1.25), (3, 40, 0.5), (1, 1024, 1.25), (1, 512, 0.5)]
# every case with its config, the v2-lite cases under their earlier ids
ARCH_CASES = ([pytest.param(*c, ARCH, id="-".join(map(str, c))) for c in CASES]
              + [pytest.param(*c, V3, id="v3-" + "-".join(map(str, c))) for c in V3_CASES])


def _cfgs(capacity_factor, dtype="float32", arch=ARCH):
    over = dict(dtype=dtype, capacity_factor=capacity_factor, **ROUTER.get(arch, {}))
    jc = dataclasses.replace(jconfigs.get_config(arch), **over)
    tc = dataclasses.replace(tconfigs.get_config(arch), **over)
    return jc, tc


def _params(jc):
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jc, jnp.dtype(jc.dtype))
    return jp, jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)


def _x(G, T, d, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal((G, T, d)).astype(np.float32)
    jx = jnp.asarray(a, jnp.dtype(dtype))
    return jx, tensor_from_numpy(np.asarray(jx), "cpu")


@pytest.mark.parametrize("T", [1, 4, 17, 32, 1000, 32768])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b", ARCH])
def test_capacity_rule_matches_jax(arch, T):
    """ceil(T * k / E * factor), at least 4, a multiple of 4."""
    for factor in (0.25, 1.25, 4.0):
        jc, tc = _cfgs(factor, arch=arch)
        c = tmoe.moe_capacity(T, tc)
        assert c == jmoe.moe_capacity(T, jc) and c >= 4 and c % 4 == 0


def _routes(G, T, E, k, seed, skew=False):
    """Top-k expert choices (G, T, k), distinct within a token; ``skew``
    sends most first choices to expert 0 so its capacity overflows."""
    rng = np.random.default_rng(seed)
    topi = np.stack([np.stack([rng.permutation(E)[:k] for _ in range(T)]) for _ in range(G)])
    if skew:
        for g, t in zip(*np.nonzero(rng.random((G, T)) < 0.7)):
            row = [e for e in topi[g, t] if e != 0][: k - 1]
            topi[g, t] = [0, *row]
    return topi.astype(np.int32)


@pytest.mark.parametrize("G, T, factor, arch", ARCH_CASES)
@pytest.mark.parametrize("skew", [False, True])
def test_dispatch_matches_jax(G, T, factor, arch, skew):
    """dst, keep and the buffer's expert rows equal the JAX package's
    ``_dispatch_group`` (vmapped over the groups) exactly."""
    jc, tc = _cfgs(factor, arch=arch)
    E, k, d = tc.n_experts, tc.top_k, tc.d_model
    C = tmoe.moe_capacity(T, tc)
    topi = _routes(G, T, E, k, seed=G * T, skew=skew)
    jx, tx = _x(G, T, d, "float32", seed=T)
    gates = jnp.ones((G, T, k), jnp.float32)
    jbuf, jdst, jkeep = jax.vmap(lambda x, g, t: jmoe._dispatch_group(x, g, t, C, jc))(
        jx, gates, jnp.asarray(topi))
    buf, dst, keep = tmoe._dispatch_group(tx, torch.from_numpy(topi).long(), C, tc)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(buf[:, : E * C].numpy(), np.asarray(jbuf)[:, : E * C])
    assert tuple(buf.shape) == (G, E * C + 1, d)
    if skew and factor < 1:
        assert not bool(keep.all())  # the case overflows an expert
    if arch == V3:
        assert bool(keep.any()) and not bool(keep.all())


@pytest.mark.parametrize("G, T, factor", CASES)
def test_dispatch_ranks_are_the_order_of_choice(G, T, factor):
    """Without the reference: a kept choice's destination is its expert's
    row block plus its rank, ranks counting first choices in token order,
    then second choices; every kept destination is unique and under the
    capacity, every dropped one the overflow row."""
    _, tc = _cfgs(factor)
    E, k = tc.n_experts, tc.top_k
    C = tmoe.moe_capacity(T, tc)
    topi = _routes(G, T, E, k, seed=7 + T, skew=True)
    _, dst, keep = tmoe._dispatch_group(torch.zeros(G, T, tc.d_model),
                                        torch.from_numpy(topi).long(), C, tc)
    for g in range(G):
        seen = np.zeros(E, dtype=np.int64)
        for j in range(k):
            for t in range(T):
                e = topi[g, t, j]
                rank = seen[e]
                seen[e] += 1
                assert bool(keep[g, t, j]) == (rank < C)
                assert int(dst[g, t, j]) == (e * C + rank if rank < C else E * C)
        kept = dst[g][keep[g]]
        assert kept.unique().numel() == kept.numel()


@pytest.mark.parametrize("G, T, factor, arch", ARCH_CASES)
def test_moe_apply_matches_jax_f32(G, T, factor, arch):
    """Output within 1e-5 and the aux within 1e-5 relative, at f32; a
    capacity under the tokens' needs drops choices (moe_dropped_frac > 0)."""
    jc, tc = _cfgs(factor, arch=arch)
    jp, tp = _params(jc)
    jx, tx = _x(G, T, tc.d_model, "float32", seed=G + T)
    want, jaux = jmoe.moe_apply(jp, jc, jx)
    got, aux = tmoe.moe_apply(tp, tc, tx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, T, tc.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert set(aux) == set(jaux)
    for key in jaux:
        assert aux[key].dtype == torch.float32
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5, err_msg=key)
    if factor < 1 and T >= 17 or arch == V3:
        assert float(aux["moe_dropped_frac"]) > 0


def test_moe_apply_matches_jax_bf16():
    """bf16 weights and input: the same routing (the router runs in f32 on
    the same bf16 values) and the output within the models' bf16 bound, 2e-2
    of its largest value."""
    jc, tc = _cfgs(1.25, dtype="bfloat16")
    jp, tp = _params(jc)
    jx, tx = _x(2, 32, tc.d_model, "bfloat16", seed=5)
    want, jaux = jmoe.moe_apply(jp, jc, jx)
    got, aux = tmoe.moe_apply(tp, tc, tx)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))
    assert float(aux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])


def test_decode_group_is_the_whole_batch(monkeypatch):
    """At decode the block hands the slot batch to moe_apply as one group
    (free slots included): the same as moe_apply on (1, B, d), and, with a
    drop-free capacity, the same as each token alone."""
    from repro_torch.models import transformer

    jc, tc = _cfgs(float(8 / 2))  # E / top_k: no choice is ever dropped
    _, tp = _params(jc)
    B = 4
    _, tx = _x(B, 1, tc.d_model, "float32", seed=9)
    bp = {"norm1": torch.ones(tc.d_model), "norm2": torch.ones(tc.d_model), "moe": tp,
          "mixer": None}
    seen = []
    apply = tmoe.moe_apply

    def spy(p, cfg, x):
        seen.append(tuple(x.shape))
        return apply(p, cfg, x)

    monkeypatch.setattr(tmoe, "moe_apply", spy)
    # the mixer adds nothing, so the block's output is x + the MoE's
    monkeypatch.setattr(transformer.attn, "mla_decode",
                        lambda p, cfg, h, cache, length: (torch.zeros_like(h), cache))
    out, _ = transformer.block_decode(bp, tc, tc.pattern[0], tx, {}, torch.zeros(B))
    assert seen == [(1, B, tc.d_model)]
    h = transformer.rmsnorm(bp["norm2"], tx, tc.norm_eps)
    whole, _ = apply(tp, tc, h.reshape(1, B, -1))
    assert torch.equal(out, tx + whole.reshape(B, 1, -1))
    alone = torch.cat([apply(tp, tc, h[i : i + 1].reshape(1, 1, -1))[0] for i in range(B)], 1)
    np.testing.assert_allclose(whole.numpy(), alone.numpy(), rtol=1e-5, atol=1e-6)
