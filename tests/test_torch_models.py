"""The port's model substrate (``repro_torch.configs`` / ``repro_torch.models``)
against the JAX package's, on the CPU, from the *same* parameters: the JAX
``init_params`` tree carried over by ``params_from_jax``. Token inputs are made
with numpy from a seed. Prefill attention runs the flash kernel's plain version
here."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro.configs import shapes as jshapes
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax

ARCHS = ("gemma3-1b-smoke", "internlm2-1.8b-smoke", "zamba2-7b-smoke", "rwkv6-3b-smoke",
         "minicpm3-4b-smoke", "deepseek-v2-lite-16b-smoke", "deepseek-v3-671b-smoke",
         "starcoder2-7b-smoke", "phi-3-vision-4.2b-smoke", "musicgen-medium-smoke")
MOE_AUX = ("moe_balance_loss", "moe_dropped_frac", "moe_router_zloss")
# bf16 routing: the share of top-k choices in which the port's own router may
# differ from the JAX package's (two of 256 at most on these inputs)
MAX_ROUTE_FLIPS = 0.02
B, S = 2, 32
F32 = dict(rtol=1e-4, atol=1e-4)


def bf16_tol(want):
    """bf16 noise in the logits is absolute, not relative: a logit is a
    d-term dot product of hidden states that carry a few bf16 ulps each. The
    JAX package differs from itself by up to 0.21 on these inputs (max |logit|
    30) when only XLA's excess-precision flag changes, failing an elementwise
    rtol=atol=2e-2 on 3-8% of the logits; so atol is 2e-2 of the largest
    logit."""
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def _pair(arch, dtype, **overrides):
    jc = dataclasses.replace(jconfigs.get_config(arch), dtype=dtype, **overrides)
    tc = dataclasses.replace(tconfigs.get_config(arch), dtype=dtype, **overrides)
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _frontend(cfg, seed=0, batch=B):
    """A frontend model's stubbed embeddings (batch, frontend_tokens, d_model),
    standard normal from a seed, as the data pipeline makes them; None for a
    text-only model. Both packages prepend them to the token embeddings."""
    if not cfg.frontend:
        return None
    rng = np.random.default_rng(seed + 100)
    return rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _jax_in(fe):
    return None if fe is None else jnp.asarray(fe)


def _port_in(fe):
    return None if fe is None else torch.from_numpy(fe)


@pytest.mark.parametrize("name", sorted(jconfigs.list_configs()))
def test_configs_equal(name):
    """All 20 registered configs: every field, the stack and the analytic
    counts."""
    a, b = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)  # recurses into the blocks
    assert [dataclasses.asdict(x) for x in a.blocks] == [dataclasses.asdict(y) for y in b.blocks]
    for fn in ("param_count", "active_param_count"):
        assert getattr(a, fn)() == getattr(b, fn)()
    assert a.n_layers == b.n_layers and a.pure_full_attention == b.pure_full_attention


def test_registry_and_shapes_equal():
    assert jconfigs.ARCH_IDS == tconfigs.ARCH_IDS
    assert len(tconfigs.list_configs()) == 20
    assert jconfigs.list_configs() == tconfigs.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in jshapes.CELLS.items()} == {
        k: dataclasses.asdict(v) for k, v in tshapes.CELLS.items()
    }
    assert jshapes.all_cells(jconfigs.ARCH_IDS) == tshapes.all_cells(tconfigs.ARCH_IDS)


def f32_tol(jp, jc, tok, want, monkeypatch, fe=None):
    """1e-4, or twice the JAX package's own spread where that is larger: the
    gap between its forward through the chunked scans and through the
    sequential oracles, both exact forms. RWKV-6's per-head group norm scales
    heads whose outputs are near 0 (std 1e-3 against eps 1e-5) by ~300, so
    f32 noise in the scan shows in the logits: the reference's two forms
    differ by up to 1.8e-4 there."""
    if not any(b.mixer in ("mamba2", "rwkv6") for b in jc.blocks):
        return F32
    with monkeypatch.context() as m:
        m.setattr(jssm, "ssd_chunked", lambda *a, chunk=64: jssm.ssd_sequential(*a))
        m.setattr(jssm, "rwkv6_chunked", lambda *a, chunk=16: jssm.rwkv6_sequential(*a))
        exact, _ = jm.forward(jp, jc, jnp.asarray(tok), _jax_in(fe))
    spread = float(np.abs(np.asarray(exact) - want).max())
    return dict(rtol=1e-4, atol=max(1e-4, 2 * spread))


@contextlib.contextmanager
def reference_routing(monkeypatch, route: bool):
    """With ``route``, the port's MoE blocks take the expert choices the JAX
    run inside the context made, in call order, and ``flips`` counts the
    choices in which the port's own router differed. bf16 needs this: a
    one-ulp difference in a hidden state (XLA and PyTorch round the sums of
    bf16 products in different places) flips the top-k of a near tie, and a
    flipped choice moves a token's whole expert output. Yields ``(jax_run,
    port_run)``: wrap each package's calls in its context."""
    seen, flips = [], {"n": 0, "of": 0}
    if not route:
        yield contextlib.nullcontext, contextlib.nullcontext, flips
        return
    top_k, topk = jax.lax.top_k, torch.topk

    def recording(x, k):
        gates, idx = top_k(x, k)
        jax.debug.callback(lambda a: seen.append(np.array(a)), idx, ordered=True)
        return gates, idx

    def replaying(probs, k, dim=-1):
        own = topk(probs, k, dim=dim)[1]
        ref = torch.from_numpy(seen.pop(0)).long()
        flips["n"] += int((own != ref).sum())
        flips["of"] += ref.numel()
        return probs.gather(-1, ref), ref

    @contextlib.contextmanager
    def patched(obj, name, fn):
        with monkeypatch.context() as m:
            m.setattr(obj, name, fn)
            yield
        jax.effects_barrier()  # every recording callback has run

    yield (lambda: patched(jax.lax, "top_k", recording),
           lambda: patched(torch, "topk", replaying), flips)
    assert not seen  # every recorded choice was replayed


def check_aux(got: dict, want: dict, dtype: str) -> None:
    """The MoE metrics of a forward: the JAX package's keys, and at f32 its
    values within 1e-5 relative; at bf16 (the reference's routing) the same
    dropped share and the router's f32 metrics within 1e-3 relative (its
    input carries bf16 noise)."""
    assert set(got) == set(want)
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert got[k].dtype == torch.float32 and np.isfinite(g)
        rtol = 1e-5 if dtype == "float32" or k == "moe_dropped_frac" else 1e-3
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(arch, dtype, monkeypatch):
    """Logits, and for MoE models the aux, of ``forward`` and ``prefill``.
    A MoE model at bf16 runs on the JAX run's expert choices
    (:func:`reference_routing`), and its own router may differ from them in
    at most MAX_ROUTE_FLIPS of the choices. A frontend model (phi-3-vision,
    musicgen) gets the same seeded embeddings in both packages, prepended to
    its S text tokens; its logits cover the text positions."""
    jc, tc, jp, tp = _pair(arch, dtype)
    tok, fe = _tokens(jc), _frontend(jc)
    moe = jc.n_experts > 0
    with reference_routing(monkeypatch, moe and dtype == "bfloat16") as (in_jax, in_port, flips):
        with in_jax():
            want, want_aux = jm.forward(jp, jc, jnp.asarray(tok), _jax_in(fe))
            want_last, want_last_aux = jm.prefill(jp, jc, jnp.asarray(tok), _jax_in(fe))
        with in_port():
            got, aux = tm.forward(tp, tc, torch.from_numpy(tok).long(), _port_in(fe))
            got_last, last_aux = tm.prefill(tp, tc, torch.from_numpy(tok).long(), _port_in(fe))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, tc.vocab)
    assert flips["n"] <= MAX_ROUTE_FLIPS * flips["of"]
    if moe:
        assert set(aux) == set(MOE_AUX)
        check_aux(aux, want_aux, dtype)
        check_aux(last_aux, want_last_aux, dtype)
    else:
        assert aux == {} and last_aux == {}
    want = np.asarray(want)
    tolerance = (f32_tol(jp, jc, tok, want, monkeypatch, fe) if dtype == "float32"
                 else bf16_tol(want))
    np.testing.assert_allclose(got.numpy(), want, **tolerance)
    assert tuple(got_last.shape) == (B, 1, tc.vocab)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **tolerance)


@pytest.mark.parametrize("seq", [37, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_short_prompt_forward_matches_jax(seq, dtype, monkeypatch):
    """A prompt shorter than 64 tokens whose length is no tile instance: both
    packages pass the SSD scan the chunk min(64, pick_chunk(S)) = S (37 or
    48), which the port's kernels take too; the logits agree at the
    tolerances of test_forward_and_prefill_match_jax."""
    jc, tc, jp, tp = _pair("zamba2-7b-smoke", dtype)
    tok = _tokens(jc, seed=2, shape=(1, seq))
    want = np.asarray(jm.forward(jp, jc, jnp.asarray(tok))[0])
    tolerance = f32_tol(jp, jc, tok, want, monkeypatch) if dtype == "float32" else bf16_tol(want)
    chunks = []
    scan = tops.ssd_scan

    def spy(*args, chunk):
        chunks.append(chunk)
        return scan(*args, chunk=chunk)

    monkeypatch.setattr(tops, "ssd_scan", spy)
    got, _ = tm.forward(tp, tc, torch.from_numpy(tok).long())
    assert chunks and set(chunks) == {seq}
    np.testing.assert_allclose(got.numpy(), want, **tolerance)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_own_forward(arch):
    """Teacher-forced decode at f32: each step's logits against the JAX
    package's decode step (1e-4), and the port's decode against its own
    forward at 2e-3, as tests/test_arch_smoke.py holds the reference; for a
    MoE model at its drop-free capacity, as there (the forward dispatches a
    sequence a group, decode the batch, so the two drop different choices
    at the configured capacity). A frontend model's decode is text-only in
    both packages and is held to the JAX decode alone: its forward needs the
    frontend prefix, which a text-only decode has not seen, so the reference
    skips that parity for frontend archs (tests/test_arch_smoke.py)."""
    cfg = tconfigs.get_config(arch)
    drop_free = dict(capacity_factor=float(cfg.n_experts / cfg.top_k)) if cfg.n_experts else {}
    jc, tc, jp, tp = _pair(arch, "float32", **drop_free)
    tok = _tokens(jc, seed=1, shape=(B, 16))
    jcache = jm.init_cache(jc, B, 16)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, jc, c, t))
    tcache = tm.init_cache(tc, B, 16, device="cpu")
    outs = []
    for i in range(16):
        want, jcache = step(jp, jcache, jnp.asarray(tok[:, i : i + 1]))
        got, tcache = tm.decode_step(tp, tc, tcache, torch.from_numpy(tok[:, i : i + 1]).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        outs.append(got)
    assert tcache["length"].tolist() == [16, 16]
    if cfg.frontend:
        return
    fwd, _ = tm.forward(tp, tc, torch.from_numpy(tok).long())
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), fwd.numpy(), rtol=2e-3, atol=2e-3)


def test_convert_unstacks_groups_in_layer_order():
    """Group g, pattern position i of the JAX stack is layer
    len(prefix) + g*len(pattern) + i of the port."""
    jc, tc, jp, tp = _pair("gemma3-1b-smoke", "float32")
    flat = transformer.layers(tc, tp["stack"])
    assert len(flat) == tc.n_layers
    P = len(tc.pattern)
    for g in range(tc.n_pattern_repeats):
        for i in range(P):
            want = np.asarray(jp["stack"]["groups"][i]["mixer"]["wq"][g])
            got = flat[len(tc.prefix) + g * P + i]["mixer"]["wq"].numpy()
            np.testing.assert_array_equal(got, want)
    n = sum(t.numel() for t in _leaves(tp["stack"])) + tp["embed"].numel() + tc.d_model
    assert n == tc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_counts_and_determinism(arch):
    """The port's own seeded init: the analytic parameter count, the same
    weights for the same seed, f32 logits from bf16 weights (a frontend
    model's from seeded frontend embeddings too)."""
    cfg = tconfigs.get_config(arch)
    a = tm.init_params(cfg, 3, device="cpu")
    b = tm.init_params(cfg, 3, device="cpu")
    n = sum(t.numel() for t in _leaves(a)) - sum(t.numel() for t in _leaves(a["stack"]))
    n += sum(t.numel() for bp in transformer.layers(cfg, a["stack"]) for t in _leaves(bp))
    n += sum(t.numel() for t in _leaves(a["stack"]["shared_attn"]))  # zamba2's, counted once
    assert n == cfg.param_count()
    assert torch.equal(a["embed"], b["embed"]) and a["embed"].dtype == torch.bfloat16
    assert float(a["embed"].float().abs().max()) <= 2.0  # truncated at 2 sigma
    tok = torch.from_numpy(_tokens(cfg)).long()
    logits, _ = tm.forward(a, cfg, tok, _port_in(_frontend(cfg)))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert tuple(logits.shape) == (B, S, cfg.vocab)


def _leaves(tree):
    """Every tensor of a params tree (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def test_deepseek_v3_cut_has_the_reference_layout():
    """deepseek-v3-671b at chip_smoke's cut (its 3 dense layers and 1 of its
    58 MoE layers, full width): the port's init on the meta device gives the
    leaves of the JAX package's ``jax.eval_shape`` of its own init, path by
    path in its flattening order, with the same shapes (a group leaf
    stacked over the one group) and dtypes, and 15,111,101,440 parameters.
    This holds the full-width q LoRA, the 128-head MLA at (192, 128) and the
    256-expert layer to the reference without memory on either side."""
    name, n = "deepseek-v3-671b", 15_111_101_440
    jc = dataclasses.replace(jconfigs.get_config(name), n_pattern_repeats=1)
    tc = dataclasses.replace(tconfigs.get_config(name), n_pattern_repeats=1)
    ref = jax.eval_shape(lambda key: jm.init_params(jc, key), jax.random.PRNGKey(0))
    port = tm.init_params(tc, torch.Generator(), device="meta")
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    ours = transformer.reference_leaves(port)
    assert len(ours) == len(ref_leaves)
    for (path, tensors, stacked), (ref_path, leaf) in zip(ours, ref_leaves):
        assert path == "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in ref_path)
        shape = (len(tensors), *tensors[0].shape) if stacked else tuple(tensors[0].shape)
        assert shape == tuple(leaf.shape), path
        assert all(str(t.dtype) == f"torch.{leaf.dtype}" for t in tensors), path
    assert sum(leaf.size for _, leaf in ref_leaves) == n == jc.param_count() == tc.param_count()
    assert sum(t.numel() for t in _leaves(port)) == n
    mixer, moe = port["stack"]["groups"][0][0]["mixer"], port["stack"]["groups"][0][0]["moe"]
    assert tuple(mixer["q_up"].shape) == (1536, 128 * 192)
    assert tuple(moe["w_up"].shape) == (256, 7168, 2048) and tc.top_k == 8


@pytest.mark.parametrize("name", sorted(tconfigs.list_configs()))
def test_every_config_initialises_with_its_parameter_count(name):
    """Every registered config, full size and smoke, initialises in the port
    (on the meta device: shapes without storage, so deepseek-v3-671b's 671 B
    parameters cost nothing) with exactly ``param_count()`` parameters, each
    layer's leaves in the JAX package's layout."""
    cfg = tconfigs.get_config(name)
    p = tm.init_params(cfg, torch.Generator(), device="meta")
    n = sum(t.numel() for t in _leaves(p)) - sum(t.numel() for t in _leaves(p["stack"]))
    n += sum(t.numel() for bp in transformer.layers(cfg, p["stack"]) for t in _leaves(bp))
    n += sum(t.numel() for t in _leaves(p["stack"]["shared_attn"]))
    assert n == cfg.param_count()
    for bp, b in zip(transformer.layers(cfg, p["stack"]), cfg.blocks):
        assert {"moe": "moe", "dense": "mlp"}.get(b.mlp, "norm1") in bp
        if b.mlp == "moe":
            assert tuple(bp["moe"]["w_up"].shape) == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
            assert bp["moe"]["router"].dtype == torch.float32


def test_shared_attention_is_one_parameter_set():
    """zamba2-7b's 81-layer stack (13 groups of 5 Mamba-2 blocks and one
    shared-attention block, then 3 Mamba-2 blocks) at smoke width: the JAX
    tree's single ``shared_attn`` mixer is carried bit for bit, and all 13
    attention positions of a forward read those same tensors, not copies.
    Each keeps its own norms and MLP, and the count has the mixer once."""
    full = jconfigs.get_config("zamba2-7b")
    width = dict(d_model=64, vocab=256, n_heads=4, n_kv_heads=4, head_dim=16, v_head_dim=16,
                 d_ff=64, ssm_state=16, ssm_heads=8, ssm_head_dim=16, dtype="float32")
    jc = dataclasses.replace(full, **width)
    tc = dataclasses.replace(tconfigs.get_config("zamba2-7b"), **width)
    assert tc.n_layers == 81 and sum(b.shared_attn for b in tc.blocks) == 13
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    shared = tp["stack"]["shared_attn"]
    for name, leaf in jp["stack"]["shared_attn"].items():
        want = np.asarray(leaf)
        np.testing.assert_array_equal(shared[name].numpy(), want)
    flat = transformer.layers(tc, tp["stack"])
    attn_layers = [bp for bp, b in zip(flat, tc.blocks) if b.shared_attn]
    assert len(attn_layers) == 13
    assert all("mixer" not in bp and {"norm1", "norm2", "mlp"} <= set(bp) for bp in attn_layers)
    assert len({id(bp["mlp"]["up"]) for bp in attn_layers}) == 13  # own MLPs
    n = sum(t.numel() for t in _leaves(tp["stack"])) + tp["embed"].numel() + tc.d_model
    n += tp["unembed"].numel()
    assert n == tc.param_count() == jc.param_count()

    seen = []
    gqa_apply = transformer.attn.gqa_apply

    def spy(p, *args, **kwargs):
        seen.append({k: v.data_ptr() for k, v in p.items()})
        return gqa_apply(p, *args, **kwargs)

    transformer.attn.gqa_apply = spy
    try:
        tm.forward(tp, tc, torch.from_numpy(_tokens(tc, shape=(1, 16))).long())
    finally:
        transformer.attn.gqa_apply = gqa_apply
    assert len(seen) == 13
    assert all(s == {k: v.data_ptr() for k, v in shared.items()} for s in seen)
