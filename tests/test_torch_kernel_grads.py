"""Gradients of the port's model kernels on the CPU. The JAX package trains
through the jnp twins of its Pallas kernels and has no backward kernel; the
port's kernel Functions (``FlashAttention``, ``SSDScan``, ``RWKV6Scan``) take
the plain version's gradient (``kernels/grad.py``). Here: the plain versions'
gradients against ``jax.grad`` of the JAX twins on the same inputs (numpy
seeds, f32), and the Functions' mechanics, which on a CPU tensor run the plain
version forward too: output and every input gradient bit for bit those of
autograd through the plain version. The kernels' own forwards are held on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import ATTN_CASES, RWKV_CASES, SSD_CASES

from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as rw
from repro_torch.kernels import ssd
from repro_torch.kernels.ref import same_bits

# the plain gradients against the twins' (f32): rtol, and atol as a share
# of the gradient's largest entry
GRAD_TOL = (1e-4, 1e-5)


def _arrays(shapes: list, seed: int, kinds: list) -> list:
    """numpy f32 inputs: ``n`` normal, ``dt`` softplus of a normal, ``A``
    negative decays, ``logw`` log decays across the model's range."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, kind in zip(shapes, kinds):
        if kind == "dt":
            a = np.logaddexp(rng.standard_normal(shape) - 1.0, 0.0)
        elif kind == "A":
            a = -np.exp(rng.uniform(0.0, 2.0, shape))
        elif kind == "logw":
            a = -np.exp(rng.uniform(-8.0, 1.0, shape))
        else:
            a = rng.standard_normal(shape) * (0.5 if kind == "half" else 1.0)
        out.append(a.astype(np.float32))
    return out


def _jax_grads(fn, arrays, cot):
    _, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(a) for a in arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(cot))


def _close(got, want, names):
    """Within GRAD_TOL, NaN where the twin's gradient is NaN: the SSD twin's
    masked ``exp`` overflows to inf above the diagonal of a chunk whose
    decays sum past f32's range, and its select passes 0 * inf = NaN back
    (``jnp.where`` and ``torch.where`` alike)."""
    rtol, share = GRAD_TOL
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, err_msg=name, equal_nan=True,
                                   atol=share * float(np.abs(w[np.isfinite(w)]).max(initial=0.0)))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_gradient_matches_jax_twin(case):
    B, S, H, KH, D, window, _, _ = case
    arrays = _arrays([(B, S, H, D), (B, S, KH, D), (B, S, KH, D)], S + H + D, ["n"] * 3)
    cot = _arrays([(B, S, H, D)], 1, ["n"])[0]
    kw = dict(window=window, chunk=64)
    want = _jax_grads(lambda q, k, v: jattn.blockwise_attention(q, k, v, **kw), arrays, cot)
    got = _torch_grads(lambda q, k, v: fa.blockwise_attention(q, k, v, **kw), arrays, cot)
    _close(got, want, "qkv")


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_gradient_matches_jax_twin(case):
    B, S, H, P, N, chunk = case
    arrays = _arrays([(B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N)], S + H + P,
                     ["n", "dt", "A", "n", "n"])
    cot = _arrays([(B, S, H, P)], 2, ["n"])[0]
    want = _jax_grads(lambda *a: jssm.ssd_chunked(*a, chunk=chunk)[0], arrays, cot)
    got = _torch_grads(lambda *a: ssd.ssd_chunked(*a, chunk=chunk)[0], arrays, cot)
    _close(got, want, ["x", "dt", "A", "B", "C"])


@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_gradient_matches_jax_twin(case):
    B, S, H, P, chunk = case
    shape = (B, S, H, P)
    arrays = _arrays([shape, shape, shape, shape, (H, P)], S + H + P,
                     ["half", "half", "n", "logw", "n"])
    arrays[-1] *= 0.3
    cot = _arrays([shape], 3, ["n"])[0]
    want = _jax_grads(lambda *a: jssm.rwkv6_chunked(*a, chunk=chunk)[0], arrays, cot)
    got = _torch_grads(lambda *a: rw.rwkv6_chunked(*a, chunk=chunk)[0], arrays, cot)
    _close(got, want, ["r", "k", "v", "logw", "u"])



FUNCTIONS = {
    # name: (Function, hsd entry, plain entry, input shapes (heads-major), kinds, keywords)
    "flash": (fa.FlashAttention, fa.flash_attention_hsd, fa.flash_attention_plain,
              [(2, 4, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32)], ["n"] * 3,
              dict(causal=True, window=24, scale=None, chunk=16)),
    "flash_not_causal": (fa.FlashAttention, fa.flash_attention_hsd, fa.flash_attention_plain,
                         [(1, 2, 32, 16), (1, 1, 32, 16), (1, 1, 32, 8)], ["n"] * 3,
                         dict(causal=False, window=0, scale=0.3, chunk=8)),
    "ssd": (ssd.SSDScan, ssd.ssd_scan_hsd, ssd.ssd_scan_plain,
            [(2, 3, 64, 16), (2, 3, 64), (3,), (2, 64, 8), (2, 64, 8)],
            ["n", "dt", "A", "n", "n"], dict(chunk=16)),
    "rwkv6": (rw.RWKV6Scan, rw.rwkv6_scan_hsd, rw.rwkv6_scan_plain,
              [(2, 2, 48, 16)] * 4 + [(2, 16)], ["half", "half", "n", "logw", "n"],
              dict(chunk=16)),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("needs", ["all", "first"])
def test_function_gradient_is_the_plain_versions(name, needs):
    """On the CPU the Function's forward runs the plain version (no launch
    is counted): its output and the gradient of every input that needs one
    equal autograd through the plain version bit for bit; an input that needs
    none gets None."""
    function, hsd, plain, shapes, kinds, kw = FUNCTIONS[name]
    arrays = _arrays(shapes, 5, kinds)
    want_grad = [needs == "all" or i == 0 for i in range(len(arrays))]
    ins = [torch.from_numpy(a).requires_grad_(w) for a, w in zip(arrays, want_grad)]
    before = hsd.launches
    out = function.apply(*ins, kw)
    assert hsd.launches == before
    cot = torch.from_numpy(_arrays([tuple(out.shape)], 6, ["n"])[0])
    got = torch.autograd.grad(out, [t for t in ins if t.requires_grad], cot)
    ref_in = [torch.from_numpy(a).requires_grad_(w) for a, w in zip(arrays, want_grad)]
    ref_out = plain(*ref_in, **kw)
    want = torch.autograd.grad(ref_out, [t for t in ref_in if t.requires_grad], cot)
    assert same_bits(out.detach(), ref_out.detach())
    with torch.no_grad():
        assert same_bits(out.detach(), hsd(*ins, **kw))
    assert len(got) == len(want) == sum(want_grad)
    for g, w in zip(got, want):
        assert same_bits(g, w)


def test_ops_wrappers_differentiate_the_plain_version_on_cpu():
    """The model-layout wrappers on CPU tensors that require a gradient run
    the plain version (no launch) and pass its gradient to every input;
    RWKV-6 still refuses chunks above 16 there."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 2, 16, generator=g, requires_grad=True) for _ in range(3))
    before = fa.flash_attention_hsd.launches
    out = ops.flash_attention(q, k, v, window=8, chunk=8)
    dq, dk, dv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert fa.flash_attention_hsd.launches == before
    want = torch.autograd.grad(
        fa.blockwise_attention(q, k, v, window=8, chunk=8).square().sum(), (q, k, v))
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b) and bool(a.abs().max() > 0)
    r, kk, vv = (torch.randn(1, 32, 1, 16, generator=g, requires_grad=True) for _ in range(3))
    logw = -torch.rand(1, 32, 1, 16, generator=g).requires_grad_()
    u = torch.randn(1, 16, generator=g, requires_grad=True)
    y = ops.rwkv6_scan(r, kk, vv, logw, u)
    grads = torch.autograd.grad(y.sum(), (r, kk, vv, logw, u))
    assert all(bool(t.abs().max() > 0) for t in grads)
    with pytest.raises(ValueError, match="chunk"):
        ops.rwkv6_scan(r, kk, vv, logw, u, chunk=32)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_under_remat_gives_the_same_gradient(name):
    """Inside ``torch.utils.checkpoint`` (the stack's remat, where the saved
    inputs may be unpacked only once) the Function gives the gradient it
    gives outside, bit for bit."""
    function, _, _, shapes, kinds, kw = FUNCTIONS[name]
    arrays = _arrays(shapes, 7, kinds)
    cot = None
    grads = []
    for remat in (False, True):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrays]

        def run(*xs):
            return function.apply(*xs, kw) * 1.5

        out = torch.utils.checkpoint.checkpoint(run, *ins, use_reentrant=False) if remat \
            else run(*ins)
        if cot is None:
            cot = torch.from_numpy(_arrays([tuple(out.shape)], 8, ["n"])[0])
        grads.append(torch.autograd.grad(out, ins, cot))
    for a, b in zip(*grads):
        assert same_bits(a, b)
