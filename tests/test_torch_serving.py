"""The port's continuous-batching engine (``repro_torch.serving``) against the
JAX package's, on the CPU, from the same parameters (the JAX init carried over
by ``params_from_jax``) at f32: the same requests give the same tokens, token
for token, with more requests than slots so that slots are recycled; the
constructor takes the reference's keywords (``greedy=``); and the
``repro_torch.launch.serve`` command runs end to end."""
import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.models as jm
import repro.serving as jserving
import repro_torch.configs as tconfigs
from repro_torch import serving as tserving
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax

SLOTS, MAX_LEN, N_REQ = 3, 40, 8


def _requests(module, vocab, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(N_REQ):
        prompt = rng.randint(1, vocab, size=rng.randint(2, 10)).tolist()
        out.append(module.Request(uid=i, prompt=prompt, max_new_tokens=int(rng.randint(2, 12))))
    return out


@pytest.mark.parametrize(
    "arch", ["gemma3-1b-smoke", "internlm2-1.8b-smoke", "zamba2-7b-smoke", "rwkv6-3b-smoke",
             "minicpm3-4b-smoke", "deepseek-v2-lite-16b-smoke", "starcoder2-7b-smoke",
             "phi-3-vision-4.2b-smoke", "musicgen-medium-smoke"]
)
def test_engine_tokens_equal_jax(arch):
    """For the SSM archs a recycled slot must also have its recurrent state
    (conv window, SSD and wkv states, token shift) zeroed on admission. The
    MLA archs decode over the latent cache; deepseek-v2-lite's MoE blocks
    dispatch the whole slot batch as one group at every tick, free slots
    included, as the JAX engine does. starcoder2 and musicgen run the ungated
    MLP; both engines serve the frontend archs (phi-3-vision, musicgen)
    text-only, with no frontend prefix."""
    _engines_serve_equal_tokens(arch)


def test_engine_takes_greedy_as_the_reference_does():
    """``ServingEngine(..., greedy=True)`` constructs in both packages and
    stores the flag; decoding stays argmax (the reference never reads it), so
    both serve the same tokens."""
    teng = _engines_serve_equal_tokens("internlm2-1.8b-smoke", greedy=True)
    assert teng.greedy is True


def _engines_serve_equal_tokens(arch, **engine_kwargs):
    """Serve the same requests on both packages' engines, built with
    ``engine_kwargs``; returns the port's engine."""
    jc = dataclasses.replace(jconfigs.get_config(arch), dtype="float32")
    tc = dataclasses.replace(tconfigs.get_config(arch), dtype="float32")
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    jeng = jserving.ServingEngine(jc, jp, slots=SLOTS, max_len=MAX_LEN, **engine_kwargs)
    teng = tserving.ServingEngine(tc, tp, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                                  **engine_kwargs)
    for r in _requests(jserving, jc.vocab, 5):
        jeng.submit(r)
    for r in _requests(tserving, tc.vocab, 5):
        teng.submit(r)
    jdone = jeng.run_until_drained()
    tdone = teng.run_until_drained()
    assert len(tdone) == N_REQ and all(r.done for r in tdone)
    assert [r.uid for r in tdone] == [r.uid for r in jdone]  # the same finishing order
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert N_REQ > SLOTS  # slots were recycled
    assert teng.active == 0 and not teng.queue
    np.testing.assert_array_equal(teng.cache["length"].numpy(), np.asarray(jeng.cache["length"]))
    return teng


def test_engine_rejects_oversized_request():
    cfg = tconfigs.get_config("internlm2-1.8b-smoke")
    from repro_torch.models import init_params

    eng = tserving.ServingEngine(cfg, init_params(cfg, 0, device="cpu"), slots=1, max_len=8,
                                 device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(tserving.Request(uid=0, prompt=[1] * 6, max_new_tokens=4))


def test_serve_cli_on_cpu(capsys):
    out = serve.main(
        ["--arch", "gemma3-1b-smoke", "--requests", "5", "--slots", "2", "--max-len", "40",
         "--device", "cpu"]
    )
    assert out["requests"] == 5 and out["tokens"] > 0 and out["ticks"] > 0
    assert "served 5 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2-7b-smoke", "rwkv6-3b-smoke"])
def test_serve_cli_on_cpu_ssm(arch, capsys):
    out = serve.main(
        ["--arch", arch, "--requests", "5", "--slots", "2", "--max-len", "40", "--device", "cpu"]
    )
    assert out["requests"] == 5 and out["tokens"] > 0 and out["ticks"] > 0
    assert "served 5 requests" in capsys.readouterr().out


@pytest.mark.parametrize(
    "arch", ["minicpm3-4b-smoke", "deepseek-v2-lite-16b-smoke", "deepseek-v3-671b-smoke"]
)
def test_serve_cli_on_cpu_mla(arch, capsys):
    """The MLA archs, with dense (minicpm3) and MoE MLPs (deepseek), serve
    from the command line."""
    out = serve.main(
        ["--arch", arch, "--requests", "5", "--slots", "2", "--max-len", "40", "--device", "cpu"]
    )
    assert out["requests"] == 5 and out["tokens"] > 0 and out["ticks"] > 0
    assert "served 5 requests" in capsys.readouterr().out
