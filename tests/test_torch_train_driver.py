"""The port's training driver (``python -m repro_torch.launch.train``)
against the JAX package's (``repro.launch.train``) with the same arguments
on the CPU, from the same initial weights (the port's init replaced by the
JAX init carried across), and a resume from a checkpoint."""
import dataclasses
import os

import jax
import numpy as np
import torch

import repro.launch.train as jdriver
import repro.optim as joptim
import repro.train as jtrain
import repro_torch.launch.train as tdriver
import repro_torch.optim as toptim
from repro.configs import get_config as jax_config
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_map

ARGS = ["--arch", "internlm2-1.8b-smoke", "--steps", "4", "--log-every", "1"]


def jax_init(cfg, opt_cfg, generator=0, *, train_cfg=None, device="cuda"):
    """``init_train_state`` of the port from the JAX package's
    ``init_train_state`` with the same seed (a ``PRNGKey``)."""
    jopt = joptim.AdamWConfig(**dataclasses.asdict(opt_cfg))
    jtc = jtrain.TrainConfig(**dataclasses.asdict(train_cfg))
    jstate = jtrain.init_train_state(jax_config(cfg.name), jopt, jax.random.PRNGKey(generator),
                                     train_cfg=jtc)
    params = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg, device)
    params = tree_map(lambda t: t.requires_grad_(), params)
    return {"params": params, "opt": toptim.init_state(opt_cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def test_driver_matches_reference_driver(monkeypatch, capsys):
    """Four bf16 steps at the drivers' defaults (batch 8, seq 128, lr 3e-3):
    the first loss within the port's bf16 logit tolerance (rtol 2e-2); the
    last within rtol 2e-3, which covers AdamW's sign noise (an entry whose
    gradient the packages round to opposite signs moves 2 lr apart; the gap
    read on these inputs is 5e-5); both drivers print a line a step, and the
    port's loss falls."""
    want = jdriver.main(ARGS)
    monkeypatch.setattr(tdriver, "init_train_state", jax_init)
    got = tdriver.main([*ARGS, "--device", "cpu"])
    np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=2e-2)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"], rtol=2e-3)
    assert len(got["losses"]) == 4 and all(np.isfinite(got["losses"]))
    assert got["last_loss"] < got["first_loss"]
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("step ")]
    assert len(lines) == 8  # four from each driver, with the same fields
    assert [x.split()[2] for x in lines[:4]] == [x.split()[2] for x in lines[4:]] == ["loss"] * 4


def test_driver_resumes_from_a_checkpoint(tmp_path, capsys):
    """An uninterrupted run of 4 steps checkpointing every 2; with its step-4
    snapshot unfinished (no COMPLETE flag), a second run resumes from step 2
    and ends at the uninterrupted run's loss."""
    args = [*ARGS, "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    full = tdriver.main(args)
    os.remove(tmp_path / "step_00000004" / "COMPLETE")
    resumed = tdriver.main(args)
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(resumed["losses"]) == 2
    assert resumed["losses"] == full["losses"][2:]
