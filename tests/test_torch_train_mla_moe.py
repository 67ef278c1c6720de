"""The port's train step against the JAX package's on the CPU, for the MLA
and MoE models chip_smoke trains at full width: minicpm3-4b (MLA with a q
LoRA, dense MLPs) and deepseek-v2-lite-16b (MLA without a q LoRA, a dense
first layer, then MoE layers of routed and shared experts). One f32 step of
each, one bf16 step of each, and deepseek-v2-lite-16b's step with two
microbatches and the MTP head, from the JAX init carried across
(tolerances in ``_torch_train_common``; the bf16 ones in
``test_torch_train.bf16_step_matches``)."""
import pytest

from repro_torch.train import TrainConfig
from test_torch_models import MAX_ROUTE_FLIPS, reference_routing
from test_torch_train import bf16_step_matches, one_step_matches

ARCHS = ["minicpm3-4b-smoke", "deepseek-v2-lite-16b-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_moe_train_step_matches_reference(arch):
    """Loss, CE and the gradient norm, and for deepseek-v2-lite-16b the MoE
    metrics (``moe_balance``, ``moe_dropped_frac``), within METRIC_RTOL;
    every gradient leaf (the router, the stacked experts, the shared
    experts, MLA's projections with and without the q LoRA) within
    GRAD_RTOL / GRAD_ATOL; the updated parameters within PARAM_ATOL /
    SIGN_SHARE. At f32 the two packages route every token alike."""
    one_step_matches(arch, TrainConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_moe_bf16_step_matches_reference(arch, monkeypatch):
    """One bf16 step, held as ``test_bf16_step_matches_reference`` holds the
    dense models. deepseek-v2-lite-16b's MoE blocks replay the JAX run's
    expert choices (``test_torch_models.reference_routing``): its jitted
    step reports each ``top_k``'s choices through an ordered
    ``jax.debug.callback``, which fires where the values are concrete, in
    program order: each gradient's forward (layers in order), then remat's
    recompute in the backward (layers in reverse), once for the step's
    gradient and once for the gradient ``jax_step`` returns, 8 calls on the
    smoke config. The port calls ``torch.topk`` in the same order (its
    non-reentrant checkpoints recompute the groups in reverse), and each
    JAX recompute chose as its forward did. Unreplayed, the port's own
    router differs in 28 of the 2,048 bf16 choices here (1.4%); held to
    MAX_ROUTE_FLIPS, as the forward is."""
    moe = arch.startswith("deepseek")
    with reference_routing(monkeypatch, moe) as (in_jax, in_port, flips):
        bf16_step_matches(arch, in_jax, in_port)
    if moe:
        assert flips["of"] == 8 * 4 * 32 * 2  # 8 calls of (B, S, top_k)
        assert flips["n"] <= MAX_ROUTE_FLIPS * flips["of"]


def test_moe_microbatched_mtp_step_matches_reference():
    """Two microbatches and the MTP head at weight 0.3 (``mtp_proj`` carried
    from the JAX state): the gradients accumulated in f32 and divided by 2,
    the metrics (``mtp_ce`` and the MoE terms among them) averaged over the
    microbatches, against the reference's ``microbatches=2, mtp_weight=0.3``.
    Each microbatch dispatches its own sequences, so the MoE capacity and
    dropped share are per microbatch in both packages."""
    one_step_matches("deepseek-v2-lite-16b-smoke", TrainConfig(microbatches=2, mtp_weight=0.3))
