"""The port's train step against the JAX package's on the CPU, for the SSM
and MoE models: zamba2-7b (Mamba-2 with shared attention), rwkv6-3b, and
deepseek-v3-671b (MLA, MoE, and the MTP head at weight 0.3); one f32 step
each from the JAX init carried across, as ``test_torch_train.py`` holds the
dense models."""
import pytest

from repro_torch.train import TrainConfig
from test_torch_train import one_step_matches


@pytest.mark.parametrize("arch", ["zamba2-7b-smoke", "rwkv6-3b-smoke"])
def test_ssm_train_step_matches_reference(arch):
    one_step_matches(arch, TrainConfig())


def test_moe_mtp_train_step_matches_reference():
    """The MoE metrics (balance, dropped share) and the MTP CE among the
    metrics; ``mtp_proj`` is carried from the JAX state and trained."""
    one_step_matches("deepseek-v3-671b-smoke", TrainConfig(mtp_weight=0.3))
