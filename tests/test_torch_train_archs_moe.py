"""The train step of the port against the JAX package's for the MoE archs:
phi3.5-MoE (capacity dispatch) and DeepSeek-V3 (MLA, a shared expert, the
aux-free router bias, which takes no gradient and still decays, and the
MTP term). 5 steps of both on the reference's carried smoke-config state
and one batch (``_train_parity.check_train_steps``, whose docstring states
every tolerance)."""
import pytest
from _train_parity import check_train_steps

MOE = ["phi35_moe_42b", "deepseek_v3_671b"]


@pytest.mark.parametrize("arch", MOE)
def test_train_steps_match_reference(arch):
    out = check_train_steps(arch)
    assert out["losses"][-1] < out["losses"][0]
