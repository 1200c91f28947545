"""The train step of the port against the JAX package's for the recurrent
archs: Jamba (Mamba's scan beside attention and MoE) and xLSTM (mLSTM and
sLSTM cells). 5 steps of both on the reference's carried smoke-config
state and one batch (``_train_parity.check_train_steps``, whose docstring
states every tolerance; these two are held to a fixed gradient bar of
twice the reference's own distance from its float64 evaluation)."""
import pytest
from _train_parity import (GRAD_BAR, check_gradients, check_train_steps,
                           step1_gradients)

RECURRENT = ["jamba_v01_52b", "xlstm_350m"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_steps_match_reference(arch):
    out = check_train_steps(arch)
    assert out["losses"][-1] < out["losses"][0]
    assert out["grad_worst"] <= GRAD_BAR[arch]


def test_planted_gradient_error_fails():
    """A relative error of 6e-5 planted in one leaf's step-1 gradient of
    the port (xLSTM's ``blocks.0.mixer.wq``, an mLSTM leaf, scaled through a
    gradient hook) fails the gradient check at the arch's fixed 3e-5."""
    leaf = "blocks.0.mixer.wq"
    pairs, _, _ = step1_gradients("xlstm_350m", plant=(leaf, 1 + 6e-5))
    with pytest.raises(AssertionError,
                       match=f"step-1 gradient of {leaf}:"):
        check_gradients("xlstm_350m", pairs)
