"""The train step of the port against the JAX package's for the dense and
GQA archs, the VLM (internvl2, its patch prefix dropped before the loss)
and the encoder-decoder (seamless, its encoder under remat too): 5 steps
of both on the reference's carried smoke-config state and one batch
(``_train_parity.check_train_steps``, whose docstring states every
tolerance). The per-arch parity is split over
``tests/test_torch_train_archs*.py``, so that no one file holds all of the
reference's slow compiles."""
import pytest
from _train_parity import check_gradients, check_train_steps, step1_gradients

DENSE = ["olmo_1b", "phi4_mini_3p8b", "stablelm_3b", "llama3_405b",
         "internvl2_26b", "seamless_m4t_large_v2"]


@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_reference(arch):
    out = check_train_steps(arch)
    assert out["losses"][-1] < out["losses"][0]


def test_planted_gradient_error_fails():
    """A relative error of 5e-5 planted in one leaf's step-1 gradient of
    the port (olmo's ``blocks.1.mlp.w_down``, scaled by 1 + 5e-5 through a
    gradient hook) fails the gradient check: the bar is the fixed 1e-5 of
    the leaf's scale, not one that widens with the port's own error."""
    leaf = "blocks.1.mlp.w_down"
    pairs, _, _ = step1_gradients("olmo_1b", plant=(leaf, 1 + 5e-5))
    with pytest.raises(AssertionError,
                       match=f"step-1 gradient of {leaf}:"):
        check_gradients("olmo_1b", pairs)
    assert check_gradients("olmo_1b", {
        n: p for n, p in pairs.items() if n != leaf}) <= 1e-5
