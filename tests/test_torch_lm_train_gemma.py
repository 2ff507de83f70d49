"""PyTorch port, LM training on the CPU: gemma3-4b at ``reduced`` size (a
17-layer group of five local layers to one global) on the reference's
weights: ``train_loss`` and every gradient leaf against
``jax.value_and_grad(api.train_loss)`` on the float32 twin and in bf16,
and one ``make_train_step`` against the reference's, within the limits
of ``torch_train_helpers``. Its own file: the reference's gradients take
~35 s to compile here.
"""
import pytest

from torch_train_helpers import EPS_BAND, TrainCase, check_grads, check_step


@pytest.fixture(scope="module")
def case():
    return TrainCase.cached("gemma3-4b")


def test_loss_and_grads_float32_twin(case):
    check_grads(case, "f32")


def test_loss_and_grads_bf16(case):
    check_grads(case, "bf16")


def test_train_step_matches_reference(case):
    check_step(case, 1, eps_band=EPS_BAND)
