"""PyTorch port, LM training on the CPU: the Mamba, MLA + MoE and
encoder-decoder configurations falcon-mamba-7b, deepseek-v2-lite-16b and
whisper-medium at ``reduced`` size on the reference's weights:
``train_loss`` and every gradient leaf against
``jax.value_and_grad(api.train_loss)`` on the float32 twin, and in bf16
(Mamba and Whisper: every gradient leaf; MoE: the loss, with the smallest
router gap of the input recorded), and (falcon-mamba-7b,
deepseek-v2-lite-16b, whisper-medium) one ``make_train_step`` at
microbatch 1 and 2 against the reference's on the float32 twin, within
the limits of ``torch_train_helpers``. jamba-v0.1-52b and
deepseek-v2-236b are in ``test_torch_lm_train_moe.py``.
"""
import pytest

from torch_train_helpers import TrainCase, check_grads, check_step

ARCHS = ("falcon-mamba-7b", "deepseek-v2-lite-16b", "whisper-medium")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return TrainCase.cached(request.param)


def test_loss_and_grads_float32_twin(case):
    check_grads(case, "f32")


def test_loss_and_grads_bf16(case, record_property):
    check_grads(case, "bf16", record_property)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(case, microbatch):
    check_step(case, microbatch)
