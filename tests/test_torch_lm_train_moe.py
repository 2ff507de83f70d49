"""PyTorch port, LM training on the CPU: the MoE configurations
jamba-v0.1-52b (one group of its attention / Mamba / MoE pattern) and
deepseek-v2-236b (MLA + MoE) at ``reduced`` size on the reference's
weights: ``train_loss`` and every gradient leaf against
``jax.value_and_grad(api.train_loss)`` on the float32 twin, and the bf16
loss with the smallest router gap of the input recorded, within the
limits of ``torch_train_helpers``. jamba's reference gradients take ~30 s
to compile here, so these two have a file of their own.
"""
import pytest

from torch_train_helpers import TrainCase, check_grads


@pytest.fixture(scope="module",
                params=("jamba-v0.1-52b", "deepseek-v2-236b"))
def case(request):
    return TrainCase.cached(request.param)


def test_loss_and_grads_float32_twin(case):
    check_grads(case, "f32")


def test_loss_and_grads_bf16(case, record_property):
    check_grads(case, "bf16", record_property)
