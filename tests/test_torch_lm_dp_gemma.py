"""PyTorch port, multi-rank LM training on the CPU: gemma3-4b at
``reduced`` size on the reference's weights, two gloo ranks. The synced
gradients against ``jax.value_and_grad(api.train_loss)`` on one device
(float32 twin within ``GRAD_FRAC_DP`` of each leaf's RMS, bf16 within the
one-rank parity limits of ``torch_train_helpers``) and one data-parallel
step against the reference's one-device ``make_train_step`` (entries
whose gradient lies within ``EPS_BAND`` of 0 held to 2 lr, as the
one-rank gemma3-4b step is). Its own file: gemma3-4b's reference
gradients take ~35 s to compile here.
"""
import pytest

from torch_dp_helpers import GRAD_FRAC_DP, check_dp_grads, check_dp_step, dp_run
from torch_train_helpers import EPS_BAND


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return dp_run("gemma3-4b", tmp_path_factory.mktemp("dp_gemma"), (1,))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dp_gradients(run, kind):
    check_dp_grads(run, kind, GRAD_FRAC_DP)


def test_dp_step_matches_reference(run):
    check_dp_step(run["out"][102], run["steps"][1], run, eps_band=EPS_BAND)
