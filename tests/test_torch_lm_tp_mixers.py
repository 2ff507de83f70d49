"""PyTorch port, tensor parallelism over the model axis on the CPU, the
mixers (``test_torch_lm_tp.py``'s checks): gemma3-4b (attention
replicated, five windowed layers of six), falcon-mamba-7b (d_inner
split, the B / C / dt products summed over the ranks), jamba-v0.1-52b
(Mamba, attention and MoE) and deepseek-v2-lite-16b (MLA, MoE with
shared experts), two gloo ranks at (1, 2) against the reference's
one-device gradients.
"""
import pytest

from torch_dp_helpers import check_tp_grads, tp_run

CASES = ("gemma3-4b", "falcon-mamba-7b", "jamba-v0.1-52b",
         "deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp_run(tmp_path_factory.mktemp("tp_mixers"), CASES)


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_tp_gradients_equal_reference(run, i, record_property):
    record_property("worst_frac", check_tp_grads(run, i))


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_bit_equal_across_model_ranks(run, case):
    assert run["replicated"][case]["differ"] == [], run["replicated"][case]
