"""PyTorch port, tensor parallelism over the model axis on the CPU: two
gloo ranks at (data, model) = (1, 2), float32 twins of the reference's
weights, against the reference's one-device gradients.

For each case the loss and every gradient (gathered whole from the
ranks' blocks) must be within ``GRAD_FRAC_TP`` of the reference leaf's
RMS; after one AdamW step every leaf the specs do not split over
"model" must be equal bit for bit on the two ranks. The dense, VLM,
MLA + MoE (at one data rank the local MoE path, its experts' ff split)
and audio configurations are here; ``test_torch_lm_tp_mixers.py`` holds
the windowed, Mamba and hybrid ones. yi-6b also runs with
``attn_shard="head_dim"`` (q, k and v split over head_dim, the scores
summed over the ranks before the softmax), a mode no published
configuration uses; its reference is yi-6b's, which computes alike on
one device whatever the mode.
"""
import pytest

from torch_dp_helpers import check_tp_grads, tp_run

CASES = ("yi-6b", "yi-6b:head_dim", "minicpm-2b", "gemma3-12b",
         "pixtral-12b", "deepseek-v2-236b", "whisper-medium")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp_run(tmp_path_factory.mktemp("tp"), CASES)


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_tp_gradients_equal_reference(run, i, record_property):
    record_property("worst_frac", check_tp_grads(run, i))


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_bit_equal_across_model_ranks(run, case):
    assert run["replicated"][case]["differ"] == [], run["replicated"][case]
