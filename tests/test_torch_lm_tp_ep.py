"""PyTorch port, expert parallelism and tensor parallelism at once on the
CPU: deepseek-v2-lite-16b and jamba-v0.1-52b reduced on four gloo ranks
at (data, model) = (2, 2), float32 twins of the reference's weights,
against the reference on a forced (2, 2) mesh (four host devices). Each
data rank routes its own tokens (the capacity from its own rows) and
holds half the experts, each model rank half of every expert's ff, so
the one-device reference differs by whole expert rows here; the forced
mesh computes the same shards. jamba-v0.1-52b's ranks also decode one
row at batch 1, the cache's Mamba state split over ("data", "model"),
wider than the weights' "model" split, against the same decode at one
rank (``B1_DECODE_FRAC`` of the logits' RMS, float32).
"""
import pytest

from torch_dp_helpers import check_tp_grads, tp_run

CASES = ("deepseek-v2-lite-16b", "jamba-v0.1-52b")
# float32 sums over the model ranks in another order
B1_DECODE_FRAC = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp_run(tmp_path_factory.mktemp("tp_ep"), CASES, shape="2,2",
                  forced=True)


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_tp_ep_gradients_equal_reference_mesh(run, i, record_property):
    record_property("worst_frac", check_tp_grads(run, i))


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_bit_equal_across_model_ranks(run, case):
    assert run["replicated"][case]["differ"] == [], run["replicated"][case]


def test_batch1_decode_with_the_state_over_data_and_model(run):
    assert run["replicated"]["jamba-v0.1-52b"]["b1_decode"] <= \
        B1_DECODE_FRAC
