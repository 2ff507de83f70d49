"""PyTorch port, the Mamba, hybrid, MLA + MoE and audio models
(falcon-mamba-7b, jamba-v0.1-52b, deepseek-v2-lite-16b, deepseek-v2-236b,
whisper-medium) at ``reduced`` size against the JAX
reference on the CPU, on the reference's own bf16 weights
(``convert.lm_params_from_reference``): prefill's last hidden state and
every cache leaf, one decode step from ``init_cache`` (logits and cache),
and the forward pass (the LMs' logits, Whisper's encoder states),
each within the fraction of its RMS that ``torch_lm_helpers.FRAC``
states.
"""
import pytest

from torch_lm_helpers import PortCase, close, reference_case, to_numpy

ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "deepseek-v2-lite-16b",
         "deepseek-v2-236b", "whisper-medium")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    ref = reference_case(request.param)
    return ref, PortCase(request.param, ref)


def test_prefill_hidden_and_cache(case):
    ref, port = case
    h, cache = port.prefill()
    close(h.float(), ref["h"], "hidden")
    got = to_numpy(cache)
    assert [a.shape for a in got] == [a.shape for a in ref["cache"]]
    for g, w in zip(got, ref["cache"]):
        close(g, w, "cache")


def test_decode_step_from_init_cache(case):
    ref, port = case
    logits, cache = port.decode()
    close(logits, ref["logits"], "logits")
    for g, w in zip(to_numpy(cache), ref["new_cache"]):
        close(g, w, "cache")


def test_forward(case):
    ref, port = case
    close(port.forward(), ref["forward"], port.forward_kind)
