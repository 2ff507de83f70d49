"""PyTorch port, flash attention's backward against the JAX reference's
``repro.models.flash._flash_bwd`` on the CPU, in float32: GQA, MLA's
dv != hd, causal and sliding-window masks across several KV chunks,
non-causal; the autograd function's gradients equal its explicit
backward; a float64 ``torch.autograd.gradcheck`` on a tiny case.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jflash
from repro_torch.models import flash, layers

# float32: |got - want| <= ATOL + RTOL |want| (measured worst |error| over
# the cases against ``_flash_bwd``: dq 7.2e-7, dk 6.0e-7, dv 1.4e-6, on
# entries up to 2.3, 2.6 and 5.2)
ATOL, RTOL = 2e-6, 2e-5

# (B, Sq, Skv, Hq, Hkv, hd, dv, causal, window, kv_chunk, scale)
CASES = {
    "gqa-causal-3-chunks": (2, 24, 24, 4, 2, 8, 8, True, None, 8, None),
    "gqa-window-multi-chunk": (2, 32, 32, 4, 2, 8, 8, True, 6, 8, 0.3),
    "mla-dv-ne-hd": (2, 16, 16, 4, 4, 12, 8, True, None, 8, 12 ** -0.5),
    "mha-noncausal-cross": (1, 12, 20, 2, 2, 8, 8, False, None, 4, None),
    "gqa-one-chunk": (1, 10, 10, 6, 3, 4, 4, True, 3, 1024, None),
}


def _inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, hd, dv = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dv)).astype(np.float32),
            rng.normal(size=(B, Sq, Hq, dv)).astype(np.float32))


def _args(case):
    """(causal, window, q_offset, kv_chunk, scale), as both packages'
    ``_flash_fwd_impl`` / ``_flash_bwd`` take them."""
    causal, window, ck, scale = case[7:]
    return causal, window, 0, ck, scale


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_reference(name):
    case = CASES[name]
    q, k, v, dout = _inputs(case)
    args = _args(case)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jout, jlse = jflash._flash_fwd_impl(jq, jk, jv, *args)
    want = jflash._flash_bwd(*args, (jq, jk, jv, jout, jlse),
                             jnp.asarray(dout))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    out, lse = flash._flash_fwd_impl(tq, tk, tv, *args)
    got = flash._flash_bwd(*args, (tq, tk, tv, out, lse),
                           torch.as_tensor(dout))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    # autograd through flash_attention gives the explicit backward
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = flash.flash_attention(*leaves, *args)
    auto = torch.autograd.grad(o, leaves, torch.as_tensor(dout))
    for a, g in zip(auto, got):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["gqa-window-multi-chunk", "mla-dv-ne-hd"])
def test_backward_matches_plain_attention_autograd(name):
    """The hand-written backward equals autograd through the plain
    chunked attention (which keeps every chunk's probabilities)."""
    case = CASES[name]
    q, k, v, dout = _inputs(case, seed=1)
    causal, window, q_offset, ck, scale = _args(case)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    o = layers.attention(*leaves, causal=causal, window=window,
                         q_offset=q_offset, kv_chunk=ck, scale=scale)
    want = torch.autograd.grad(o, leaves, torch.as_tensor(dout))
    leaves2 = [t.detach().clone().requires_grad_(True) for t in leaves]
    o2 = flash.flash_attention(*leaves2, causal, window, q_offset, ck, scale)
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    got = torch.autograd.grad(o2, leaves2, torch.as_tensor(dout))
    for g, w in zip(got, want):
        _close(g, w)


def test_gradcheck_float64():
    """Finite differences in float64 on a tiny windowed GQA case of two
    KV chunks."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float64
                               ).requires_grad_(True)
               for s in ((1, 6, 4, 3), (1, 6, 2, 3), (1, 6, 2, 5)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash.flash_attention(a, b, c, True, 4, 0, 3, None),
        (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_bf16_backward_dtypes():
    """bf16 inputs give bf16 gradients, float32 sums inside."""
    q, k, v, dout = _inputs(CASES["gqa-window-multi-chunk"], seed=3)
    leaves = [torch.as_tensor(a).to(torch.bfloat16).requires_grad_(True)
              for a in (q, k, v)]
    o = flash.flash_attention(*leaves, True, 6, 0, 8, 0.3)
    grads = torch.autograd.grad(o, leaves,
                                torch.as_tensor(dout).to(torch.bfloat16))
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(
        g.float()).all()) for g in grads)
