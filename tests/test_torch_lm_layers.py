"""PyTorch port, the LM stack's building blocks against the JAX reference
on the CPU: the configs, ``rms_norm``, ``rope``, ``attention``, flash's
forward, the Mamba mixer and its decode, the MoE FFN (capacity overflow,
router ties) and ``convert.lm_params_from_reference``. The same numpy
inputs go through both; float32 unless a test says otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models.lm import init_params as jinit_lm
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import flash, layers, mamba, moe

# float32 limits of the layer functions (|got - want| <= ATOL + RTOL |want|;
# the measured worst errors are in CHANGES.md)
ATOL, RTOL = 2e-6, 2e-5
# Mamba: exp and the scan's products in another rounding order (XLA fuses
# the scan's multiply-adds under jit)
MAMBA_ATOL, MAMBA_RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    mine, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(configs.reduced(mine))
            == dataclasses.asdict(jconfigs.reduced(ref)))
    for m, r in ((mine, ref), (configs.reduced(mine), jconfigs.reduced(ref))):
        assert m.param_count() == r.param_count()
        assert m.active_param_count() == r.active_param_count()
        assert m.n_groups == r.n_groups and m.d_inner == r.d_inner


def test_rms_norm_scales_by_one_plus_scale():
    """bf16 (the models' dtype) equal bit for bit; float32 within its
    limit (XLA's rsqrt is not PyTorch's)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.3
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(scale, jnp.bfloat16)),
                      np.float32)
    got = layers.rms_norm(_t(x).to(torch.bfloat16),
                          _t(scale).to(torch.bfloat16)).float()
    np.testing.assert_array_equal(got.numpy(), want)
    _close(layers.rms_norm(_t(x), _t(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    # zero scales: the plain RMS normalisation
    got = layers.rms_norm(_t(x), torch.zeros(32))
    _close(got, x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6))


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(1)
    x, s, b = (rng.normal(size=sh).astype(np.float32)
               for sh in ((3, 7, 16), (16,), (16,)))
    _close(layers.layer_norm(_t(x), _t(s), _t(b)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b)))


def test_rope_is_interleaved_and_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)
    for theta in (10_000.0, 1e6):
        _close(layers.rope(_t(x), _t(pos), theta),
               jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # pairs are (2i, 2i + 1): a unit vector on lane 2i rotates within its
    # pair only
    e = torch.zeros(1, 1, 1, 16)
    e[..., 4] = 1.0
    out = layers.rope(e, torch.tensor([3]), 10_000.0)[0, 0, 0]
    ang = 3 * 10_000.0 ** (-2 / 8)
    assert torch.count_nonzero(out) == 2
    _close(out[4:6], [np.cos(ang), np.sin(ang)], atol=1e-6)
    # positions as a decode step gives them (one row at pos)
    _close(layers.rope(_t(x[:, :1]), torch.full((1,), 7), 1e4),
           jlayers.rope(jnp.asarray(x[:, :1]), jnp.full((1,), 7), 1e4))


def _qkv(rng, B, Sq, Skv, Hq, Hkv, hd, dv=None):
    dv = dv or hd
    return (rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, dv)).astype(np.float32))


ATTN_CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, hd, dv, kwargs)
    "causal_mha": (2, 16, 16, 2, 2, 8, None, dict(causal=True)),
    "causal_gqa": (2, 16, 16, 4, 2, 8, None, dict(causal=True)),
    "window": (1, 24, 24, 4, 1, 8, None, dict(causal=True, window=5)),
    "window_chunks": (2, 24, 24, 4, 2, 8, None,
                      dict(causal=True, window=7, kv_chunk=8)),
    "odd_skv_one_chunk": (2, 21, 21, 2, 1, 8, None,
                          dict(causal=True, kv_chunk=8)),
    "mla_dv": (2, 12, 12, 4, 4, 12, 8,
               dict(causal=True, scale=(8 + 4) ** -0.5)),
    "cross_bidirectional": (2, 5, 24, 4, 4, 8, None, dict(causal=False)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference(case):
    B, Sq, Skv, Hq, Hkv, hd, dv, kw = ATTN_CASES[case]
    q, k, v = _qkv(np.random.default_rng(3), B, Sq, Skv, Hq, Hkv, hd, dv)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    _close(layers.attention(_t(q), _t(k), _t(v), **kw), want)


def test_attention_decode_with_kv_len_matches_reference():
    """Decode: one query at an offset, a cache valid to kv_len per row."""
    q, k, v = _qkv(np.random.default_rng(4), 3, 1, 16, 4, 2, 8)
    kv_len = np.array([1, 7, 16], np.int32)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, kv_len=jnp.asarray(kv_len),
                             q_offset=9, window=None)
    got = layers.attention(_t(q), _t(k), _t(v), causal=False,
                           kv_len=_t(kv_len), q_offset=9, window=None)
    _close(got, want)
    # rows past kv_len carry no weight
    k2, v2 = k.copy(), v.copy()
    k2[0, 1:] = 1e3
    v2[0, 1:] = -1e3
    got2 = layers.attention(_t(q), _t(k2), _t(v2), causal=False,
                            kv_len=_t(kv_len), q_offset=9)
    _close(got2[0], got[0])


def test_attention_bf16_scales_q_in_its_dtype():
    """``q * scale`` rounds in bf16 before the float32 scores, as the
    reference does; the outputs agree within one bf16 ulp of their
    magnitude."""
    q, k, v = _qkv(np.random.default_rng(5), 2, 8, 8, 4, 2, 24)
    sc = 24 ** -0.5                      # not a power of two
    want = np.asarray(jlayers.attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    got = layers.attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, atol=2 ** -8, rtol=2 ** -7)
    qs = layers.scale_in(_t(q).to(torch.bfloat16), sc)
    np.testing.assert_array_equal(
        qs.float().numpy(),
        np.asarray(jnp.asarray(q, jnp.bfloat16) * sc, np.float32))


@pytest.mark.parametrize("window", [None, 6])
def test_flash_forward_matches_reference(window):
    q, k, v = _qkv(np.random.default_rng(6), 2, 24, 24, 4, 2, 8, 12)
    args = (True, window, 0, 8, 0.3)
    want_out, want_lse = jflash._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *args)
    out, lse = flash._flash_fwd_impl(_t(q), _t(k), _t(v), *args)
    _close(out, want_out)
    _close(lse, want_lse)
    _close(flash.flash_attention(_t(q), _t(k), _t(v), *args),
           jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), *args))
    # the forward equals the plain chunked attention
    _close(out, layers.attention(_t(q), _t(k), _t(v), causal=True,
                                 window=window, kv_chunk=8, scale=0.3))


def _mamba_params(rng, d=16, di=32, ds=8, dc=4):
    dtr = max(d // 16, 1)
    shapes = {"in_x": (d, di), "in_z": (d, di), "conv_w": (dc, di),
              "conv_b": (di,), "w_B": (di, ds), "w_C": (di, ds),
              "dt_down": (di, dtr), "dt_up": (dtr, di), "dt_bias": (di,),
              "A_log": (di, ds), "D": (di,), "out": (di, d)}
    return {k: (rng.normal(size=s) * (0.5 if k in ("A_log", "D", "dt_bias")
                                      else 0.3)).astype(np.float32)
            for k, s in shapes.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tp(p):
    return {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("S", [32, 13])
def test_mamba_mixer_matches_reference(S):
    """Chunks of 16 (S = 32) and one odd chunk (S = 13), from zero state
    and from a carried one."""
    rng = np.random.default_rng(7)
    p = _mamba_params(rng)
    x = rng.normal(size=(2, S, 16)).astype(np.float32)
    h0 = rng.normal(size=(2, 32, 8)).astype(np.float32)
    c0 = rng.normal(size=(2, 3, 32)).astype(np.float32)
    mix = jax.jit(lambda x, p, h0, c0: jmamba.mamba_mixer(
        x, p, d_state=8, h0=h0, conv0=c0, return_state=True))
    for state in (False, True):
        jh0, jc0 = (jnp.asarray(h0), jnp.asarray(c0)) if state else (None,
                                                                    None)
        want, (wh, wc) = mix(jnp.asarray(x), _j(p), jh0, jc0)
        got, (gh, gc) = mamba.mamba_mixer(
            _t(x), _tp(p), d_state=8, h0=_t(h0) if state else None,
            conv0=_t(c0) if state else None, return_state=True)
        _close(got, want, MAMBA_ATOL, MAMBA_RTOL)
        _close(gh, wh, MAMBA_ATOL, MAMBA_RTOL)
        _close(gc, wc)


def test_mamba_decode_steps_match_reference_and_the_mixer():
    rng = np.random.default_rng(8)
    p = _mamba_params(rng)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    step = jax.jit(lambda x, p, h, c: jmamba.mamba_decode_step(
        x, p, (h, c), d_state=8))
    jh, jc = jmamba.init_mamba_state(2, 32, 8, 4, jnp.float32)
    th, tc = mamba.init_mamba_state(2, 32, 8, 4, torch.float32)
    outs = []
    for t in range(6):
        want, (jh, jc) = step(jnp.asarray(x[:, t:t + 1]), _j(p), jh, jc)
        got, (th, tc) = mamba.mamba_decode_step(_t(x[:, t:t + 1]), _tp(p),
                                                (th, tc), d_state=8)
        _close(got, want, MAMBA_ATOL, MAMBA_RTOL)
        _close(th, jh, MAMBA_ATOL, MAMBA_RTOL)
        outs.append(got)
    full, (fh, _) = mamba.mamba_mixer(_t(x), _tp(p), d_state=8,
                                      return_state=True)
    _close(torch.cat(outs, 1), full, MAMBA_ATOL, MAMBA_RTOL)
    _close(th, fh, MAMBA_ATOL, MAMBA_RTOL)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 3.0, 25.0, 80.0])
    want = jax.nn.softplus(jnp.asarray(x.numpy()))
    _close(mamba.softplus(x), want, atol=0, rtol=1e-7)


def _moe_params(rng, d=16, E=4, ff=24):
    return {"router": (rng.normal(size=(d, E)) * 0.5).astype(np.float32),
            "gate": (rng.normal(size=(E, d, ff)) * 0.2).astype(np.float32),
            "up": (rng.normal(size=(E, d, ff)) * 0.2).astype(np.float32),
            "down": (rng.normal(size=(E, ff, d)) * 0.2).astype(np.float32)}


def _moe_both(x, p, E, k, cf):
    want, waux = jmoe.moe_ffn(jnp.asarray(x), _j(p), n_experts=E, top_k=k,
                              capacity_factor=cf, mesh=None, ep_axis=None)
    got, aux = moe.moe_ffn(_t(x), _tp(p), n_experts=E, top_k=k,
                           capacity_factor=cf)
    return got, aux, want, waux


def test_moe_ffn_with_capacity_overflow_matches_reference():
    rng = np.random.default_rng(9)
    p = _moe_params(rng)
    # a shared direction in every token and the router's column 0 along it
    # send most tokens to expert 0: past its capacity of 10 rows
    x = rng.normal(size=(3, 7, 16)).astype(np.float32) + 1.0
    p["router"][:, 0] = 2.0
    N, E, k, cf = 21, 4, 2, 1.0
    cap = moe.capacity(cf, k, N, E)
    assert cap == int(max(8, round(cf * k * N / E))) == 10
    ids, _, _ = moe._router(_t(x.reshape(N, 16)), _t(p["router"]), k)
    _, _, valid = moe._pack(_t(x.reshape(N, 16)), ids, E, cap)
    assert not bool(valid.all()), "the case must drop tokens"
    got, aux, want, waux = _moe_both(x, p, E, k, cf)
    _close(got, want)
    _close(aux, waux)


def test_moe_capacity_rounds_half_to_even():
    # 1.25 * 2 * 21 / 5 = 10.5 -> 10 (Python's round), 8 at least
    assert moe.capacity(1.25, 2, 21, 5) == 10
    assert moe.capacity(1.25, 2, 27, 5) == 14        # 13.5 -> 14
    assert moe.capacity(1.25, 2, 4, 5) == 8


def test_moe_router_ties_take_the_lower_expert_first():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(12, 16)).astype(np.float32)
    # all-equal probabilities, then pairs of equal columns (1 = 3, 0 = 5)
    zero = np.zeros((16, 6), np.float32)
    dup = (rng.normal(size=(16, 6)) * 0.5).astype(np.float32)
    dup[:, 3], dup[:, 5] = dup[:, 1], dup[:, 0]
    for w in (zero, dup):
        for k in (2, 3, 6):
            wi, ww, wa = jmoe._router(jnp.asarray(x), jnp.asarray(w), k)
            gi, gw, ga = moe._router(_t(x), _t(w), k)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            _close(gw, ww)
            _close(ga, wa)
    gi, _, _ = moe._router(_t(x), _t(zero), 3)
    assert (gi.numpy() == [0, 1, 2]).all()
    # the whole FFN with tied routes
    p = _moe_params(rng, E=6)
    p["router"] = dup
    got, aux, want, waux = _moe_both(x.reshape(2, 6, 16), p, 6, 2, 1.25)
    _close(got, want)


def test_lm_params_from_reference_bit_for_bit():
    """Every bf16 leaf of a reference parameter pytree comes across equal
    bit for bit, with its names and stacked layout."""
    cfg = jconfigs.reduced(jconfigs.get_config("jamba-v0.1-52b"))
    ref = jax.jit(lambda key: jinit_lm(cfg, key))(jax.random.PRNGKey(0))
    mine = lm_params_from_reference(ref, device="cpu")
    rl, treedef = jax.tree.flatten(ref)
    ml = jax.tree.leaves(mine, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert len(rl) == len(ml) and len(rl) > 20
    assert jax.tree.structure(
        jax.tree.map(lambda a: 0, mine,
                     is_leaf=lambda a: isinstance(a, torch.Tensor))) \
        == jax.tree.structure(jax.tree.map(lambda a: 0, ref))
    for r, m in zip(rl, ml):
        assert m.dtype == torch.bfloat16 and tuple(m.shape) == r.shape
        np.testing.assert_array_equal(
            m.view(torch.int16).numpy().view(np.uint16),
            np.asarray(r).view(np.uint16))
    # float32 leaves keep their dtype
    f = lm_params_from_reference({"a": [np.ones(3, np.float32)]},
                                 device="cpu")
    assert f["a"][0].dtype == torch.float32


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_associative_scan_combines_in_the_reference_order(n):
    """The in-chunk scan of the Mamba mixer is ``lax.associative_scan``'s
    recursion; with the reference's combine traced eagerly (no fused
    multiply-adds) the two agree bit for bit."""
    rng = np.random.default_rng(11)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.normal(size=(2, n, 3)).astype(np.float32)
    wa, wb = jax.lax.associative_scan(jmamba._ssm_combine,
                                      (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ga, gb = mamba.associative_scan(mamba._ssm_combine, (_t(a), _t(b)), 1)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    seq = np.zeros_like(b[:, 0])
    for t in range(n):
        seq = a[:, t] * seq + b[:, t]
    _close(gb[:, -1], seq)


def test_whisper_mlp_uses_the_tanh_gelu():
    from repro.models import whisper as jwhisper
    from repro_torch.models import whisper
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    p = {"norm2": np.zeros(16, np.float32),
         "w_up": (rng.normal(size=(16, 32)) * 0.5).astype(np.float32),
         "w_down": (rng.normal(size=(32, 16)) * 0.5).astype(np.float32)}
    want = jwhisper._mlp(jnp.asarray(x), _j(p))
    _close(whisper._mlp(_t(x), _tp(p)), want)
    exact = _t(x) + torch.nn.functional.gelu(
        layers.rms_norm(_t(x), torch.zeros(16)) @ _t(p["w_up"])) \
        @ _t(p["w_down"])
    assert np.abs(exact.numpy() - np.asarray(want)).max() > 1e-5


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "whisper-medium"])
def test_init_params_follow_the_schema(arch):
    """The port's own draw: the reference's names, shapes and bf16 dtype,
    zero-initialised norms / biases / A_log / D, std 0.02 elsewhere, the
    same values for the same seed."""
    from repro.models import build as jbuild
    from repro_torch.models import build
    cfg = configs.reduced(configs.get_config(arch))
    api = build(cfg)
    p1 = api.init_params(torch.Generator().manual_seed(5))
    p2 = api.init_params(torch.Generator().manual_seed(5))
    ref = jbuild(jconfigs.reduced(jconfigs.get_config(arch))
                 ).abstract_params()
    is_t = dict(is_leaf=lambda a: isinstance(a, torch.Tensor))
    paths = jax.tree_util.tree_flatten_with_path(p1, **is_t)[0]
    rpaths = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in paths] == [k for k, _ in rpaths]
    for (path, a), (_, r), b in zip(paths, rpaths,
                                    jax.tree.leaves(p2, **is_t)):
        assert tuple(a.shape) == r.shape and a.dtype == torch.bfloat16
        assert torch.equal(a, b)
        name = str(path[-1])
        if any(k in name for k in ("norm", "conv_b", "dt_bias", "A_log",
                                   "'D'")):
            assert not a.any(), path
        elif a.numel() > 1000:
            assert abs(float(a.float().std()) - 0.02) < 2e-3, path
