"""PyTorch port, the LM serving loop on the CPU: stepwise decode against
the port's own forward pass (the windowed ring wraps at ``reduced``'s
window of 8), and ``launch.serve`` against the reference's ``serve`` on
the reference's weights: the same tokens at every step up to a row's
first near-tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.launch import serve as jserve
from repro.models import Ctx, build as jbuild
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import build, lm, whisper
from repro_torch.train.train_step import make_prefill, make_serve_step

# decode against forward: within DECODE_FRAC of the forward logits' RMS
# (0.017 here; the reference's own test allows atol 0.15 / rtol 0.1,
# tests/test_smoke_archs.py); measured worst 0.0 on both architectures
DECODE_FRAC = 0.1
# serve: the logits of each step, teacher-forced on the reference's
# tokens, agree within SERVE_ATOL (measured worst 0.0051, deepseek-v2-
# lite-16b; the logits' RMS is 0.18); a row's tokens are compared up to
# its first step whose top-2 gap in the reference's logits is within
# twice that (the smallest gap seen is 0.45)
SERVE_ATOL = 0.015
BATCH, PROMPT, GEN = 2, 5, 8


@pytest.mark.parametrize("arch", ["gemma3-12b", "falcon-mamba-7b"])
def test_decode_matches_forward_logits(arch):
    """The reference's ``test_decode_matches_prefill_logits`` on the port:
    16 teacher-forced decode steps from ``init_cache`` equal the forward
    pass's logits; gemma3's local layers keep a ring of 8 rows."""
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(2))
    B, S = 2, 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, S)))
    cache = api.init_cache(B, S, device="cpu")
    if arch.startswith("gemma"):
        assert cache[0]["k"].shape[2] == 8 and cache[5]["k"].shape[2] == S
    stepwise = []
    for t in range(S):
        with torch.inference_mode():
            lg, cache = api.decode_step(params, cache, toks[:, t:t + 1], t)
        stepwise.append(lg)
    stepwise = torch.stack(stepwise, dim=1)
    hid, _ = lm.forward_hidden(params, toks, cfg)
    full = lm.logits_of(params, hid)
    rms = float(full.pow(2).mean().sqrt())
    np.testing.assert_allclose(stepwise.numpy(), full.numpy(),
                               atol=DECODE_FRAC * rms, rtol=0)
    # the serve step is the greedy argmax of the same logits
    nxt, _ = make_serve_step(api)(params, api.init_cache(B, S, device="cpu"),
                                  toks[:, :1], 0)
    assert nxt.shape == (B, 1)
    assert nxt[:, 0].tolist() == stepwise[:, 0].argmax(-1).tolist()


def test_float32_twin_decode_matches_its_forward():
    """Activations follow the parameters' dtype: a float32 twin of the
    same weights decodes through the ring equal to its own forward pass
    within float32 rounding."""
    cfg = reduced(get_config("gemma3-12b"))
    params = lm.tree_map(lambda t: t.float(), lm.init_params(
        cfg, torch.Generator().manual_seed(6)))
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(6))
    cache = lm.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    assert lm.act_dtype(params) == torch.float32
    with torch.inference_mode():
        steps = torch.stack([lm.decode_step(params, cache, toks[:, t:t + 1],
                                            t, cfg)[0] for t in range(S)], 1)
        full = lm.logits_of(params, lm.forward_hidden(params, toks, cfg)[0])
    assert cache[0]["k"].dtype == torch.float32
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_greedy_step_takes_the_first_of_tied_logits(monkeypatch):
    cfg = reduced(get_config("yi-6b"))
    api = build(cfg)
    tied = torch.zeros(2, cfg.vocab)
    tied[:, [200, 7, 3]] = 1.0
    monkeypatch.setattr(lm, "decode_step",
                        lambda p, c, t, pos, cfg: (tied, c))
    nxt, _ = make_serve_step(api)(None, None, None, 0)
    assert nxt[:, 0].tolist() == [3, 3]


def _reference_trace(arch, seed):
    """The reference ``serve`` loop (``repro.launch.serve.serve``'s steps,
    without a mesh), keeping each step's logits."""
    cfg = jreduced(jget_config(arch))
    api = jbuild(cfg)
    ctx = Ctx(None)
    params = jax.jit(api.init_params)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(BATCH, PROMPT))
    step = jax.jit(lambda p, c, t, pos: api.decode_step(p, c, t, pos, ctx))
    cache = api.init_cache(BATCH, PROMPT + GEN)
    tok = jnp.asarray(tokens[:, :1], jnp.int32)
    inputs, logits, gen = [], [], []
    for pos in range(PROMPT + GEN - 1):
        inputs.append(np.asarray(tok))
        lg, cache = step(params, cache, tok, jnp.int32(pos))
        logits.append(np.asarray(lg))
        if pos + 1 < PROMPT:
            tok = jnp.asarray(tokens[:, pos + 1:pos + 2], jnp.int32)
        else:
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
            gen.append(np.asarray(tok[:, 0]))
    return params, tokens, inputs, np.stack(logits), np.stack(gen, axis=1)


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b",
                                  "deepseek-v2-lite-16b", "whisper-medium"])
def test_serve_matches_reference(arch, monkeypatch):
    seed = 0
    jparams, tokens, inputs, ref_logits, ref_gen = _reference_trace(arch,
                                                                    seed)
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = lm_params_from_reference(jparams, device="cpu")

    # every step's logits, teacher-forced on the reference's inputs
    cache = api.init_cache(BATCH, PROMPT + GEN, device="cpu")
    for pos, tok in enumerate(inputs):
        with torch.inference_mode():
            lg, cache = api.decode_step(params, cache,
                                        torch.as_tensor(np.array(tok)).long(),
                                        pos)
        np.testing.assert_allclose(lg.numpy(), ref_logits[pos],
                                   atol=SERVE_ATOL, rtol=0)

    # the port's loop, greedy on its own tokens: equal to the reference's
    # up to each row's first near-tie
    gen, seconds = serve.generate(api, params, tokens, GEN, "cpu")
    assert gen.shape == ref_gen.shape == (BATCH, GEN) and seconds > 0
    top2 = np.sort(ref_logits[PROMPT - 1:], axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 2 * SERVE_ATOL       # (GEN, B)
    compared = 0
    for b in range(BATCH):
        stop = int(np.argmax(near[:, b])) if near[:, b].any() else GEN
        np.testing.assert_array_equal(gen[b, :stop], ref_gen[b, :stop])
        compared += stop
    assert compared >= BATCH * GEN // 2, "too few steps compared"

    # serve() itself, with the reference's weights in place of the port's
    # own draw: the reference's dict
    module = whisper if cfg.family == "audio" else lm
    monkeypatch.setattr(module, "init_params", lambda cfg, gen: params)
    out = serve.serve(arch, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
                      seed=seed, device="cpu")
    want = jserve.serve(arch, batch=BATCH, prompt_len=PROMPT,
                        gen_tokens=GEN, seed=seed)
    assert set(out) == set(want) == {"generated", "tokens_per_s", "sample"}
    assert tuple(out["generated"]) == tuple(want["generated"])
    assert out["tokens_per_s"] > 0
    stop = int(np.argmax(near[:, 0])) if near[:, 0].any() else GEN
    assert want["sample"] == ref_gen[0, :8].tolist()
    assert out["sample"][:stop] == want["sample"][:stop]


def test_prefill_factory_and_serve_cli(capsys):
    cfg = reduced(get_config("pixtral-12b"))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(1))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 6)),
             "patches": torch.randn(2, cfg.n_patches, cfg.d_model)}
    h, cache = make_prefill(api, 12)(params, batch)
    assert h.shape == (2, cfg.d_model) and torch.isfinite(h.float()).all()
    assert cache[0]["k"].shape[2] == 6 + cfg.n_patches
    serve.main(["--arch", "gemma3-4b", "--batch", "1", "--prompt", "3",
                "--tokens", "2", "--device", "cpu"])
    line = capsys.readouterr().out
    assert "'generated': (1, 2)" in line and "tokens_per_s" in line


def test_serve_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve("yi-6b", batch=1, prompt_len=2, gen_tokens=1)
