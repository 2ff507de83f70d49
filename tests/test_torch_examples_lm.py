"""PyTorch port, the LM example twins on the CPU:
``examples/align_whisper_torch.py`` on the reference's weights
(``convert.lm_params_from_reference``) learns the same alignment support
and gives the same token-to-frame anchors as the reference example's own
functions (``cross_attention_costs``, ``core.dtw._dp_rows``,
``core.paths.backtrack``) on the same draws; ``examples/serve_lm_torch.py``
serves reduced yi-6b.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced
from repro.core.dtw import INF, _dp_rows
from repro.core.paths import backtrack
from repro.models import Ctx, build
from repro_torch.convert import lm_params_from_reference

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_alignment(ref, params, cfg):
    """The reference example's steps, through its own functions."""
    api, ctx = build(cfg), Ctx(None)
    rng = np.random.default_rng(0)
    S = 32

    def draw():
        frames = jnp.asarray(rng.normal(size=(1, cfg.n_frames, cfg.d_model)),
                             jnp.bfloat16)
        tokens = jnp.asarray(rng.integers(0, cfg.vocab, size=(1, S)))
        return np.asarray(ref.cross_attention_costs(api, cfg, params, frames,
                                                    tokens, ctx)[0])

    counts = np.zeros((S, cfg.n_frames), np.float32)
    for _ in range(6):
        c = draw()
        counts += np.asarray(backtrack(_dp_rows(jnp.asarray(c) - c.min()
                                                + 1e-3)), np.float32)
    support = counts >= 1.0
    c = draw()
    c = jnp.asarray(c - c.min() + 1e-3)
    D = _dp_rows(jnp.where(jnp.asarray(support), c, INF))
    path = np.asarray(backtrack(D))
    miss = not np.isfinite(float(D[-1, -1])) or float(D[-1, -1]) >= 1e29
    if miss:
        path = np.asarray(backtrack(_dp_rows(c)))
    return support, {t: int(np.argmax(path[t])) for t in range(0, S, 8)}, miss


def test_align_whisper_twin_equals_reference():
    ref, port = _load("align_whisper"), _load("align_whisper_torch")
    cfg = dataclasses.replace(reduced(get_config("whisper-medium")),
                              n_frames=port.N_FRAMES)
    params = build(cfg).init_params(jax.random.PRNGKey(0))
    support, anchors, miss = _reference_alignment(ref, params, cfg)
    got = port.main(["--device", "cpu"],
                    params=lm_params_from_reference(params, device="cpu"))
    assert np.array_equal(got["support"], support)
    assert got["fraction"] == float(support.mean())
    assert got["anchors"] == anchors and got["miss"] == miss


def test_serve_lm_twin_generates():
    out = _load("serve_lm_torch").main(
        ["--arch", "yi-6b", "--batch", "2", "--tokens", "4",
         "--device", "cpu"])
    assert out["generated"] == (2, 4)
