"""Shared by the LM parity tests of the PyTorch port: the reference's
serving calls on one reduced configuration, compiled once per
architecture, and the port's same calls on the reference's weights.

bf16 products round differently under XLA's and PyTorch's CPU kernels
(one bf16 ulp in a few entries in ten thousand), so the models agree
within a stated tolerance, not bit for bit.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import Ctx, build as jbuild
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build, lm, whisper

# Each limit is a fraction of the reference leaf's RMS (rtol 0), and never
# above the reference's own decode-against-forward atol of 0.15
# (tests/test_smoke_archs.py). Measured worst |error| / RMS over the ten
# reduced models: hidden states (and Whisper's encoder states) 0.031;
# decode logits 0.034; forward logits 0.238 (jamba-v0.1-52b: 0.042 at
# one of its 32 positions, 0.021 and 0.012 at two more, the rest within
# 0.005); cache leaves 0.142 (gemma3-4b's decode cache, 0.0049 on an RMS
# of 0.037; the float32 Mamba states 0.04-0.14 of theirs).
FRAC = {"hidden": 0.1, "logits": 0.1, "forward": 0.6, "cache": 0.3}
ATOL_MAX = 0.15
B, S = 2, 16


def close(got, want, kind):
    """``got`` equals ``want`` within ``FRAC[kind]`` of want's RMS."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want * want)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=min(FRAC[kind] * rms, ATOL_MAX))


def to_numpy(tree):
    """A port pytree (dicts / lists of tensors) as float32 numpy leaves in
    ``jax.tree.leaves`` order."""
    return [t.float().numpy() for t in jax.tree.leaves(
        tree, is_leaf=lambda a: isinstance(a, torch.Tensor))]


def reference_case(arch, seed=3):
    """The reference's prefill, one decode step from ``init_cache`` at
    position S, and ``forward_hidden``'s logits (Whisper: ``encode``'s
    states) on a reduced config, with the inputs and parameters."""
    cfg = jreduced(jget_config(arch))
    api = jbuild(cfg)
    ctx = Ctx(None)
    params = jax.jit(api.init_params)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = np.asarray(jnp.asarray(
            rng.normal(size=(B, cfg.n_frames, cfg.d_model)), jnp.bfloat16))
    if cfg.family == "vlm":
        batch["patches"] = np.asarray(jnp.asarray(
            rng.normal(size=(B, cfg.n_patches, cfg.d_model)), jnp.bfloat16))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    h, cache = jax.jit(lambda p, b: api.prefill(p, b, ctx, S + 4))(params, jb)
    logits, new_cache = jax.jit(
        lambda p, c, t: api.decode_step(p, c, t, jnp.int32(S), ctx))(
        params, api.init_cache(B, S + 4), jb["tokens"][:, :1])
    out = {"params": params, "batch": batch,
           "h": np.asarray(h, np.float32),
           "cache": [np.asarray(a, np.float32)
                     for a in jax.tree.leaves(cache)],
           "logits": np.asarray(logits),
           "new_cache": [np.asarray(a, np.float32)
                         for a in jax.tree.leaves(new_cache)]}
    if cfg.family == "audio":
        fwd = jax.jit(lambda p, b: jwhisper.encode(p, b["frames"], cfg, ctx))
    else:
        fwd = jax.jit(lambda p, b: (jlm.forward_hidden(
            p, b["tokens"], cfg, ctx, patches=b.get("patches"),
            remat=False)[0] @ p["embed"].T).astype(jnp.float32))
    out["forward"] = np.asarray(fwd(params, jb), np.float32)
    return out


class PortCase:
    """The port's model on the reference's parameters and inputs."""

    def __init__(self, arch, ref):
        self.cfg = reduced(get_config(arch))
        self.api = build(self.cfg)
        self.params = lm_params_from_reference(ref["params"], device="cpu")
        self.batch = {k: torch.as_tensor(np.asarray(v, np.float32)
                                         if v.dtype.name == "bfloat16"
                                         else v)
                      for k, v in ref["batch"].items()}
        self.batch["tokens"] = self.batch["tokens"].long()
        # the limit ``forward`` is held to: Whisper's are encoder states
        self.forward_kind = ("hidden" if self.cfg.family == "audio"
                             else "forward")

    def prefill(self):
        return self.api.prefill(self.params, self.batch, S + 4)

    def decode(self):
        cache = self.api.init_cache(B, S + 4, device="cpu")
        return self.api.decode_step(self.params, cache,
                                    self.batch["tokens"][:, :1], S)

    def forward(self):
        """The LMs' forward logits; Whisper's encoder states."""
        if self.cfg.family == "audio":
            return whisper.encode(self.params, self.batch["frames"],
                                  self.cfg).float()
        hid, _ = lm.forward_hidden(self.params, self.batch["tokens"],
                                   self.cfg, patches=self.batch.get("patches"))
        return lm.logits_of(self.params, hid)
