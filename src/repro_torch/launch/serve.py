"""Batched serving driver: a greedy decode loop over a KV cache (the port
of ``repro.launch.serve``).

The prompt is ingested step by step into a cache of prompt + generated
rows (teacher forcing), then each step feeds back its argmax. As in the
reference, ``serve`` decodes from ``init_cache`` and never runs the
encoder or the patch path: a Whisper model cross-attends to the all-zero
cross cache, a VLM sees text only. ``prefill`` drives those paths.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import resolve_device
from repro_torch.models import build
from repro_torch.train.train_step import make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(api, params, tokens, gen_tokens: int, device, on_step=None):
    """Greedy continuation of ``tokens`` (B, prompt_len): the prompt fed
    step by step, then ``gen_tokens`` argmax steps. ``on_step(pos,
    cache)``, where given, is called after each step is enqueued (a
    timing and inspection hook). Returns (generated (B, gen_tokens)
    numpy, seconds of the loop, the card synchronised)."""
    device = torch.device(device)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                           device=device)
    B, prompt_len = toks.shape
    S_cache = prompt_len + gen_tokens
    step_fn = make_serve_step(api)
    cache = api.init_cache(B, S_cache, device=device)
    tok = toks[:, :1]
    out = []
    _sync(device)
    t0 = time.perf_counter()
    for pos in range(S_cache - 1):
        if pos + 1 < prompt_len:
            _, cache = step_fn(params, cache, tok, pos)
            tok = toks[:, pos + 1:pos + 2]              # teacher forcing
        else:
            tok, cache = step_fn(params, cache, tok, pos)
            out.append(tok[:, 0])
        if on_step is not None:
            on_step(pos, cache)
    _sync(device)
    dt = time.perf_counter() - t0
    return torch.stack(out, dim=1).cpu().numpy(), dt


def serve(arch: str, batch: int = 4, prompt_len: int = 16,
          gen_tokens: int = 16, use_reduced: bool = True, seed: int = 0,
          device=None):
    """Serve ``batch`` random prompts of ``arch`` (seeded weights and
    tokens) on ``device`` (the card unless the caller names another).
    Returns {"generated": shape, "tokens_per_s", "sample": row 0's first
    8 tokens}."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    api = build(cfg)
    params = api.init_params(torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, prompt_len))
    gen, dt = generate(api, params, tokens, gen_tokens, device)
    tps = batch * gen.shape[1] / dt
    return {"generated": gen.shape, "tokens_per_s": round(tps, 1),
            "sample": gen[0, :8].tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    print(serve(args.arch, args.batch, args.prompt, args.tokens,
                device=args.device))


if __name__ == "__main__":
    main()
