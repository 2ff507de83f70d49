"""Batched serving driver: a greedy decode loop over a KV cache (the port
of ``repro.launch.serve``).

The prompt is ingested step by step into a cache of prompt + generated
rows (teacher forcing), then each step feeds back its argmax. As in the
reference, ``serve`` decodes from ``init_cache`` and never runs the
encoder or the patch path: a Whisper model cross-attends to the all-zero
cross cache, a VLM sees text only. ``prefill`` drives those paths.

``prefill_generate`` is the serving path of a decoder LM: each prompt of
a batch of equal-length prompts is prefilled in one pass, its per-layer
pieces written into the decode cache, and decoding starts after it; on
the card the decode step is replayed from one captured CUDA graph.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import resolve_device
from repro_torch.models import build, lm
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


def _write_prefill(cache, pieces, rows: slice, P: int) -> None:
    """Write ``api.prefill``'s per-layer pieces of the prompts ``rows``
    (each P tokens) into the decode cache: sequence leaves at rows 0..P-1,
    a windowed layer's last w positions into its ring (position p at row
    p % w), a Mamba state as it is."""
    for c, pc in zip(cache, pieces):
        for k, v in pc.items():
            if k in ("h", "conv"):
                c[k][:, rows] = v
            elif v.shape[2] == P:
                c[k][:, rows, :P] = v
            else:
                c[k][:, rows] = torch.roll(v, P % v.shape[2], dims=2)


# a CUDA device's side stream for the decode step's warm-up and capture:
# one a device, since the card's libraries keep a workspace a stream
_SIDE = {}


def _decode_steps(api, params, cache, device):
    """``step(tok (B, 1), pos) -> logits (B, V)``: ``api.decode_step`` on
    ``cache``, eager off the card. On a CUDA device the first step runs
    eagerly on a side stream (the warm-up a capture needs), the second is
    captured there as one CUDA graph over static copies of the token and
    the position, with the recorder paused, and it and every later step
    replay the graph (span ``lm.decode``), the cache written in place:
    the host only copies the step's inputs in."""
    if device.type != "cuda":
        return lambda tok, pos: api.decode_step(params, cache, tok, pos)[0]
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    side = _SIDE[device]
    main = torch.cuda.current_stream(device)
    graph = {}

    def step(tok, pos):
        side.wait_stream(main)
        if not graph.get("warm"):
            with torch.cuda.stream(side):
                logits = api.decode_step(params, cache, tok, pos)[0]
            main.wait_stream(side)
            graph["warm"] = True
            return logits
        if "g" not in graph:
            g = torch.cuda.CUDAGraph()
            graph.update(g=g, tok=tok.clone(), pos=torch.full(
                (), pos, dtype=torch.long, device=device))
            with torch.cuda.stream(side), trace.paused():
                g.capture_begin()
                try:
                    graph["logits"] = api.decode_step(
                        params, cache, graph["tok"], graph["pos"])[0]
                finally:
                    g.capture_end()
            main.wait_stream(side)
        else:
            graph["tok"].copy_(tok)
            graph["pos"].fill_(pos)
        with trace.span("lm.decode"):
            graph["g"].replay()
        return graph["logits"]

    return step


# prompt tokens a prefill pass takes at most (whole prompts, one at least):
# the pass's float32 attention chunks grow with its tokens. On one H100,
# 64 DeepSeek-V2-Lite prompts of 2,048 tokens prefill in 6.33 s at 8 a
# pass (42 GB peak), 6.15 s at 16 (48 GB), 6.12 s at 32 (61 GB), and run
# out of memory at 64 (PERF.md section 6)
PREFILL_TOKENS = 1 << 15


def prefill_generate(api, params, tokens: torch.Tensor, gen_tokens: int, *,
                     on_logits=None) -> torch.Tensor:
    """Greedy continuation of the equal-length prompts ``tokens`` (B, P), a
    tensor on the parameters' device, by a decoder LM: the prompts
    prefilled in one pass each (as many a pass as ``PREFILL_TOKENS``
    holds), their pieces written into rows 0..P-1 of a cache of P +
    gen_tokens rows in the parameters' dtype, the first token the argmax
    of the head on the prefill's last hidden state, then ``gen_tokens -
    1`` decode steps
    from position P, each feeding back its argmax (the first index among
    equal logits; on the card from the second step on, replays of one
    captured graph, ``_decode_steps``). ``on_logits(i, logits, chosen)``,
    where given, sees the float32 logits (B, V) that chose generated
    token i, and the tokens (B,), on the device, before the next step
    overwrites them. Returns the generated tokens (B, gen_tokens) on the
    device; nothing waits for the device."""
    B, P = tokens.shape
    S_cache = P + gen_tokens
    rows = max(1, PREFILL_TOKENS // P)
    with torch.inference_mode():
        cache = lm.init_cache(api.cfg, B, S_cache, lm.act_dtype(params),
                              device=tokens.device)
        hs = []
        for b0 in range(0, B, rows):
            h, pieces = api.prefill(params, {"tokens": tokens[b0:b0 + rows]},
                                    S_cache)
            _write_prefill(cache, pieces, slice(b0, b0 + rows), P)
            hs.append(h)
        logits = lm.logits_of(params, torch.cat(hs))
        step = _decode_steps(api, params, cache, tokens.device)
        out = []
        for i in range(gen_tokens):
            if i:
                logits = step(tok, P + i - 1)
            chosen = torch.argmax(logits, dim=-1)
            if on_logits is not None:
                on_logits(i, logits, chosen)
            out.append(chosen)
            tok = chosen[:, None]
        return torch.stack(out, dim=1)


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
