"""The paper inside the LM stack, on the PyTorch port: SP-DTW-accelerated
Whisper timestamp alignment (the twin of ``examples/align_whisper.py`` on
``repro_torch``).

Whisper's word-level timestamps come from a DTW over the decoder's
cross-attention costs (token axis against audio-frame axis). Across
utterances the alignment paths stay near the diagonal, like the paper's
occupancy grids, so the learned sparsification applies directly: learn
the occupancy grid from a few aligned utterances, then run the DP on that
support alone for every later utterance.

  PYTHONPATH=src python examples/align_whisper_torch.py          # the card
  PYTHONPATH=src python examples/align_whisper_torch.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.dtw import INF, _dp_rows
from repro_torch.core.engine import resolve_device
from repro_torch.core.paths import backtrack
from repro_torch.models import build
from repro_torch.models.layers import rms_norm
from repro_torch.models.whisper import encode

# token and frame axes of one utterance (a square grid, so the utterances
# share one support)
N_FRAMES = S = 32
N_TRAIN = 6


def cross_attention_costs(cfg, params, frames, tokens):
    """-(attention mass) between decoder tokens and audio frames, summed
    over the heads of the last decoder layer (the Whisper recipe): (B, S,
    n_frames) float32."""
    enc = encode(params, frames, cfg)
    x = params["embed"][tokens].to(torch.bfloat16)
    gp = {k: v[-1] for k, v in params["groups"][0].items()}  # last layer
    xn = rms_norm(x, gp["x_norm"])
    q = torch.einsum("bsd,dhk->bshk", xn, gp["x_wq"])
    k = torch.einsum("bsd,dhk->bshk", enc, gp["x_wk"])
    # bf16 scores divided in float32 (the reference's numpy-scalar
    # divisor promotes them)
    s = torch.einsum("bshk,bthk->bst", q, k).float() / np.sqrt(q.shape[-1])
    return -torch.softmax(s, dim=-1)


def utterance(rng, cfg, device):
    """One utterance's stubbed frames (bf16) and tokens, drawn from
    ``rng`` as the reference example draws them."""
    frames = torch.from_numpy(rng.normal(size=(1, cfg.n_frames,
                                               cfg.d_model))).to(
        torch.bfloat16).to(device)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, S))).to(
        device)
    return frames, tokens


def shifted(c: torch.Tensor) -> torch.Tensor:
    """The cost grid moved to positive values (min + 1e-3)."""
    return c - c.min() + 1e-3


def align(cfg, params, device, seed: int = 0) -> dict:
    """Learn the support from ``N_TRAIN`` utterances, then align one new
    utterance on it. Returns the support (bool (S, n_frames)), its
    fraction of the grid, the token -> frame anchors of every 8th token,
    whether the support missed the new utterance, and the path."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        counts = torch.zeros((S, cfg.n_frames), dtype=torch.float32,
                             device=device)
        for _ in range(N_TRAIN):
            c = cross_attention_costs(cfg, params, *utterance(rng, cfg,
                                                              device))[0]
            # path through the cost grid (the DTW DP on cost c)
            counts += backtrack(_dp_rows(shifted(c))).float()
        # cells visited at least once form the support
        support = counts >= 1.0
        c = shifted(cross_attention_costs(cfg, params,
                                          *utterance(rng, cfg, device))[0])
        D_sparse = _dp_rows(torch.where(support, c,
                                        torch.full_like(c, INF)))
        path = backtrack(D_sparse)
        end = float(D_sparse[-1, -1])
        # the example's own rule: a new utterance whose path leaves the
        # learned support is aligned on the full grid instead
        miss = not np.isfinite(end) or end >= 1e29
        if miss:
            path = backtrack(_dp_rows(c))
    path = path.cpu().numpy()
    return {"support": support.cpu().numpy(),
            "fraction": float(support.float().mean()),
            "anchors": {t: int(np.argmax(path[t])) for t in range(0, S, 8)},
            "miss": miss, "path": path}


def main(argv=None, params=None):
    """Run the example; ``params`` (a Whisper parameter pytree on the
    device) replaces the seeded weights. Returns ``align``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(reduced(get_config("whisper-medium")),
                              n_frames=N_FRAMES)
    if params is None:
        params = build(cfg).init_params(
            torch.Generator(device=device).manual_seed(0))
    out = align(cfg, params, device)
    frac = out["fraction"]
    print(f"learned alignment support: {100 * frac:.1f}% of the grid")
    if out["miss"]:
        print("support miss -> full DP")
    print(f"token -> frame anchors: {out['anchors']}")
    print(f"DP cells evaluated: {int(out['support'].sum())} sparse vs "
          f"{S * cfg.n_frames} full ({100 * (1 - frac):.1f}% saved per "
          f"utterance)")
    return out


if __name__ == "__main__":
    main()
