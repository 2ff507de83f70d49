"""Fault-tolerant LM / Whisper training driver (the port of
``repro.launch.train``).

Deterministic resumable data (batch = f(seed, step), ``TokenPipeline``),
async checkpoints with keep-last-k and integrity hashes, automatic resume
from the newest complete checkpoint (elastic: a checkpoint written at one
rank count restores at another), and a straggler watchdog (a step slower
than ``straggler_factor`` x the median so far is logged). The optimizer
is AdamW under a cosine schedule with ``max(steps // 10, 1)`` warm-up
steps.

The ranks are laid out as the reference's host mesh
(``launch.mesh.make_host_mesh(data_axis, model_axis)``); one process
without a launcher is the 1 x 1 layout. With ``data_axis`` D > 1 the job
runs as D ranks under ``python -m torch.distributed.run`` (``--backend
gloo|nccl``, ``launch.mesh.init_group``): every rank draws the global
batch of each step and computes on its rows, the step is data-parallel
(``train_step.make_train_step``, the gradients synced per microbatch), the
MoE layers run expert-parallel, and rank 0 alone logs and writes
checkpoints. With ``model_axis`` M > 1 the model is split over M ranks
(tensor parallelism: each rank holds its block of every leaf the specs
split over "model"), D x M ranks in all; a model axis that does not
split some leaf raises ``ValueError`` naming it. A checkpoint holds
whole leaves, so a run resumes at any D x M.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b  # the card
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc_per_node 2 -m -- repro_torch.launch.train --arch minicpm-2b \\
      --steps 4 --data-axis 2 --backend gloo --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc_per_node 2 -m -- repro_torch.launch.train --arch minicpm-2b \\
      --steps 4 --model-axis 2 --backend gloo --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import resolve_device
from repro_torch.launch import mesh
from repro_torch.models import build, lm, whisper
from repro_torch.train.checkpoint import (CheckpointManager,
                                          restore_checkpoint)
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def to_device(batch, device):
    """A ``TokenPipeline`` batch as tensors on ``device``: tokens int64,
    patches and frames float32."""
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                               else torch.float32, device=device)
            for k, v in batch.items()}


def _schema_leaves(schema, prefix=""):
    """(path, shape, spec) of every leaf of a parameter schema."""
    for k, v in schema.items():
        if isinstance(v, list):
            for i, g in enumerate(v):
                yield from _schema_leaves(g, f"{prefix}{k}[{i}].")
        else:
            yield f"{prefix}{k}", v[0], v[2]


def check_split(cfg, sizes) -> None:
    """Raise ``ValueError`` naming the first parameter leaf whose split
    dimension the ranks of ``sizes`` ({axis: ranks}) do not divide (and,
    with ``attn_shard="head_dim"``, a block of head_dim that cuts a RoPE
    pair)."""
    schema = (whisper.whisper_schema(cfg) if cfg.family == "audio"
              else lm.model_schema(cfg))
    for path, shape, spec in _schema_leaves(schema):
        for dim, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else entry or ()
            n = math.prod(sizes.get(a, 1) for a in names)
            if n > 1 and shape[dim] % n:
                raise ValueError(
                    f"leaf {path} of shape {tuple(shape)}: dimension {dim} "
                    f"does not split over the {n} ranks of {tuple(names)}")
    m = sizes.get("model", 1)
    if cfg.attn_shard == "head_dim" and m > 1 and (cfg.head_dim // m) % 2:
        raise ValueError(f"head_dim {cfg.head_dim} over {m} model ranks "
                         f"cuts a RoPE pair")


def train(arch: str, steps: int = 20, use_reduced: bool = True,
          ckpt_dir: str = DEFAULT_CKPT_DIR, batch: int = 8, seq: int = 64,
          ckpt_every: int = 5, microbatch: int = 1, data_axis: int = 1,
          model_axis: int = 1, seed: int = 0,
          straggler_factor: float = 3.0, lr: float = 1e-3,
          log_every: int = 1, device=None):
    """Train ``arch`` (``reduced`` by default) from seeded weights, or
    from the newest checkpoint in ``ckpt_dir``, up to step ``steps`` on
    ``device`` (the card unless the caller names another), over the
    group's ranks laid out ``data_axis`` x ``model_axis``. Returns the
    losses of the steps this call ran (the mean over the data ranks, the
    same on every rank)."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    check_split(cfg, {"data": data_axis, "model": model_axis})
    if mesh.world()[1] != data_axis * model_axis:
        raise ValueError(
            f"data_axis {data_axis} x model_axis {model_axis} needs as many "
            f"ranks; this process has a group of {mesh.world()[1]}: start "
            f"the ranks with python -m torch.distributed.run")
    layout = mesh.make_host_mesh(data_axis, model_axis)
    lead = layout.rank == 0
    device = resolve_device(device)
    api = build(cfg)
    opt = AdamW(lr=cosine_schedule(lr, max(steps // 10, 1), steps))
    step_fn = make_train_step(api, opt, microbatch=microbatch,
                              layout=layout)

    pspecs = api.param_pspecs()
    specs = {"params": pspecs, "opt": opt.state_pspecs(pspecs)}
    params = api.init_params(
        torch.Generator(device=device).manual_seed(seed), layout=layout)
    opt_state = opt.init(params)
    mgr = CheckpointManager(ckpt_dir, keep_last=3, layout=layout)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = restore_checkpoint(ckpt_dir, latest,
                                   {"params": params, "opt": opt_state},
                                   specs=specs, layout=layout)
        params, opt_state = state["params"], state["opt"]
        start = latest
        if lead:
            print(f"[resume] step {start} (elastic: mesh "
                  f"{data_axis}x{model_axis})", flush=True)

    pipe = TokenPipeline(cfg, batch, seq, seed=seed)
    losses, times = [], []
    for step in range(start, steps):
        # deterministic: resume-safe; each rank keeps its rows of it
        b = to_device(pipe.batch_at(step), device)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        times.append(dt)
        losses.append(loss)
        med = float(np.median(times))
        if lead and len(times) > 3 and dt > straggler_factor * med:
            print(f"[straggler] step {step}: {dt:.2f}s vs median "
                  f"{med:.2f}s — flagged for rebalance", flush=True)
        if lead and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f}ms", flush=True)
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            mgr.save(step + 1, {"params": params, "opt": opt_state}, specs)
    mgr.wait()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--backend", default="gloo", choices=mesh.BACKENDS,
                    help="collectives under the launcher (nccl: a card "
                         "per rank)")
    args = ap.parse_args(argv)
    device = args.device
    if mesh.launched():
        device = mesh.init_group(args.backend, device)
    try:
        losses = train(args.arch, args.steps, args.reduced, args.ckpt_dir,
                       args.batch, args.seq, ckpt_every=args.ckpt_every,
                       lr=args.lr, microbatch=args.microbatch,
                       data_axis=args.data_axis, model_axis=args.model_axis,
                       device=device)
        if mesh.world()[0] == 0:
            print(json.dumps({"first_loss": losses[0] if losses else None,
                              "last_loss": losses[-1] if losses else None,
                              "steps_run": len(losses),
                              "ranks": mesh.world()[1]}))
    finally:
        mesh.destroy_group()


if __name__ == "__main__":
    main()
