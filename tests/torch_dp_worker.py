"""One rank of the multi-rank LM training tests (``torch_dp_helpers``
starts it as two gloo ranks on the CPU, or alone as the one-rank side).

  python tests/torch_dp_worker.py layout OUT
  python tests/torch_dp_worker.py dp ARCH WEIGHTS OUT
  python tests/torch_dp_worker.py ep WEIGHTS OUT ARCH:CF ...
  python tests/torch_dp_worker.py ckpt OUT

WEIGHTS is a checkpoint directory holding {"params": ...} at step 0 (the
float32 twin) and, for ``dp``, at step 1 (bf16). Results are checkpoints
under OUT, written by rank 0 with every split leaf gathered whole
(``save_checkpoint(..., specs, layout)``), so the tests read them with
numpy. The batch is ``TokenPipeline(cfg, 4, 16, seed=1).batch_at(0)``, as
``tests/torch_train_helpers.py`` draws it.
"""
import dataclasses
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh
from repro_torch.models import build
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.train_step import (int8_all_reduce, leaf_specs,
                                          make_train_step, value_and_grad)

B, S = 4, 16
LR = (1e-3, 1, 4)        # cosine_schedule(base, warmup, total)
LAYOUTS = (((2, 1), ("data", "model")), ((1, 2), ("data", "model")),
           ((2, 1, 1), ("pod", "data", "model")))


def batch_of(cfg):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                               else torch.float32)
            for k, v in TokenPipeline(cfg, B, S, seed=1).batch_at(0).items()}


def params_from(api, directory, step, layout, dtype):
    like = tree_map(lambda t: t.to(dtype), api.init_params(
        torch.Generator().manual_seed(0), layout=layout))
    return restore_checkpoint(directory, step, {"params": like},
                              specs={"params": api.param_pspecs()},
                              layout=layout)["params"]


def same_on_every_rank(tree, specs, layout, what):
    """Every leaf that no rank splits is equal bit for bit on every
    rank."""
    for i, (t, spec) in enumerate(zip(tree_leaves(tree), specs)):
        if mesh.sharded_dims(spec, layout):
            continue
        parts = mesh.all_gather_dim(t[None], layout.group("data"), 0)
        if not all(torch.equal(parts[0], p) for p in parts):
            raise AssertionError(f"{what}: leaf {i} differs across ranks")


def job_layout(out):
    rank, size = mesh.world()
    rows = []
    for shape, axes in LAYOUTS:
        lay = mesh.Layout(shape, axes)
        sets = {}
        for n in range(1, len(axes) + 1):
            for names in itertools.combinations(axes, n):
                t = torch.tensor([float(rank)])
                mesh.all_reduce_(t, lay.group(names))
                sets[",".join(names)] = {
                    "members": list(lay.members(names)),
                    "size": lay.size(names), "index": lay.index(names),
                    "sum": float(t[0])}
        rows.append({"shape": list(shape), "axes": list(axes),
                     "coords": list(lay.coords), "sets": sets})
    Path(out).mkdir(parents=True, exist_ok=True)
    (Path(out) / f"layout_r{rank}.json").write_text(json.dumps(rows))


def job_dp(arch, weights, out):
    rank, size = mesh.world()
    layout = mesh.make_host_mesh(size, 1)
    cfg = reduced(get_config(arch))
    api = build(cfg)
    pspecs = api.param_pspecs()
    batch = batch_of(cfg)
    gspecs = {"grads": pspecs, "loss": ()}

    def save(step, tree, specs):
        save_checkpoint(out, step, tree, specs=specs, layout=layout)

    for step, wstep, dtype in ((100, 1, torch.bfloat16),
                               (101, 0, torch.float32)):
        params = params_from(api, weights, wstep, layout, dtype)
        loss, g = make_train_step(api, AdamW(), layout=layout).grads(
            params, batch)
        save(step, {"grads": g, "loss": loss}, gspecs)
    pspec_out = {"params": pspecs, "loss": (), "gnorm": ()}
    for step, kw in ((102, {}),
                     (111, dict(grad_sync="deferred", microbatch=1)),
                     (112, dict(grad_sync="deferred", microbatch=2))):
        params = params_from(api, weights, 0, layout, torch.float32)
        opt = AdamW(lr=cosine_schedule(*LR))
        fn = make_train_step(api, opt, layout=layout, **kw)
        new, _, met = fn(params, opt.init(params), batch)
        same_on_every_rank(new, leaf_specs(new, pspecs), layout, arch)
        save(step, {"params": new, "loss": met["loss"],
                    "gnorm": met["grad_norm"]}, pspec_out)
    # deferred + int8 against the uncompressed deferred sync, and the
    # largest |local sum| over the ranks of each leaf (the scale's source)
    params = params_from(api, weights, 0, layout, torch.float32)
    for step, comp in ((120, "int8"), (121, None)):
        loss, g = make_train_step(
            api, AdamW(), layout=layout, grad_sync="deferred",
            grad_compression=comp).grads(params, batch)
        save(step, {"grads": g, "loss": loss}, gspecs)
    from repro_torch.models.lm import Ctx
    ctx = Ctx(layout)
    _, local = value_and_grad(api, params, ctx.rows(batch), ctx)
    amax = tree_map(lambda t: mesh.all_reduce_(
        t.abs().max().reshape(1), layout.group("data"), "max")[0], local)
    save(122, {"grads": amax}, {"grads": tree_map(lambda _: (), amax)})
    # a (pod, data, model) = (2, 1, 1) layout: the plain step, and int8_pod
    pods = mesh.Layout((size, 1, 1), ("pod", "data", "model"))
    for step, comp in ((140, "int8_pod"), (141, None)):
        loss, g = make_train_step(api, AdamW(), layout=pods,
                                  grad_compression=comp).grads(params, batch)
        save_checkpoint(out, step, {"grads": g, "loss": loss}, specs=gspecs,
                        layout=pods)
    # int8_all_reduce of N(0, 1) leaves, rank r drawing from seed r
    rng = np.random.default_rng(rank)
    tree = {"a": torch.as_tensor(rng.normal(size=(64,)).astype(np.float32)),
            "b": torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32))}
    got = int8_all_reduce(tree, layout.group("data"))
    save(130, {"in": tree, "out": got},
         {"in": {"a": ("data",), "b": ("data", None)},
          "out": {"a": (), "b": ()}})


def job_ep(weights, out, *cases):
    """Each case ``ARCH:CF`` (CF a capacity factor or "default"): the
    synced float32 gradients on ``WEIGHTS/ARCH`` at step ``200 + 10 i +
    ranks`` of OUT, case i."""
    rank, size = mesh.world()
    layout = mesh.make_host_mesh(size, 1)
    for i, case in enumerate(cases):
        arch, cf = case.split(":")
        cfg = reduced(get_config(arch))
        if cf != "default":
            cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
        api = build(cfg)
        params = params_from(api, str(Path(weights) / arch), 0, layout,
                             torch.float32)
        loss, g = make_train_step(api, AdamW(), layout=layout).grads(
            params, batch_of(cfg))
        save_checkpoint(out, 200 + 10 * i + size, {"grads": g, "loss": loss},
                        specs={"grads": api.param_pspecs(), "loss": ()},
                        layout=layout)


def job_ckpt(out):
    """deepseek-v2-lite-16b reduced, seeded (the port's draws, each rank
    its blocks), one step: its blocks written to
    ``OUT/held_r<rank>.npz``, then saved at step 5 under the layout; then the
    checkpoint ``OUT/one`` (written at one rank) restored here, each
    rank's blocks written to ``OUT/blocks_r<rank>.npz``."""
    rank, size = mesh.world()
    layout = mesh.make_host_mesh(size, 1)
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    api = build(cfg)
    pspecs = api.param_pspecs()
    opt = AdamW(lr=cosine_schedule(*LR))
    specs = {"params": pspecs, "opt": opt.state_pspecs(pspecs)}
    params = api.init_params(torch.Generator().manual_seed(0), layout=layout)
    state = opt.init(params)
    params, state, _ = make_train_step(api, opt, layout=layout)(
        params, state, batch_of(cfg))
    held = tree_leaves(params) + tree_leaves(state.m)
    np.savez(Path(out) / f"held_r{rank}.npz",
             **{f"l{i}": t.float().numpy() for i, t in enumerate(held)})
    save_checkpoint(str(Path(out) / "two"), 5,
                    {"params": params, "opt": state}, specs=specs,
                    layout=layout)
    back = restore_checkpoint(str(Path(out) / "one"), 5,
                              {"params": params, "opt": state}, specs=specs,
                              layout=layout)
    flat = tree_leaves(back["params"]) + tree_leaves(back["opt"].m)
    np.savez(Path(out) / f"blocks_r{rank}.npz",
             **{f"l{i}": t.float().numpy() for i, t in enumerate(flat)})


def main():
    if mesh.launched():
        mesh.init_group("gloo", "cpu")
    torch.set_num_threads(1)
    job, *args = sys.argv[1:]
    {"layout": job_layout, "dp": job_dp, "ep": job_ep,
     "ckpt": job_ckpt}[job](*args)
    mesh.destroy_group()


if __name__ == "__main__":
    main()
