"""One rank of the multi-rank LM training tests (``torch_dp_helpers``
starts it as two gloo ranks on the CPU, or alone as the one-rank side).

  python tests/torch_dp_worker.py layout OUT
  python tests/torch_dp_worker.py dp ARCH WEIGHTS OUT
  python tests/torch_dp_worker.py ep WEIGHTS OUT ARCH:CF ...
  python tests/torch_dp_worker.py ckpt OUT
  python tests/torch_dp_worker.py tp D,M WEIGHTS OUT BASE CASE ...
  python tests/torch_dp_worker.py tp_step D,M WEIGHTS OUT ARCH
  python tests/torch_dp_worker.py tp_ckpt D,M OUT
  python tests/torch_dp_worker.py tp_restore D,M ROOT SAVED OUT
  python tests/torch_dp_worker.py decode WEIGHTS OUT ARCH ...

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
                                          make_train_step, value_and_grad,
                                          zero_blocks)

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
    # ZeRO-2 (accum_pspecs: reduce-scattered float32 accumulators, the
    # optimizer state split over "data") against the same step without
    with torch.device("meta"):
        shapes = api.abstract_params()
    for step, zero in ((150, False), (151, True)):
        params = params_from(api, weights, 0, layout, torch.float32)
        opt = AdamW(lr=cosine_schedule(*LR))
        acc = opt.state_pspecs(pspecs, zero1=True, shapes=shapes,
                               data_size=size).m if zero else None
        fn = make_train_step(api, opt, layout=layout, microbatch=2,
                             accum_pspecs=acc)
        state = opt.init(zero_blocks(params, pspecs, acc, layout)
                         if zero else params)
        new, _, met = fn(params, state, batch)
        save(step, {"params": new, "loss": met["loss"],
                    "gnorm": met["grad_norm"]}, pspec_out)
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


# --------------------------------------------- tensor parallelism (model)
def tp_layout(shape):
    d, m = (int(x) for x in shape.split(","))
    return mesh.make_host_mesh(d, m)


def tp_config(case):
    """A case ``ARCH`` or ``ARCH:head_dim`` (yi-6b's attention split over
    head_dim, no published config's mode): the reduced config."""
    arch, _, mode = case.partition(":")
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, attn_shard=mode) if mode else cfg


def replicated_equal(tree, specs, layout, axis="model"):
    """Indices of the leaves not split over ``axis`` that differ bit for
    bit between the ranks along it."""
    group = layout.group(axis)
    bad = []
    for i, (t, spec) in enumerate(zip(tree_leaves(tree), specs)):
        if any(axis in names for _, names in mesh.sharded_dims(spec,
                                                              layout)):
            continue
        parts = mesh.all_gather_dim(t.contiguous()[None], group, 0)
        if not all(torch.equal(parts[0], q) for q in parts):
            bad.append(i)
    return bad


def job_tp(shape, weights, out, base, *cases):
    """Each case i on the layout ``D,M``: the float32 twin's loss and
    synced gradients (gathered whole) at step ``BASE + i`` of OUT, then
    one AdamW step, whose leaves replicated over "model" must stay equal
    bit for bit on the model ranks (``OUT/replicated.json``)."""
    layout = tp_layout(shape)
    flags = {}
    for i, case in enumerate(cases):
        cfg = tp_config(case)
        api = build(cfg)
        pspecs = api.param_pspecs()
        params = params_from(api, str(Path(weights) / case.split(":")[0]),
                             0, layout, torch.float32)
        step = make_train_step(api, AdamW(lr=cosine_schedule(*LR)),
                               layout=layout)
        loss, g = step.grads(params, batch_of(cfg))
        save_checkpoint(out, int(base) + i, {"grads": g, "loss": loss},
                        specs={"grads": pspecs, "loss": ()}, layout=layout)
        opt = AdamW(lr=cosine_schedule(*LR))
        new, _, met = make_train_step(api, opt, layout=layout)(
            params, opt.init(params), batch_of(cfg))
        flags[case] = {"differ": replicated_equal(
            new, leaf_specs(new, pspecs), layout),
            "loss": float(met["loss"])}
        if layout.size("data") > 1 and any(s.mixer == "mamba"
                                           for s in cfg.pattern):
            flags[case]["b1_decode"] = batch1_decode(
                api, str(Path(weights) / case.split(":")[0]), layout)
    if mesh.world()[0] == 0:
        (Path(out) / f"replicated_{base}.json").write_text(json.dumps(flags))


def batch1_decode(api, weights, layout, steps=6):
    """A batch-1 decode of ``steps`` tokens of the decode prompt's first
    row on ``layout``, whose cache splits the Mamba state's d_inner over
    ("data", "model") wider than the weights' "model" split, against the
    same decode at one rank in this process: the worst |logits - one
    rank's| over the steps, a fraction of the one-rank logits' RMS."""
    from repro_torch.models.lm import Ctx, init_cache
    whole = params_from(api, weights, 0, None, torch.float32)
    params = params_from(api, weights, 0, layout, torch.float32)
    prompt = torch.as_tensor(decode_prompt(api.cfg))[:1]
    caches = (init_cache(api.cfg, 1, 16, torch.float32, device="cpu"),
              init_cache(api.cfg, 1, 16, torch.float32, device="cpu",
                         layout=layout))
    worst = 0.0
    with torch.no_grad():
        for pos in range(steps):
            tok = prompt[:, pos:pos + 1]
            one, _ = api.decode_step(whole, caches[0], tok, pos)
            got, _ = api.decode_step(params, caches[1], tok, pos,
                                     Ctx(layout))
            rms = float(one.pow(2).mean().sqrt())
            worst = max(worst, float((got - one).abs().max()) / rms)
    return worst


def job_tp_step(shape, weights, out, arch):
    """``make_train_step`` of ``ARCH`` (float32 twin) on the layout
    ``D,M``: per microbatch at m = 1 and 2, and deferred at m = 2; the new
    parameters (gathered whole), loss and grad norm at steps 400, 401 and
    402 of OUT, and the replicated leaves' check in OUT/step_<D>_<M>.json;
    then the deferred m = 2 gradients through int8 (410) and without
    (411), and each leaf's largest |local sum| over every rank (412)."""
    layout = tp_layout(shape)
    cfg = tp_config(arch)
    api = build(cfg)
    pspecs = api.param_pspecs()
    flags = {}
    for k, kw in enumerate((dict(microbatch=1), dict(microbatch=2),
                            dict(microbatch=2, grad_sync="deferred"))):
        params = params_from(api, str(Path(weights) / arch), 0, layout,
                             torch.float32)
        opt = AdamW(lr=cosine_schedule(*LR))
        new, _, met = make_train_step(api, opt, layout=layout, **kw)(
            params, opt.init(params), batch_of(cfg))
        flags[400 + k] = replicated_equal(new, leaf_specs(new, pspecs),
                                          layout)
        save_checkpoint(out, 400 + k, {"params": new, "loss": met["loss"],
                                       "gnorm": met["grad_norm"]},
                        specs={"params": pspecs, "loss": (), "gnorm": ()},
                        layout=layout)
    # deferred at m = 2 through int8_all_reduce and without, and the
    # largest |local sum| of any rank (the quantization scale's source)
    from repro_torch.models.lm import Ctx
    params = params_from(api, str(Path(weights) / arch), 0, layout,
                         torch.float32)
    gspecs = {"grads": pspecs, "loss": ()}
    for k, comp in ((410, "int8"), (411, None)):
        loss, g = make_train_step(api, AdamW(), layout=layout, microbatch=2,
                                  grad_sync="deferred",
                                  grad_compression=comp).grads(
            params, batch_of(cfg))
        save_checkpoint(out, k, {"grads": g, "loss": loss}, specs=gspecs,
                        layout=layout)
    ctx = Ctx(layout)
    rows = ctx.rows(batch_of(cfg))
    half = {n: t.shape[0] // 2 for n, t in rows.items()}
    local = None
    for i in range(2):
        sl = {n: t[i * half[n]:(i + 1) * half[n]] for n, t in rows.items()}
        g = value_and_grad(api, params, sl, ctx)[1]
        local = g if local is None else tree_map(torch.add, local, g)
    amax = tree_map(lambda t: mesh.all_reduce_(
        t.abs().max().reshape(1), torch.distributed.group.WORLD, "max")[0],
        local)
    save_checkpoint(out, 412, {"grads": amax},
                    specs={"grads": tree_map(lambda _: (), amax)},
                    layout=layout)
    if mesh.world()[0] == 0:
        (Path(out) / f"step_{shape.replace(',', '_')}.json").write_text(
            json.dumps(flags))


def job_tp_ckpt(shape, out):
    """minicpm-2b and deepseek-v2-lite-16b reduced, seeded, one step on
    the layout ``D,M``; saved (parameters and AdamW state) at step 7 of
    OUT/<ARCH>_<D>_<M>, each rank's blocks in ``held_r<rank>.npz`` there;
    then each checkpoint ``OUT/<ARCH>_one`` (written at one rank) restored
    here, the blocks in ``back_r<rank>.npz``."""
    layout = tp_layout(shape)
    rank = mesh.world()[0]
    for arch in ("minicpm-2b", "deepseek-v2-lite-16b"):
        cfg = reduced(get_config(arch))
        api = build(cfg)
        pspecs = api.param_pspecs()
        opt = AdamW(lr=cosine_schedule(*LR))
        specs = {"params": pspecs, "opt": opt.state_pspecs(pspecs)}
        params = api.init_params(torch.Generator().manual_seed(0),
                                 layout=layout)
        state = opt.init(params)
        params, state, _ = make_train_step(api, opt, layout=layout)(
            params, state, batch_of(cfg))
        d = Path(out) / f"{arch}_{shape.replace(',', '_')}"
        d.mkdir(parents=True, exist_ok=True)
        held = tree_leaves(params) + tree_leaves(state.m)
        np.savez(d / f"held_r{rank}.npz",
                 **{f"l{i}": t.float().numpy() for i, t in enumerate(held)})
        save_checkpoint(str(d), 7, {"params": params, "opt": state},
                        specs=specs, layout=layout)
        back = restore_checkpoint(str(Path(out) / f"{arch}_one"), 7,
                                  {"params": params, "opt": state},
                                  specs=specs, layout=layout)
        flat = tree_leaves(back["params"]) + tree_leaves(back["opt"].m)
        np.savez(d / f"back_r{rank}.npz",
                 **{f"l{i}": t.float().numpy() for i, t in enumerate(flat)})


def job_tp_restore(shape, root, saved, out):
    """Each of ``job_tp_ckpt``'s architectures: its checkpoint at step 7
    of ROOT/<ARCH>_<SAVED> restored on the layout ``D,M``, each rank's
    blocks in OUT/<ARCH>_<D>_<M>_r<rank>.npz."""
    layout = tp_layout(shape)
    rank = mesh.world()[0]
    for arch in ("minicpm-2b", "deepseek-v2-lite-16b"):
        cfg = reduced(get_config(arch))
        api = build(cfg)
        pspecs = api.param_pspecs()
        opt = AdamW(lr=cosine_schedule(*LR))
        params = api.init_params(torch.Generator().manual_seed(1),
                                 layout=layout)
        back = restore_checkpoint(str(Path(root) / f"{arch}_{saved}"), 7,
                                  {"params": params,
                                   "opt": opt.init(params)},
                                  specs={"params": pspecs,
                                         "opt": opt.state_pspecs(pspecs)},
                                  layout=layout)
        flat = tree_leaves(back["params"]) + tree_leaves(back["opt"].m)
        Path(out).mkdir(parents=True, exist_ok=True)
        np.savez(Path(out) / f"{arch}_{shape.replace(',', '_')}_r{rank}.npz",
                 **{f"l{i}": t.float().numpy() for i, t in enumerate(flat)})


DECODE_B, DECODE_PROMPT, DECODE_S = 4, 8, 24


def decode_prompt(cfg):
    """The decode tests' prompt: (DECODE_B, DECODE_PROMPT) tokens of
    seed 5."""
    return np.random.default_rng(5).integers(
        0, cfg.vocab, (DECODE_B, DECODE_PROMPT)).astype(np.int64)


def prefill_batch(cfg):
    """The prefill check's batch: the decode prompt (and for Whisper
    frames of seed 6)."""
    batch = {"tokens": torch.as_tensor(decode_prompt(cfg))}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(np.random.default_rng(6).normal(
            size=(DECODE_B, cfg.n_frames, cfg.d_model)).astype(np.float32))
    return batch


def job_decode(weights, out, *archs):
    """Each architecture's bf16 weights (step 1 of WEIGHTS/ARCH) on a
    (1, n) layout: the prompt fed step by step into ``init_cache(...,
    layout=)``, then greedy steps through ``make_serve_step(api,
    layout)``, DECODE_S - 1 steps in all; the logits and tokens of every
    step in OUT/decode_<ARCH>.npz, with each cache leaf's block shape;
    then ``make_prefill(api, DECODE_S, layout)`` on the float32 twin (step
    0), each rank's hidden states and cache blocks in
    OUT/prefill_<ARCH>_r<rank>.npz."""
    from repro_torch.launch.shapes import cache_pspecs
    from repro_torch.train.train_step import make_prefill, make_serve_step
    layout = mesh.make_host_mesh(1, mesh.world()[1])
    for arch in archs:
        cfg = reduced(get_config(arch))
        api = build(cfg)
        params = params_from(api, str(Path(weights) / arch), 1, layout,
                             torch.bfloat16)
        prompt = torch.as_tensor(decode_prompt(cfg))
        cache = api.init_cache(DECODE_B, DECODE_S, device="cpu",
                               layout=layout)
        shapes = [list(t.shape) for t in tree_leaves(cache)]
        specs = leaf_specs(cache, cache_pspecs(cfg, DECODE_B, layout))
        logits, fed = [], []

        def recording(*a, **kw):
            lg, c = api.decode_step(*a, **kw)
            logits.append(lg.numpy().copy())
            return lg, c

        step = make_serve_step(dataclasses.replace(api,
                                                   decode_step=recording),
                               layout)
        tok = prompt[:, :1]
        for pos in range(DECODE_S - 1):
            fed.append(tok[:, 0].numpy())
            nxt, cache = step(params, cache, tok, pos)
            tok = (prompt[:, pos + 1:pos + 2] if pos + 1 < DECODE_PROMPT
                   else nxt)
        if mesh.world()[0] == 0:
            np.savez(Path(out) / f"decode_{arch}.npz",
                     logits=np.stack(logits), fed=np.stack(fed),
                     shapes=json.dumps(shapes), specs=json.dumps(specs))
        # make_prefill under the layout on the float32 twin: the last
        # hidden states and this rank's cache blocks
        f32 = params_from(api, str(Path(weights) / arch), 0, layout,
                          torch.float32)
        h, pc = make_prefill(api, DECODE_S, layout)(f32, prefill_batch(cfg))
        np.savez(Path(out) / f"prefill_{arch}_r{mesh.world()[0]}.npz",
                 h=h.numpy(), **{f"c{i}": t.numpy()
                                 for i, t in enumerate(tree_leaves(pc))})


def main():
    if mesh.launched():
        mesh.init_group("gloo", "cpu")
    torch.set_num_threads(1)
    job, *args = sys.argv[1:]
    {"layout": job_layout, "dp": job_dp, "ep": job_ep,
     "ckpt": job_ckpt, "tp": job_tp, "tp_step": job_tp_step,
     "tp_ckpt": job_tp_ckpt, "tp_restore": job_tp_restore,
     "decode": job_decode}[job](*args)
    mesh.destroy_group()


if __name__ == "__main__":
    main()
