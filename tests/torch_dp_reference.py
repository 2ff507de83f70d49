"""The reference's side of the multi-rank LM training tests, on forced
host devices (``torch_dp_helpers.start_forced`` sets ``XLA_FLAGS``).

  python tests/torch_dp_reference.py ep WEIGHTS OUT ARCH:CF ...
      on a (2, 1) host mesh, the float32 twin's loss and gradients of
      ``api.train_loss`` under ``Ctx(mesh)`` (the expert-parallel MoE),
      jitted as ``make_train_step`` jits them, for the weights
      ``WEIGHTS/ARCH`` (a checkpoint, step 0); written as checkpoints at
      step 200 + 10 i of OUT, case i
  python tests/torch_dp_reference.py grads D,M WEIGHTS OUT BASE ARCH ...
      as ``ep`` on a (D, M) host mesh (D x M forced devices), case i
      written at step BASE + i of OUT
  python tests/torch_dp_reference.py decode WEIGHTS OUT ARCH ...
      on a (1, 2) host mesh, the bf16 weights (step 1 of WEIGHTS/ARCH)
      placed by ``param_pspecs`` and ``init_cache(B, S)`` placed by
      ``cache_pspecs``: ``torch_dp_worker``'s prompt fed step by step,
      then greedy steps, through ``make_serve_step(api, mesh)`` (its
      tokens) and the same step jitted with its logits kept; OUT gets
      decode_<ARCH>.npz
  python tests/torch_dp_reference.py int8 OUT
      ``_int8_psum`` in a shard_map over 2 devices of the N(0, 1) leaves
      device r draws from seed r (as ``torch_dp_worker``'s ranks); OUT
      gets int8.npz
  python tests/torch_dp_reference.py restore CKPT STEP ARCH OUT
      the port's checkpoint restored with the (2, 1) mesh's shardings of
      the parameters and the AdamW state, then written again at STEP of
      OUT (``np.asarray`` of each sharded array)
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_config, reduced
from repro.launch.mesh import make_host_mesh, make_mesh
from repro.launch.shapes import specs_to_shardings
from repro.models import Ctx, build
from repro.train.checkpoint import restore_checkpoint, save_checkpoint
from repro.train.data import TokenPipeline
from repro.train.optimizer import AdamW
from repro.train.train_step import _int8_psum

from torch_train_helpers import float32_reference


def job_ep(weights, out, *cases):
    mesh = make_host_mesh(2, 1)
    for i, case in enumerate(cases):
        arch, cf = case.split(":")
        cfg = reduced(get_config(arch))
        if cf != "default":
            cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
        api = build(cfg)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                           jnp.float32),
                            api.abstract_params())
        batch = {k: jnp.asarray(v) for k, v in
                 TokenPipeline(cfg, 4, 16, seed=1).batch_at(0).items()}
        with float32_reference(), compat.set_mesh(mesh):
            sh = specs_to_shardings(api.param_pspecs(), mesh)
            params = restore_checkpoint(str(Path(weights) / arch), 0,
                                        {"params": like},
                                        shardings={"params": sh})["params"]
            ctx = Ctx(mesh)
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, b: api.train_loss(p, b, ctx)))(params, batch)
        save_checkpoint(out, 200 + 10 * i, {"grads": g, "loss": loss})


def job_grads(shape, weights, out, base, *archs):
    d, m = (int(x) for x in shape.split(","))
    mesh = make_host_mesh(d, m)
    for i, arch in enumerate(archs):
        cfg = reduced(get_config(arch))
        api = build(cfg)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                           jnp.float32),
                            api.abstract_params())
        batch = {k: jnp.asarray(v) for k, v in
                 TokenPipeline(cfg, 4, 16, seed=1).batch_at(0).items()}
        with float32_reference(), compat.set_mesh(mesh):
            sh = specs_to_shardings(api.param_pspecs(), mesh)
            params = restore_checkpoint(str(Path(weights) / arch), 0,
                                        {"params": like},
                                        shardings={"params": sh})["params"]
            ctx = Ctx(mesh)
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, b: api.train_loss(p, b, ctx)))(params, batch)
        save_checkpoint(out, int(base) + i, {"grads": g, "loss": loss})


def job_decode(weights, out, *archs):
    from repro.launch.shapes import cache_pspecs
    from repro.train.train_step import make_serve_step
    from torch_dp_worker import DECODE_B, DECODE_PROMPT, DECODE_S
    mesh = make_host_mesh(1, 2)
    ctx = Ctx(mesh)
    for arch in archs:
        cfg = reduced(get_config(arch))
        api = build(cfg)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                           a.dtype),
                            api.abstract_params())
        prompt = jnp.asarray(np.random.default_rng(5).integers(
            0, cfg.vocab, (DECODE_B, DECODE_PROMPT)).astype(np.int32))
        with compat.set_mesh(mesh):
            sh = specs_to_shardings(api.param_pspecs(), mesh)
            params = restore_checkpoint(str(Path(weights) / arch), 1,
                                        {"params": like},
                                        shardings={"params": sh})["params"]
            csh = specs_to_shardings(cache_pspecs(cfg, DECODE_B, mesh),
                                     mesh)
            serve = make_serve_step(api, mesh)

            def with_logits(p, c, t, pos):
                logits, c = api.decode_step(p, c, t, pos, ctx)
                return (jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None],
                        logits, c)

            logged = jax.jit(with_logits, donate_argnums=(1,))
            runs = {}
            for name in ("serve", "logged"):
                cache = jax.device_put(api.init_cache(DECODE_B, DECODE_S),
                                       csh)
                tok, logits, fed = prompt[:, :1], [], []
                for pos in range(DECODE_S - 1):
                    fed.append(np.asarray(tok[:, 0]))
                    if name == "serve":
                        nxt, cache = serve(params, cache, tok,
                                           jnp.int32(pos))
                    else:
                        nxt, lg, cache = logged(params, cache, tok,
                                                jnp.int32(pos))
                        logits.append(np.asarray(lg, np.float32))
                    tok = (prompt[:, pos + 1:pos + 2]
                           if pos + 1 < DECODE_PROMPT else nxt)
                runs[name] = (np.stack(fed), logits)
        assert np.array_equal(runs["serve"][0], runs["logged"][0]), arch
        np.savez(Path(out) / f"decode_{arch}.npz",
                 logits=np.stack(runs["logged"][1]), fed=runs["serve"][0])


def job_int8(out):
    mesh = make_mesh((2,), ("pod",))
    draws = [np.random.default_rng(r) for r in range(2)]
    a = np.stack([r.normal(size=(64,)).astype(np.float32) for r in draws])
    b = np.stack([r.normal(size=(3, 5)).astype(np.float32) for r in draws])

    def f(x, y):
        out = _int8_psum({"a": x[0], "b": y[0]}, "pod")
        return out["a"][None], out["b"][None]

    got = compat.shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                           out_specs=(P("pod"), P("pod")),
                           check_vma=False)(jnp.asarray(a), jnp.asarray(b))
    np.savez(Path(out) / "int8.npz", a=np.asarray(got[0]),
             b=np.asarray(got[1]))


def job_restore(ckpt, step, arch, out):
    step = int(step)
    mesh = make_host_mesh(2, 1)
    api = build(reduced(get_config(arch)))
    opt = AdamW()
    params = api.abstract_params()
    state = jax.eval_shape(opt.init, params)
    pspecs = api.param_pspecs()
    with compat.set_mesh(mesh):
        # specs_to_shardings rebuilds a named tuple from a generator,
        # which AdamState refuses: map its fields one by one
        sh = {"params": specs_to_shardings(pspecs, mesh),
              "opt": type(state)(*(
                  None if f is None else specs_to_shardings(f, mesh)
                  for f in opt.state_pspecs(pspecs)))}
        tree = restore_checkpoint(ckpt, step, {"params": params,
                                               "opt": state}, shardings=sh)
    assert tree["params"]["groups"][0]["gate"].sharding.spec == \
        P(None, "data", None, "model")
    save_checkpoint(out, step, tree)


def main():
    job, *args = sys.argv[1:]
    {"ep": job_ep, "int8": job_int8, "restore": job_restore,
     "grads": job_grads, "decode": job_decode}[job](*args)


if __name__ == "__main__":
    main()
