"""PyTorch port, the LM training runtime on the CPU against the JAX
reference: the pytree AdamW on identical gradients (float32 and bf16
moments, with and without the master copy, a cosine lr), the cosine
schedule, checkpoints (round trip, keep-last-k, corruption, the
invisible ``.tmp``, and restores across the two packages, bf16 bits
equal), ``TokenPipeline`` batches and its prefetch stream, ``train()``
with its resume, and a resume that reproduces an uninterrupted run's
losses bit for bit.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.train import checkpoint as jckpt
from repro.train.data import TokenPipeline as JPipeline
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import cosine_schedule as jcosine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import adam_state_from_reference
from repro_torch.launch.train import train
from repro_torch.train.checkpoint import (CheckpointManager,
                                          list_checkpoints,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamW, cosine_schedule

# AdamW on identical gradients, 6 steps: float32 leaves within
# ADAM_RTOL_F32 |want| + ADAM_ATOL_F32 (XLA fuses the moment updates into
# multiply-adds, PyTorch rounds each product: the leaves differ in their
# last bits, measured worst 1.7e-8 on an entry of 0.0085 after 6 steps
# of lr up to 1e-2), bf16 leaves
# within one bf16 ulp of their value (a float32 master a few ulps apart
# can round to the neighbouring bf16 value)
ADAM_RTOL_F32, ADAM_ATOL_F32 = 5e-7, 5e-8
BF16_ULP = 2.0 ** -7


def _tree(rng):
    return {"w": rng.normal(size=(4, 8)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(16,)).astype(np.float32)},
                       {"b": rng.normal(size=(3, 5)).astype(np.float32)}]}


def _leaves(tree):
    return [np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                       else a, np.float32)
            for a in jax.tree.leaves(
                tree, is_leaf=lambda a: isinstance(a, torch.Tensor))]


def _assert_leaves(got, want, bf16):
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        if bf16:
            np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-30,
                                       err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=ADAM_RTOL_F32,
                                       atol=ADAM_ATOL_F32,
                                       err_msg=f"leaf {i}")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("keep_master", [True, False])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moments, keep_master, param_dtype):
    rng = np.random.default_rng(0)
    init = _tree(rng)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jopt = JAdamW(lr=jcosine(1e-2, 2, 6), moment_dtype=jdt[moments],
                  keep_master=keep_master)
    opt = AdamW(lr=cosine_schedule(1e-2, 2, 6), moment_dtype=tdt[moments],
                keep_master=keep_master)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt[param_dtype]), init)
    tp = jax.tree.map(lambda a: torch.as_tensor(a).to(tdt[param_dtype]),
                      init)
    js, ts = jopt.init(jp), opt.init(tp)
    update = jax.jit(jopt.update)
    for step in range(6):
        g = _tree(rng)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt[param_dtype]), g)
        tg = jax.tree.map(lambda a: torch.as_tensor(
            np.asarray(jnp.asarray(a, jdt[param_dtype]), np.float32)
        ).to(tdt[param_dtype]), g)
        jp, js = update(jg, js, jp)
        if step % 2:
            tp, ts = opt.update_(tg, ts, tp)
        else:
            tp, ts = opt.update(tg, ts, tp)
        assert ts.step == int(js.step) == step + 1
        bf16 = param_dtype == "bfloat16" or moments == "bfloat16"
        _assert_leaves(tp, jp, param_dtype == "bfloat16")
        _assert_leaves(ts.m, js.m, bf16)
        _assert_leaves(ts.v, js.v, bf16)
        if keep_master:
            _assert_leaves(ts.master, js.master, bf16)
        else:
            assert ts.master is None and js.master is None


def test_adamw_state_carried_from_reference():
    """``convert.adam_state_from_reference`` carries the step, moments
    and master across: one more step from the reference's state equals
    the reference's next step."""
    rng = np.random.default_rng(1)
    init = _tree(rng)
    jopt, opt = JAdamW(lr=3e-3), AdamW(lr=3e-3)
    jp = jax.tree.map(jnp.asarray, init)
    js = jopt.init(jp)
    for _ in range(3):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, _tree(rng)), js, jp)
    ts = adam_state_from_reference(js, device="cpu")
    assert ts.step == 3
    tp = jax.tree.map(lambda a: torch.as_tensor(np.asarray(a)), jp)
    g = _tree(rng)
    jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
    tp, ts = opt.update(jax.tree.map(torch.as_tensor, g), ts, tp)
    _assert_leaves(tp, jp, False)
    _assert_leaves(ts.master, js.master, False)


# cosine_schedule against the reference: |lr - ref| within
# SCHEDULE_ULPS float32 ulps of base_lr. XLA computes pi * prog with a
# reciprocal product and its own cosine, the port with a division and
# torch.cos: the argument and the cosine each round once, which moves
# 0.5 base (1 + cos) by at most ~2.5 ulps of base_lr (measured worst 1.5,
# at (3e-4, 10, 1000) step 317).
SCHEDULE_ULPS = 3


@pytest.mark.parametrize("base,warmup,total", [(1e-3, 1, 6), (5e-3, 1, 12),
                                               (3e-4, 4, 40), (1e-2, 0, 7),
                                               (3e-4, 10, 1000)])
def test_cosine_schedule_matches_reference(base, warmup, total):
    want = jax.jit(jcosine(base, warmup, total))
    lr = cosine_schedule(base, warmup, total)
    limit = SCHEDULE_ULPS * float(np.spacing(np.float32(base)))
    for s in range(total + 3):
        got = lr(s)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want(jnp.int32(s)))) <= limit, s


def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.randn(4, generator=g).to(torch.bfloat16),
                  {"c": torch.tensor(3, dtype=torch.int32)}],
            "opt": AdamW().init(torch.ones(2, dtype=torch.bfloat16))}


def _same(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    tree = _ckpt_tree()
    mgr = CheckpointManager(d, keep_last=2)
    for s in (1, 2, 3):
        mgr.save(s, tree)
    mgr.wait()
    assert list_checkpoints(d) == [2, 3] and mgr.latest_step() == 3
    out = restore_checkpoint(d, 3, tree)
    assert out["b"][0].dtype == torch.bfloat16 and out["opt"].step == 0
    assert type(out["opt"]).__name__ == "AdamState"
    _same(out, tree)
    manifest = json.load(open(os.path.join(d, "step_00000003",
                                           "manifest.json")))
    assert manifest["step"] == 3
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {
        "float32", "bfloat16", "int32"}


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"w": torch.ones(8)})
    leaf = os.path.join(d, "step_00000001", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(IOError):
        restore_checkpoint(d, 1, {"w": torch.zeros(8)})


def test_checkpoint_tmp_is_invisible(tmp_path):
    """A half-written step (its ``.tmp`` directory, or a directory
    without a manifest) is not listed; the newest complete one is."""
    d = str(tmp_path)
    save_checkpoint(d, 4, {"w": torch.ones(3)})
    shutil.copytree(os.path.join(d, "step_00000004"),
                    os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000007"))
    assert list_checkpoints(d) == [4]
    assert CheckpointManager(d).latest_step() == 4


def test_checkpoints_restore_across_packages(tmp_path):
    """A reference checkpoint restores in the port and a port checkpoint
    in the reference, bf16 bits equal both ways."""
    rng = np.random.default_rng(5)
    vals = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "layers": [{"k": rng.normal(size=(5,)).astype(np.float32)}]}
    k = vals["layers"][0]["k"]
    jtree = {"params": {"w": jnp.asarray(vals["w"], jnp.bfloat16),
                        "layers": [{"k": jnp.asarray(k)}]},
             "step": jnp.asarray(7, jnp.int32)}
    ttree = {"params": {"w": torch.as_tensor(vals["w"]).to(torch.bfloat16),
                        "layers": [{"k": torch.as_tensor(k)}]},
             "step": 7}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save_checkpoint(ref_dir, 2, jtree)
    save_checkpoint(port_dir, 2, ttree)
    got = restore_checkpoint(ref_dir, 2, ttree)
    assert got["step"] == 7 and got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["w"].view(torch.int16).numpy(),
        np.asarray(jtree["params"]["w"]).view(np.int16))
    np.testing.assert_array_equal(got["params"]["layers"][0]["k"].numpy(), k)
    back = jckpt.restore_checkpoint(port_dir, 2, jtree)
    assert int(back["step"]) == 7
    assert back["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["params"]["w"]).view(np.int16),
        ttree["params"]["w"].view(torch.int16).numpy())
    # the same leaf paths and files in both layouts
    for d in (ref_dir, port_dir):
        leaves = json.load(open(os.path.join(d, "step_00000002",
                                             "manifest.json")))["leaves"]
        assert [leaf["path"] for leaf in leaves] == [
            ".params.layers[0].k", ".params.w", ".step"]


@pytest.mark.parametrize("arch", ["yi-6b", "pixtral-12b", "whisper-medium"])
def test_token_pipeline_equals_reference(arch):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    want, got = JPipeline(jcfg, 4, 32, seed=7), TokenPipeline(cfg, 4, 32,
                                                              seed=7)
    for step in (0, 5, 11):
        w, g = want.batch_at(step), got.batch_at(step)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert not np.array_equal(got.batch_at(5)["tokens"],
                              got.batch_at(6)["tokens"])


def test_token_pipeline_prefetch_stream():
    cfg = reduced(get_config("yi-6b"))
    pipe = TokenPipeline(cfg, batch=4, seq_len=32, seed=7).start(from_step=5)
    try:
        for step in (5, 6, 7):
            np.testing.assert_array_equal(
                next(pipe)["tokens"], pipe.batch_at(step)["tokens"])
    finally:
        pipe.stop()


def test_train_loss_decreases_and_resumes(tmp_path):
    """The reference's ``test_train_loss_decreases_end_to_end`` on the
    port."""
    kw = dict(use_reduced=True, ckpt_dir=str(tmp_path), batch=4, seq=32,
              ckpt_every=6, lr=5e-3, log_every=100, device="cpu")
    losses = train("minicpm-2b", steps=12, **kw)
    assert len(losses) == 12 and losses[-1] < losses[0], losses
    losses2 = train("minicpm-2b", steps=14, **kw)
    assert len(losses2) == 2            # resumed at 12, ran 12..13
    assert list_checkpoints(str(tmp_path)) == [6, 12, 14]


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Delete the checkpoints past step 6 of a 14-step run: the resumed
    run's losses for steps 6-13 equal the uninterrupted run's bit for
    bit."""
    d = str(tmp_path)
    kw = dict(use_reduced=True, ckpt_dir=d, batch=4, seq=32, ckpt_every=6,
              lr=5e-3, log_every=100, device="cpu")
    full = train("minicpm-2b", steps=14, **kw)
    assert list_checkpoints(d) == [6, 12, 14]
    for s in (12, 14):
        shutil.rmtree(os.path.join(d, f"step_{s:08d}"))
    resumed = train("minicpm-2b", steps=14, **kw)
    assert resumed == full[6:]


def test_train_refuses_multi_rank_axes(tmp_path):
    """A model axis that does not split some leaf raises naming it (the
    reduced whisper-medium's 2 heads over 4 ranks); a data or model axis
    of 2 needs two ranks (tests/test_torch_lm_dp_train.py and
    tests/test_torch_lm_tp_train.py run them)."""
    with pytest.raises(ValueError, match=r"leaf .*wq of shape"):
        train("whisper-medium", steps=1, ckpt_dir=str(tmp_path),
              model_axis=4, device="cpu")
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train("minicpm-2b", steps=1, ckpt_dir=str(tmp_path), model_axis=2,
              device="cpu")
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train("minicpm-2b", steps=1, ckpt_dir=str(tmp_path), data_axis=2,
              device="cpu")
