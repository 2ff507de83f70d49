"""PyTorch port, the expert-parallel MoE and the elastic checkpoint on the
CPU (two gloo ranks against the reference on two forced devices).

- deepseek-v2-lite-16b and jamba-v0.1-52b at ``reduced`` size, float32
  twins of the reference's weights (written by the reference's
  ``save_checkpoint``, restored at two ranks, each rank its 4 of the 8
  experts): the loss and every synced gradient at two ranks against the
  reference's ``value_and_grad(api.train_loss)`` under ``Ctx(mesh)`` on a
  (2, 1) mesh, the expert-parallel ``moe_ffn`` (each shard's capacity
  from its own tokens, the aux loss the shards' mean), within
  ``GRAD_FRAC_DP`` of each leaf's RMS. One case at capacity factor 0.5,
  where tokens drop: there the two ranks equal the reference's two
  devices and differ from one rank (a capacity of 8 rows on each of two
  ranks drops other tokens than 8 rows on one).
- The checkpoint across rank counts: deepseek-v2-lite-16b's parameters
  and AdamW state after one two-rank step, saved at two ranks (the
  experts gathered to rank 0), restore at one rank to the ranks' own
  blocks and in the reference with the (2, 1) mesh's shardings to the
  same bits; a one-rank save restores at two ranks to each rank's block.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import build as jbuild
from repro.train.checkpoint import save_checkpoint as jsave_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.models import build, moe
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step
from repro_torch.pytree import tree_leaves

from torch_dp_helpers import (GRAD_FRAC_DP, read_leaves, start_forced,
                              start_ranks, under, wait_all, worker,
                              worst_frac)
from torch_dp_worker import LR, batch_of, params_from
from torch_train_helpers import LOSS_ATOL_F32

ARCHS = ("deepseek-v2-lite-16b", "jamba-v0.1-52b")
LOW_CF = 0.5
CASES = ("deepseek-v2-lite-16b:default", f"deepseek-v2-lite-16b:{LOW_CF}",
         "jamba-v0.1-52b:default")


def _cfg(case):
    arch, cf = case.split(":")
    cfg = reduced(get_config(arch))
    if cf != "default":
        import dataclasses
        cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
    return cfg


def _one_rank_grads(case, weights):
    """The port's one-rank (no layout) float32 gradients on the same
    weights, as checkpoint paths."""
    cfg = _cfg(case)
    api = build(cfg)
    params = params_from(api, str(weights / case.split(":")[0]), 0, None,
                         torch.float32)
    loss, g = make_train_step(api, AdamW()).grads(params, batch_of(cfg))
    d = weights.parent / "one_rank" / case.replace(":", "_")
    save_checkpoint(str(d), 0, {"grads": g, "loss": loss})
    return read_leaves(d, 0)


def _dropped(case, n_ranks):
    """Token-expert assignments past capacity on each of ``n_ranks``
    ranks' rows (the capacity comes from a rank's own tokens)."""
    cfg = _cfg(case)
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    batch = batch_of(cfg)
    seen = []
    pack = moe._pack

    def counted(x, ids, n_experts, capacity):
        out = pack(x, ids, n_experts, capacity)
        seen.append(int((~out[2]).sum()))
        return out

    moe._pack = counted
    try:
        with torch.no_grad():
            for r in range(n_ranks):
                rows = {k: v[r * 4 // n_ranks:(r + 1) * 4 // n_ranks]
                        for k, v in batch.items()}
                api.train_loss(params, rows)
    finally:
        moe._pack = pack
    return sum(seen)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    w = d / "weights"
    for arch in ARCHS:
        japi = jbuild(jreduced(jget_config(arch)))
        params = jax.jit(japi.init_params)(jax.random.PRNGKey(3))
        jsave_checkpoint(str(w / arch), 0, {"params": jax.tree.map(
            lambda a: a.astype(jnp.float32), params)})
    # one rank's checkpoint, for the two ranks to restore
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    api = build(cfg)
    opt = AdamW(lr=cosine_schedule(*LR))
    params = api.init_params(torch.Generator().manual_seed(0))
    state = opt.init(params)
    params, state, _ = make_train_step(api, opt)(params, state,
                                                 batch_of(cfg))
    one = {"params": params, "opt": state}
    save_checkpoint(str(d / "ck" / "one"), 5, one)
    procs = (start_ranks(worker("ep", w, d / "out", *CASES))
             + start_ranks(worker("ckpt", d / "ck"))
             + [start_forced(["tests/torch_dp_reference.py", "ep", w,
                              d / "ref", *CASES])])
    one_rank = {c: _one_rank_grads(c, w) for c in CASES[:2]}
    drops = {n: _dropped(CASES[1], n) for n in (1, 2)}
    wait_all(procs)
    wait_all([start_forced(["tests/torch_dp_reference.py", "restore",
                            d / "ck" / "two", 5, "deepseek-v2-lite-16b",
                            d / "ck" / "ref"])])
    return {"dir": d, "one_rank": one_rank, "drops": drops, "one": one}


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASES)
def test_expert_parallel_equals_reference_two_devices(run, i):
    got = read_leaves(run["dir"] / "out", 200 + 10 * i + 2)
    want = read_leaves(run["dir"] / "ref", 200 + 10 * i)
    assert abs(float(got[".loss"]) - float(want[".loss"])) <= LOSS_ATOL_F32
    worst, at = worst_frac(under(got, ".grads"), under(want, ".grads"))
    assert worst <= GRAD_FRAC_DP, (worst, at)


def test_dropping_case_differs_from_one_rank(run):
    """At capacity factor 0.5 both layouts drop tokens, and other ones:
    the one-rank gradients are far from the two ranks' (which equal the
    reference's two devices, above)."""
    assert run["drops"][1] > 0 and run["drops"][2] > 0, run["drops"]
    got = under(read_leaves(run["dir"] / "out", 200 + 10 + 2), ".grads")
    one = under(run["one_rank"][CASES[1]], ".grads")
    worst, at = worst_frac(one, got)
    assert worst > 100 * GRAD_FRAC_DP, (worst, at)


def _held(d):
    """The two ranks' blocks after their step, as the worker saved them
    before writing its checkpoint: {index: [rank 0, rank 1]}."""
    held = [np.load(d / f"held_r{r}.npz") for r in range(2)]
    return {int(k[1:]): [h[k] for h in held] for k in held[0].files}


def test_two_rank_save_restores_at_one_rank(run):
    d = run["dir"] / "ck"
    like = run["one"]
    back = restore_checkpoint(str(d / "two"), 5, like)
    flat = tree_leaves(back["params"]) + tree_leaves(back["opt"].m)
    for i, blocks in _held(d).items():
        whole = flat[i].float().numpy()
        if blocks[0].shape == whole.shape:        # replicated
            assert np.array_equal(blocks[0], whole), i
            assert np.array_equal(blocks[1], whole), i
        else:                                     # experts, split on axis 1
            assert np.array_equal(np.concatenate(blocks, axis=1), whole), i
    assert back["opt"].step == 1


def test_two_rank_save_restores_in_reference_with_shardings(run):
    d = run["dir"] / "ck"
    got = read_leaves(d / "ref", 5)
    want = read_leaves(d / "two", 5)
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


def test_one_rank_save_restores_at_two_ranks(run):
    d = run["dir"] / "ck"
    whole = tree_leaves(run["one"]["params"]) + tree_leaves(
        run["one"]["opt"].m)
    for r in range(2):
        blocks = np.load(d / f"blocks_r{r}.npz")
        for i, t in enumerate(whole):
            b = blocks[f"l{i}"]
            w = t.float().numpy()
            if b.shape != w.shape:                # this rank's experts
                w = np.split(w, 2, axis=1)[r]
            assert np.array_equal(b, w), (r, i)
