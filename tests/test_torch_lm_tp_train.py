"""PyTorch port, the training step, checkpoints and the trainer over the
model axis on the CPU (gloo ranks).

- yi-6b reduced, float32 twin of the reference's weights: one
  ``make_train_step`` at (data, model) = (1, 2) and (2, 2), per
  microbatch at m = 1 and 2 and deferred at m = 2, against the port's
  one-rank step on the same rows (deferred: each data rank's m slices of
  its own rows, the one-rank step at m times the data ranks): the loss,
  the grad norm and every new parameter within ``torch_train_helpers``'
  step limits, and every leaf not split over "model" equal bit for bit
  on the model ranks; deferred + int8 within the quantization bound of
  the uncompressed deferred sync.
- Checkpoints across layouts: minicpm-2b and deepseek-v2-lite-16b after
  one step at (1, 2) and (2, 2), saved (parameters and AdamW state,
  gathered whole to rank 0), restore at one rank to the blocks each rank
  held, bit for bit, and the (2, 2) save restores at (2, 1) and (1, 2) to
  the blocks of the whole leaves; a one-rank save restores at (1, 2) and
  (2, 2) to each rank's block.
- ``python -m repro_torch.launch.train --model-axis 2`` (two gloo ranks)
  trains, and ``train(..., model_axis=1)`` resumes its checkpoint.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import train
from repro_torch.models import build
from repro_torch.pytree import tree_leaves
from repro_torch.train.checkpoint import (list_checkpoints,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.train_step import leaf_specs, make_train_step

from torch_dp_helpers import (read_leaves, reference_weights, start_launcher,
                              start_ranks, under, wait_all, worker)
from torch_dp_worker import LR, batch_of, params_from
from torch_train_helpers import (EPS_BAND, GNORM_RTOL, LOSS_ATOL_F32,
                                 PARAM_ATOL)

LAYOUTS = {"1,2": (1, 2), "2,2": (2, 2)}
CKPT_ARCHS = ("minicpm-2b", "deepseek-v2-lite-16b")
TRAIN_RUN = ["--arch", "minicpm-2b", "--batch", "4", "--seq", "32",
             "--ckpt-every", "3", "--lr", "5e-3", "--backend", "gloo",
             "--device", "cpu"]


def _one_rank_step(w, **kw):
    """The port's one-rank step of yi-6b's float32 twin: (loss, grad norm,
    {path: new parameter}, {path: gradient})."""
    cfg = reduced(get_config("yi-6b"))
    api = build(cfg)
    params = params_from(api, str(w / "yi-6b"), 0, None, torch.float32)
    opt = AdamW(lr=cosine_schedule(*LR))
    step = make_train_step(api, opt, **kw)
    _, grads = step.grads(params, batch_of(cfg))
    new, _, met = step(params, opt.init(params), batch_of(cfg))
    d = w.parent / "one" / str(kw.get("microbatch", 1))
    save_checkpoint(str(d), 0, {"params": new, "grads": grads})
    got = read_leaves(d, 0)
    return (float(met["loss"]), float(met["grad_norm"]),
            under(got, ".params"), under(got, ".grads"))


def _one_rank_checkpoints(root):
    """Each of CKPT_ARCHS seeded, one step at one rank, saved at step 7 of
    ROOT/<ARCH>_one; returns {arch: the whole leaves (params, then m)}."""
    out = {}
    for arch in CKPT_ARCHS:
        cfg = reduced(get_config(arch))
        api = build(cfg)
        opt = AdamW(lr=cosine_schedule(*LR))
        params = api.init_params(torch.Generator().manual_seed(2))
        state = opt.init(params)
        params, state, _ = make_train_step(api, opt)(params, state,
                                                     batch_of(cfg))
        save_checkpoint(str(root / f"{arch}_one"), 7,
                        {"params": params, "opt": state})
        out[arch] = [t.float().numpy() for t in
                     tree_leaves(params) + tree_leaves(state.m)]
    return out


def _specs(arch):
    """The partition specs of the params, then of AdamW's m, leaf for
    leaf."""
    api = build(reduced(get_config(arch)))
    params = api.init_params(torch.Generator().manual_seed(0))
    pspecs = api.param_pspecs()
    flat = leaf_specs(params, pspecs)
    return flat + flat


def _block(whole, spec, shape, rank):
    """Rank ``rank``'s block of a whole numpy leaf on a (data, model)
    layout of ``shape``."""
    coords = dict(zip(("data", "model"), np.unravel_index(rank, shape)))
    sizes = dict(zip(("data", "model"), shape))
    for dim, entry in enumerate(spec):
        names = [entry] if isinstance(entry, str) else list(entry or [])
        names = [a for a in names if a in sizes]
        n = int(np.prod([sizes[a] for a in names])) if names else 1
        if n == 1:
            continue
        k = int(np.ravel_multi_index([coords[a] for a in names],
                                     [sizes[a] for a in names]))
        step = whole.shape[dim] // n
        whole = np.take(whole, range(k * step, (k + 1) * step), axis=dim)
    return whole


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    w = d / "weights"
    reference_weights(w, ("yi-6b",))
    ck = d / "ck"
    ck.mkdir()
    one_ckpt = _one_rank_checkpoints(ck)
    procs = []
    for shape, (dd, mm) in LAYOUTS.items():
        procs += start_ranks(worker("tp_step", shape, w, d / shape, "yi-6b"),
                             n=dd * mm)
        procs += start_ranks(worker("tp_ckpt", shape, ck), n=dd * mm)
    procs.append(start_launcher(["repro_torch.launch.train", *TRAIN_RUN,
                                 "--steps", "6", "--model-axis", "2",
                                 "--ckpt-dir", d / "trainer"]))
    one = {m: _one_rank_step(w, microbatch=m) for m in (1, 2, 4)}
    logs = wait_all(procs)
    wait_all(start_ranks(worker("tp_restore", "2,1", ck, "2_2", d / "back"))
             + start_ranks(worker("tp_restore", "1,2", ck, "2_2",
                                  d / "back")))
    return {"dir": d, "one": one, "ck": ck, "one_ckpt": one_ckpt,
            "trainer_log": logs[-1]}


@pytest.mark.parametrize("shape", LAYOUTS)
@pytest.mark.parametrize("k", range(3), ids=["m1", "m2", "deferred_m2"])
def test_tp_step_equals_one_rank_step(run, shape, k):
    dd = LAYOUTS[shape][0]
    m = (1, 2, 2 * dd)[k]
    wl, wg, wp, grads = run["one"][m]
    got = read_leaves(run["dir"] / shape, 400 + k)
    assert abs(float(got[".loss"]) - wl) <= LOSS_ATOL_F32
    assert abs(float(got[".gnorm"]) - wg) <= GNORM_RTOL * wg
    port = under(got, ".params")
    for key, want in wp.items():
        atol = np.where(np.abs(grads[key]) < EPS_BAND, 2 * LR[0],
                        PARAM_ATOL)
        np.testing.assert_array_less(np.abs(port[key] - want),
                                     atol + 1e-30, err_msg=key)


@pytest.mark.parametrize("shape", LAYOUTS)
def test_tp_deferred_int8_within_quantization_bound(run, shape):
    """Deferred sync at m = 2 through ``int8_all_reduce`` at (D, M): each
    data rank's rounding moves an entry of its local sum by at most half
    the shared scale (the largest |local sum| / 127), so the D ranks'
    sum, divided by m D, moves by at most scale / (2 m). At (1, 2) there
    is no data rank to sync with: equal bit for bit."""
    d = run["dir"] / shape
    q, exact, amax = (under(read_leaves(d, k), ".grads")
                      for k in (410, 411, 412))
    dd = LAYOUTS[shape][0]
    quantized = False
    for k, e in exact.items():
        err = float(np.max(np.abs(q[k] - e)))
        if dd == 1:
            assert err == 0.0, k
            continue
        bound = float(amax[k]) / 127.0 / (2 * 2)
        assert err <= bound * (1 + 1e-5) + 1e-7 * float(np.abs(e).max()), (
            k, err, bound)
        quantized |= err > 0
    assert quantized or dd == 1


@pytest.mark.parametrize("shape", LAYOUTS)
def test_tp_step_replicated_leaves_bit_equal(run, shape):
    flags = json.loads((run["dir"] / shape /
                        f"step_{shape.replace(',', '_')}.json").read_text())
    assert flags == {str(400 + k): [] for k in range(3)}


@pytest.mark.parametrize("shape", LAYOUTS)
@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_layout_save_restores_at_one_rank(run, shape, arch):
    """The save at ``shape`` restored whole at one rank: each rank's
    block of every leaf is the bits that rank held."""
    d = run["ck"] / f"{arch}_{shape.replace(',', '_')}"
    api = build(reduced(get_config(arch)))
    opt = AdamW(lr=cosine_schedule(*LR))
    params = api.init_params(torch.Generator().manual_seed(1))
    back = restore_checkpoint(str(d), 7, {"params": params,
                                          "opt": opt.init(params)})
    assert back["opt"].step == 1
    flat = [t.float().numpy() for t in
            tree_leaves(back["params"]) + tree_leaves(back["opt"].m)]
    specs = _specs(arch)
    dd, mm = LAYOUTS[shape]
    for r in range(dd * mm):
        held = np.load(d / f"held_r{r}.npz")
        for i, (whole, spec) in enumerate(zip(flat, specs)):
            assert np.array_equal(_block(whole, spec, (dd, mm), r),
                                  held[f"l{i}"]), (r, i)


@pytest.mark.parametrize("shape", ("2,1", "1,2"))
@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_two_by_two_save_restores_at_two_ranks(run, shape, arch):
    d = run["ck"] / f"{arch}_2_2"
    held = [np.load(d / f"held_r{r}.npz") for r in range(4)]
    specs = _specs(arch)
    # the whole leaves, assembled from the (2, 2) ranks' blocks by the
    # one-rank restore (test_layout_save_restores_at_one_rank holds it)
    api = build(reduced(get_config(arch)))
    opt = AdamW(lr=cosine_schedule(*LR))
    params = api.init_params(torch.Generator().manual_seed(1))
    back = restore_checkpoint(str(d), 7, {"params": params,
                                          "opt": opt.init(params)})
    flat = [t.float().numpy() for t in
            tree_leaves(back["params"]) + tree_leaves(back["opt"].m)]
    assert len(held[0].files) == len(flat)
    dd, mm = (int(x) for x in shape.split(","))
    for r in range(2):
        got = np.load(run["dir"] / "back" /
                      f"{arch}_{shape.replace(',', '_')}_r{r}.npz")
        for i, (whole, spec) in enumerate(zip(flat, specs)):
            assert np.array_equal(got[f"l{i}"],
                                  _block(whole, spec, (dd, mm), r)), (r, i)


@pytest.mark.parametrize("shape", LAYOUTS)
@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_one_rank_save_restores_at_layout(run, shape, arch):
    d = run["ck"] / f"{arch}_{shape.replace(',', '_')}"
    specs = _specs(arch)
    dd, mm = LAYOUTS[shape]
    for r in range(dd * mm):
        back = np.load(d / f"back_r{r}.npz")
        for i, (whole, spec) in enumerate(zip(run["one_ckpt"][arch],
                                              specs)):
            assert np.array_equal(back[f"l{i}"],
                                  _block(whole, spec, (dd, mm), r)), (r, i)


def test_launch_train_model_axis_two_resumes_at_one(run):
    line = json.loads([ln for ln in run["trainer_log"].splitlines()
                       if ln.startswith("{")][-1])
    assert line["steps_run"] == 6 and line["ranks"] == 2, line
    assert line["last_loss"] < line["first_loss"], line
    d = run["dir"] / "trainer"
    assert list_checkpoints(str(d)) == [3, 6]
    losses = train("minicpm-2b", steps=8, use_reduced=True,
                   ckpt_dir=str(d), batch=4, seq=32, ckpt_every=3,
                   lr=5e-3, log_every=100, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert list_checkpoints(str(d)) == [3, 6, 8]
