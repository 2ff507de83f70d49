"""PyTorch port, tensor-parallel decode on the CPU: two gloo ranks at
(data, model) = (1, 2) on the reference's bf16 weights, against the
reference on a forced (1, 2) mesh.

Each side feeds the same 8-token prompt step by step into a cache from
``init_cache`` placed by its ``cache_pspecs`` (the sequence split over
"model": flash-decode, the ranks' attention merged by log-sum-exp), then
decodes greedily, 23 steps in all: the port through ``make_serve_step(api,
layout)``, the reference through ``make_serve_step(api, mesh)`` (and the
same step jitted with its logits kept). yi-6b (GQA, heads split),
gemma3-4b (attention replicated, the local layers' 8-row rings split 4
and 4 and wrapping), deepseek-v2-lite-16b (the compressed MLA cache),
falcon-mamba-7b (the state split over d_inner) and whisper-medium (its
self cache split over the sequence, the cross cache over heads).

Every step's logits must be within ``torch_lm_helpers.FRAC["logits"]``
of the reference's RMS, and the tokens equal, up to the first step whose
argmax differs, which must be a near-tie: the reference's top two logits
of that row within twice that tolerance. The port's cache blocks must
have the shapes its specs give the whole cache. ``make_prefill(api,
S_cache, layout)`` on the float32 twin: each rank's last hidden states
and cache blocks equal the one-rank prefill's, cut by the same specs,
within ``PREFILL_FRAC`` of their RMS.
"""
import json

import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.launch.shapes import cache_pspecs
from repro_torch.models import build
from repro_torch.pytree import tree_leaves
from repro_torch.train.train_step import leaf_specs

from torch_dp_helpers import (reference_weights, start_forced, start_ranks,
                              wait_all, worker)
from torch_dp_worker import DECODE_B, DECODE_PROMPT, DECODE_S
from torch_lm_helpers import ATOL_MAX, FRAC

# float32 sums in another order (measured worst on the CPU: 2.0e-6 of
# the RMS, falcon-mamba-7b's state)
PREFILL_FRAC = 1e-4
ARCHS = ("yi-6b", "gemma3-4b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
         "whisper-medium")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_decode")
    w = d / "weights"
    reference_weights(w, ARCHS)
    (d / "out").mkdir()
    (d / "ref").mkdir()
    wait_all(start_ranks(worker("decode", w, d / "out", *ARCHS))
             + [start_forced(["tests/torch_dp_reference.py", "decode", w,
                              d / "ref", *ARCHS])])
    out = {a: (np.load(d / "out" / f"decode_{a}.npz"),
               np.load(d / "ref" / f"decode_{a}.npz")) for a in ARCHS}
    out["dir"] = d
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_decode_equals_reference_mesh(run, arch):
    got, want = run[arch]
    lg, lw = got["logits"], want["logits"]
    assert lg.shape == lw.shape == (DECODE_S - 1, DECODE_B,
                                    reduced(get_config(arch)).vocab)
    steps = 0
    for t in range(DECODE_S - 1):
        assert np.array_equal(got["fed"][t], want["fed"][t]), (arch, t)
        rms = float(np.sqrt(np.mean(lw[t] * lw[t])))
        tol = min(FRAC["logits"] * rms, ATOL_MAX)
        np.testing.assert_allclose(lg[t], lw[t], rtol=0, atol=tol,
                                   err_msg=f"{arch} step {t}")
        steps += 1
        differ = np.argmax(lg[t], -1) != np.argmax(lw[t], -1)
        if t + 1 >= DECODE_PROMPT and differ.any():
            top = np.sort(lw[t][differ], axis=-1)
            assert np.all(top[:, -1] - top[:, -2] <= 2 * tol), (arch, t)
            break
    assert steps >= DECODE_PROMPT, (arch, steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_cache_blocks_follow_cache_pspecs(run, arch):
    """Each rank's cache leaf is the whole leaf cut by its spec over two
    model ranks."""
    got, _ = run[arch]
    cfg = reduced(get_config(arch))
    whole = build(cfg).init_cache(DECODE_B, DECODE_S, device="cpu")
    specs = json.loads(str(got["specs"]))
    assert specs == json.loads(json.dumps(leaf_specs(
        whole, cache_pspecs(cfg, DECODE_B, {"data": 1, "model": 2}))))
    want = []
    for t, spec in zip(tree_leaves(whole), specs):
        shape = list(t.shape)
        for dim, entry in enumerate(spec):
            names = [entry] if isinstance(entry, str) else entry or []
            if "model" in names:
                shape[dim] //= 2
        want.append(shape)
    assert json.loads(str(got["shapes"])) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_equals_one_rank_cut_by_cache_pspecs(run, arch):
    import torch
    from torch_dp_worker import params_from, prefill_batch
    d = run["dir"]
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = params_from(api, str(d / "weights" / arch), 0, None,
                         torch.float32)
    h, cache = api.prefill(params, prefill_batch(cfg), DECODE_S)
    specs = leaf_specs(cache, cache_pspecs(cfg, DECODE_B,
                                           {"data": 1, "model": 2}))
    for r in range(2):
        got = np.load(d / "out" / f"prefill_{arch}_r{r}.npz")
        rms = float(h.pow(2).mean().sqrt())
        assert np.max(np.abs(got["h"] - h.numpy())) <= PREFILL_FRAC * rms
        for i, (t, spec) in enumerate(zip(tree_leaves(cache), specs)):
            want = t
            for dim, entry in enumerate(spec):
                names = [entry] if isinstance(entry, str) else entry or []
                if "model" in names:
                    want = torch.chunk(want, 2, dim=dim)[r]
            want = want.float().numpy()
            rms = float(np.sqrt(np.mean(want * want)))
            assert got[f"c{i}"].shape == want.shape, (arch, r, i)
            assert np.max(np.abs(got[f"c{i}"] - want)) <= (
                PREFILL_FRAC * rms), (arch, r, i)
