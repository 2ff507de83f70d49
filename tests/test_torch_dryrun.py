"""PyTorch port, the dry run on a fake 256- or 512-rank layout
(``repro_torch.launch.dryrun``, ``cost_analysis``, ``shapes.input_specs``,
``abstract_params``, ``mesh.make_production_mesh`` / ``fake_world``, the
model flags) against the reference, on the CPU. Every test opens and
closes its own fake group.

- ``abstract_params`` gives the reference's ``abstract_params()`` shapes
  and dtypes leaf for leaf, for the ten architectures at full width, and
  under the 16 x 16 layout each rank-0 block is the reference's
  ``NamedSharding.shard_shape`` of its ``param_pspecs``.
- ``input_specs`` gives the reference's global shapes, dtypes (int64 token
  ids for its int32), ``seq_len``, ``batch`` and ``tokens_per_step`` for
  the 40 cells, and rank 0's block of every input under 16 x 16 is the
  reference's ``NamedSharding.shard_shape`` (an ``AbstractMesh``: no
  devices, no compile).
- ``_combine(p1, p2, G)`` equals a full-depth trace's FLOPs, bytes and
  per-op collective counts exactly, a reduced dense and a reduced MoE
  configuration at G = 3 on a fake (2, 2) layout (meta tensors); fake and
  meta tensors count alike.
- ``CollectiveCounter`` reproduces ``tests/test_launch.py``'s parser
  numbers on the same collectives issued on the fake group;
  ``roofline_terms`` the reference's roofline arithmetic at the H100's
  rates.
- gemma3-4b ``decode_32k`` at full width on the fake 16 x 16 layout,
  without probes, ends "ok" through the command line, its
  ``argument_bytes`` the sum over its leaves' rank blocks.
- The flags: ``remat_policy="save_tp"`` issues fewer all-reduces than
  "minimal"; ``flash=False`` gives the flash path's loss and gradients.
- The Gram and cluster dry runs: the one-rank count equals the real
  one-rank job's ``visited_cells``; on both production layouts they give
  the reference's keys.
"""
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.launch.shapes import input_specs as j_input_specs
from repro.models import build as jbuild
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch import cost_analysis, dryrun, mesh
from repro_torch.launch.shapes import SHAPES, input_specs, tree_paths
from repro_torch.models import build
from repro_torch.models.layers import FLAGS
from repro_torch.pytree import tree_leaves

AMESH = AbstractMesh((16, 16), ("data", "model"))
DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.long: "int32"}


def _pspec(spec):
    return P(*[tuple(e) if isinstance(e, (list, tuple)) else e
               for e in spec])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_reference(arch):
    japi = jbuild(jget_config(arch))
    want = tree_paths(japi.abstract_params())
    wspecs = tree_paths(japi.param_pspecs())
    api = build(get_config(arch))
    with torch.device("meta"):
        got = tree_paths(api.abstract_params())
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert DTYPES[got[k].dtype] == str(w.dtype), k
    with mesh.fake_world(256), torch.device("meta"):
        blocks = tree_paths(api.abstract_params(
            layout=mesh.make_production_mesh()))
    for k, w in want.items():
        assert tuple(blocks[k].shape) == NamedSharding(
            AMESH, wspecs[k]).shard_shape(w.shape), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    japi, api = jbuild(jcfg), build(cfg)
    with mesh.fake_world(256), torch.device("meta"):
        layout = mesh.make_production_mesh()
        for shape in SHAPES:
            want = j_input_specs(jcfg, shape, AMESH, api=japi)
            got = input_specs(cfg, shape, layout, api)
            assert (got.kind, got.seq_len, got.batch, got.tokens_per_step) \
                == (want.kind, want.seq_len, want.batch,
                    want.tokens_per_step), shape
            wargs = tree_paths(want.args)
            wsh = tree_paths(want.in_shardings)
            assert got.leaves.keys() == wargs.keys(), shape
            blocks = tree_paths(got.args)
            for k, w in wargs.items():
                leaf = got.leaves[k]
                assert leaf.shape == tuple(w.shape), (shape, k)
                assert DTYPES[leaf.dtype] == str(w.dtype), (shape, k)
                assert leaf.local == wsh[k].shard_shape(w.shape), (shape, k)
                assert NamedSharding(AMESH, _pspec(leaf.spec)).shard_shape(
                    w.shape) == leaf.local, (shape, k)
                if shape.startswith(("decode", "long")) and k != "0":
                    # the cache is this rank's block; the batch is whole
                    assert tuple(blocks[k].shape) == leaf.local, (shape, k)
                else:
                    assert tuple(blocks[k].shape) == leaf.shape, (shape, k)


def _probes(cfg, gs, tensors="meta"):
    with mesh.fake_world(4), dryrun.fake_tensors(tensors):
        layout = mesh.Layout((2, 2), ("data", "model"))
        return [dryrun._probe(cfg, "train_4k", layout, g) for g in gs]


@pytest.mark.parametrize("arch", ("yi-6b", "deepseek-v2-lite-16b"))
def test_combine_equals_the_full_depth_trace(arch):
    cfg = reduced(get_config(arch))
    p1, p2, p3 = _probes(cfg, (1, 2, 3))
    got = dryrun._combine(p1, p2, 3)
    for k in ("flops", "bytes", "coll"):
        assert got[k] == p3[k], k
    assert got["coll_counts"] == p3["coll_counts"]
    assert p3["coll_counts"]["reduce-scatter"] > 0
    if arch.startswith("deepseek"):
        assert p3["coll_counts"]["all-to-all"] > 0


def test_fake_and_meta_tensors_count_alike():
    cfg = reduced(get_config("yi-6b"))
    assert _probes(cfg, (1,), "fake") == _probes(cfg, (1,), "meta")


def test_collective_counter_reproduces_the_parser():
    """``tests/test_launch.py``'s HLO: an all-gather of bf16[32] to [64]
    over a group of two (counted once), an all-to-all of f32[8, 16] over
    four ranks."""
    with mesh.fake_world(4):
        layout = mesh.Layout((2, 2), ("data", "model"))
        with cost_analysis.CollectiveCounter() as cc:
            mesh.all_gather_dim(torch.zeros(32, dtype=torch.bfloat16),
                                layout.group("model"), 0)
            x = torch.zeros(8, 16)
            dist.all_to_all_single(torch.empty_like(x), x,
                                   group=layout.group(("data", "model")))
        out = cc.summary()
    assert out["per_op"]["all-gather"]["count"] == 1
    assert out["per_op"]["all-gather"]["wire_bytes"] == 64 * 2 / 2
    assert out["per_op"]["all-to-all"]["wire_bytes"] == pytest.approx(
        8 * 16 * 4 * 3 / 4)
    assert not dist.is_initialized()


def test_roofline_terms_math():
    rl = cost_analysis.roofline_terms(989e12, 3.35e12, 50e9)
    assert abs(rl.compute_s - 1) < 1e-9
    assert abs(rl.memory_s - 1) < 1e-9
    assert abs(rl.collective_s - 1) < 1e-9
    rl2 = cost_analysis.roofline_terms(1e12, 3.35e11, 1e9)
    assert rl2.dominant == "memory"
    assert rl2.bound_time_s == rl2.memory_s
    assert cost_analysis.link_bw(range(8)) == cost_analysis.NVLINK_BW
    assert cost_analysis.link_bw((7, 8)) == cost_analysis.NIC_BW


def test_gemma_decode_cell_ok_and_its_argument_bytes(tmp_path):
    dryrun.main(["--arch", "gemma3-4b", "--shape", "decode_32k",
                 "--no-probes", "--out", str(tmp_path)])
    res = json.loads((tmp_path / "gemma3-4b__decode_32k__single.json"
                      ).read_text())
    assert res["status"] == "ok" and res["mesh"] == "16x16"
    assert (res["seq_len"], res["batch"], res["tokens_per_step"]) == \
        (32768, 128, 128)
    assert not dist.is_initialized()
    # the rank's parameters and inputs, block by block, from the specs
    cfg = get_config("gemma3-4b")
    api = build(cfg)
    with mesh.fake_world(256), torch.device("meta"):
        layout = mesh.make_production_mesh()
        cell = input_specs(cfg, "decode_32k", layout, api)
    from repro_torch.train.train_step import leaf_specs
    with torch.device("meta"):
        shapes = api.abstract_params()
    want = sum(math.prod(mesh.local_shape(tuple(t.shape), spec,
                                          layout_sizes())) * 2
               for t, spec in zip(tree_leaves(shapes),
                                  leaf_specs(shapes, api.param_pspecs())))
    for k, leaf in cell.leaves.items():
        item = torch.empty((), dtype=leaf.dtype).element_size()
        blk = leaf.local if k.startswith("1/") else leaf.shape
        want += math.prod(blk) * item
    assert res["memory"]["argument_bytes"] == want
    assert res["memory"]["peak_bytes_est"] >= want


class layout_sizes:
    """A stand-in layout of the 16 x 16 sizes for ``local_shape``."""
    axes = ("data", "model")

    def size(self, names):
        names = (names,) if isinstance(names, str) else names
        return 16 ** len(names)


def _train_collectives(policy):
    cfg = reduced(get_config("yi-6b"))
    FLAGS["remat_policy"] = policy
    try:
        with mesh.fake_world(2), dryrun.fake_tensors("meta"):
            layout = mesh.Layout((1, 2), ("data", "model"))
            return dryrun._probe(cfg, "train_4k", layout, 1)["coll_counts"]
    finally:
        FLAGS["remat_policy"] = "minimal"


def test_save_tp_keeps_the_all_reduced_outputs():
    minimal, save_tp = (_train_collectives(p)
                        for p in ("minimal", "save_tp"))
    assert 0 < save_tp["all-reduce"] < minimal["all-reduce"]


def test_flash_flag_off_gives_the_flash_paths_values():
    from repro_torch.train.train_step import value_and_grad
    cfg = reduced(get_config("gemma3-4b"))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    params = {k: (v.float() if isinstance(v, torch.Tensor) else
                  [{kk: vv.float() for kk, vv in g.items()} for g in v])
              for k, v in params.items()}
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 17), generator=gen)}
    loss, grads = value_and_grad(api, params, batch)
    FLAGS["flash"] = False
    try:
        loss2, grads2 = value_and_grad(api, params, batch)
    finally:
        FLAGS["flash"] = True
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_gram_and_cluster_dry_runs():
    from repro_torch.launch import cluster, gram
    stats = {}
    gram.run(16, 16, "spdtw", device="cpu", stats=stats)
    one = gram.dryrun(16, 16, "spdtw")
    assert one["cells_per_device"] == stats["visited_cells"] > 0
    for n, multi in ((256, False), (512, True)):
        with mesh.fake_world(n):
            layout = mesh.make_production_mesh(multi_pod=multi)
            g = gram.dryrun(2048, 128, "spdtw", layout=layout)
            c = cluster.dryrun(512, 2048, 128, layout=layout)
        assert {"mode", "flops_per_device", "bytes_per_device",
                "temp_bytes", "devices", "pairs"} <= set(g)
        assert {"mode", "flops_per_device", "bytes_per_device",
                "temp_bytes", "devices", "centroids", "steps"} <= set(c)
        assert g["devices"] == c["devices"] == n
        assert g["cells_per_device"] * n == g["pairs"] * g["cells_per_pair"]
    assert not dist.is_initialized()


def test_fake_world_closes_its_group_on_error():
    with pytest.raises(RuntimeError, match="inside"):
        with mesh.fake_world(512):
            layout = mesh.make_production_mesh(multi_pod=True)
            assert layout.shape == (2, 16, 16)
            assert layout.axes == ("pod", "data", "model")
            raise RuntimeError("inside")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        with mesh.fake_world(512):
            mesh.make_production_mesh()
    assert not dist.is_initialized()
    np.testing.assert_equal(len(SHAPES), 4)
