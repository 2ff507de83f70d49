"""PyTorch port, the sharded-corpus tier on the CPU against the reference:
``CorpusIndex.take``, ``SimilarityEngine.shard``, ``launch/shard_index``
(``shard_offsets``, ``shard_corpus_state``, ``merge_topk``, the host path
of ``ShardedSearch``), ``SearchEngine(shards > 1)`` and
``scenarios.run``'s ``BENCH_serving.json`` payload. The cases mirror
``tests/test_shard.py``.

Both sides get the same numpy inputs; the reference computes with
``impl="scan"`` and ``use_mesh=False``, the port with ``device="cpu"``
(its plain versions). Offsets, ids, sizes and the per-candidate rows a
slice copies (corpus, envelopes) must be equal; distances and sketch
rows, which both sides compute, within rtol = atol = 1e-5. Within the
port, sharded answers must equal the unsharded cascade bit for bit.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.check_artifacts import check_file
from repro.core import learn_sparse_paths as j_learn
from repro.core.engine import MeasureSpec as JSpec
from repro.core.engine import fit as j_fit
from repro.launch import search as j_search
from repro.launch import shard_index as j_si
from repro_torch.core import learn_sparse_paths as t_learn
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.launch import scenarios as t_sc
from repro_torch.launch import search as t_search
from repro_torch.launch import shard_index as t_si
from torch_serving_helpers import patch_reference_anchors

N_RAGGED = 23     # not divisible by 2 or 4: every split is ragged
TOL = dict(rtol=1e-5, atol=1e-5)


def _corpus(N=N_RAGGED, T=32, seed=0, dup=None):
    """Seeded synthetic corpus; ``dup`` copies row dup[0] into row dup[1]
    to force an exact distance tie."""
    rng = np.random.default_rng(seed)
    C = rng.normal(size=(N, T)).astype(np.float32)
    if dup is not None:
        C[dup[1]] = C[dup[0]]
    return C


def _engines(C, n_sp=12, seed=0, sketch_r=0):
    """(reference engine, port engine) fitted on the same corpus and the
    same learned support."""
    jsp = j_learn(jnp.asarray(C[:n_sp]), theta=6.0)
    tsp = t_learn(torch.as_tensor(C[:n_sp]), theta=6.0)
    je = j_fit(JSpec(family="spdtw", seed=seed, sketch_r=sketch_r), C,
               sp=jsp, impl="scan")
    te = t_fit(TSpec(family="spdtw", seed=seed, sketch_r=sketch_r), C,
               sp=tsp, device="cpu")
    return je, te


def _queries(C, B=8, seed=1):
    rng = np.random.default_rng(seed)
    return (C[rng.integers(0, len(C), B)]
            + 0.05 * rng.normal(size=(B, C.shape[1]))).astype(np.float32)


@pytest.fixture(scope="module")
def ragged():
    C = _corpus()
    je, te = _engines(C)
    return C, je, te


# ------------------------------------------------------------ partitions
@pytest.mark.parametrize("n,S", [(23, 1), (23, 2), (23, 4), (23, 23),
                                 (5, 8), (1, 3)])
def test_shard_offsets_equal_reference(n, S):
    got = t_si.shard_offsets(n, S)
    assert got.dtype == np.int64
    assert got.tolist() == j_si.shard_offsets(n, S).tolist()


def _index_rows(idx):
    rows = {f: np.asarray(getattr(idx, f)) for f in
            ("corpus", "env_lo", "env_hi")}
    if idx.sketch is not None:
        rows["sketch"] = np.asarray(idx.sketch.sketch)
        rows["sq"] = np.asarray(idx.sketch.sq)
    return rows


def _assert_rows_bitwise(got, want):
    """Per-candidate index rows of two port indexes, bit for bit."""
    g, w = _index_rows(got), _index_rows(want)
    assert g.keys() == w.keys()
    for k in g:
        assert np.array_equal(g[k], w[k]), k


def _assert_rows_match_reference(got, want):
    """Port rows against the reference's: the sliced copies exactly, the
    computed sketch rows within TOL."""
    g, w = _index_rows(got), _index_rows(want)
    assert g.keys() == w.keys()
    for k in g:
        if k in ("sketch", "sq"):
            np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)
        else:
            assert np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def sketched():
    """A ragged corpus fitted with a 4-anchor sketch on both sides, the
    port drawing the reference's anchors."""
    mp = pytest.MonkeyPatch()
    patch_reference_anchors(mp)
    try:
        C = _corpus()
        je, te = _engines(C, sketch_r=4)
        yield C, je, te, mp
    finally:
        mp.undo()


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_engine_shard_equals_with_corpus_and_reference(S, sketched):
    """Each shard engine's index equals ``with_corpus(shard)``'s bit for
    bit (the sharding invariant) and the reference's shard; labels and the
    device ride along."""
    C, je, te, _ = sketched
    labels = np.arange(len(C)) % 3
    te = te.with_corpus(C, labels=labels)
    offs = t_si.shard_offsets(len(C), S)
    shards, jshards = te.shard(S), je.shard(S)
    assert len(shards) == len(jshards) == S
    for s, (se, js) in enumerate(zip(shards, jshards)):
        lo, hi = int(offs[s]), int(offs[s + 1])
        assert se.device == te.device and se.corpus_size == hi - lo
        assert np.array_equal(se.labels, labels[lo:hi])
        _assert_rows_bitwise(se.index, te.with_corpus(C[lo:hi]).index)
        _assert_rows_match_reference(se.index, js.index)


@pytest.mark.parametrize("sel", [slice(0, 1), slice(4, 17),
                                 np.array([2, 2, 5, 0, 5]),
                                 np.array([22, 0, 11])],
                         ids=("first", "middle", "repeats", "unordered"))
def test_take_equals_refit_and_reference(sel, sketched):
    """``take`` with a slice or a (repeating) integer selector: the
    statics shared by reference, the rows equal to a re-fit on the
    selected corpus and to the reference's ``take``."""
    C, je, te, _ = sketched
    got = te.index.take(sel)
    assert got.weights is te.index.weights and got.bsp is te.index.bsp
    assert got.sketch.anchors is te.index.sketch.anchors
    _assert_rows_bitwise(got, te.with_corpus(C[sel]).index)
    _assert_rows_match_reference(got, je.index.take(
        sel if isinstance(sel, slice) else jnp.asarray(sel)))


def test_single_row_corpus_and_shard_count_clamping():
    """N = 1 clamps to one shard, N = 5 with 8 shards to five one-row
    shards; each equals a re-fit on its rows, and the host path still
    merges to the single-host answer."""
    rng = np.random.default_rng(2)
    C1 = rng.normal(size=(1, 32)).astype(np.float32)
    tsp = t_learn(torch.as_tensor(rng.normal(size=(10, 32)).astype(
        np.float32)), theta=6.0)
    one = t_fit(TSpec(family="spdtw", seed=2), C1, sp=tsp, device="cpu")
    assert len(one.shard(3)) == 1
    _assert_rows_bitwise(one.shard(3)[0].index, one.with_corpus(C1).index)
    C = _corpus(N=5)
    je, te = _engines(C, n_sp=5)
    shards = te.shard(8)
    assert len(shards) == len(je.shard(8)) == 5
    for s, se in enumerate(shards):
        _assert_rows_bitwise(se.index, te.with_corpus(C[s:s + 1]).index)
    Q = _queries(C, B=4)
    nn0, d0 = te.knn(Q)
    sh = t_si.ShardedSearch(te, 8)
    assert sh.n_shards == 5 and sh.path == "host"
    g, d = sh.knn(Q)
    assert torch.equal(g, nn0) and torch.equal(d, d0)


def test_shard_corpus_state_equals_reference(ragged):
    """Equal-block layout: ragged shards pad with global row 0 / gid 0,
    every array and the balance stats as the reference's."""
    C, je, te = ragged
    got, want = t_si.shard_corpus_state(te, 4), j_si.shard_corpus_state(
        je, 4)
    assert got.n_shards == 4 and got.n_max == 6 and got.n_total == N_RAGGED
    assert got.gid.dtype == torch.int32
    for f in ("corpus", "gid", "env_lo", "env_hi"):
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f
    assert got.sketch is None and want.sketch is None
    assert got.sizes.tolist() == want.sizes.tolist()
    assert got.offsets.tolist() == want.offsets.tolist()
    assert got.balance() == want.balance()
    last = int(got.sizes[3])
    assert np.array_equal(got.corpus[3, last:].numpy(),
                          np.broadcast_to(C[0], (got.n_max - last, 32)))


# ------------------------------------------------------------- the merge
def _merge_cases():
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 4, size=(5, 12)).astype(np.float32)
    gids = np.stack([rng.permutation(12) for _ in range(5)]).astype(
        np.int32)
    infs = ties.copy()
    infs[:, ::3] = np.inf                   # ties at inf, across shards
    dup = gids.copy()
    dup[:, 6:] = dup[:, :6]                 # a gid in two shards (pads)
    return {"ties": (ties, gids), "inf": (infs, gids),
            "repeated_gids": (ties, dup)}


@pytest.mark.parametrize("case", ("ties", "inf", "repeated_gids"))
@pytest.mark.parametrize("k", (1, 4, 12, 20))
def test_merge_topk_equals_reference_and_lexicographic(case, k):
    """The merge is the lexicographic (dist, gid) order and the
    reference's ``lax.top_k`` merge, ties forced, at inf too."""
    dists, gids = _merge_cases()[case]
    g, d = t_si.merge_topk(torch.as_tensor(dists), torch.as_tensor(gids), k)
    jg, jd = j_si.merge_topk(jnp.asarray(dists), jnp.asarray(gids), k)
    assert np.array_equal(g.numpy(), np.asarray(jg))
    assert np.array_equal(d.numpy(), np.asarray(jd))
    for r in range(len(dists)):
        order = np.lexsort((gids[r], dists[r]))[:min(k, dists.shape[1])]
        assert g[r].tolist() == gids[r][order].tolist()


# ------------------------------------------------------------ host path
@pytest.mark.parametrize("S", [1, 2, 4])
def test_sharded_top1_equals_single_host_and_reference(S, ragged):
    """Ragged shards, host path: the merged top-1 equals the port's
    unsharded cascade bit for bit, and the reference's sharded search."""
    C, je, te = ragged
    Q = _queries(C)
    nn0, d0 = te.knn(Q)
    sh = t_si.ShardedSearch(te, S)
    assert sh.path == "host" and sh.balance()["path"] == "host"
    g, d = sh.knn(Q)
    assert g.dtype == torch.int32
    assert torch.equal(g, nn0) and torch.equal(d, d0)
    jg, jd = j_si.ShardedSearch(je, S, impl="scan", use_mesh=False).knn(Q)
    assert np.array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)


def test_sharded_tie_breaks_by_corpus_index():
    """An exact duplicate in a later shard loses the tie: the merge
    returns the smallest global id, as ``argmin`` does (and the
    reference's ``tests/test_shard.py`` asserts of its own merge)."""
    C = _corpus(dup=(1, 20))
    tsp = t_learn(torch.as_tensor(C[:12]), theta=6.0)
    te = t_fit(TSpec(family="spdtw"), C, sp=tsp, device="cpu")
    Q = np.stack([C[1], C[20]])
    for S in (2, 4):
        g, d = t_si.ShardedSearch(te, S).knn(Q)
        assert g.tolist() == [1, 1]
        assert g.tolist() == te.gram(Q).argmin(1).tolist()


def test_sharded_top3_equals_stable_argsort_and_reference(ragged):
    """k > 1: the merged set equals the Gram's k smallest per row (ids by
    a stable argsort, values bit for bit) and the reference's."""
    C, je, te = ragged
    Q = _queries(C)
    D = te.gram(Q)
    ids = torch.sort(D, dim=1, stable=True).indices[:, :3]
    g, d = t_si.ShardedSearch(te, 4, k=3).knn(Q)
    assert torch.equal(g.long(), ids) and torch.equal(d, D.gather(1, ids))
    jg, jd = j_si.ShardedSearch(je, 4, k=3, impl="scan",
                                use_mesh=False).knn(Q)
    assert np.array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)


def test_distributed_path_needs_its_group(ragged):
    """Without a process group of S ranks the distributed path refuses
    (a group of one serves S = 1), and the dense oracle does not serve."""
    C, _, te = ragged
    with pytest.raises(ValueError, match="2 ranks"):
        t_si.ShardedSearch(te, 2, use_dist=True)
    one = t_si.ShardedSearch(te, 1, use_dist=True)
    assert one.path == "dist"
    Q = _queries(C)
    nn0, d0 = te.knn(Q)
    g, d = one.knn(Q)
    assert torch.equal(g, nn0) and torch.equal(d, d0)
    with pytest.raises(ValueError, match="sharded"):
        t_si.ShardedSearch(te, 2, impl="dense")


# --------------------------------------------------------------- serving
def test_search_engine_shards_wiring(ragged):
    """``SearchEngine(shards=2)`` serves the unsharded answers, reports
    the shard story instead of the prune counters, and re-shards when it
    adopts a snapshot."""
    from repro_torch.core import SnapshotStore
    C, je, te = ragged
    labels = np.arange(len(C)) % 3
    tsp = te.sp
    base = t_search.SearchEngine(C, labels, sp=tsp, device="cpu")
    shrd = t_search.SearchEngine(C, labels, sp=tsp, shards=2, device="cpu")
    Q = _queries(C)
    nn0, d0 = base.search(Q)
    nn1, d1 = shrd.search(Q)
    assert np.array_equal(nn0, nn1) and np.array_equal(d0, d1)
    jshrd = j_search.SearchEngine(C, labels, sp=je.sp, impl="scan",
                                  shards=2)
    jnn, jd = jshrd.search(Q)
    assert np.array_equal(nn1, np.asarray(jnn))
    np.testing.assert_allclose(d1, np.asarray(jd), **TOL)
    st, jst = shrd.stats(), jshrd.stats()
    assert set(st) == set(jst)
    assert st["n_shards"] == 2 and "total" in st["latency_ms"]
    assert "pre_dp_prune_overall" not in st
    want_bal = dict(jst["shard_balance"], path="host")
    assert st["shard_balance"] == want_bal
    # a snapshot adoption re-shards the new corpus
    store = SnapshotStore(te)
    serve = t_search.SearchEngine(None, refresh=store, shards=3)
    first = serve.sharded
    grown = te.with_corpus(np.concatenate([C, Q[:4]]))
    store.publish(grown)
    nn2, d2 = serve.search(Q)
    assert serve.sharded is not first and serve.sharded.shidx.n_total == 27
    enn, ed = grown.knn(Q)
    assert np.array_equal(nn2, enn.numpy()) and np.array_equal(d2, ed.numpy())


# the reference's payload keys (launch/scenarios.py run)
SERVING_KEYS = {"bench", "backend", "impl", "dataset", "corpus", "T",
                "n_queries", "seed", "n_shards", "shard_path",
                "shard_balance", "exact", "scenarios", "stats"}


def test_scenarios_run_payload_passes_the_reference_schema(tmp_path):
    """``scenarios.run`` at smoke size on a ragged split (25 series in 3
    shards): ``exact`` true, the reference's payload keys, the balance of
    its layout, and a ``BENCH_serving.json`` that the reference's schema
    passes (and fails once ``exact`` is false)."""
    kw = dict(dataset="CBF", n_queries=12, batch=4, shards=3, n_train=25,
              T=24, n_sp_train=8, seed=1, rate_qps=500.0)
    got = t_sc.run(device="cpu", **kw)
    assert got["exact"] is True and set(got) == SERVING_KEYS
    assert set(got["scenarios"]) == set(t_sc.SCENARIOS)
    assert got["shard_path"] == "host" and got["n_shards"] == 3
    assert got["shard_balance"] == {
        "n_shards": 3, "sizes": [9, 8, 8], "min_size": 8, "max_size": 9,
        "imbalance": 9 / (25 / 3), "pad_frac": 1 - 25 / 27, "path": "host"}
    path = tmp_path / "BENCH_serving.json"
    path.write_text(json.dumps(got, default=float))
    assert check_file(str(path)) == []
    path.write_text(json.dumps(dict(got, exact=False), default=float))
    assert any("bit-identical" in e for e in check_file(str(path)))
    with pytest.raises(ValueError, match="shards"):
        t_sc.run(device="cpu", **dict(kw, shards=1))


def test_scenarios_cli_writes_the_serving_artifact(tmp_path):
    rc = t_sc.main(["--scenario", "offline", "--smoke", "--shards", "3",
                    "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    out = json.loads((tmp_path / "BENCH_serving.json").read_text())
    assert out["exact"] is True and out["n_shards"] == 3
    assert check_file(str(tmp_path / "BENCH_serving.json")) == []
