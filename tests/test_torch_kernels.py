"""PyTorch port, kernel layer: the plain versions of K1 (``gram_block``)
and K2 (``spdtw_block``) against the reference's JAX scan twins, the
backend registry, and — on a machine with a CUDA card only — the CUDA
kernels against their plain versions.

The plain versions repeat the scan twins' operation order, so the limit
is rtol 1e-6. On the reference side XLA's CPU compiler contracts the
multivariate channel sum into fused multiply-adds, so at d > 1 the two
differ in the last bits (ROADMAP.md, section C); at d = 1 they are
equal.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import block_sparse_from_arrays
from repro_torch.core.occupancy import block_sparsify
from repro_torch.kernels import _build
from repro_torch.kernels import backends as t_bk
from repro_torch.kernels import gram_block as t_gb
from repro_torch.kernels.spdtw_block import spdtw_block

RTOL = 1e-6



@pytest.fixture(scope="module")
def J():
    """The reference's modules. They need jax, which a machine with a
    CUDA card may not have; the card-only tests below do not use them.
    There, run those with ``PYTHONPATH=src python -m pytest -q
    --noconftest -m cuda tests/test_torch_kernels.py``."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import occupancy
    from repro.kernels import backends, gram_block
    return SimpleNamespace(jnp=jnp, occ=occupancy, bk=backends,
                           gb=gram_block)


def _support(T, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    w = np.zeros((T, T), np.float32)
    sup = (np.abs(i[:, None] - i[None, :]) <= 4) | (rng.random((T, T)) < 0.1)
    w[sup] = rng.uniform(0.5, 2.0, int(sup.sum())).astype(np.float32)
    return w


def _plans(J, w, tile):
    """The reference's plan and the port's copy of it (``convert``)."""
    jb = J.occ.block_sparsify(w, tile=tile)
    tb = block_sparse_from_arrays(dict(tile=jb.tile, active=jb.active,
                                       slot=jb.slot, blocks=jb.blocks,
                                       T=jb.T, meta=jb.plan()))
    return jb, tb


def _series(rng, n, T, d):
    shape = (n, T) if d == 1 else (n, T, d)
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=0)


@pytest.fixture
def launches_unchanged():
    before = _build.launch_counts()
    yield
    assert _build.launch_counts() == before, "a CPU tensor launched a kernel"


@pytest.mark.parametrize("d", [1, 3])
def test_gram_scan_matches_reference(J, d, launches_unchanged):
    jnp, j_gb = J.jnp, J.gb
    T = 30
    rng = np.random.default_rng(d)
    jb, tb = _plans(J, _support(T, d), tile=8)
    A, B = _series(rng, 5, T, d), _series(rng, 6, T, d)
    want = j_gb.gram_spdtw_scan(jnp.asarray(A), jnp.asarray(B), jb)
    got = t_gb.gram_spdtw_scan(torch.as_tensor(A), torch.as_tensor(B), tb,
                               block_a=2)
    _close(got, want)
    # the K1 wrapper runs the plain version for CPU tensors
    _close(t_gb.gram_spdtw_block(torch.as_tensor(A), torch.as_tensor(B),
                                 tb), want)
    # thresholds + alive0 + live-tile counts
    G = np.asarray(want)
    thr = np.quantile(G, 0.4, axis=1).astype(np.float32)
    alive0 = rng.random(G.shape) > 0.25
    wG, wt = j_gb.gram_spdtw_scan(jnp.asarray(A), jnp.asarray(B), jb,
                                  thresholds=jnp.asarray(thr),
                                  alive0=jnp.asarray(alive0),
                                  return_tiles=True)
    gG, gt = t_gb.gram_spdtw_scan(torch.as_tensor(A), torch.as_tensor(B), tb,
                                  thresholds=torch.as_tensor(thr),
                                  alive0=torch.as_tensor(alive0),
                                  return_tiles=True)
    _close(gG, wG)
    assert np.array_equal(gt.numpy(), np.asarray(wt))
    # values at or below the threshold equal the exact sweep's bit for
    # bit, dead pairs are +INF
    exact = got.numpy()
    ok = (exact <= thr[:, None]) & alive0
    assert ok.any()
    assert np.array_equal(gG.numpy()[ok], exact[ok])
    assert (gG.numpy()[~alive0] >= 1e29).all()


@pytest.mark.parametrize("d", [1, 3])
def test_paired_scan_and_prefix_bound_match_reference(J, d,
                                                       launches_unchanged):
    jnp, j_gb = J.jnp, J.gb
    T = 30
    rng = np.random.default_rng(10 + d)
    jb, tb = _plans(J, _support(T, 10 + d), tile=8)
    x, y = _series(rng, 7, T, d), _series(rng, 7, T, d)
    want = np.asarray(j_gb.spdtw_paired_scan(jnp.asarray(x), jnp.asarray(y),
                                             jb))
    got = t_gb.spdtw_paired_scan(torch.as_tensor(x), torch.as_tensor(y), tb)
    _close(got, want)
    _close(spdtw_block(torch.as_tensor(x), torch.as_tensor(y), tb), want)
    thr = (want * np.where(np.arange(7) % 2 == 0, 1.1, 0.9)).astype(
        np.float32)
    _close(t_gb.spdtw_paired_scan(torch.as_tensor(x), torch.as_tensor(y),
                                  tb, thresholds=torch.as_tensor(thr)),
           j_gb.spdtw_paired_scan(jnp.asarray(x), jnp.asarray(y), jb,
                                  thresholds=jnp.asarray(thr)))
    n_prefix = t_gb.prefix_tile_count(tb, 0.5, T)
    assert n_prefix == j_gb.prefix_tile_count(jb, 0.5, T) > 0
    A, B = x[:4], y[:5]
    want_lb = j_gb.gram_prefix_bound(jnp.asarray(A), jnp.asarray(B), jb,
                                     n_prefix)
    _close(t_gb.gram_prefix_bound(torch.as_tensor(A), torch.as_tensor(B),
                                  tb, n_prefix), want_lb)
    _close(t_gb.gram_spdtw_block(torch.as_tensor(A), torch.as_tensor(B), tb,
                                 n_prefix=n_prefix), want_lb)


def test_ragged_length_and_unreachable_corner(J):
    jnp, j_gb = J.jnp, J.gb
    T = 21                       # not a multiple of the tile edge
    rng = np.random.default_rng(5)
    jb, tb = _plans(J, _support(T, 5), tile=8)
    A, B = _series(rng, 3, T, 1), _series(rng, 4, T, 1)
    _close(t_gb.gram_spdtw_scan(torch.as_tensor(A), torch.as_tensor(B), tb),
           j_gb.gram_spdtw_scan(jnp.asarray(A), jnp.asarray(B), jb))
    w = np.zeros((16, 16), np.float32)
    w[:8, :8] = 1.0              # the corner tile is inactive
    _, tb0 = _plans(J, w, tile=8)
    G = t_gb.gram_spdtw_scan(torch.as_tensor(A[:, :16]),
                             torch.as_tensor(B[:, :16]), tb0)
    assert (G.numpy() >= 1e29).all()


def test_tile_major_layout_matches_reference(J):
    jnp, j_bk = J.jnp, J.bk
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 21, 2)).astype(np.float32)
    want = np.asarray(j_bk.to_tile_major(jnp.asarray(X), 8, 24, n_to=4))
    got = t_bk.to_tile_major(torch.as_tensor(X), 8, 24, n_to=4)
    assert np.array_equal(got.numpy(), want)
    back = t_bk.from_tile_major(got, 8, 2, 21)[:3]
    assert np.array_equal(back.numpy(), X)


def test_backend_registry_never_steps_a_cuda_tensor_down(monkeypatch):
    assert t_bk.available_backends() == ("dense", "scan", "cuda")
    assert t_bk.resolve("auto", device="cpu").name == "scan"
    assert t_bk.resolve("ref", device="cpu").name == "scan"
    assert t_bk.resolve("dense", device="cpu").name == "dense"
    cuda = torch.device("cuda")
    assert t_bk.resolve("auto", device=cuda).name == "cuda"
    for cap in (t_bk.EARLY_ABANDON, t_bk.PRUNED_DP, t_bk.MULTIVARIATE):
        assert t_bk.resolve("auto", device=cuda, require=(cap,)).name \
            == "cuda"
    with pytest.raises(ValueError):
        t_bk.resolve("scan", device=cuda)       # plain versions: CPU only
    with pytest.raises(ValueError):
        t_bk.resolve("cuda", device="cpu")
    # scan walks down to dense on the CPU for what only dense has; cuda
    # has no fallback and raises instead
    monkeypatch.setitem(t_bk._REGISTRY, "dense", t_bk.Backend(
        "dense", "cpu", frozenset({t_bk.MULTIVARIATE, "extra"}), None, ""))
    assert t_bk.resolve("scan", device="cpu",
                        require=("extra",)).name == "dense"
    with pytest.raises(ValueError):
        t_bk.resolve("cuda", device=cuda, require=("extra",))


def test_plan_resolver_caches_by_content():
    w = _support(24, 3)
    a = t_bk.resolve_plan(weights=w)
    b = t_bk.resolve_plan(weights=torch.as_tensor(w.copy()))
    assert a is b
    assert t_bk.resolve_plan(T=24) is t_bk.resolve_plan(T=24)
    assert np.array_equal(t_bk.densify(a)[:24, :24], w)


# ------------------------------------------------------ card-only checks
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,T", [(8, 1, 40), (8, 3, 40), (16, 1, 70),
                                   (16, 3, 70), (32, 1, 150), (32, 3, 150),
                                   (128, 1, 150), (128, 3, 150)])
def test_cuda_kernels_match_plain_versions(cuda_device, S, d, T):
    rng = np.random.default_rng(S + d)
    tb = block_sparsify(_support(T, S + d), tile=S)
    A = torch.as_tensor(_series(rng, 6, T, d), device=cuda_device)
    B = torch.as_tensor(_series(rng, 9, T, d), device=cuda_device)
    before = _build.launch_counts()
    G = t_gb.gram_spdtw_block(A, B, tb)
    Gp = t_gb.gram_spdtw_scan(A, B, tb)
    assert torch.equal(G, Gp)
    thr = torch.quantile(Gp, 0.4, dim=1)
    alive0 = torch.as_tensor(rng.random((6, 9)) > 0.25, device=cuda_device)
    assert torch.equal(
        t_gb.gram_spdtw_block(A, B, tb, thresholds=thr, alive0=alive0),
        t_gb.gram_spdtw_scan(A, B, tb, thresholds=thr, alive0=alive0))
    n_prefix = max(1, t_gb.prefix_tile_count(tb, 0.5, T))
    assert torch.equal(t_gb.gram_spdtw_block(A, B, tb, n_prefix=n_prefix),
                       t_gb.gram_prefix_bound(A, B, tb, n_prefix))
    P = spdtw_block(A, B[:6], tb)
    assert torch.equal(P, t_gb.spdtw_paired_scan(A, B[:6], tb))
    assert torch.equal(P, torch.diagonal(Gp[:, :6]))
    after = _build.launch_counts()
    assert after["spdtw_tiles_gram"] == before["spdtw_tiles_gram"] + 3
    assert after["spdtw_tiles_paired"] == before["spdtw_tiles_paired"] + 1


# ------------------------------------------------ K1's list mode (pairs)
@pytest.mark.parametrize("share", [0.0, 0.35, 1.0])
def test_pair_list_plain_matches_flatnonzero(share):
    rng = np.random.default_rng(int(100 * share))
    m = rng.random((37, 53)) < share
    ids, count = t_gb.pair_list(torch.as_tensor(m))
    assert ids.dtype == count.dtype == torch.int32
    assert np.array_equal(ids.numpy(), np.flatnonzero(m))
    assert count.tolist() == [int(m.sum())]
    assert torch.equal(t_gb.pair_list_plain(torch.as_tensor(m))[0], ids)


def test_pair_list_checks_its_arguments():
    m = torch.ones((3, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="dtype"):
        t_gb.pair_list(m.to(torch.uint8))
    for bad in (m.reshape(-1), m[None]):
        with pytest.raises(ValueError, match="shape"):
            t_gb.pair_list(bad)
    with pytest.raises(ValueError, match="CPU tensors"):
        t_gb.pair_list(m.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_gb.pair_list_cuda(m)
    # the list mode is K1's: the plain versions refuse it
    tb = block_sparsify(_support(16, 0), tile=8)
    A, B = torch.zeros((3, 16)), torch.zeros((4, 16))
    with pytest.raises(ValueError, match="list mode"):
        t_gb.gram_spdtw_block(A, B, tb, alive0=m, out=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="list mode"):
        t_gb.gram_spdtw_block(A, B, tb, n_prefix=1, out=torch.zeros(3, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 700), (61, 257), (4000, 1000)])
@pytest.mark.parametrize("share", [0.0, 0.35, 1.0])
def test_cuda_pair_list_matches_plain(cuda_device, shape, share):
    rng = np.random.default_rng(shape[1] + int(100 * share))
    m = torch.as_tensor(rng.random(shape) < share, device=cuda_device)
    before = _build.launch_counts()["spdtw_pair_list"]
    ids, count = t_gb.pair_list(m)
    assert _build.launch_counts()["spdtw_pair_list"] == before + 1
    assert ids.shape == (m.numel(),) and count.shape == (1,)
    want, n = t_gb.pair_list_plain(m.cpu())
    assert torch.equal(count.cpu(), n)
    assert torch.equal(ids[:int(n)].cpu(), want)


SENTINEL = -7.0


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,T,route", [(16, 1, 70, "thread"),
                                         (16, 3, 70, "thread"),
                                         (64, 1, 150, "lanes")])
@pytest.mark.parametrize("share", [0.0, 0.35, 1.0])
def test_cuda_k1_pair_list_matches_masked_k1(cuda_device, S, d, T, route,
                                             share):
    """K1 on a pair list (a mask, ``alive0``) equals the masked K1 on the
    listed pairs: the full grid's values there (a pair's sweep does not
    depend on the others'), the plain version under the same mask, and
    leaves the rest of ``out`` as it was (+INF without ``out``)."""
    from repro_torch.kernels.spdtw_block import tile_geometry
    rng = np.random.default_rng(S + d + int(100 * share))
    tb = block_sparsify(_support(T, S + d), tile=S)
    assert tile_geometry(S, d, tb.T)["route"] == route
    Na, Nb = 40, 37
    A = torch.as_tensor(_series(rng, Na, T, d), device=cuda_device)
    B = torch.as_tensor(_series(rng, Nb, T, d), device=cuda_device)
    mask = torch.as_tensor(rng.random((Na, Nb)) < share, device=cuda_device)

    def fresh():
        return torch.full((Na, Nb), SENTINEL, device=cuda_device)

    # thresholded exact mode
    thr = torch.quantile(t_gb.gram_spdtw_block(A, B, tb), 0.4, dim=1)
    grid = t_gb.gram_spdtw_block(A, B, tb, thresholds=thr)
    plain = t_gb.gram_spdtw_scan(A, B, tb, thresholds=thr, alive0=mask)
    out = fresh()
    before = _build.launch_counts()
    got = t_gb.gram_spdtw_block(A, B, tb, thresholds=thr, alive0=mask,
                                out=out)
    after = _build.launch_counts()
    assert got is out
    for k in ("spdtw_pair_list", "spdtw_tiles_gram"):
        assert after[k] == before[k] + 1
    assert torch.equal(got[mask], grid[mask])
    assert torch.equal(got[mask], plain[mask])
    assert (got[~mask] == SENTINEL).all()
    # without out, into +INF: the masked K1, whole
    assert torch.equal(t_gb.gram_spdtw_block(A, B, tb, thresholds=thr,
                                             alive0=mask), plain)
    # prefix mode
    n_prefix = max(1, t_gb.prefix_tile_count(tb, 0.5, T))
    lb = t_gb.gram_spdtw_block(A, B, tb, n_prefix=n_prefix)
    assert torch.equal(lb, t_gb.gram_prefix_bound(A, B, tb, n_prefix))
    got = t_gb.gram_spdtw_block(A, B, tb, n_prefix=n_prefix, alive0=mask,
                                out=fresh())
    assert torch.equal(got[mask], lb[mask])
    assert (got[~mask] == SENTINEL).all()
    assert torch.equal(t_gb.gram_spdtw_block(A, B, tb, n_prefix=n_prefix,
                                             alive0=mask),
                       torch.where(mask, lb, t_gb.INF))


@pytest.mark.cuda
def test_cuda_k1_pair_list_unreachable_corner(cuda_device):
    w = np.zeros((16, 16), np.float32)
    w[:8, :8] = 1.0              # the corner tile is inactive
    tb = block_sparsify(w, tile=8)
    rng = np.random.default_rng(3)
    A = torch.as_tensor(_series(rng, 5, 16, 1), device=cuda_device)
    B = torch.as_tensor(_series(rng, 6, 16, 1), device=cuda_device)
    mask = torch.as_tensor(rng.random((5, 6)) < 0.5, device=cuda_device)
    out = torch.full((5, 6), SENTINEL, device=cuda_device)
    got = t_gb.gram_spdtw_block(A, B, tb, alive0=mask, out=out)
    assert (got[mask] >= 1e29).all() and (got[~mask] == SENTINEL).all()
    assert torch.equal(t_gb.gram_spdtw_block(A, B, tb, alive0=mask),
                       t_gb.gram_spdtw_scan(A, B, tb, alive0=mask))


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["spdtw", "sp_krdtw"])
def test_cuda_cascade_on_pair_lists(cuda_device, fam):
    """The cascades on the card run K1's prefix and exact passes on pair
    lists (the prefix pass on the whole grid where stats or counts are
    asked for, whose ``stage3_pruned`` needs the bound on every pair):
    the answers equal the full Gram argmin in every mode, the survivors
    and stats agree across modes, and the recorder counts the prefix
    pass's pairs as the list's length."""
    from repro_torch import trace
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    g = torch.Generator().manual_seed(7)
    X = torch.randn(300, 64, generator=g).cumsum(dim=1)
    Q = torch.randn(120, 64, generator=g).cumsum(dim=1)
    eng = fit(MeasureSpec(family=fam, support="learned", theta=2.0), X,
              device=cuda_device)
    D = eng.gram(Q)
    want_nn = torch.argmin(D, dim=1).to(torch.int32)
    want_d = D.gather(1, want_nn[:, None].long())[:, 0]
    before = _build.launch_counts()
    nn0, d0 = eng.knn(Q)
    after = _build.launch_counts()
    assert after["spdtw_tiles_gram"] - before["spdtw_tiles_gram"] == \
        (2 if fam == "spdtw" else 1)
    assert after["spdtw_pair_list"] - before["spdtw_pair_list"] == \
        (2 if fam == "spdtw" else 1)
    nn1, d1, raw = eng.knn(Q, return_stats="counts")
    nn2, d2, st = eng.knn(Q, return_stats=True)
    for nn, dd in ((nn0, d0), (nn1, d1), (nn2, d2)):
        assert torch.equal(nn, want_nn) and torch.equal(dd, want_d)
    total = st["n_queries"] * st["n_candidates"]
    assert st["prefix_tiles"] > 0
    assert int(raw["dp_pairs"]) + raw["seed_pairs"] == st["dp_pairs"]
    for i in (1, 2, 3):
        assert int(raw[f"stage{i}_pruned"]) / total == st[f"stage{i}_prune"]
    assert st["pre_dp_prune"] == 1.0 - st["dp_pairs"] / total
    assert int(raw["abandoned"]) / total == st["dp_abandoned"]
    trace.disable()
    trace.reset()
    try:
        trace.enable()
        seen = {}
        for mode in (False, "counts", True):
            trace.reset()
            eng.knn(Q, return_stats=mode)
            seen[mode] = {k.removeprefix("cascade."): int(v) for k, v in
                          trace.snapshot()["counts"].items()}
    finally:
        trace.disable()
        trace.reset()
    for mode, c in seen.items():
        assert c["alive2"] == seen[True]["alive2"]
        assert c["dp_pairs"] == seen[True]["dp_pairs"] == \
            int(raw["dp_pairs"])
        assert c["prefix_pairs"] == (c["alive2"] if mode is False else total)
        assert c["prefix_cells"] == c["prefix_pairs"] * \
            t_gb.prefix_cell_count(eng.index.bsp, st["prefix_tiles"])
