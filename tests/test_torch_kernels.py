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
