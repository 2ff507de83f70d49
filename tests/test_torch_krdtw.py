"""PyTorch port, kernel-measure layer: log K_rdtw, the DTW / DTW_sc
baselines, the kernel bounds and the plain versions of K3-K6 against the
reference, on the CPU; and, on a machine with a CUDA card only, the CUDA
kernels K3-K6 against their plain versions.

Tolerances. The port's core K_rdtw repeats the reference's row recursion
and ``jax.lax.associative_scan``'s pairing, but XLA's exp / log / log1p
are not PyTorch's and XLA's CPU compiler may contract multiply-adds, so
log-kernel values agree within rtol 1e-5 (observed ~4e-7); the plain K3 /
K4 sweeps against the Pallas kernels in interpret mode likewise. The DTW
recurrences are min and add only: the plain K5 / K6 equal the Pallas
kernels bit for bit at d = 1 (limit rtol 1e-6). The kernel bounds'
slacks agree within rtol 1e-6.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import baselines as t_base
from repro_torch.core import bounds as t_bounds
from repro_torch.core import dtw as t_dtw
from repro_torch.core import krdtw as t_krdtw
from repro_torch.core.measures import build_corpus_index
from repro_torch.kernels import _build
from repro_torch.kernels import backends as t_bk
from repro_torch.kernels import dtw_banded as t_k6
from repro_torch.kernels import dtw_wavefront as t_k5
from repro_torch.kernels import gram_block as t_gb
from repro_torch.kernels import krdtw_wavefront as t_k4

KTOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def J():
    """The reference's modules. They need jax, which a machine with a
    CUDA card may not have; the card-only tests below do not use them.
    There, run those with ``PYTHONPATH=src python -m pytest -q
    --noconftest -m cuda tests/test_torch_krdtw.py``."""
    jnp = pytest.importorskip("jax.numpy")
    import importlib
    mods = {n: importlib.import_module(f"repro.{n}") for n in (
        "core.krdtw", "core.dtw", "core.baselines", "core.bounds",
        "core.measures", "kernels.dtw_wavefront", "kernels.dtw_banded",
        "kernels.krdtw_wavefront", "kernels.gram_block")}
    return SimpleNamespace(jnp=jnp, krdtw=mods["core.krdtw"],
                           dtw=mods["core.dtw"], base=mods["core.baselines"],
                           bounds=mods["core.bounds"],
                           measures=mods["core.measures"],
                           k5=mods["kernels.dtw_wavefront"],
                           k6=mods["kernels.dtw_banded"],
                           k4=mods["kernels.krdtw_wavefront"],
                           gb=mods["kernels.gram_block"])


def _pairs(seed, B, T, d=1):
    rng = np.random.default_rng(seed)
    shape = (B, T) if d == 1 else (B, T, d)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _support(T, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    sup = (np.abs(i[:, None] - i[None, :]) <= 3) | (rng.random((T, T)) < 0.15)
    sup[0, 0] = sup[-1, -1] = True
    return sup


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture
def launches_unchanged():
    before = _build.launch_counts()
    yield
    assert _build.launch_counts() == before, "a CPU tensor launched a kernel"


# ------------------------------------------------------------- core K_rdtw
@pytest.mark.parametrize("domain", ["full", "band", "masked"])
def test_log_krdtw_matches_reference(J, domain):
    T, nu = 19, 0.5
    x, y = _pairs(1, 4, T)
    sup = _support(T, 1)
    for a, b in zip(x, y):
        ja, jb_ = J.jnp.asarray(a), J.jnp.asarray(b)
        if domain == "full":
            want = J.krdtw.log_krdtw(ja, jb_, nu)
            got = t_krdtw.log_krdtw(_t(a), _t(b), nu)
        elif domain == "band":
            want = J.krdtw.log_krdtw_sc(ja, jb_, nu, 3)
            got = t_krdtw.log_krdtw_sc(_t(a), _t(b), nu, 3)
        else:
            want = J.krdtw.log_sp_krdtw(ja, jb_, nu, J.jnp.asarray(sup))
            got = t_krdtw.log_sp_krdtw(_t(a), _t(b), nu, _t(sup))
        np.testing.assert_allclose(float(got), float(want), **KTOL)
    # linear space and the normalized Gram
    np.testing.assert_allclose(
        float(t_krdtw.krdtw(_t(x[0]), _t(y[0]), nu)),
        float(J.krdtw.krdtw(J.jnp.asarray(x[0]), J.jnp.asarray(y[0]), nu)),
        **KTOL)
    lg = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    dx, dy = lg[:, 0].copy(), lg[0].copy()
    np.testing.assert_allclose(
        t_krdtw.normalized_gram(_t(lg), _t(dx), _t(dy)).numpy(),
        np.asarray(J.krdtw.normalized_gram(J.jnp.asarray(lg),
                                           J.jnp.asarray(dx),
                                           J.jnp.asarray(dy))), rtol=1e-6)


def test_linrec_scan_matches_reference(J):
    rng = np.random.default_rng(3)
    for n in (2, 7, 16):
        a = rng.uniform(0, 1, size=(4, n)).astype(np.float32)
        b = rng.uniform(0, 1, size=(4, n)).astype(np.float32)
        a[:, 0] = 0
        want = np.asarray(J.krdtw.linrec_scan(J.jnp.asarray(a),
                                              J.jnp.asarray(b)))
        got = t_krdtw.linrec_scan(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dtw_sc_band_cells_and_baselines_match_reference(J):
    x, y = _pairs(4, 3, 23)
    for a, b in zip(x, y):
        for r in (0, 2, 5):
            assert float(t_dtw.dtw_sc(_t(a), _t(b), r)) == float(
                J.dtw.dtw_sc(J.jnp.asarray(a), J.jnp.asarray(b), r))
        ja, jb_ = J.jnp.asarray(a), J.jnp.asarray(b)
        for name, args in (("euclidean", ()), ("corr", ()),
                           ("corr_dissimilarity", ()), ("daco", (4,))):
            np.testing.assert_allclose(
                float(getattr(t_base, name)(_t(a), _t(b), *args)),
                float(getattr(J.base, name)(ja, jb_, *args)),
                rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            t_base.autocorr_operator(_t(a), 5).numpy(),
            np.asarray(J.base.autocorr_operator(ja, 5)), rtol=1e-5,
            atol=1e-6)
    assert t_dtw.band_cells(23, 23, 4) == J.dtw.band_cells(23, 23, 4)
    np.testing.assert_allclose(t_base.znormalize(_t(x)).numpy(),
                               np.asarray(J.base.znormalize(
                                   J.jnp.asarray(x))), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- kernel bounds
def test_kernel_bounds_and_index_fields_match_reference(J):
    T = 21
    sup = _support(T, 5)
    for s in (None, sup):
        want = J.bounds.krdtw_log_slacks(s, T=T)
        got = t_bounds.krdtw_log_slacks(s, T=T)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    rng = np.random.default_rng(5)
    b1 = rng.uniform(0, 30, (4, 6)).astype(np.float32)
    b2 = rng.uniform(0, 5, (4, 6)).astype(np.float32)
    b1[0, 0] = 1e31                     # clamped to INF on both sides
    s1, s2 = J.bounds.krdtw_log_slacks(sup, T=T)
    np.testing.assert_allclose(
        t_bounds.lb_log_krdtw(_t(b1), _t(b2), 0.5, s1, s2).numpy(),
        np.asarray(J.bounds.lb_log_krdtw(J.jnp.asarray(b1),
                                         J.jnp.asarray(b2), 0.5, s1, s2)),
        rtol=1e-6)
    C = rng.normal(size=(6, T)).astype(np.float32)
    w = sup.astype(np.float32)
    ji = J.measures.build_corpus_index(J.jnp.asarray(C), w, kind="sp_krdtw",
                                       nu=0.5)
    ti = build_corpus_index(_t(C), w, kind="sp_krdtw", nu=0.5)
    assert ti.nu == ji.nu == 0.5
    np.testing.assert_allclose((ti.log_s1, ti.log_s2),
                               (ji.log_s1, ji.log_s2), rtol=1e-6)
    assert np.array_equal(ti.bsp.plan(), ji.bsp.plan())
    with pytest.raises(ValueError, match="nu"):
        build_corpus_index(_t(C), w, kind="krdtw")


# ------------------------------------------- plain K3-K6 vs Pallas (interpret)
@pytest.mark.parametrize("T,r", [(1, None), (17, None), (17, 0), (24, 3),
                                 (24, 30)])
def test_plain_k5_k6_equal_pallas_kernels(J, T, r, launches_unchanged):
    x, y = _pairs(T, 5, T)
    want = np.asarray(J.k5.wavefront_dtw(J.jnp.asarray(x), J.jnp.asarray(y),
                                         radius=r, interpret=True))
    got = t_k5.wavefront_dtw(_t(x), _t(y), radius=r).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.array_equal(got, want)
    if r is None:
        return
    want6 = np.asarray(J.k6.banded_dtw(J.jnp.asarray(x), J.jnp.asarray(y), r,
                                       interpret=True))
    got6 = t_k6.banded_dtw(_t(x), _t(y), r).numpy()
    assert np.array_equal(got6, want6)
    # the Gram mode is the strip over the pair grid
    G = t_k6.banded_dtw_gram(_t(x[:2]), _t(y), r).numpy()
    for a in range(2):
        assert np.array_equal(G[a], t_k6.banded_dtw_plain(
            _t(np.repeat(x[a:a + 1], 5, 0)), _t(y), r).numpy())


def test_plain_k5_k6_multivariate_match_dense_core(J, launches_unchanged):
    x, y = _pairs(8, 4, 20, d=3)
    want = np.asarray(J.dtw.dtw_matrix(J.jnp.asarray(x[0]),
                                       J.jnp.asarray(y[0]))[-1, -1])
    np.testing.assert_allclose(
        t_k5.wavefront_dtw(_t(x), _t(y)).numpy()[0], want, rtol=1e-6)
    wsc = np.asarray(J.dtw.dtw_sc(J.jnp.asarray(x[1]), J.jnp.asarray(y[1]),
                                  4))
    np.testing.assert_allclose(t_k6.banded_dtw(_t(x), _t(y), 4).numpy()[1],
                               wsc, rtol=1e-6)
    np.testing.assert_allclose(
        t_k5.wavefront_dtw(_t(x), _t(y), radius=4).numpy()[1], wsc,
        rtol=1e-6)


@pytest.mark.parametrize("T,nu,dom", [(9, 1.0, "full"), (21, 0.5, "radius"),
                                      (24, 2.0, "support")])
def test_plain_k3_k4_match_pallas_kernels(J, T, nu, dom, launches_unchanged):
    x, y = _pairs(30 + T, 5, T)
    kw_j, kw_t, kw_g = {}, {}, {}
    if dom == "radius":
        kw_j = kw_t = {"radius": 4}
        kw_g = {"radius": 4}
    elif dom == "support":
        sup = _support(T, T)
        md = t_k4.mask_to_diagonal_major(sup)
        assert np.array_equal(md, J.k4.mask_to_diagonal_major(sup))
        kw_j = {"mask_diag": J.jnp.asarray(md)}
        kw_t = {"mask_diag": md}
        kw_g = {"support": sup}
    want = np.asarray(J.k4.wavefront_log_krdtw(
        J.jnp.asarray(x), J.jnp.asarray(y), nu, interpret=True, **kw_j))
    got = t_k4.wavefront_log_krdtw(_t(x), _t(y), nu, **kw_t).numpy()
    np.testing.assert_allclose(got, want, **KTOL)
    A, B = x[:3], y[:4]
    wantg = np.asarray(J.gb.gram_log_krdtw_block(
        J.jnp.asarray(A), J.jnp.asarray(B), nu, interpret=True, **kw_g))
    gotg = t_gb.gram_log_krdtw_block(_t(A), _t(B), nu, **kw_g).numpy()
    np.testing.assert_allclose(gotg, wantg, **KTOL)
    # the Gram's diagonal is the paired sweep on the same pairs, bit for bit
    assert np.array_equal(np.diagonal(gotg), got[:3])


def test_long_series_plain_sweep_is_finite():
    x, y = _pairs(9, 2, 300)
    got = t_k4.wavefront_log_krdtw_plain(_t(x), _t(y), 1.0).numpy()
    assert np.isfinite(got).all()


# --------------------------------------------------------------- routing
def test_dtw_pairs_route_to_the_kernels_on_cuda():
    """``engine.pairs`` for dtw / dtw_sc resolves to the ``cuda`` backend
    (K5) for CUDA tensors; the plain versions stay CPU-only. Checked
    through the registry: nothing launches here."""
    cuda = torch.device("cuda")
    assert t_bk.resolve("auto", device=cuda).name == "cuda"
    assert t_bk.resolve("auto", device="cpu").name == "scan"
    with pytest.raises(ValueError):
        t_bk.resolve("scan", device=cuda)
    from repro_torch.kernels import ops
    import inspect
    src = inspect.getsource(ops._dtw_pairs)
    assert "NotImplementedError" not in src and "wavefront_dtw" in src


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8, 2))
    with pytest.raises(ValueError, match="univariate"):
        t_k4.krdtw_cuda(x, x, 1.0, radius=None, mask_bits=None, gram=True)
    with pytest.raises(ValueError, match="CUDA"):
        t_k5.dtw_wavefront_cuda(x, x)
    with pytest.raises(ValueError, match="radius"):
        t_k6.banded_dtw(x, x, -1)
    bits = t_k4.pack_diagonal_mask(t_k4.mask_to_diagonal_major(
        _support(40, 1)), 40, "cpu")
    assert bits.shape == (79, 2) and bits.dtype == torch.int32
    md = t_k4.mask_to_diagonal_major(_support(40, 1))
    k, i = 45, 33
    assert bool((int(bits[k, i // 32]) >> (i % 32)) & 1) == bool(md[k, i])


# ------------------------------------------------------ card-only checks
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _narrow_support(T):
    """|i - j| <= 3: at most 4 positions per diagonal, so the narrow sweep
    packs 8 pairs per warp."""
    i = np.arange(T)
    return np.abs(i[:, None] - i[None, :]) <= 3


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 100, 300, 600, 1024])
def test_cuda_k3_k4_match_plain_and_each_other(cuda_device, T):
    x, y = (torch.as_tensor(a, device=cuda_device) for a in _pairs(T, 9, T))
    domains = ({}, {"radius": 5}, {"support": _support(T, T)},
               {"support": _narrow_support(T)})
    before = _build.launch_counts()
    for nu in (0.1, 2.0):
        for kw in domains:
            G = t_gb.gram_log_krdtw_block(x[:4], y, nu, **kw)
            Gp = t_gb.gram_log_krdtw_plain(x[:4], y, nu, **kw)
            assert torch.equal(G, Gp)
            md = t_k4.mask_to_diagonal_major(kw["support"]) \
                if "support" in kw else None
            P = t_k4.wavefront_log_krdtw(x[:4], y[:4], nu,
                                         radius=kw.get("radius"),
                                         mask_diag=md)
            assert torch.equal(P, torch.diagonal(G[:, :4]))
            assert torch.equal(P, t_k4.wavefront_log_krdtw_plain(
                x[:4], y[:4], nu, radius=kw.get("radius"), mask_diag=md))
    after = _build.launch_counts()
    assert after["krdtw_gram"] == before["krdtw_gram"] + 8
    assert after["krdtw_paired"] == before["krdtw_paired"] + 8


@pytest.mark.cuda
def test_cuda_k3_k4_at_the_longest_ucr_length(cuda_device):
    """T = 2709 (UCR HandOutlines), a few pairs: the full grid (wide
    sweep, no length limit), a corridor and a narrow support."""
    T = 2709
    x, y = (torch.as_tensor(a, device=cuda_device) for a in _pairs(T, 3, T))
    for kw in ({}, {"radius": 6}, {"support": _narrow_support(T)}):
        G = t_gb.gram_log_krdtw_block(x[:2], y, 0.5, **kw)
        assert torch.equal(G, t_gb.gram_log_krdtw_plain(x[:2], y, 0.5, **kw))
        md = t_k4.mask_to_diagonal_major(kw["support"]) \
            if "support" in kw else None
        P = t_k4.wavefront_log_krdtw(x[:2], y[:2], 0.5,
                                     radius=kw.get("radius"), mask_diag=md)
        assert torch.equal(P, torch.diagonal(G[:, :2]))
        assert bool(torch.isfinite(G).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,radii", [
    (24, 1, (None, 0, 3, 13, 26)), (128, 1, (None, 0, 3, 13, 26)),
    (100, 3, (None, 0, 3, 13, 26)),
    # past the register layouts: K5's shared-memory diagonals (T > 512)
    # and K6's 409-cell strip (2w + 1 > 256)
    (1024, 1, (None, 204))])
def test_cuda_k5_k6_equal_plain(cuda_device, T, d, radii):
    x, y = (torch.as_tensor(a, device=cuda_device)
            for a in _pairs(T + d, 8, T, d))
    for r in radii:
        assert torch.equal(t_k5.wavefront_dtw(x, y, radius=r),
                           t_k5.wavefront_dtw_plain(x, y, radius=r))
        if r is None:
            continue
        assert torch.equal(t_k6.banded_dtw(x, y, r),
                           t_k6.banded_dtw_plain(x, y, r))
        assert torch.equal(t_k6.banded_dtw_gram(x[:3], y, r),
                           t_k6.banded_dtw_gram_plain(x[:3], y, r))
