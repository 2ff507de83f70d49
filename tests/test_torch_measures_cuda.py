"""PyTorch port: the measure layer and the sketch tier on a CUDA card,
against the same calls on the CPU (on a machine with a card only).

``Measure`` routes ``cross`` / ``gram_log`` / ``pair`` / ``logk`` to
K1-K6, ``dedup_by_spdtw`` and ``pairwise`` to K1 / K3, the sketch tier
to K1, K2 and K7. On the CPU, spdtw and the sketch run K1 / K2's plain
versions, so the hard SP-DTW values must be equal bit for bit; dtw and
dtw_sc run the dense core DP there (the reference's evaluator, summing
in another association) and the kernel measures and baselines go
through ``expf`` / ``logf`` and reductions that differ between the CPU
and CUDA builds of PyTorch, so those agree within rel 1e-5. Every
neighbour, kept index and DP count must be equal:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_measures_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.classify import svm_rws_series
from repro_torch.core import make_measure, pairwise, spdtw_pairwise
from repro_torch.core.engine import fit
from repro_torch.core.occupancy import learn_sparse_paths
from repro_torch.core.spec import MeasureSpec
from repro_torch.data import dedup_by_spdtw, load

NAMES = ("corr", "daco", "euclidean", "dtw", "dtw_sc", "krdtw", "spdtw",
         "sp_krdtw", "krdtw_sc")
# computed on the CPU by the plain versions of the kernels the card runs
PLAIN_TWIN = ("spdtw",)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data():
    ds = load("SyntheticControl", n_train=30, n_test=20)
    sp = learn_sparse_paths(torch.as_tensor(ds.X_train), theta=4.0)
    return ds, sp


def _close(got, want, exact):
    got = got.cpu()
    if exact:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_measure_equals_cpu(cuda_device, name):
    ds, sp = _data()
    kw = dict(sp=sp, radius=3, nu=0.5, lags=5)
    mg = make_measure(name, ds.T, device=cuda_device, **kw)
    mc = make_measure(name, ds.T, device="cpu", **kw)
    assert mg.visited_cells == mc.visited_cells
    A, B = ds.X_test, ds.X_train
    exact = name in PLAIN_TWIN
    Cg, Cc = mg.cross(A, B), mc.cross(A, B)
    assert Cg.device.type == "cuda"
    _close(Cg, Cc, exact)
    assert torch.equal(Cg.argmin(1).cpu(), Cc.argmin(1))
    y = B[np.arange(len(A)) % len(B)]
    _close(mg.pair(A, y), mc.pair(A, y), False)
    if mg.is_kernel:
        _close(mg.gram_log(A, B), mc.gram_log(A, B), False)
        _close(mg.logk(A, A), mc.logk(A, A), False)
    if mg.supports_cascade:
        nn_g, _ = mg.knn(A, B)
        nn_c, _ = mc.knn(A, B)
        assert torch.equal(nn_g.cpu(), nn_c)


@pytest.mark.cuda
def test_cuda_pairwise_and_dedup_equal_cpu(cuda_device):
    ds, sp = _data()
    A, B = ds.X_test, ds.X_train
    _close(spdtw_pairwise(A, B, sp.weights, device=cuda_device),
           spdtw_pairwise(A, B, sp.weights, device="cpu"), True)
    for kind in ("dtw", "krdtw", "sp_krdtw"):
        _close(pairwise(A, B, kind, sp=sp, nu=0.5, device=cuda_device),
               pairwise(A, B, kind, sp=sp, nu=0.5, device="cpu"), False)
    X = np.concatenate([ds.X_train, ds.X_train[:8] + 0.01]).astype(
        np.float32)
    xg, ig = dedup_by_spdtw(X, 5.0, sample_for_grid=12, seed=1,
                            device=cuda_device)
    xc, ic = dedup_by_spdtw(X, 5.0, sample_for_grid=12, seed=1,
                            device="cpu")
    assert np.array_equal(ig, ic) and np.array_equal(xg, xc)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", (None, 0.1))
def test_cuda_sketch_equals_cpu(cuda_device, gamma):
    import dataclasses
    from repro_torch.core import sketch as sk
    ds, sp = _data()
    spec = MeasureSpec("spdtw", theta=4.0, sketch_r=8, seed=3)
    eg = fit(spec, ds.X_train, sp=sp, device=cuda_device)
    ec = fit(spec, ds.X_train, sp=sp, device="cpu")
    ig, ic = eg.index, ec.index
    assert torch.equal(ig.sketch.anchors.cpu(), ic.sketch.anchors)
    if gamma is not None:
        ig = dataclasses.replace(ig, sketch=sk.build_sketch_index(
            eg.corpus, ig.sketch.anchors, bsp=ig.bsp, weights=ig.weights,
            gamma=gamma))
        ic = dataclasses.replace(ic, sketch=sk.build_sketch_index(
            ec.corpus, ic.sketch.anchors, bsp=ic.bsp, weights=ic.weights,
            gamma=gamma))
    _close(ig.sketch.sketch, ic.sketch.sketch, gamma is None)
    Q = torch.as_tensor(ds.X_test)
    for top_c in (4, 8, 30):
        nn_g, d_g, st_g = sk.sketch_knn(Q, ig, top_c=top_c,
                                        return_stats=True)
        nn_c, d_c, st_c = sk.sketch_knn(Q, ic, top_c=top_c,
                                        return_stats=True)
        assert torch.equal(nn_g.cpu(), nn_c)
        assert st_g["dp_pairs"] == st_c["dp_pairs"]
        _close(d_g, d_c, True)
    Kg, Ktg = svm_rws_series(ds.X_train, ds.X_test, sp=sp, R=8, seed=3,
                             device=cuda_device)
    Kc, Ktc = svm_rws_series(ds.X_train, ds.X_test, sp=sp, R=8, seed=3,
                             device="cpu")
    _close(Kg, Kc, False)
    _close(Ktg, Ktc, False)
