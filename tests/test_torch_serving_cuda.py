"""PyTorch port, the serving tier on a CUDA card (on a machine with a card
only): the threaded learner on a CUDA stream of its own, with every batch
served during the refresh equal to the answers of the snapshot that served
it, and the anomaly decisions on the card equal to the exact path and to
the same calls on the CPU. K1 and K2 equal their plain versions bit for
bit, so the card's neighbours, distances and flags must equal the CPU's:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_serving_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SnapshotStore
from repro_torch.core.engine import fit
from repro_torch.core.occupancy import learn_sparse_paths
from repro_torch.core.spec import MeasureSpec
from repro_torch.data import load
from repro_torch.launch.learner import Learner
from repro_torch.launch.scenarios import _inject_outliers
from repro_torch.launch.search import SearchEngine, _make_workload
from repro_torch.monitor import fit_anomaly_scorer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _split(n_train=160, T=64):
    ds = load("TwoPatterns", n_train=n_train, n_test=40, T=T)
    queries = _make_workload(ds, "retrieval", 192, 0)
    return ds, queries


class _StreamRecorder(Learner):
    """A learner that records the stream each of its steps launched on."""

    def step(self):
        self.streams.append(torch.cuda.current_stream().cuda_stream)
        return super().step()


@pytest.mark.cuda
def test_threaded_learner_on_its_own_stream(cuda_device):
    ds, queries = _split()
    n0 = 120
    sp = learn_sparse_paths(torch.as_tensor(ds.X_train[:32],
                                            device=cuda_device), theta=8.0)
    base = fit(MeasureSpec("spdtw"), ds.X_train[:n0],
               labels=ds.y_train[:n0], sp=sp, device=cuda_device)
    store = SnapshotStore(base, keep_history=True)
    serve = SearchEngine(None, refresh=store)
    learner = _StreamRecorder(store, ds.X_train[n0:],
                              labels=ds.y_train[n0:], batch=5)
    learner.streams = []
    served = []
    learner.start()
    try:
        for lo in range(0, len(queries), 16):
            nn, d = serve.search(queries[lo:lo + 16])
            served.append((serve.engine, lo, nn, d))
        learner.join(timeout=300)
    finally:
        learner.stop()
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    assert learner.streams and all(s != default for s in learner.streams)
    versions = [s.version for s in store.history]
    assert versions == list(range(9))
    answers = {}
    for eng, lo, nn, d in served:
        if eng.version not in answers:
            a, b = eng.knn(queries)
            answers[eng.version] = (a.cpu().numpy(), b.cpu().numpy())
        want_nn, want_d = answers[eng.version]
        assert np.array_equal(nn, want_nn[lo:lo + 16])
        assert np.array_equal(d, want_d[lo:lo + 16])
    # the final snapshot equals a fresh fit on the final corpus, and the
    # CPU's answers
    last = store.current().engine
    fresh = fit(last.spec, last.corpus, labels=last.labels, sp=last.sp,
                bsp=last.bsp, T=last.T, device=cuda_device)
    nn_a, d_a = last.knn(queries)
    nn_b, d_b = fresh.knn(queries)
    assert torch.equal(nn_a, nn_b) and torch.equal(d_a, d_b)
    cpu = fit(last.spec, last.corpus.cpu(), labels=last.labels,
              sp=learn_sparse_paths(torch.as_tensor(ds.X_train[:32]),
                                    theta=8.0), device="cpu")
    nn_c, d_c = cpu.knn(queries)
    assert torch.equal(nn_a.cpu(), nn_c) and torch.equal(d_a.cpu(), d_c)


@pytest.mark.cuda
def test_anomaly_decisions_exact_on_the_card(cuda_device):
    ds, queries = _split(n_train=200, T=64)
    queries, _ = _inject_outliers(queries, 0.25, 0)
    sp = learn_sparse_paths(torch.as_tensor(ds.X_train[:32],
                                            device=cuda_device), theta=8.0)
    spec = MeasureSpec("spdtw", theta=8.0, sketch_r=8)
    eng = fit(spec, ds.X_train, labels=ds.y_train, sp=sp,
              device=cuda_device)
    scorer = fit_anomaly_scorer(eng, n_cal=64)
    flags, scores, st = scorer.decide(queries, return_stats=True)
    flags_x, d_exact = scorer.decide_exact(queries)
    assert np.array_equal(flags, flags_x)
    assert np.array_equal(flags_x, d_exact > np.float32(scorer.tau))
    assert st["n_clean_fast"] + st["n_flag_fast"] + st["n_escalated"] \
        == len(queries)
    # the same scorer on the CPU: the same anchors (drawn on the CPU) and
    # K1 / K2 equal to their plain versions, so the same threshold and
    # flags; the scores cancel from squared norms whose float32 sums may
    # round apart in the last bit
    cpu = fit(spec, ds.X_train, labels=ds.y_train,
              sp=learn_sparse_paths(torch.as_tensor(ds.X_train[:32]),
                                    theta=8.0), device="cpu")
    cs = fit_anomaly_scorer(cpu, n_cal=64)
    assert cs.tau == scorer.tau
    cflags, cscores = cs.decide(queries)
    assert np.array_equal(cflags, flags)
    scale = float(cpu.index.sketch.sq.max())
    np.testing.assert_allclose(cscores, scores, rtol=1e-5,
                               atol=1e-6 * scale)
