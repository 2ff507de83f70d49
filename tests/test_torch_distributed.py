"""PyTorch port, the multi-device jobs on the CPU: ``launch/gram.py``
(``gram_job``, ``knn_job``, ``run``), ``launch/cluster.py``
(``cluster_job``, ``run``), ``launch/mesh.py`` and the distributed path of
``launch/shard_index.ShardedSearch``.

As one rank (no process group) each job is held against the reference's
job on ``make_host_mesh(1, 1)`` at the reference tests' sizes
(``tests/test_launch.py``, ``tests/test_search.py``,
``tests/test_cluster.py``), on the same numpy inputs: Gram values within
rtol = atol = 1e-5 (the two packages' DPs round differently in the last
bits), neighbours equal, centroids within atol 5e-4 and final losses
within rtol 1e-5 (``tests/test_torch_cluster.py``'s limits for the same
barycenter steps). Then one launch of two ``gloo`` ranks on the CPU runs
the sharded search (its distributed path), the Gram, the 1-NN and the
cluster jobs, each of which must equal the one-rank run (the same script
in a fresh process without a group) bit for bit.
"""
import inspect
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.launch import cluster as j_cluster
from repro.launch import gram as j_gram
from repro.launch.mesh import make_host_mesh
from repro_torch.core.engine import engine_for
from repro_torch.launch import cluster as t_cluster
from repro_torch.launch import gram as t_gram
from repro_torch.launch import mesh

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- one rank
@pytest.mark.parametrize("kind", ("dtw", "spdtw", "sp_krdtw"))
def test_gram_job_one_rank_equals_reference(kind):
    got = t_gram.run(n=8, t=16, kind=kind, device="cpu")
    want = j_gram.run(n=8, t=16, kind=kind)
    assert got.shape == want.shape == (8, 8)
    np.testing.assert_allclose(got, want, **TOL)
    if kind != "sp_krdtw":
        assert np.allclose(np.diag(got), 0, atol=1e-4)


def test_knn_job_one_rank_equals_reference():
    nn, dist = t_gram.run(n=8, t=16, kind="spdtw", mode="knn", device="cpu")
    jnn, jdist = j_gram.run(n=8, t=16, kind="spdtw", mode="knn")
    assert nn.dtype == np.int32 and np.array_equal(nn, np.asarray(jnn))
    assert (nn == np.arange(8)).all()
    np.testing.assert_allclose(dist, np.asarray(jdist), **TOL)
    with pytest.raises(ValueError, match="admissible"):
        t_gram.knn_job(t_gram.corridor(16), kind="sp_krdtw", device="cpu")


def test_cluster_job_one_rank_equals_reference():
    """The reference's unsharded-equality case (t 16, n 12, k 2, 6
    steps, a radius-2 corridor) and its host-mesh run (k 4, n 16, 8
    steps)."""
    t, n, k = 16, 12, 2
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, t)).astype(np.float32)
    w = np.abs(np.arange(t)[:, None] - np.arange(t)[None]) <= 2
    w = w.astype(np.float32)
    A = (np.arange(n) % k == np.arange(k)[:, None]).astype(np.float32)
    Z0 = rng.normal(size=(k, t)).astype(np.float32)
    Zt, Lt = t_cluster.cluster_job(w, 0.1, steps=6, device="cpu")(Z0, X, A)
    mesh1 = make_host_mesh(1, 1)
    with compat.set_mesh(mesh1):
        Zj, Lj = j_cluster.cluster_job(mesh1, w, 0.1, steps=6)(
            jnp.asarray(Z0), jnp.asarray(X), jnp.asarray(A))
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=5e-4)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-5)
    Z, loss = t_cluster.run(k=4, n=16, t=16, steps=8, device="cpu")
    jZ, jloss = j_cluster.run(k=4, n=16, t=16, steps=8)
    assert Z.shape == (4, 16) and np.isfinite(Z).all()
    np.testing.assert_allclose(Z, np.asarray(jZ), atol=5e-4)
    np.testing.assert_allclose(loss, np.asarray(jloss), rtol=1e-5)


def test_engine_for_takes_the_support_rule_and_device():
    w = t_gram.corridor(16)
    for family, support in (("spdtw", "learned"), ("sp_krdtw", "learned"),
                            ("dtw", "dense"), ("krdtw_sc", "dense")):
        eng = engine_for(family, weights=w if support == "learned" else None,
                         T=16, device="cpu")
        assert eng.spec.support == support and eng.corpus is None
        assert eng.device == torch.device("cpu")
    eng = engine_for("spdtw", weights=w, device="cpu")
    assert np.array_equal(eng.weights.numpy(), w) and eng.T == 16


def test_mesh_refuses_what_it_cannot_place(monkeypatch):
    """nccl takes one card per rank and never steps down to gloo; a job
    outside the launcher has no group to join; gloo ranks compute where
    they are told."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n_cards + 1))
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh.rank_device("nccl")
    with pytest.raises(ValueError, match="backend"):
        mesh.rank_device("mpi")
    assert mesh.rank_device("gloo", "cpu") == torch.device("cpu")
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        mesh.init_group("gloo", "cpu")
    assert mesh.world() == (0, 1)
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_gather_cat(t) is t and mesh.gather_objects(3) == [3]
    with pytest.raises(ValueError, match="divide"):
        with monkeypatch.context() as m:
            m.setattr(mesh, "world", lambda: (0, 3))
            t_gram.stripe(t)


# ------------------------------------------------------- two gloo ranks
def _corpus():
    rng = np.random.default_rng(0)
    C = rng.normal(size=(23, 32)).astype(np.float32)
    Q = np.concatenate([C[:1], C[[5, 17]] + 0.05 * rng.normal(size=(2, 32)),
                        C[22:]]).astype(np.float32)
    return C, Q


# every job at the one-rank tests' sizes; the sharded search on a ragged
# 23-row corpus (shard 1 pads with a copy of row 0) with k 1, 3 and 12 (at
# 12 shard 1's 11 rows fill the common width), and ``search.run`` with
# --shards 2. Launched as two ranks it takes the distributed path; run
# alone, with no group, it is the one-rank run (the host path), which
# holds the merged answers to the unsharded cascade and the Gram.
WORKER = """
import sys
import numpy as np
import torch
sys.path.insert(0, {src!r})
from repro_torch.core import learn_sparse_paths
from repro_torch.core.engine import fit
from repro_torch.core.spec import MeasureSpec
from repro_torch.launch import cluster, gram, mesh, search
from repro_torch.launch.shard_index import ShardedSearch

{corpus_src}
if mesh.launched():
    mesh.init_group("gloo", "cpu")
rank, size = mesh.world()
path = "dist" if size > 1 else "host"
out = {{}}
for kind in ("spdtw", "sp_krdtw"):
    out["G_" + kind] = gram.run(n=8, t=16, kind=kind, device="cpu")
out["nn"], out["dist"] = gram.run(n=8, t=16, kind="spdtw", mode="knn",
                                  device="cpu")
out["Z"], out["loss"] = cluster.run(k=4, n=16, t=16, steps=8,
                                    device="cpu")
C, Q = _corpus()
sp = learn_sparse_paths(torch.as_tensor(C[:12]), theta=6.0)
eng = fit(MeasureSpec("spdtw"), C, sp=sp, device="cpu")
D = eng.gram(Q)
for k in (1, 3, 12):
    sh = ShardedSearch(eng, 2, k=k)
    assert sh.path == path, sh.path
    g, d = sh.knn(Q)
    if size == 1 and k == 1:
        nn0, d0 = eng.knn(Q)
        assert torch.equal(g, nn0) and torch.equal(d, d0)
        assert g[0] == 0    # the query that is row 0 finds row 0
    elif size == 1:
        ids = torch.sort(D, dim=1, stable=True).indices[:, :k]
        assert torch.equal(g.long(), ids) and torch.equal(d, D.gather(1, ids))
    out[f"g{{k}}"], out[f"d{{k}}"] = g.numpy(), d.numpy()
res = search.run(dataset="CBF", n_queries=8, batch=4, n_train=16, T=24,
                 n_sp_train=8, seed=1, shards=2, check=True, device="cpu")
assert res["stats"]["shard_balance"]["path"] == path
out["search_nn"], out["search_dist"] = res["nn"], res["dist"]
np.savez({out!r} + f"/w{{size}}r{{rank}}.npz", **out)
mesh.destroy_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_one_rank(tmp_path):
    """Two gloo ranks and one process without a group run the worker side
    by side, each single-threaded in a fresh interpreter; every array of
    each rank equals the one-rank run's bit for bit."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(src=str(ROOT / "src"),
                                    corpus_src=inspect.getsource(_corpus),
                                    out=str(tmp_path)))
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    base["OMP_NUM_THREADS"] = "1"
    group = dict(base, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    envs = [dict(group, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in envs + [base]]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    want = np.load(tmp_path / "w1r0.npz")
    for r in range(2):
        got = np.load(tmp_path / f"w2r{r}.npz")
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), (r, k)
