"""Shared by the multi-rank LM training tests of the PyTorch port: ranks
started as subprocesses (two gloo ranks on the CPU, as
``tests/test_torch_distributed.py`` starts them), the reference on forced
host devices in a subprocess (``XLA_FLAGS``, as ``tests/test_scenarios.py``
runs it), and the checkpoints both sides read and write.

Every rank runs single-threaded in a fresh interpreter; a launch fails
its test when any process exits nonzero or passes its time limit.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
TIMEOUT_S = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def start_ranks(argv, n: int = 2):
    """``n`` gloo ranks of ``python argv...`` (a group on localhost);
    returns the processes."""
    env = _base_env()
    group = dict(env, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    return [subprocess.Popen([sys.executable, *map(str, argv)], cwd=ROOT,
                             env=dict(group, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def start_forced(argv, devices: int = 2):
    """``python argv...`` with the reference on ``devices`` forced host
    devices."""
    env = dict(_base_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, *map(str, argv)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def start_launcher(args, n: int = 2):
    """``python -m torch.distributed.run --standalone`` with ``n`` ranks
    of the module call ``args`` (``-m`` and its arguments)."""
    env = _base_env()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "--", *map(str, args)]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_all(procs, timeout: int = TIMEOUT_S):
    """Every process's output; fails the test on a nonzero exit (all are
    killed at the time limit)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def worker(job, *args):
    """The argv of one job of ``torch_dp_worker.py``."""
    return [WORKER, job, *args]


def read_leaves(directory, step):
    """{manifest path: float32 array (bfloat16 bits widened exactly)} of
    one checkpoint, read with numpy alone."""
    base = Path(directory) / f"step_{step:08d}"
    man = json.loads((base / "manifest.json").read_text())
    out = {}
    for leaf in man["leaves"]:
        if leaf.get("none"):
            continue
        a = np.load(base / leaf["file"])
        if leaf["dtype"] == "bfloat16":
            a = (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
                 << 16).view(np.float32)
        out[leaf["path"]] = np.asarray(a, np.float32)
    return out


def manifest_hashes(directory, step):
    """{path: sha256} of one checkpoint's leaves."""
    base = Path(directory) / f"step_{step:08d}"
    man = json.loads((base / "manifest.json").read_text())
    return {leaf["path"]: leaf.get("sha256") for leaf in man["leaves"]}


def worst_frac(got: dict, want: dict, prefix: str = ""):
    """max over the leaves under ``prefix`` of max |got - want| / RMS(want),
    with the worst leaf's path; leaves whose RMS is 0 must be equal."""
    worst, at = 0.0, None
    keys = [k for k in want if k.startswith(prefix)]
    assert keys, prefix
    for k in keys:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        rms = float(np.sqrt(np.mean(w * w)))
        if rms == 0.0:
            assert np.array_equal(g, w), k
            continue
        r = float(np.max(np.abs(g - w))) / rms
        if r > worst:
            worst, at = r, k
    return worst, at


# ------------------------------------------- the data-parallel LM checks
# the two-rank float32 twin's gradients against the reference on one
# device, a fraction of each leaf's RMS: the one-rank port's measured
# worst (jamba-v0.1-52b, tests/torch_train_helpers.py)
GRAD_FRAC_DP = 1.2e-5
DP_STEPS = (100, 101, 102, 111, 112, 120, 121, 122, 130, 140, 141, 150,
            151)


def dp_run(arch, d, microbatches, others=()):
    """The reference's weights of ``arch`` (``TrainCase``) written for the
    ranks, one launch of two ranks of the worker's ``dp`` job (with the
    processes ``others`` already started beside it), and meanwhile the
    reference's one-device steps at ``microbatches``. Returns the case,
    the directory, the reference steps and the ranks' checkpoints."""
    from repro_torch.train.checkpoint import save_checkpoint
    from torch_train_helpers import TrainCase
    case = TrainCase.cached(arch)
    w = d / "weights"
    save_checkpoint(str(w), 0, {"params": case.port_params("f32")})
    save_checkpoint(str(w), 1, {"params": case.port_params("bf16")})
    procs = start_ranks(worker("dp", arch, w, d / "out")) + list(others)
    steps = {m: case.reference_step(m) for m in microbatches}
    wait_all(procs)
    return {"case": case, "dir": d, "steps": steps,
            "out": {s: read_leaves(d / "out", s) for s in DP_STEPS}}


def under(out: dict, prefix: str) -> dict:
    """The leaves of a checkpoint under ``prefix``, the prefix cut."""
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def reference_leaves(tree) -> dict:
    """{checkpoint path: float32 array} of a reference pytree."""
    import jax
    from repro_torch.train.checkpoint import _leaf_paths
    return {p: np.asarray(a, np.float32) for p, a in _leaf_paths(
        jax.tree.map(np.asarray, tree))}


def check_dp_grads(run, kind, frac=None):
    """The two ranks' synced gradients (float32 twin "f32": within
    ``frac`` of each leaf's RMS; "bf16": the one-rank parity limits)
    against the reference's one-device ``value_and_grad``."""
    from torch_train_helpers import (GRAD_FRAC_BF16, GRAD_RTOL_BF16,
                                     LOSS_ATOL_BF16, LOSS_ATOL_F32)
    loss, grads = run["case"].ref[kind]
    got = run["out"][101 if kind == "f32" else 100]
    atol = LOSS_ATOL_F32 if kind == "f32" else LOSS_ATOL_BF16
    assert abs(float(got[".loss"]) - float(loss)) <= atol
    want = reference_leaves(grads)
    port = under(got, ".grads")
    if kind == "f32":
        worst, at = worst_frac(port, want)
        assert worst <= frac, (worst, at)
        return
    for k, w in want.items():
        rms = float(np.sqrt(np.mean(w * w)))
        excess = float(np.max(np.abs(port[k] - w) - GRAD_RTOL_BF16
                              * np.abs(w)))
        assert excess <= GRAD_FRAC_BF16 * rms, (k, excess, rms)


def check_dp_step(got, want, run, eps_band=0.0):
    """One two-rank step (loss, grad norm, new parameters) against the
    reference's one-device step on the float32 twin, as
    ``torch_train_helpers.check_step`` holds the one-rank step."""
    from torch_train_helpers import (GNORM_RTOL, LOSS_ATOL_F32, LR,
                                     PARAM_ATOL)
    wl, wg, wp = want
    assert abs(float(got[".loss"]) - wl) <= LOSS_ATOL_F32
    assert abs(float(got[".gnorm"]) - wg) <= GNORM_RTOL * wg
    port = under(got, ".params")
    grads = reference_leaves(run["case"].ref["f32"][1])
    for k, w in reference_leaves(wp).items():
        atol = np.where(np.abs(grads[k]) < eps_band, 2 * LR[0], PARAM_ATOL)
        np.testing.assert_array_less(np.abs(port[k] - w), atol + 1e-30,
                                     err_msg=k)


# ------------------------------------- the tensor-parallel (model) checks
# the port's float32 gradients over the model ranks against the
# reference's, a fraction of each leaf's RMS (the reference's own forced
# (1, 2) mesh reads within 1.41e-5 of its one device, gemma3-4b)
GRAD_FRAC_TP = 2e-5
TP_BASE = 300


def reference_weights(directory, archs):
    """The reference's seed-3 weights of each reduced architecture (as
    ``torch_train_helpers.TrainCase`` draws them, shared with it) written
    for the ranks under ``directory/ARCH``: the float32 twin at step 0,
    bf16 at step 1. Returns {arch: the reference's bf16 parameters}."""
    import jax
    import jax.numpy as jnp
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.train.checkpoint import save_checkpoint
    from torch_train_helpers import reference_params
    out = {}
    for arch in archs:
        params = reference_params(arch)
        f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        d = str(Path(directory) / arch)
        save_checkpoint(d, 0, {"params": lm_params_from_reference(
            f32, device="cpu")})
        save_checkpoint(d, 1, {"params": lm_params_from_reference(
            params, device="cpu")})
        out[arch] = params
    return out


def reference_f32_grads(arch, params):
    """The reference's one-device float32-twin loss and gradients of
    ``train_loss`` on ``TokenPipeline(cfg, 4, 16, seed=1)``'s batch (the
    ones ``TrainCase`` holds, shared with it), as {checkpoint path:
    array} with ".loss"."""
    from torch_train_helpers import reference_grads
    loss, g = reference_grads(arch, "f32", params)
    out = {".grads" + k: v for k, v in reference_leaves(g).items()}
    out[".loss"] = np.asarray(loss, np.float32)
    return out


def tp_run(d, cases, shape="1,2", forced=False):
    """The cases' float32 gradients on the ranks of the layout ``shape``
    (one launch of the worker's ``tp`` job), against the reference: on
    one device in this process meanwhile, or (``forced``) on a forced
    mesh of that shape in a subprocess. Returns {"got": [...], "want":
    [...], "replicated": the ranks' bit-equality flags}."""
    archs = sorted({c.split(":")[0] for c in cases})
    w = d / "weights"
    params = reference_weights(w, archs)
    n = int(np.prod([int(x) for x in shape.split(",")]))
    procs = start_ranks(worker("tp", shape, w, d / "out", TP_BASE, *cases),
                        n=n)
    if forced:
        procs.append(start_forced(["tests/torch_dp_reference.py", "grads",
                                   shape, w, d / "ref", TP_BASE, *cases],
                                  devices=n))
        wait_all(procs)
        want = [read_leaves(d / "ref", TP_BASE + i)
                for i in range(len(cases))]
    else:
        one = {a: reference_f32_grads(a, params[a]) for a in archs}
        wait_all(procs)
        want = [one[c.split(":")[0]] for c in cases]
    got = [read_leaves(d / "out", TP_BASE + i) for i in range(len(cases))]
    flags = json.loads((d / "out" / f"replicated_{TP_BASE}.json"
                        ).read_text())
    return {"got": got, "want": want, "replicated": flags, "cases": cases}


def check_tp_grads(run, i):
    """Case i's loss and every gathered gradient against the reference's;
    returns the worst |error| / RMS."""
    from torch_train_helpers import LOSS_ATOL_F32
    got, want = run["got"][i], run["want"][i]
    assert abs(float(got[".loss"]) - float(want[".loss"])) <= LOSS_ATOL_F32
    worst, at = worst_frac(under(got, ".grads"), under(want, ".grads"))
    assert worst <= GRAD_FRAC_TP, (run["cases"][i], worst, at)
    return worst
