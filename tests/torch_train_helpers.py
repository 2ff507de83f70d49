"""Shared by the LM training parity tests of the PyTorch port: the
reference's ``train_loss`` gradients and ``make_train_step`` on one
reduced configuration, compiled once per architecture and module, and the
port's same calls on the reference's weights and batches.

"float32 twin" means the same weights cast to float32 on both sides. The
reference casts its embeddings, patches and frames to its module-level
``DTYPE`` (bfloat16); ``float32_reference`` sets that name to float32
while the reference traces, so its twin computes in float32 throughout,
as the port's does (no file of the reference changes).

The parity tests are split over four files so that each stays within
about a minute alone (gemma3-4b's and jamba-v0.1-52b's reference
gradients take ~35 s each to compile here, the other eight a few
seconds); each file holds its architectures to ``check_grads`` and all
but gemma3-12b, jamba-v0.1-52b and deepseek-v2-236b (whose reference
steps add the most compile time) to ``check_step``.

Limits, each set from the readings noted beside it (the ten reduced
models, ``B`` x ``S`` tokens of ``TokenPipeline(seed=1)``, on the CPU):
"""
import contextlib
import fcntl
import os
import tempfile
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import Ctx, build as jbuild
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro.train.data import TokenPipeline as JPipeline
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import cosine_schedule as jcosine
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build, moe
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step, value_and_grad

# float32 twins: the loss within LOSS_ATOL_F32 (measured worst 4.8e-7 on
# losses of ~5.3) and every gradient leaf within GRAD_FRAC_F32 of the
# reference leaf's RMS, rtol 0 (measured worst 1.2e-5, jamba-v0.1-52b)
LOSS_ATOL_F32 = 1e-5
GRAD_FRAC_F32 = 1e-4
# bf16: the loss within LOSS_ATOL_BF16 (measured worst 1.8e-4 without MoE,
# 5.5e-4 with it, jamba-v0.1-52b); dense and Mamba gradients within
# GRAD_RTOL_BF16 (two bf16 ulps) plus GRAD_FRAC_BF16 of the leaf's RMS
# (measured worst 0.072 beyond the rtol, falcon-mamba-7b; the raw worst
# |error| / RMS is 0.29, gemma3-4b's embedding, whose largest entries are
# ~40x its RMS; 0.18 beyond the rtol). MoE gradients are held only on the
# float32 twin: a router near-tie picks other experts under XLA's and
# PyTorch's bf16 products (ROADMAP section C), which moves whole expert
# gradients (jamba-v0.1-52b reached 3.9x the RMS); bf16 MoE is held on the
# loss, and the smallest router gap of the input is recorded
# (``smallest_router_gap``).
LOSS_ATOL_BF16 = 1e-3
GRAD_RTOL_BF16 = 2.0 ** -6
GRAD_FRAC_BF16 = 0.3
# one train step (AdamW(lr=cosine_schedule(1e-3, 1, 4)), float32 twin):
# the loss as above, the grad norm within GNORM_RTOL (measured worst
# 6.1e-7) and every parameter within PARAM_ATOL, 2 % of the step's lr
# (measured worst 7.1e-6, deepseek-v2-lite-16b: Adam's first step is
# lr * g / (|g| + eps), lr * sign(g) wherever |g| >> eps, so the entries
# that differ are those whose |g| is near eps; a gradient entry whose
# sign the two sides' rounding flipped would move by 2 * lr = 2e-3,
# which no entry did)
GNORM_RTOL = 1e-5
PARAM_ATOL = 2e-5
# gemma3-4b's step (``check_step(..., eps_band=EPS_BAND)``): entries whose
# reference gradient lies within EPS_BAND of 0, where Adam's first step
# lr * g / (|g| + eps) follows g's value and not its sign, are held to
# 2 lr, the most two first steps can differ; the rest to PARAM_ATOL
# (reading: one entry of each of two leaves past PARAM_ATOL, 2.1e-5 at
# g 3.4e-10 against the port's 1.2e-10, a gradient difference 2.4e-7 of
# the leaf's RMS; the rest within 6.9e-6)
EPS_BAND = 100 * 1e-8
B, S = 4, 16
LR = (1e-3, 1, 4)              # cosine_schedule(base, warmup, total)
MOE = ("jamba-v0.1-52b", "deepseek-v2-lite-16b", "deepseek-v2-236b")


@contextlib.contextmanager
def float32_reference():
    """The reference's activations in float32 while it traces."""
    old = jlm.DTYPE, jwhisper.DTYPE
    jlm.DTYPE = jwhisper.DTYPE = jnp.float32
    try:
        yield
    finally:
        jlm.DTYPE, jwhisper.DTYPE = old


def to_torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                               else torch.float32)
            for k, v in batch.items()}


def leaves(tree):
    """float32 numpy leaves of a reference or port pytree, in
    ``jax.tree.leaves`` order."""
    return [np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                       else a, np.float32)
            for a in jax.tree.leaves(
                tree, is_leaf=lambda a: isinstance(a, torch.Tensor))]


def worst_frac(got, want, rtol=0.0):
    """max over the leaves of max(|got - want| - rtol |want|) / RMS(want),
    with the index of the worst leaf."""
    worst, at = 0.0, None
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        rms = float(np.sqrt(np.mean(w * w)))
        if rms == 0.0:
            assert np.array_equal(g, w), i
            continue
        r = float(np.max(np.abs(g - w) - rtol * np.abs(w))) / rms
        if r > worst:
            worst, at = r, i
    return worst, at


def f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


# ------------------------------------------------ the shared reference
# The reference's weights, gradients and steps are pure functions of the
# architecture. Under pytest-xdist every worker of one run sees the same
# ``PYTEST_XDIST_TESTRUNUID``; the first worker to need an entry computes
# it under a file lock and writes it beside the others in the temporary
# directory, and every other worker (of any test file) reads it, so each
# reference compile runs once a run, not once a file.

def _shared_dir():
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return None
    d = Path(tempfile.gettempdir()) / f"repro_torch_reference_{uid}"
    d.mkdir(exist_ok=True)
    return d


def _to_numpy(a):
    """A reference array as numpy, bfloat16 as its raw uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def shared(key, compute, bf16=()):
    """``compute()`` (a dict of reference arrays), computed once per test
    run across the xdist workers (``_shared_dir``) and once per process
    without xdist. The entries named in ``bf16`` come back as bfloat16."""
    d = _shared_dir()
    if d is None:
        return compute()
    path = d / f"{key}.npz"
    with open(d / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = {k: _to_numpy(v) for k, v in compute().items()}
            tmp = d / f"{key}.part.npz"
            np.savez(tmp, **out)
            os.replace(tmp, path)
        with np.load(path) as z:
            return {k: (z[k].view(jnp.bfloat16) if k in bf16 else z[k])
                    for k in z.files}


def _tree(treedef, arrays):
    """The pytree ``treedef`` from the entries "0", "1", ... of a shared
    dict."""
    return jax.tree.unflatten(treedef, [jnp.asarray(arrays[str(i)])
                                        for i in range(treedef.num_leaves)])


def reference_params(arch):
    """The reference's seed-3 bf16 weights of the reduced ``arch``."""
    japi = jbuild(jreduced(jget_config(arch)))
    treedef = jax.tree.structure(japi.abstract_params())

    def draw():
        leaves = jax.tree.leaves(japi.init_params(jax.random.PRNGKey(3)))
        return {str(i): a for i, a in enumerate(leaves)}

    got = shared(f"params_{arch}", draw,
                 bf16={str(i) for i in range(treedef.num_leaves)})
    return _tree(treedef, got)


def reference_batch(arch):
    """``TokenPipeline(cfg, B, S, seed=1)``'s first batch (numpy)."""
    return JPipeline(jreduced(jget_config(arch)), B, S, seed=1).batch_at(0)


def reference_grads(arch, kind, params=None):
    """(loss, gradients) of the reference's ``train_loss`` at the seed-3
    weights on ``reference_batch``: ``kind`` "bf16", or "f32", the float32
    twin."""
    japi = jbuild(jreduced(jget_config(arch)))
    treedef = jax.tree.structure(japi.abstract_params())

    def grads():
        p = reference_params(arch) if params is None else params
        jbatch = {k: jnp.asarray(v) for k, v in reference_batch(arch).items()}
        ctx = Ctx(None)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: japi.train_loss(p, b, ctx)))
        if kind == "bf16":
            loss, g = vg(p, jbatch)
        else:
            with float32_reference():
                loss, g = vg(f32(p), jbatch)
        out = {str(i): a for i, a in enumerate(jax.tree.leaves(g))}
        out["loss"] = loss
        return out

    got = shared(f"grads_{kind}_{arch}", grads,
                 bf16={str(i) for i in range(treedef.num_leaves)}
                 if kind == "bf16" else ())
    return jnp.asarray(got["loss"]), _tree(treedef, got)


class TrainCase:
    """One architecture at ``reduced`` size: the reference's weights
    (seed 3) and one ``TokenPipeline(seed=1)`` batch, the reference's loss
    and gradients in bf16 and on the float32 twin, and the port's model
    on the same weights (the reference's parts through ``shared``)."""

    _made: dict = {}

    @classmethod
    def cached(cls, arch):
        """One case per architecture and process, so the tests of a file
        share its reference compiles."""
        if arch not in cls._made:
            cls._made[arch] = cls(arch)
        return cls._made[arch]

    def __init__(self, arch):
        self.arch = arch
        cfg = jreduced(jget_config(arch))
        self.japi = jbuild(cfg)
        self.params = reference_params(arch)
        self.batch = reference_batch(arch)
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.ref = {kind: reference_grads(arch, kind, self.params)
                    for kind in ("bf16", "f32")}
        self.cfg = reduced(get_config(arch))
        self.api = build(self.cfg)
        self.tbatch = to_torch_batch(self.batch)

    def port_params(self, kind):
        p = self.params if kind == "bf16" else f32(self.params)
        return lm_params_from_reference(p, device="cpu")

    def port_value_and_grad(self, kind):
        return value_and_grad(self.api, self.port_params(kind), self.tbatch)

    def reference_step(self, microbatch):
        """The reference's ``make_train_step(api, None, opt,
        microbatch=m, donate=False)`` on the float32 twin: (loss, grad
        norm, new params)."""
        treedef = jax.tree.structure(self.params)

        def run():
            opt = JAdamW(lr=jcosine(*LR))
            with float32_reference():
                # not donated: the float32 twin's master copy is its
                # params' own buffers (astype to the same dtype), which
                # XLA cannot take twice
                step = jmake_train_step(self.japi, None, opt,
                                        microbatch=microbatch,
                                        donate=False)
                p = f32(self.params)
                new, _, met = step(p, opt.init(p), self.jbatch)
                jax.block_until_ready(new)
            out = {str(i): a for i, a in enumerate(jax.tree.leaves(new))}
            out.update(loss=met["loss"], grad_norm=met["grad_norm"])
            return out

        got = shared(f"step_{microbatch}_{self.arch}", run)
        return (float(got["loss"]), float(got["grad_norm"]),
                _tree(treedef, got))

    def port_step(self, microbatch):
        opt = AdamW(lr=cosine_schedule(*LR))
        step = make_train_step(self.api, opt, microbatch=microbatch)
        p = self.port_params("f32")
        new, state, met = step(p, opt.init(p), self.tbatch)
        assert state.step == 1
        return float(met["loss"]), float(met["grad_norm"]), new

    def smallest_router_gap(self):
        """The smallest top-k gap in router probability over the port's
        bf16 forward on this batch: between the k-th and (k+1)-th largest
        probability of any token at any MoE layer (a near-tie there picks
        other experts under XLA)."""
        gaps = []
        router = moe._router

        def logged(x, w_router, top_k):
            probs = torch.softmax((x @ w_router).float(), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            gaps.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
            return router(x, w_router, top_k)

        moe._router = logged
        try:
            with torch.no_grad():
                self.api.train_loss(self.port_params("bf16"), self.tbatch)
        finally:
            moe._router = router
        return min(gaps)


def check_grads(case, kind, record_property=None):
    """The port's loss and gradients against the reference's, ``kind``
    "f32" (the float32 twin) or "bf16" (MoE: the loss, and the smallest
    router gap recorded)."""
    want_loss, want = case.ref[kind]
    loss, got = case.port_value_and_grad(kind)
    atol = LOSS_ATOL_F32 if kind == "f32" else LOSS_ATOL_BF16
    assert abs(float(loss) - float(want_loss)) <= atol, (
        float(loss), float(want_loss))
    if kind == "f32":
        worst, at = worst_frac(got, want)
        assert worst <= GRAD_FRAC_F32, (worst, at)
    elif case.arch in MOE:
        if record_property is not None:
            record_property("smallest_router_gap", case.smallest_router_gap())
    else:
        worst, at = worst_frac(got, want, rtol=GRAD_RTOL_BF16)
        assert worst <= GRAD_FRAC_BF16, (worst, at)


def check_step(case, microbatch, eps_band=0.0):
    """One port ``make_train_step`` against the reference's on the
    float32 twin: loss, grad norm and every new parameter (those whose
    reference gradient is within ``eps_band`` of 0 to 2 lr)."""
    wl, wg, wp = case.reference_step(microbatch)
    gl, gg, gp = case.port_step(microbatch)
    assert abs(gl - wl) <= LOSS_ATOL_F32, (gl, wl)
    assert abs(gg - wg) <= GNORM_RTOL * wg, (gg, wg)
    for i, (g, w, jg) in enumerate(zip(leaves(gp), leaves(wp),
                                       leaves(case.ref["f32"][1]))):
        atol = np.where(np.abs(jg) < eps_band, 2 * LR[0], PARAM_ATOL)
        np.testing.assert_array_less(np.abs(g - w), atol + 1e-30,
                                     err_msg=f"leaf {i}")
