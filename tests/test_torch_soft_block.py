"""PyTorch port, the soft-SP-DTW tile engines (``repro_torch.kernels.
soft_block``) against the reference's JAX scan twins on the same numpy
inputs, and — on a machine with a CUDA card only — K7 / K8 / K9 against
their plain versions.

Limits: values and stash rtol 1e-5; gradients and E blocks rtol 1e-4 with
an absolute floor of 1e-4 of the largest reference entry (f32 sums; at
d > 1 XLA's CPU compiler also contracts the channel sum into fused
multiply-adds, ROADMAP.md section C). In float64 the Functions pass
``torch.autograd.gradcheck``, and the block path's weight gradient equals
the reference's dense gradient (E is zero outside the support).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import block_sparse_from_arrays
from repro_torch.core.occupancy import block_sparsify
from repro_torch.kernels import _build
from repro_torch.kernels import backends as t_bk
from repro_torch.kernels import soft_block as t_sb

VAL_RTOL = 1e-5
GRAD_RTOL = 1e-4
GAMMA = 0.3


@pytest.fixture(scope="module")
def J():
    """The reference's modules (they need jax; the card-only tests at the
    end do not use them)."""
    jax = pytest.importorskip("jax")
    from repro.core import occupancy
    from repro.kernels import soft_block
    return SimpleNamespace(jax=jax, jnp=jax.numpy, occ=occupancy,
                           sb=soft_block)


def _weights(T, seed, corner="reachable"):
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    sup = (np.abs(i[:, None] - i[None, :]) <= 3) | (rng.random((T, T)) < 0.1)
    w = np.where(sup, rng.uniform(0.5, 2.0, (T, T)), 0.0).astype(np.float32)
    if corner == "cell":          # the result tile active, its cell masked
        w[-1, -1] = w[-2, -1] = w[-1, -2] = 0.0
    return w


def _plans(J, w, tile):
    jb = J.occ.block_sparsify(w, tile=tile)
    tb = block_sparse_from_arrays(dict(tile=jb.tile, active=jb.active,
                                       slot=jb.slot, blocks=jb.blocks,
                                       T=jb.T, meta=jb.plan()))
    return jb, tb


def _series(rng, n, T, d):
    shape = (n, T) if d == 1 else (n, T, d)
    return rng.normal(size=shape).astype(np.float32)


def _vals(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=VAL_RTOL, atol=0)


def _grads(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * scale)


@pytest.fixture
def launches_unchanged():
    before = _build.launch_counts()
    yield
    assert _build.launch_counts() == before, "a CPU tensor launched a kernel"


@pytest.mark.parametrize("corner", ["reachable", "cell"])
def test_reverse_plan_equals_reference(J, corner):
    w = _weights(40, 3, corner)
    jb, tb = _plans(J, w, 8)
    T_tiles = jb.T // 8
    for T_orig in (40, 37, 25):
        g_out = t_sb.result_tile_step(tb.plan(), 8, T_orig)
        assert g_out >= 0
        want = jb.reverse_plan(g_out)
        got = tb.reverse_plan(g_out)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tb.reverse_plan(g_out) is got          # cached
    assert T_tiles == tb.active.shape[0]


@pytest.mark.parametrize("S,d,T,T_orig,corner", [
    (8, 1, 30, 30, "reachable"), (8, 3, 30, 27, "reachable"),
    (16, 1, 40, 37, "reachable"), (8, 1, 30, 30, "cell")])
def test_scan_twins_match_reference(J, S, d, T, T_orig, corner,
                                    launches_unchanged):
    jnp = J.jnp
    rng = np.random.default_rng(S + d + T_orig)
    w = _weights(T, S + d, corner)
    jb, tb = _plans(J, w, S)
    A, B = _series(rng, 3, T_orig, d), _series(rng, 4, T_orig, d)
    jA, jB = jnp.asarray(A), jnp.asarray(B)
    tA, tB = torch.as_tensor(A), torch.as_tensor(B)
    # K7's plain versions
    _vals(t_sb.gram_soft_spdtw_scan(tA, tB, tb, GAMMA),
          J.sb.gram_soft_spdtw_scan(jA, jB, jb, GAMMA, T_orig=T_orig))
    _vals(t_sb.soft_spdtw_paired_scan(tA, tB[:3], tb, GAMMA),
          J.sb.soft_spdtw_paired_scan(jA, jB[:3], jb, GAMMA, T_orig=T_orig))
    # K8's: values and the stash
    jv, jst = J.sb.gram_soft_fwd_stash(jA, jB, jb, GAMMA, T_orig=T_orig)
    tv, tst = t_sb.gram_soft_fwd_stash(tA, tB, tb, GAMMA, block_a=2)
    _vals(tv, jv)
    _vals(tst, jst)
    pv, pst = t_sb.soft_spdtw_fwd_stash(tA, tB[:3], tb, GAMMA)
    jpv, jpst = J.sb.soft_spdtw_fwd_stash(jA, jB[:3], jb, GAMMA,
                                          T_orig=T_orig)
    _vals(pv, jpv)
    _vals(pst, jpst)
    # K9's: gradients from the reference's own stash
    gbar = rng.normal(size=(3, 4)).astype(np.float32) * \
        (np.asarray(jv) < 1e29)
    jg = J.sb.gram_soft_bwd_scan(jA, jB, jb, GAMMA, jst, jnp.asarray(gbar),
                                 T_orig=T_orig)
    tg = t_sb.gram_soft_bwd_scan(tA, tB, tb, GAMMA,
                                 torch.as_tensor(np.array(jst)),
                                 torch.as_tensor(gbar), block_a=2)
    for got, want in zip(tg, jg):
        _grads(got, want)
    pbar = gbar[:, 0]
    jg = J.sb.soft_spdtw_bwd_block(jA, jB[:3], jb, GAMMA, jpst,
                                   jnp.asarray(pbar), T_orig=T_orig)
    tg = t_sb.soft_spdtw_bwd_block(tA, tB[:3], tb, GAMMA, pst,
                                   torch.as_tensor(pbar))
    for got, want in zip(tg, jg):
        _grads(got, want)
    # E through the block-sparse reverse sweep
    _grads(t_sb.soft_alignment_pairs(tA, tB[:3], tb, GAMMA),
           J.sb.soft_alignment_pairs(jA, jB[:3], jb, GAMMA, T_orig=T_orig))


def test_unreachable_corner_tile(J, launches_unchanged):
    T = 24
    w = np.zeros((T, T), np.float32)
    w[:8, :8] = 1.0                     # the corner tile never active
    jb, tb = _plans(J, w, 8)
    rng = np.random.default_rng(4)
    x, y = _series(rng, 3, T, 1), _series(rng, 3, T, 1)
    want = np.asarray(J.sb.soft_spdtw_paired_scan(
        J.jnp.asarray(x), J.jnp.asarray(y), jb, GAMMA))
    xt = torch.as_tensor(x).requires_grad_()
    wt = torch.as_tensor(w).requires_grad_()
    v = t_sb.soft_spdtw_batch(xt, torch.as_tensor(y), wt, GAMMA)
    assert bool((v >= 1e29).all()) and bool((want >= 1e29).all())
    v.sum().backward()
    assert float(xt.grad.abs().max()) == 0.0
    assert float(wt.grad.abs().max()) == 0.0


@pytest.mark.parametrize("d", [1, 2])
def test_functions_pass_gradcheck_in_float64(d, launches_unchanged):
    T = 12
    w = torch.as_tensor(_weights(T, 7), dtype=torch.float64)
    rng = np.random.default_rng(d)
    shape = (lambda n: (n, T)) if d == 1 else (lambda n: (n, T, d))
    x = torch.tensor(rng.normal(size=shape(2)), requires_grad=True)
    y = torch.tensor(rng.normal(size=shape(2)), requires_grad=True)
    B = torch.tensor(rng.normal(size=shape(3)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: t_sb.soft_spdtw_batch(a, b, w, GAMMA), (x, y))
    assert torch.autograd.gradcheck(
        lambda a, b: t_sb.soft_spdtw_gram_batch(a, b, w, GAMMA), (x, B))


def test_weight_gradients_equal_reference_dense_gradients(J,
                                                          launches_unchanged):
    jax, jnp = J.jax, J.jnp
    T = 16
    w = _weights(T, 9)
    rng = np.random.default_rng(10)
    A, B = _series(rng, 2, T, 1), _series(rng, 3, T, 1)
    gbar = rng.normal(size=(2, 3)).astype(np.float32)

    def f(ww):      # traced weights: the reference's dense route
        G = J.sb.soft_spdtw_gram_batch(jnp.asarray(A), jnp.asarray(B), ww,
                                       GAMMA)
        return jnp.sum(G * gbar)

    want = np.asarray(jax.grad(f)(jnp.asarray(w)))
    wt = torch.as_tensor(w).requires_grad_()
    G = t_sb.soft_spdtw_gram_batch(torch.as_tensor(A), torch.as_tensor(B),
                                   wt, GAMMA)
    (G * torch.as_tensor(gbar)).sum().backward()
    _grads(wt.grad, want)
    assert float(wt.grad[torch.as_tensor(w) == 0].abs().max()) == 0.0
    # and the forward without grad is the stash-free route, same values
    with torch.no_grad():
        G0 = t_sb.soft_spdtw_gram_batch(torch.as_tensor(A),
                                        torch.as_tensor(B), wt, GAMMA)
    assert torch.equal(G0, G.detach())


def _band_weights(T, radius=3):
    i = np.arange(T)
    return (np.abs(i[:, None] - i[None, :]) <= radius).astype(np.float32)


def test_long_series_run_on_a_32_tile_recut(J, launches_unchanged):
    """At T > 256 ``default_tile`` picks 64; the soft entries walk the
    same support re-cut into 32-tiles (the edges K7-K9 are built for),
    and values and gradients equal the reference's on its 64-tile
    plan."""
    jax, jnp = J.jax, J.jnp
    T = 300
    w = _band_weights(T)
    plan = t_bk.resolve_plan(weights=w)
    cut = t_sb.soft_plan(plan)
    assert (plan.tile, cut.tile) == (64, 32)
    assert t_sb.soft_plan(plan) is cut and t_sb.soft_plan(cut) is cut
    np.testing.assert_array_equal(t_bk.densify(cut)[:T, :T],
                                  t_bk.densify(plan)[:T, :T])
    rng = np.random.default_rng(11)
    x, y = _series(rng, 2, T, 1), _series(rng, 2, T, 1)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(J.sb.soft_spdtw_batch(a, jnp.asarray(y),
                                                jnp.asarray(w), GAMMA)))(
        jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    v = t_sb.soft_spdtw_batch(xt, torch.as_tensor(y), w, GAMMA)
    v.sum().backward()
    _vals(v.sum().detach(), jv)
    _grads(xt.grad, jg)


def test_engine_plan_reaches_the_soft_entries(monkeypatch,
                                              launches_unchanged):
    """An engine fit with ``spec.tile`` hands its plan to soft_pairs,
    grad, soft_gram and barycenter, not the default tile's."""
    from repro_torch.core.engine import fit
    from repro_torch.core.occupancy import default_tile
    from repro_torch.core.spec import MeasureSpec
    T = 24
    X = _series(np.random.default_rng(12), 6, T, 1)
    eng = fit(MeasureSpec("spdtw", theta=2.0, weight_gamma=0.5, tile=16),
              X, device="cpu")
    assert eng.bsp.tile == 16 != default_tile(T)
    seen = []
    for name in ("soft_fwd_stash_block", "soft_spdtw_paired_scan",
                 "gram_soft_spdtw_scan"):
        real = getattr(t_sb, name)

        def spy(x, y, bsp, *a, _real=real, **k):
            seen.append(bsp)
            return _real(x, y, bsp, *a, **k)
        monkeypatch.setattr(t_sb, name, spy)
    x = torch.as_tensor(X[:2])
    with torch.no_grad():
        eng.soft_pairs(x, x.flip(0))
        eng.soft_gram(x)
    eng.grad(x, x.flip(0))
    eng.barycenter(steps=1)
    assert len(seen) == 4 and all(b is eng.bsp for b in seen)


def test_backends_differentiate_on_both_devices():
    cuda = torch.device("cuda")
    cap = (t_bk.DIFFERENTIABLE,)
    assert t_bk.resolve("auto", device="cpu", require=cap).name == "scan"
    assert t_bk.resolve("auto", device=cuda, require=cap).name == "cuda"
    assert t_bk.get_backend("cuda").fallback is None
    with pytest.raises(ValueError):
        t_bk.resolve("dense", device="cpu", require=(t_bk.DIFFERENTIABLE,))


# ------------------------------------------------------ card-only checks
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,T,T_orig", [(8, 1, 40, 40), (16, 1, 70, 67),
                                          (16, 3, 70, 70)])
def test_soft_kernels_match_plain_versions(cuda_device, S, d, T, T_orig):
    rng = np.random.default_rng(S + d)
    tb = block_sparsify(_weights(T, S + d), tile=S)
    A = torch.as_tensor(_series(rng, 5, T_orig, d), device=cuda_device)
    B = torch.as_tensor(_series(rng, 7, T_orig, d), device=cuda_device)
    before = _build.launch_counts()
    G = t_sb.gram_soft_spdtw_block(A, B, tb, GAMMA)
    Gp = t_sb.gram_soft_spdtw_scan(A, B, tb, GAMMA)
    torch.testing.assert_close(G, Gp, rtol=VAL_RTOL, atol=0)
    G8, L8 = t_sb.soft_fwd_stash_block(A, B, tb, GAMMA, gram=True)
    G8p, L8p = t_sb.gram_soft_fwd_stash(A, B, tb, GAMMA)
    assert torch.equal(G8, G)
    torch.testing.assert_close(L8, L8p, rtol=VAL_RTOL, atol=0)
    gbar = torch.as_tensor(rng.normal(size=(5, 7)).astype(np.float32),
                           device=cuda_device)
    got = t_sb.soft_bwd_block(A, B, tb, GAMMA, L8, gbar, gram=True)
    want = t_sb.gram_soft_bwd_scan(A, B, tb, GAMMA, L8p, gbar)
    for g, w_ in zip(got, want):
        scale = float(w_.abs().max())
        torch.testing.assert_close(g, w_, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale)
    P, Q = t_sb.soft_fwd_stash_block(A, B[:5], tb, GAMMA, gram=False)
    assert torch.equal(P, torch.diagonal(G[:, :5]))
    got = t_sb.soft_bwd_block(A, B[:5], tb, GAMMA, Q, gbar[:, 0],
                              gram=False)
    want = t_sb.soft_spdtw_bwd_block(A, B[:5], tb, GAMMA, Q, gbar[:, 0])
    for g, w_ in zip(got, want):
        scale = float(w_.abs().max())
        torch.testing.assert_close(g, w_, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale)
    after = _build.launch_counts()
    assert after["soft_tiles_fwd"] == before["soft_tiles_fwd"] + 1
    assert after["soft_tiles_stash"] == before["soft_tiles_stash"] + 2
    assert after["soft_tiles_bwd"] == before["soft_tiles_bwd"] + 2


@pytest.mark.cuda
def test_soft_wrappers_never_run_a_plain_version_on_cuda(cuda_device,
                                                         monkeypatch):
    """With every plain version patched to fail, the differentiable
    entries on CUDA tensors (multivariate gradients included) run K7 /
    K8 / K9 and nothing else."""
    def fail(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("gram_soft_spdtw_scan", "soft_spdtw_paired_scan",
                 "gram_soft_fwd_stash", "soft_spdtw_fwd_stash",
                 "gram_soft_bwd_scan", "soft_spdtw_bwd_block",
                 "_reverse_tile_scan", "_tile_scan", "soft_tile_sweep",
                 "soft_reverse_tile_sweep"):
        monkeypatch.setattr(t_sb, name, fail)
    rng = np.random.default_rng(0)
    T, d = 40, 3
    w = torch.as_tensor(_weights(T, 1), device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(4, T, d)).astype(np.float32),
                        device=cuda_device).requires_grad_()
    y = torch.as_tensor(rng.normal(size=(4, T, d)).astype(np.float32),
                        device=cuda_device)
    before = _build.launch_counts()
    t_sb.soft_spdtw_batch(x, y, w, GAMMA).sum().backward()
    t_sb.soft_spdtw_gram_batch(x, y, w, GAMMA).sum().backward()
    with torch.no_grad():
        t_sb.soft_spdtw_batch(x, y, w, GAMMA)
        t_sb.soft_spdtw_gram_batch(x, y, w, GAMMA)
    after = _build.launch_counts()
    assert after["soft_tiles_stash"] - before["soft_tiles_stash"] == 2
    assert after["soft_tiles_bwd"] - before["soft_tiles_bwd"] == 2
    assert after["soft_tiles_fwd"] - before["soft_tiles_fwd"] == 2
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_long_series_on_the_card(cuda_device):
    """T = 300 on the default 64-tile plan: the entries run K8 / K9 on the
    32-tile re-cut, and agree with the same call on the CPU."""
    T = 300
    w = _band_weights(T)
    rng = np.random.default_rng(13)
    x, y = _series(rng, 4, T, 1), _series(rng, 4, T, 1)
    out = {}
    for dev in ("cpu", cuda_device):
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        v = t_sb.soft_spdtw_batch(xt, torch.as_tensor(y, device=dev), w,
                                  GAMMA)
        v.sum().backward()
        out[str(dev)] = (v.detach().cpu(), xt.grad.cpu())
    before = _build.launch_counts()
    xt = torch.as_tensor(x, device=cuda_device).requires_grad_()
    t_sb.soft_spdtw_batch(xt, torch.as_tensor(y, device=cuda_device), w,
                          GAMMA).sum().backward()
    after = _build.launch_counts()
    assert after["soft_tiles_stash"] == before["soft_tiles_stash"] + 1
    assert after["soft_tiles_bwd"] == before["soft_tiles_bwd"] + 1
    (vc, gc), (vg, gg) = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(vg, vc, rtol=VAL_RTOL, atol=0)
    torch.testing.assert_close(gg, gc, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(gc.abs().max()))
