"""PyTorch port: the tile anti-diagonal schedule and the launch geometry
of the soft kernels' two templates ("pairs" and "tiles"); and, on a
machine with a CUDA card only, K7 / K8 / K9 under both templates against
their plain version and each other.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.occupancy import block_sparsify
from repro_torch.kernels import _build
from repro_torch.kernels import soft_block as t_sb
from repro_torch.kernels.backends import series_dim, to_tile_major

GRAD_RTOL = 1e-4
GAMMA = 0.3
SMEM_MAX = 232448
CASES = [(8, 1, 40), (16, 1, 70), (16, 3, 70)]
SUPPORTS = ["random", "corner cell masked", "ragged"]


def _weights(T, seed, support):
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    sup = (np.abs(i[:, None] - i[None, :]) <= 3) | (rng.random((T, T)) < 0.1)
    w = np.where(sup, rng.uniform(0.5, 2.0, (T, T)), 0.0).astype(np.float32)
    if support == "corner cell masked":
        w[-1, -1] = w[-2, -1] = w[-1, -2] = 0.0
    return w


def _case(S, d, T, support):
    """(weights, T_orig, A (3, T_orig[, d]), B (4, ...)) from a seed."""
    w = _weights(T, 10 * S + d, support)
    T_orig = T - 3 if support == "ragged" else T
    rng = np.random.default_rng(S + d + T_orig + SUPPORTS.index(support))
    shape = (lambda n: (n, T_orig)) if d == 1 else (lambda n: (n, T_orig, d))
    return (w, T_orig, rng.normal(size=shape(3)).astype(np.float32),
            rng.normal(size=shape(4)).astype(np.float32))


def _plan_cases():
    """(plan, g_out) pairs: a band plus random tiles, a full grid, a
    ragged result tile."""
    out = []
    for T, S, seed, T_orig in ((70, 8, 1, 70), (128, 16, 2, 128),
                               (300, 32, 3, 290), (64, 8, 4, 50)):
        w = _weights(T, seed, "random") if seed != 2 else \
            np.ones((T, T), np.float32)
        bsp = block_sparsify(w, tile=S)
        out.append((bsp, t_sb.result_tile_step(bsp.plan(), S, T_orig)))
    return out


@pytest.mark.parametrize("reverse", [False, True])
def test_tile_diagonals_schedule(reverse):
    for bsp, g_out in _plan_cases():
        plan = bsp.reverse_plan(g_out) if reverse else bsp.plan()[:g_out + 1]
        order, dptr = t_sb.tile_diagonals(plan, reverse=reverse)
        assert order.dtype == np.int32 and dptr.dtype == np.int32
        # every walked tile once
        assert sorted(order.tolist()) == list(range(plan.shape[0]))
        assert dptr[0] == 0 and dptr[-1] == plan.shape[0]
        assert (np.diff(dptr) > 0).all()
        diag_of = {}
        for q in range(len(dptr) - 1):
            rows = plan[order[dptr[q]:dptr[q + 1]]]
            ti, tj = rows[:, 0], rows[:, 1]
            assert len(set((ti + tj).tolist())) == 1
            assert len(set(ti.tolist())) == len(ti)
            assert len(set(tj.tolist())) == len(tj)
            for a, b in zip(ti, tj):
                diag_of[(int(a), int(b))] = q
        # every dependency on an earlier diagonal: the forward reads the
        # tiles above / left / above-left, the reverse the tiles below /
        # right / below-right
        s = 1 if reverse else -1
        for (a, b), q in diag_of.items():
            for da, db in ((s, 0), (0, s), (s, s)):
                dep = (a + da, b + db)
                if dep in diag_of:
                    assert diag_of[dep] < q
        # per tile row and per tile column, the plan's own order
        flat = plan[order]
        for c in (0, 1):
            for v in np.unique(plan[:, c]):
                want = plan[plan[:, c] == v][:, 1 - c]
                got = flat[flat[:, c] == v][:, 1 - c]
                assert np.array_equal(got, want)


@pytest.mark.parametrize("T", [128, 300, 1024, 2709])
@pytest.mark.parametrize("S", [8, 16, 32])
def test_soft_geometry_fits_the_card(S, T):
    Tp = -(-T // S) * S
    Ti = Tp // S
    for d in (1, 3):
        for backward in (False, True):
            geo = t_sb.soft_geometry(S, d, Tp, 250, Ti, backward=backward,
                                     template="tiles")
            assert geo["template"] == "tiles"
            assert geo["smem_bytes"] <= SMEM_MAX
            G = geo["groups"]
            assert geo["threads"] == G * S <= 512 and G >= 1
            floats = (9 * Tp + 6 * Ti + G * d * S) if backward \
                else 3 * Tp + 2 * Ti
            assert geo["smem_bytes"] == floats * 4
            auto = t_sb.soft_geometry(S, d, Tp, 10 ** 6, Ti,
                                      backward=backward)
            assert auto["smem_bytes"] <= SMEM_MAX
    # the main path: the barycenter launches take the tiles template, the
    # 4000 x 1000 soft Gram the pairs template with y in registers
    small = t_sb.soft_geometry(16, 1, 128, 250, 8)
    assert (small["template"], small["threads"]) == ("tiles", 128)
    big = t_sb.soft_geometry(16, 1, 128, 4_000_000, 8)
    assert (big["template"], big["threads"], big["y_in_registers"]) == \
        ("pairs", 128, True)
    with pytest.raises(ValueError):
        t_sb.soft_geometry(16, 1, 128, 250, 8, template="lanes")


# ------------------------------------------------------ card-only checks
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(S, d, T, support, dev):
    if T == 300:    # the 64-tile default plan, re-cut into 32-tiles
        i = np.arange(T)
        w = (np.abs(i[:, None] - i[None, :]) <= 3).astype(np.float32)
        from repro_torch.kernels import backends as t_bk
        bsp = t_sb.soft_plan(t_bk.resolve_plan(weights=w))
        T_orig = T
        rng = np.random.default_rng(11)
        A = rng.normal(size=(3, T)).astype(np.float32)
        B = rng.normal(size=(4, T)).astype(np.float32)
    else:
        w, T_orig, A, B = _case(S, d, T, support)
        bsp = block_sparsify(w, tile=S)
    return (bsp, T_orig, torch.as_tensor(A, device=dev),
            torch.as_tensor(B, device=dev))


CARD_CASES = [(S, d, T, s) for S, d, T in CASES for s in SUPPORTS] + \
    [(32, 1, 300, "band")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,T,support", CARD_CASES)
def test_forward_templates_equal_plain(cuda_device, S, d, T, support):
    """K7 and K8 under each template forced, Gram and paired mode, equal
    the plain version (the scan) bit for bit: values and stash."""
    bsp, T_orig, A, B = _card_case(S, d, T, support, cuda_device)
    dd = series_dim(A)
    g_out = t_sb.result_tile_step(bsp.plan(), bsp.tile, T_orig)
    r = (T_orig - 1) % bsp.tile
    Ap, Bp = to_tile_major(A, bsp.tile, bsp.T), to_tile_major(B, bsp.tile,
                                                              bsp.T)
    v_p, L_p = t_sb.gram_soft_fwd_stash(A, B, bsp, GAMMA)
    pv_p, pL_p = t_sb.soft_spdtw_fwd_stash(A, B[:3], bsp, GAMMA)
    before = _build.launch_counts()
    for tmpl in ("pairs", "tiles"):
        for gram, (vw, Lw), xp, yp in ((True, (v_p, L_p), Ap, Bp),
                                       (False, (pv_p, pL_p), Ap, Bp[:3])):
            v7, _ = t_sb.soft_fwd_cuda(xp, yp, bsp, gram=gram, d=dd,
                                       g_out=g_out, r=r, gamma=GAMMA,
                                       template=tmpl)
            v8, L8 = t_sb.soft_fwd_cuda(xp, yp, bsp, gram=gram, d=dd,
                                        g_out=g_out, r=r, gamma=GAMMA,
                                        stash=True, template=tmpl)
            assert torch.equal(v7, v8), (tmpl, gram)
            assert torch.equal(v7, vw.reshape(-1)), (tmpl, gram)
            assert torch.equal(L8, Lw), (tmpl, gram)
    after = _build.launch_counts()
    assert after["soft_tiles_fwd"] == before["soft_tiles_fwd"] + 4
    assert after["soft_tiles_stash"] == before["soft_tiles_stash"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,T,support", CARD_CASES)
def test_backward_templates_agree(cuda_device, S, d, T, support):
    bsp, T_orig, A, B = _card_case(S, d, T, support, cuda_device)
    dd = series_dim(A)
    g_out = t_sb.result_tile_step(bsp.plan(), bsp.tile, T_orig)
    r = (T_orig - 1) % bsp.tile
    Ap, Bp = to_tile_major(A, bsp.tile, bsp.T), to_tile_major(B, bsp.tile,
                                                              bsp.T)
    rng = np.random.default_rng(S + d + T)
    for gram, yp in ((True, Bp), (False, Bp[:3])):
        v, L = t_sb.soft_fwd_cuda(Ap, yp, bsp, gram=gram, d=dd, g_out=g_out,
                                  r=r, gamma=GAMMA, stash=True)
        gbar = torch.as_tensor(rng.normal(size=v.shape).astype(np.float32),
                               device=cuda_device) * (v < 1e29)
        before = _build.launch_counts()
        out = {t: t_sb.soft_bwd_cuda(Ap, yp, bsp, L, gbar, gram=gram, d=dd,
                                     g_out=g_out, r=r, gamma=GAMMA,
                                     eblocks=True, template=t)
               for t in ("pairs", "tiles")}
        after = _build.launch_counts()
        assert after["soft_tiles_bwd"] == before["soft_tiles_bwd"] + 2
        (gx0, gy0, gw0, E0), (gx1, gy1, gw1, E1) = out["pairs"], out["tiles"]
        assert torch.equal(gx0, gx1) and torch.equal(gy0, gy1)
        assert torch.equal(E0, E1)
        torch.testing.assert_close(gw1, gw0, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(gw0.abs().max()))


@pytest.mark.cuda
def test_entries_take_the_kernels_under_both_regimes(cuda_device):
    """The differentiable entries launch K8 / K9 at barycenter-like P (the
    tiles template) and K7 at a Gram past PAIRS_MIN_FWD (pairs template),
    and their values equal the plain version's bit for bit."""
    w, T_orig, A, B = _case(16, 1, 70, "random")
    bsp = block_sparsify(w, tile=16)
    rng = np.random.default_rng(21)
    n = int(np.ceil(np.sqrt(t_sb.PAIRS_MIN_FWD)))
    X = torch.as_tensor(rng.normal(size=(n, T_orig)).astype(np.float32),
                        device=cuda_device)
    before = _build.launch_counts()
    x = X[:8].clone().requires_grad_()
    v = t_sb.soft_spdtw_batch(x, X[8:16], w, GAMMA, bsp=bsp)
    v.sum().backward()
    with torch.no_grad():
        G = t_sb.soft_spdtw_gram_batch(X, X, w, GAMMA, bsp=bsp)
    after = _build.launch_counts()
    assert after["soft_tiles_stash"] == before["soft_tiles_stash"] + 1
    assert after["soft_tiles_bwd"] == before["soft_tiles_bwd"] + 1
    assert after["soft_tiles_fwd"] == before["soft_tiles_fwd"] + 1
    assert torch.equal(v.detach(), t_sb.soft_spdtw_paired_scan(
        X[:8], X[8:16], bsp, GAMMA))
    assert torch.equal(G[:4], t_sb.gram_soft_spdtw_scan(X[:4], X, bsp,
                                                        GAMMA))
    assert bool(torch.isfinite(x.grad).all())
