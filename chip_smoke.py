#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --stop-after 2 # build and kernel checks only

Phases (each one fails the run on a mismatch, with a nonzero exit):

1. Environment and build: the card's name and power limit, the torch and
   CUDA versions; builds the four sources of
   ``src/repro_torch/kernels/csrc`` (one nvcc each, started together) and
   prints the build times and the compiler's register report.
2. Kernels against their plain PyTorch versions, on the card:
   - K2 (``spdtw_tiles_paired``) against ``spdtw_paired_scan``, K1
     (``spdtw_tiles_gram``: plain, thresholded with ``alive0``, prefix
     mode) against ``gram_spdtw_scan`` / ``gram_prefix_bound``, for every
     tile edge S, d in {1, 3}, random sparse supports and a learned one;
   - K3 (``krdtw_gram``) and K4 (``krdtw_paired``) against
     ``gram_log_krdtw_plain`` / ``wavefront_log_krdtw_plain`` at T in
     {24, 100, 128, 300, 1024}, nu in {0.1, 0.5, 2}, on the full grid, a
     corridor and a support; K3 and K4 must agree bit for bit;
   - K5 (``dtw_wavefront``) and K6 (``dtw_banded``, pairs and Gram) against
     ``wavefront_dtw_plain`` / ``banded_dtw_plain`` over the radius grid
     up to w = 26, at d in {1, 3}, and K6 at T = 1024, w = 204.
   - K7 (``soft_tiles_fwd``), K8 (``soft_tiles_stash``) and K9
     (``soft_tiles_bwd``) against ``gram_soft_spdtw_scan`` /
     ``soft_spdtw_paired_scan``, ``gram_soft_fwd_stash`` /
     ``soft_spdtw_fwd_stash`` and ``gram_soft_bwd_scan`` /
     ``soft_spdtw_bwd_block`` (values, stash, gx / gy / gw, E blocks) at
     (S, d, T) in {(8, 1, 40), (16, 1, 70), (16, 3, 70)}, Gram and paired
     mode, on a random support, a masked corner cell, a ragged T_orig and
     an inactive corner tile, under each launch template ("pairs",
     "tiles") forced and the wrappers' own choice.
   K1-K4, K6, K7 and K8 must equal their plain versions bit for bit (K7
   = K8, and K9's two templates give equal gx, gy and E blocks); the
   limit is rel 1e-6 for K5, and rtol 1e-4 / atol 1e-5 for K9's gradients
   and E blocks (f32 sums in another order).
3. The SP-DTW main path at the UCR TwoPatterns shape (1000 train / 4000
   test, T = 128, 4 classes): ``fit`` learns the support from all
   499,500 train pairs on the card, ``engine.gram`` runs K1 over
   4000 x 1000, ``engine.knn`` the cascade (K2 seeds, K1 prefix bound and
   survivors), whose neighbours must equal the Gram argmin bit for bit;
   ``engine.classify`` gives the error rate, and the DTW Gram (K1 over
   the all-ones plan) the SP-DTW / DTW time ratio. A slice of the Gram is
   held against the dense core DP, and the Gram is timed again on
   sparser supports learned from the same counts.
3b. The kernel-measure and baseline path at the same shape (paper Tables
   II, IV and VI): ``select_nu`` (K3 Grams), ``select_theta_gamma`` for
   sp_krdtw on fit's counts with thetas as shares of the train pairs
   (K3), ``select_radius`` (K6 Grams), ``svm_gram_series`` +
   ``svm_error`` for krdtw, krdtw_sc and sp_krdtw (K3 Grams, K4
   self-similarities), the sp_krdtw ``engine.knn`` kernel cascade (K4
   seeds and survivors, K1 prefix bound), whose neighbours must equal the
   ``-gram_log`` argmin bit for bit, and the DTW / DTW_sc baselines (K5
   pairs, K6 pairs and the dtw_sc Gram). Each stage is timed with CUDA
   events.
3c. The centroid and soft-Gram path at the same shape: ``fit_centroids``
   (4 classes x 60 Adam steps through K8 / K9 in paired mode, K1
   medoids), the centroid-seeded cascade (neighbours equal to phase 3's
   cascade and the Gram argmin, bit for bit), nearest-centroid and 1-NN
   classification, the 4000 x 1000 soft Gram without a gradient (K7; every
   value at most the hard Gram's, 1e-3 relative slack) and the 1000 x 1000
   train soft Gram with a gradient (K8, K9) on the 10 %-share support, K8
   equal to the plain forward and gA held against the plain backward on
   64 rows, gw zero outside the support; K8 / K9 in paired mode at the
   fit's shapes under both templates, with their wrappers' and bare
   launches' times.
   For each path the launch counters are set to 0 just before and read
   just after, and each of its kernels must have launched. Then a
   torch.profiler pass gives the device time by kernel and the device's
   idle share for calls of both paths.
4. Timing at the paths' shapes: each kernel against its plain version,
   with its bound (K8 / K9 as their bare launches' device time, with the
   template each launch takes); both K8 / K9 templates at the pair counts
   on either side of ``PAIRS_MIN_FWD`` / ``PAIRS_MIN_BWD`` (a record, not
   a gate); one JSON line ``{"kernels": ...}`` of all nine kernels.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository's ``src/`` beside it, the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, and
# HBM3 bandwidth
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# special-function unit (expf's ex2): 16 results per clock per SM on
# compute capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput), 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_RATE = 16 * 132 * 1.98e9
REL_LIMIT = 1e-6
DEVICE = "cuda"
# the main path: UCR TwoPatterns' published split and length
N_TRAIN, N_TEST, T_MAIN = 1000, 4000, 128

CSRC = "src/repro_torch/kernels/csrc/"
# entry point -> (the TPU kernel it replaces, its source)
KERNELS = {
    "spdtw_tiles_gram": ("src/repro/kernels/gram_block.py:98",
                         CSRC + "spdtw_tiles.cu"),
    "spdtw_tiles_paired": ("src/repro/kernels/spdtw_block.py:148",
                           CSRC + "spdtw_tiles.cu"),
    "krdtw_gram": ("src/repro/kernels/gram_block.py:648",
                   CSRC + "krdtw_wavefront.cu"),
    "krdtw_paired": ("src/repro/kernels/krdtw_wavefront.py:105",
                     CSRC + "krdtw_wavefront.cu"),
    "dtw_wavefront": ("src/repro/kernels/dtw_wavefront.py:30",
                      CSRC + "dtw_wavefront.cu"),
    "dtw_banded": ("src/repro/kernels/dtw_banded.py:41",
                   CSRC + "dtw_wavefront.cu"),
    "soft_tiles_fwd": ("src/repro/kernels/soft_block.py:806",
                       CSRC + "soft_tiles.cu"),
    "soft_tiles_stash": ("src/repro/kernels/soft_block.py:915",
                         CSRC + "soft_tiles.cu"),
    "soft_tiles_bwd": ("src/repro/kernels/soft_block.py:998",
                       CSRC + "soft_tiles.cu"),
}
LIBRARIES = ("spdtw_tiles", "krdtw_wavefront", "dtw_wavefront", "soft_tiles")
SOFT = ("soft_tiles_fwd", "soft_tiles_stash", "soft_tiles_bwd")
# the kernels of the SP-DTW path (phase 3) and of the kernel-measure and
# baseline path (phase 3b)
SLICE1 = ("spdtw_tiles_gram", "spdtw_tiles_paired")
SLICE2 = ("spdtw_tiles_gram", "krdtw_gram", "krdtw_paired", "dtw_wavefront",
          "dtw_banded")
# K3 / K4 against their plain versions (exp / log on both sides)
KREL_LIMIT = 1e-5
# the soft values' limit against a plain version in another association
# (rel); K9's gradients and E blocks (f32 sums in another order): |got - want| <=
# GRAD_RTOL |want| + GRAD_ATOL
SOFT_REL_LIMIT = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
SOFT_GAMMA = 0.1
# the launch templates of K7-K9 (``soft_block.soft_geometry``)
TEMPLATES = ("pairs", "tiles")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def diff(a, b):
    """(max abs, max rel) difference of two tensors of equal shape."""
    import torch
    d = (a.double() - b.double()).abs()
    rel = d / b.double().abs().clamp_min(1e-30)
    return float(d.max()) if d.numel() else 0.0, \
        float(rel.max()) if d.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 1, warmup: int = 0):
    """Median time of ``fn()`` in ms over ``reps`` runs (CUDA events) and
    the last result."""
    import torch
    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), out


def device_ms(fn, reps: int = 5):
    """Median device time in ms of the work ``fn()`` enqueues (CUDA
    events), with the host's own time hidden: each run is enqueued behind
    a ~1 ms spin of the card, so the start event fires when the spin ends
    and the launches are already queued. Returns (ms, last result)."""
    import torch
    out, times = None, []
    for _ in range(reps + 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times[1:]), out


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        list(ex.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        _build.library(name)
        info = _build.BUILD_LOG.get(name, {})
        log(f"build: {name}.cu in {info.get('seconds', 0.0):.1f} s")
        for line in info.get("log", "").splitlines():
            if any(k in line for k in ("registers", "Compiling entry",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")
    log(f"build: all sources in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

def _random_support(T, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    w = np.zeros((T, T), np.float32)
    band = np.abs(i[:, None] - i[None, :]) <= max(2, T // 10)
    extra = rng.random((T, T)) < 0.05
    sup = band | extra
    w[sup] = rng.uniform(0.5, 2.0, size=int(sup.sum())).astype(np.float32)
    return w


def _check_case(label, bsp, A, B, T):
    """K1 (plain, thresholded + alive0, prefix) and K2 (plain and
    thresholded) against their plain versions on one support."""
    import torch
    from repro_torch.kernels import gram_block as gb
    from repro_torch.kernels.spdtw_block import spdtw_block
    worst = {"spdtw_tiles_gram": [0.0, 0.0], "spdtw_tiles_paired": [0.0, 0.0]}

    def record(kernel, what, got, want):
        ab, rel = diff(got, want)
        worst[kernel][0] = max(worst[kernel][0], ab)
        worst[kernel][1] = max(worst[kernel][1], rel)
        log(f"  {label} {what}: max abs {ab:.3g} max rel {rel:.3g}")
        require(torch.equal(got, want), f"{label} {what}: not bit for bit "
                f"(rel {rel})")

    G = gb.gram_spdtw_block(A, B, bsp, T_orig=T)
    Gp = gb.gram_spdtw_scan(A, B, bsp, T_orig=T, block_a=A.shape[0])
    record("spdtw_tiles_gram", "gram", G, Gp)
    require(torch.equal(G.argmin(1), Gp.argmin(1)), f"{label} gram nn")
    g = torch.Generator(device="cpu").manual_seed(7)
    thr = torch.quantile(Gp.double(), 0.3, dim=1).float()
    alive0 = (torch.rand(Gp.shape, generator=g) > 0.3).to(A.device)
    Gt = gb.gram_spdtw_block(A, B, bsp, T_orig=T, thresholds=thr,
                             alive0=alive0)
    Gtp = gb.gram_spdtw_scan(A, B, bsp, T_orig=T, block_a=A.shape[0],
                             thresholds=thr, alive0=alive0)
    record("spdtw_tiles_gram", "gram thr+alive0", Gt, Gtp)
    require(torch.equal(Gt.argmin(1), Gtp.argmin(1)), f"{label} thr nn")
    n_prefix = gb.prefix_tile_count(bsp, 0.5, T)
    if n_prefix > 0:
        Lb = gb.gram_spdtw_block(A, B, bsp, T_orig=T, n_prefix=n_prefix)
        Lbp = gb.gram_prefix_bound(A, B, bsp, n_prefix, T_orig=T,
                                   block_a=A.shape[0])
        record("spdtw_tiles_gram", f"prefix({n_prefix})", Lb, Lbp)
    n = min(A.shape[0], B.shape[0])
    x, y = A[:n], B[:n]
    P = spdtw_block(x, y, bsp, T_orig=T)
    Pp = gb.spdtw_paired_scan(x, y, bsp, T_orig=T)
    record("spdtw_tiles_paired", "paired", P, Pp)
    record("spdtw_tiles_paired", "paired = gram diagonal", P,
           torch.diagonal(Gp[:n, :n]))
    # half the pairs sit under their threshold, half above it
    pthr = Pp * torch.where(torch.arange(n, device=Pp.device) % 2 == 0,
                            1.1, 0.9)
    Pt = spdtw_block(x, y, bsp, T_orig=T, thresholds=pthr)
    Ptp = gb.spdtw_paired_scan(x, y, bsp, T_orig=T, thresholds=pthr)
    record("spdtw_tiles_paired", "paired thr", Pt, Ptp)
    return worst


def phase_kernels():
    import numpy as np
    import torch
    from repro_torch.core.occupancy import block_sparsify, learn_sparse_paths
    from repro_torch.data.synthetic_ucr import make_cbf
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    worst = {k: [0.0, 0.0] for k in KERNELS}
    cases = [(8, 1, 70), (8, 3, 70), (16, 1, 100), (16, 3, 100),
             (32, 1, 150), (32, 3, 150), (64, 1, 150), (128, 1, 200),
             (128, 3, 200)]
    for S, d, T in cases:
        bsp = block_sparsify(_random_support(T, seed=S + d), tile=S)
        shape = (lambda n: (n, T)) if d == 1 else (lambda n: (n, T, d))
        A = torch.as_tensor(rng.normal(size=shape(24)).astype(np.float32),
                            device=dev)
        B = torch.as_tensor(rng.normal(size=shape(40)).astype(np.float32),
                            device=dev)
        w = _check_case(f"S={S} d={d} T={T} random", bsp, A, B, T)
        for k in w:
            worst[k] = [max(a, b) for a, b in zip(worst[k], w[k])]
    ds = make_cbf(n_train=40, n_test=24, T=128)
    Xtr = torch.as_tensor(ds.X_train, device=dev)
    sp = learn_sparse_paths(Xtr, theta=2.0, gamma=0.5)
    bsp = block_sparsify(sp, tile=16)
    w = _check_case("S=16 d=1 T=128 learned(CBF)", bsp,
                    torch.as_tensor(ds.X_test, device=dev), Xtr, 128)
    for k in w:
        worst[k] = [max(a, b) for a, b in zip(worst[k], w[k])]
    for k, v in _check_slice2().items():
        worst[k] = [max(a, b) for a, b in zip(worst[k], v)]
    for k, v in _check_soft().items():
        worst[k] = [max(a, b) for a, b in zip(worst[k], v)]
    log(f"phase 2 ok: worst (abs, rel) {worst}")
    return worst


def _band_support(T, seed):
    """A corridor plus random cells, as a (T, T) bool support."""
    import numpy as np
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    sup = (np.abs(i[:, None] - i[None, :]) <= max(2, T // 12)) | \
        (rng.random((T, T)) < 0.05)
    sup[0, 0] = sup[-1, -1] = True
    return sup


def _check_slice2():
    """K3 / K4 (log K_rdtw) and K5 / K6 (DTW, DTW_sc) against their plain
    versions at T in {24, 100, 128, 300}: K3 / K4 for nu in {0.1, 0.5, 2}
    on the full grid, a corridor and a support (learned from CBF at
    T = 128); K5 / K6 over the TwoPatterns radius grid up to w = 26, at
    d in {1, 3}. Past the old length and width limits, at T = 1024: K3 /
    K4 at nu = 0.5 on the full grid (the wide sweep), the radius-6
    corridor and a band support (the narrow sweep), and K6 at w = 204 (a
    409-cell strip, the shared-memory sweep) and K5 on the full grid (its
    shared-memory diagonals past T = 512). K3, K4 and K6 must equal
    their plain versions bit for bit, and K3 and K4 each other."""
    import numpy as np
    import torch
    from repro_torch.core.occupancy import learn_sparse_paths
    from repro_torch.data.synthetic_ucr import make_cbf
    from repro_torch.kernels import dtw_banded as kb
    from repro_torch.kernels import dtw_wavefront as kw
    from repro_torch.kernels import gram_block as gb
    from repro_torch.kernels import krdtw_wavefront as kk
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    worst = {k: [0.0, 0.0] for k in ("krdtw_gram", "krdtw_paired",
                                     "dtw_wavefront", "dtw_banded")}

    def record(kernel, what, got, want, limit, exact=True):
        ab, rel = diff(got, want)
        worst[kernel][0] = max(worst[kernel][0], ab)
        worst[kernel][1] = max(worst[kernel][1], rel)
        log(f"  {what}: max abs {ab:.3g} max rel {rel:.3g}")
        require(rel <= limit, f"{what}: rel {rel} > {limit}")
        if exact:
            require(torch.equal(got, want), f"{what}: not bit for bit")

    ds = make_cbf(n_train=40, n_test=24, T=128)
    learned = learn_sparse_paths(torch.as_tensor(ds.X_train), theta=2.0)
    for T in (24, 100, 128, 300, 1024):
        A = torch.as_tensor(rng.normal(size=(12, T)).astype(np.float32),
                            device=dev)
        B = torch.as_tensor(rng.normal(size=(16, T)).astype(np.float32),
                            device=dev)
        sup = learned.support.numpy() if T == 128 else _band_support(T, T)
        for nu in ((0.5,) if T == 1024 else (0.1, 0.5, 2.0)):
            for dom, kw_ in (("full", {}), ("radius 6", {"radius": 6}),
                             ("support", {"support": sup})):
                label = f"T={T} nu={nu} {dom}"
                G = gb.gram_log_krdtw_block(A, B, nu, **kw_)
                Gp = gb.gram_log_krdtw_plain(A, B, nu, **kw_)
                record("krdtw_gram", f"K3 {label}", G, Gp, KREL_LIMIT)
                md = None if "support" not in kw_ else \
                    kk.mask_to_diagonal_major(sup)
                x, y = A, B[:12]
                P = kk.wavefront_log_krdtw(x, y, nu, radius=kw_.get(
                    "radius"), mask_diag=md)
                Pp = kk.wavefront_log_krdtw_plain(x, y, nu, radius=kw_.get(
                    "radius"), mask_diag=md)
                record("krdtw_paired", f"K4 {label}", P, Pp, KREL_LIMIT)
                require(torch.equal(P, torch.diagonal(G[:, :12])),
                        f"K3 != K4 bit for bit, {label}")
        for d in ((1,) if T == 1024 else (1, 3)):
            shape = (16, T) if d == 1 else (16, T, d)
            x = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                device=dev)
            y = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                device=dev)
            for r in ((None, 204) if T == 1024 else
                      (None, 0, 3, 6, 13, 26)):
                label = f"T={T} d={d} radius {r}"
                record("dtw_wavefront", f"K5 {label}",
                       kw.wavefront_dtw(x, y, radius=r),
                       kw.wavefront_dtw_plain(x, y, radius=r), REL_LIMIT,
                       exact=False)
                if r is None:
                    continue
                record("dtw_banded", f"K6 {label}", kb.banded_dtw(x, y, r),
                       kb.banded_dtw_plain(x, y, r), REL_LIMIT)
                record("dtw_banded", f"K6 gram {label}",
                       kb.banded_dtw_gram(x[:6], y, r),
                       kb.banded_dtw_gram_plain(x[:6], y, r), REL_LIMIT)
    log(f"  K3 == K4 bit for bit on every case; K3, K4, K6 == plain")
    return worst


def _soft_diff(got, want, rtol, atol):
    """(max abs, max rel, worst excess over rtol |want| + atol) of two
    tensors of equal shape; entries that are +INF on both sides (no
    admissible path) are equal, an INF on one side only fails."""
    import torch
    g, w = got.double(), want.double()
    inf_g, inf_w = g >= 1e29, w >= 1e29
    if not torch.equal(inf_g, inf_w):
        return float("inf"), float("inf"), float("inf")
    ok = ~inf_w
    d = (g - w).abs()[ok]
    if d.numel() == 0:
        return 0.0, 0.0, -1.0
    aw = w.abs()[ok]
    rel = d / aw.clamp_min(1e-30)
    return float(d.max()), float(rel.max()), \
        float((d - rtol * aw - atol).max())


def _fwd_templates(A, B, bsp, gamma, T_orig, gram):
    """K7 and K8 under each template forced: {template: (K7 values, K8
    values, K8 stash)}, flat (P,) values."""
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import series_dim, to_tile_major
    S = bsp.tile
    g_out = sb.result_tile_step(bsp.plan(), S, T_orig)
    kw = dict(gram=gram, d=series_dim(A), g_out=g_out, r=(T_orig - 1) % S,
              gamma=gamma)
    Ap, Bp = to_tile_major(A, S, bsp.T), to_tile_major(B, S, bsp.T)
    out = {}
    for tmpl in TEMPLATES:
        v7, _ = sb.soft_fwd_cuda(Ap, Bp, bsp, template=tmpl, **kw)
        v8, L8 = sb.soft_fwd_cuda(Ap, Bp, bsp, stash=True, template=tmpl,
                                  **kw)
        out[tmpl] = (v7, v8, L8)
    return out


def _bwd_templates(A, B, bsp, gamma, T_orig, gram, stash, gbar):
    """K9 under each template forced on one stash: {template: (gx, gy, gw,
    E blocks)}."""
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import series_dim, to_tile_major
    S = bsp.tile
    g_out = sb.result_tile_step(bsp.plan(), S, T_orig)
    Ap, Bp = to_tile_major(A, S, bsp.T), to_tile_major(B, S, bsp.T)
    return {tmpl: sb.soft_bwd_cuda(
        Ap, Bp, bsp, stash, gbar.reshape(-1).contiguous(), gram=gram,
        d=series_dim(A), g_out=g_out, r=(T_orig - 1) % S, gamma=gamma,
        eblocks=True, template=tmpl) for tmpl in TEMPLATES}


def _template_gates(label, fwd, plain_v, plain_L, bwd, fails):
    """K7 = K8 = the plain version bit for bit under every template
    (``fwd`` from ``_fwd_templates``), and K9's templates (``bwd`` from
    ``_bwd_templates``) with equal gx, gy and E blocks and gw within
    GRAD_RTOL. Appends what fails to ``fails``."""
    import torch
    for tmpl, (v7, v8, L8) in fwd.items():
        if not torch.equal(v7, plain_v.reshape(-1)):
            fails.append(f"K7 ({tmpl}) != plain, {label}")
        if not torch.equal(v8, v7):
            fails.append(f"K8 ({tmpl}) != K7, {label}")
        if not torch.equal(L8, plain_L):
            fails.append(f"K8 ({tmpl}) stash != plain, {label}")
    (gx0, gy0, gw0, E0), (gx1, gy1, gw1, E1) = bwd["pairs"], bwd["tiles"]
    if not (torch.equal(gx0, gx1) and torch.equal(gy0, gy1)
            and torch.equal(E0, E1)):
        fails.append(f"K9 templates differ in gx / gy / E, {label}")
    _, rel, exc = _soft_diff(gw1, gw0, GRAD_RTOL,
                             GRAD_RTOL * float(gw0.abs().max()))
    if exc > 0:
        fails.append(f"K9 templates' gw beyond rtol {GRAD_RTOL}, {label}")


def _check_soft():
    """K7 / K8 / K9 against their plain versions at (S, d, T) in {(8, 1,
    40), (16, 1, 70), (16, 3, 70)}, in Gram and paired mode, on a random
    support, on one whose corner cell is masked (the result tile active
    but its cell unreachable), at ragged T_orig = T - 3, and on one whose
    corner tile is inactive (no launch: +INF values, zero gradients).
    K7 / K8 values and stash equal the plain version bit for bit under
    both templates and the entries' own choice, K7 = K8, and paired = the
    Gram diagonal. K9 fed the kernel's stash against the plain reverse
    sweep fed the plain stash (the same bits) at GRAD_RTOL / GRAD_ATOL;
    K9's two templates give equal gx, gy and E blocks, gw within
    GRAD_RTOL. Every comparison is printed before the first failure is
    raised."""
    import numpy as np
    import torch
    from repro_torch.core.occupancy import block_sparsify
    from repro_torch.kernels import soft_block as sb
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2)
    worst = {k: [0.0, 0.0] for k in SOFT}
    fails = []

    def record(kernel, what, got, want, rtol, atol=0.0, exact=False):
        ab, rel, exc = _soft_diff(got, want, rtol, atol)
        worst[kernel][0] = max(worst[kernel][0], ab)
        worst[kernel][1] = max(worst[kernel][1], rel)
        log(f"  {what}: max abs {ab:.3g} max rel {rel:.3g}")
        if exact and not torch.equal(got, want):
            fails.append(f"{what}: not bit for bit")
        elif exc > 0:
            fails.append(f"{what}: beyond rtol {rtol} atol {atol}")

    gamma = SOFT_GAMMA
    for S, d, T in ((8, 1, 40), (16, 1, 70), (16, 3, 70)):
        w_rand = _random_support(T, seed=10 * S + d)
        w_cell = w_rand.copy()
        w_cell[T - 1, T - 1] = 0.0
        w_cell[T - 2, T - 1] = w_cell[T - 1, T - 2] = 0.0
        for sup, w, T_orig in (("random", w_rand, T),
                               ("corner cell masked", w_cell, T),
                               ("ragged", w_rand, T - 3)):
            bsp = block_sparsify(w, tile=S)
            shape = (lambda n: (n, T_orig)) if d == 1 else \
                (lambda n: (n, T_orig, d))
            A = torch.as_tensor(rng.normal(size=shape(6)).astype(np.float32),
                                device=dev)
            B = torch.as_tensor(rng.normal(size=shape(9)).astype(np.float32),
                                device=dev)
            lab = f"S={S} d={d} T={T} T_orig={T_orig} {sup}"
            Gs, Ls = sb.gram_soft_fwd_stash(A, B, bsp, gamma)
            Ps, Qs = sb.soft_spdtw_fwd_stash(A, B[:6], bsp, gamma)
            G7 = sb.gram_soft_spdtw_block(A, B, bsp, gamma)
            record("soft_tiles_fwd", f"K7 gram {lab}", G7, Gs, 0.0,
                   exact=True)
            P7 = sb.soft_spdtw_paired_block(A, B[:6], bsp, gamma)
            record("soft_tiles_fwd", f"K7 paired {lab}", P7, Ps, 0.0,
                   exact=True)
            G8, L8 = sb.soft_fwd_stash_block(A, B, bsp, gamma, gram=True)
            if not torch.equal(G8, G7):
                fails.append(f"K8 != K7 bit for bit, gram {lab}")
            record("soft_tiles_stash", f"K8 gram stash {lab}", L8, Ls, 0.0,
                   exact=True)
            P8, Q8 = sb.soft_fwd_stash_block(A, B[:6], bsp, gamma,
                                             gram=False)
            if not torch.equal(P8, P7):
                fails.append(f"K8 != K7 bit for bit, paired {lab}")
            if not torch.equal(P7, torch.diagonal(G7[:, :6])):
                fails.append(f"paired != Gram diagonal, {lab}")
            record("soft_tiles_stash", f"K8 paired stash {lab}", Q8, Qs,
                   0.0, exact=True)
            # K9 with the kernel's stash against the plain reverse scan
            # with the plain stash (the same bits)
            gbar = torch.as_tensor(rng.normal(size=(6, 9)).astype(
                np.float32), device=dev) * (Gs < 1e29)
            gk = sb.soft_bwd_block(A, B, bsp, gamma, L8, gbar, gram=True)
            gp = sb.gram_soft_bwd_scan(A, B, bsp, gamma, Ls, gbar)
            for name, a, b in zip(("gA", "gB", "gw"), gk, gp):
                record("soft_tiles_bwd", f"K9 gram {name} {lab}", a, b,
                       GRAD_RTOL, GRAD_ATOL)
            pbar = gbar[:, 0].contiguous()
            gk = sb.soft_bwd_block(A, B[:6], bsp, gamma, Q8, pbar,
                                   gram=False)
            gp = sb.soft_spdtw_bwd_block(A, B[:6], bsp, gamma, Qs, pbar)
            for name, a, b in zip(("gx", "gy", "gw"), gk, gp):
                record("soft_tiles_bwd", f"K9 paired {name} {lab}", a, b,
                       GRAD_RTOL, GRAD_ATOL)
            record("soft_tiles_bwd", f"K9 E blocks {lab}",
                   _kernel_eblocks(A, B[:6], bsp, gamma, Q8, T_orig),
                   _plain_eblocks(A, B[:6], bsp, gamma, Qs, T_orig),
                   GRAD_RTOL, GRAD_ATOL)
            # both templates forced, Gram and paired mode
            if sb.result_tile_step(bsp.plan(), S, T_orig) >= 0:
                for gram, Bx, pv, pL, gb_ in ((True, B, Gs, Ls, gbar),
                                              (False, B[:6], Ps, Qs, pbar)):
                    _template_gates(
                        f"{'gram' if gram else 'paired'} {lab}",
                        _fwd_templates(A, Bx, bsp, gamma, T_orig, gram),
                        pv, pL,
                        _bwd_templates(A, Bx, bsp, gamma, T_orig, gram, pL,
                                       gb_), fails)
        # the corner tile inactive: no launch, +INF and zero gradients
        w_off = w_rand.copy()
        w_off[-S:, -S:] = 0.0
        bsp = block_sparsify(w_off, tile=S)
        x = torch.as_tensor(rng.normal(size=(4, T) if d == 1 else
                                       (4, T, d)).astype(np.float32),
                            device=dev).requires_grad_()
        v = sb.soft_spdtw_batch(x, x.detach().flip(0), w_off, gamma)
        v.sum().backward()
        if not (bool((v >= 1e29).all()) and bool((x.grad == 0).all())):
            fails.append(f"corner tile inactive S={S} d={d}: values "
                         f"{v.tolist()}")
        log(f"  S={S} d={d} corner tile inactive: +INF, zero gradients")
    log(f"  K7 / K8 == plain bit for bit under both templates, K9 "
        f"templates' gx / gy / E equal: {not fails}")
    require(not fails, "; ".join(fails))
    return worst


def _kernel_eblocks(x, y, bsp, gamma, stash, T_orig):
    """K9's E blocks (K, P, S, S) for aligned pairs with gbar = 1."""
    import torch
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import series_dim, to_tile_major
    g_out = sb.result_tile_step(bsp.plan(), bsp.tile, T_orig)
    S = bsp.tile
    ones = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    _, _, _, E = sb.soft_bwd_cuda(
        to_tile_major(x, S, bsp.T), to_tile_major(y, S, bsp.T), bsp, stash,
        ones, gram=False, d=series_dim(x), g_out=g_out,
        r=(T_orig - 1) % S, gamma=gamma, eblocks=True)
    return E.reshape(E.shape[0], E.shape[1], S, S)


def _plain_eblocks(x, y, bsp, gamma, stash, T_orig):
    """The plain reverse scan's E blocks (K, P, S, S), gbar = 1."""
    import torch
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import series_dim, to_tile_major
    g_out = sb.result_tile_step(bsp.plan(), bsp.tile, T_orig)
    S, d = bsp.tile, series_dim(x)
    xp, yp = to_tile_major(x, S, bsp.T), to_tile_major(y, S, bsp.T)
    _, _, _, E = sb._reverse_tile_scan(
        bsp.reverse_plan(g_out), torch.as_tensor(bsp.blocks,
                                                 device=x.device),
        lambda ti, tj: (xp[:, ti * d * S:(ti + 1) * d * S],
                        yp[:, tj * d * S:(tj + 1) * d * S]),
        stash, torch.ones((x.shape[0],), device=x.device), x.shape[0],
        bsp.T, S=S, ri=(T_orig - 1) % S, rj=(T_orig - 1) % S, gamma=gamma,
        with_eblocks=True, d=d)
    return E


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------

def phase_main_path():
    import numpy as np
    import torch
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data.synthetic_ucr import make_two_patterns
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts

    ds = make_two_patterns(n_train=N_TRAIN, n_test=N_TEST, T=T_MAIN)
    stage = {}

    def timed(name, fn):
        ms, out = cuda_ms(fn)
        stage[name] = ms
        log(f"  {name}: {ms:.1f} ms")
        return out

    reset_launch_counts()
    spec = MeasureSpec("spdtw", theta=2.0, weight_gamma=0.5)
    eng = timed("fit (learn support from 499,500 pairs, plan, index)",
                lambda: fit(spec, ds.X_train, labels=ds.y_train,
                            device=DEVICE))
    G = timed("engine.gram (K1)", lambda: eng.gram(ds.X_test))
    nn, nnd, stats = timed("engine.knn cascade",
                           lambda: eng.knn(ds.X_test, return_stats=True))
    pred = timed("engine.classify", lambda: eng.classify(ds.X_test))
    deng = fit(MeasureSpec("dtw", support="dense"), ds.X_train,
               labels=ds.y_train, device=DEVICE)
    Gd = timed("dtw engine.gram (K1, all-ones plan)",
               lambda: deng.gram(ds.X_test))
    launches = launch_counts()
    log(f"  launches on the main path: {launches}")
    for k in SLICE1:
        require(launches[k] > 0, f"{k} never launched on the main path")

    bsp = eng.bsp
    log(f"  support: {eng.sp.n_cells} of {T_MAIN ** 2} cells, tile "
        f"{bsp.tile}, {bsp.n_active} of {bsp.active.size} tiles active")
    require(tuple(G.shape) == (N_TEST, N_TRAIN), "gram shape")
    require(bool(torch.isfinite(G).all()) and bool((G >= 0).all()),
            "gram values")
    ref_nn = torch.argmin(G, dim=1).to(torch.int32)
    require(torch.equal(nn, ref_nn), "cascade nn != Gram argmin")
    require(torch.equal(nnd, G.gather(1, ref_nn[:, None].long())[:, 0]),
            "cascade nn distance != Gram minimum")
    log(f"  cascade nn == Gram argmin, bit for bit; stats {stats}")
    err = float(np.mean(pred != ds.y_test))
    require(np.array_equal(pred, ds.y_train[nn.cpu().numpy()]),
            "classify != labels of knn")
    log(f"  1-NN test error: SP-DTW {err:.4f}")
    dnn = torch.argmin(Gd, dim=1).cpu().numpy()
    derr = float(np.mean(ds.y_train[dnn] != ds.y_test))
    log(f"  1-NN test error: DTW {derr:.4f}")
    # a slice against the dense core DP (the repository's oracle)
    qa, cb = torch.as_tensor(ds.X_test[:8], device=DEVICE), eng.corpus[:64]
    for what, got, w in (("spdtw", G[:8, :64], eng.weights),
                         ("dtw", Gd[:8, :64], None)):
        want = ref.wdtw_cross(qa, cb, w)
        ab, rel = diff(got, want)
        log(f"  {what} Gram slice vs dense core DP: max abs {ab:.3g} "
            f"max rel {rel:.3g}")
        require(rel <= 1e-4, f"{what} Gram slice vs dense core DP")
    _theta_sweep(eng, ds, deng.bsp.n_active,
                 stage["dtw engine.gram (K1, all-ones plan)"])
    ratio = stage["engine.gram (K1)"] / \
        stage["dtw engine.gram (K1, all-ones plan)"]
    log(f"  SP-DTW / DTW Gram time ratio: {ratio:.3f} (speed-up "
        f"{1 / ratio:.2f}x; tiles {bsp.n_active} vs "
        f"{deng.bsp.n_active})")
    return {"engine": eng, "ds": ds, "X_test": ds.X_test, "G": G, "nn": nn,
            "launches": launches, "stages": stage}


def _theta_sweep(eng, ds, dtw_tiles, dtw_ms):
    """SP-DTW at larger thresholds on the same occupancy counts: tiles
    kept, K1 Gram time against the DTW Gram's, and the 1-NN test error
    (the paper's speed / accuracy trade-off, Fig. 4 and Table VI)."""
    import numpy as np
    import torch
    from repro_torch.core.occupancy import block_sparsify, learn_sparse_paths
    from repro_torch.kernels import gram_block as gb
    Q = torch.as_tensor(ds.X_test, device=DEVICE)
    n_pairs = N_TRAIN * (N_TRAIN - 1) // 2
    for share in (0.01, 0.1, 0.3, 0.5):
        sp = learn_sparse_paths(None, theta=share * n_pairs,
                                gamma=eng.spec.weight_gamma,
                                counts=eng.sp.counts)
        bsp = block_sparsify(sp, tile=eng.bsp.tile)
        ms, G = cuda_ms(lambda: gb.gram_spdtw_block(Q, eng.corpus, bsp))
        nn = torch.argmin(G, dim=1).cpu().numpy()
        err = float(np.mean(ds.y_train[nn] != ds.y_test))
        log(f"  theta = {share:g} x pairs: {sp.n_cells} cells, "
            f"{bsp.n_active} of {dtw_tiles} tiles; K1 Gram {ms:.1f} ms "
            f"(DTW {dtw_ms:.1f} ms, ratio {ms / dtw_ms:.3f}); 1-NN "
            f"error {err:.4f}")


# ---------------------------------------------------------------------------
# Phase 3b: the kernel-measure and baseline path (paper Tables II, IV, VI)
# ---------------------------------------------------------------------------

# meta-parameter grids of the path: nu as benchmarks/common.py, theta as
# shares of the train pairs (an absolute count of 2 keeps every tile at
# this size), the radius grid of the reference's select_radius
NU_GRID = (0.1, 0.5, 2.0)
THETA_SHARES = (0.01, 0.1, 0.3)
RADIUS_FRACS = (0.0, 0.02, 0.05, 0.1, 0.2)


def phase_kernel_path(main):
    """select_nu (K3 Grams), select_theta_gamma for sp_krdtw on fit's
    counts (K3), the Table IV SVM for krdtw / krdtw_sc / sp_krdtw (K3
    Grams, K4 self-similarities), the sp_krdtw kernel cascade (K4 seeds
    and survivors, K1 prefix bound) against the -gram_log argmin, and the
    DTW / DTW_sc baselines (K5 pairs, K6 pairs, select_radius and the
    dtw_sc Gram on K6). Launch counters are set to 0 just before and read
    just after; K1 and K3-K6 must all have launched."""
    import numpy as np
    import torch
    from repro_torch.classify import crossval, svm
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    ds = main["ds"]
    counts = main["engine"].sp.counts
    Xtr = torch.as_tensor(ds.X_train, device=DEVICE)
    Xte = torch.as_tensor(ds.X_test, device=DEVICE)
    n_classes = int(ds.y_train.max()) + 1
    stage = {}

    def timed(name, fn):
        ms, out = cuda_ms(fn)
        stage[name] = ms
        log(f"  {name}: {ms:.1f} ms")
        return out

    log(f"  grids: nu {NU_GRID}, theta {THETA_SHARES} x train pairs, "
        f"radius fractions {RADIUS_FRACS} of T (nothing cut)")
    reset_launch_counts()
    sel_nu = timed("select_nu krdtw (3 K3 Grams 1000 x 1000)",
                   lambda: crossval.select_nu(Xtr, ds.y_train, grid=NU_GRID))
    nu = sel_nu.nu
    log(f"  nu = {nu} (LOO {sel_nu.loo:.4f})")
    n_pairs = N_TRAIN * (N_TRAIN - 1) // 2
    sel_th, curve = timed(
        "select_theta_gamma sp_krdtw (3 K3 Grams 1000 x 1000)",
        lambda: crossval.select_theta_gamma(
            Xtr, ds.y_train, name="sp_krdtw",
            thetas=[f * n_pairs for f in THETA_SHARES], nu=nu,
            counts=counts, return_curve=True))
    for th, _, err, cells in curve:
        log(f"    theta {th:.0f} ({th / n_pairs:g} x pairs): {cells} cells, "
            f"LOO {err:.4f}")
    sp = sel_th.sp
    log(f"  theta = {sel_th.theta:.0f} ({sel_th.theta / n_pairs:g} x pairs, "
        f"{sp.n_cells} cells, LOO {sel_th.loo:.4f})")
    sel_r = timed("select_radius (5 K6 Grams 1000 x 1000)",
                  lambda: crossval.select_radius(Xtr, ds.y_train,
                                                 fracs=RADIUS_FRACS))
    radius = sel_r.radius
    log(f"  dtw_sc radius = {radius} (LOO {sel_r.loo:.4f})")

    svm_err = {}
    for kind in ("krdtw", "krdtw_sc", "sp_krdtw"):
        K, Kt = timed(f"svm_gram_series {kind} (K3 1000 x 1000 + 4000 x "
                      f"1000, K4 4000)",
                      lambda kind=kind: svm.svm_gram_series(
                          Xtr, Xte, kind=kind, sp=sp, nu=nu, radius=radius))
        require(bool(torch.isfinite(K).all()) and
                bool(torch.isfinite(Kt).all()), f"{kind} SVM Gram finite")
        ddiff = float((torch.diagonal(K) - 1).abs().max())
        require(ddiff <= 1e-5, f"{kind} normalized diagonal != 1")
        svm_err[kind] = timed(f"svm_error {kind}",
                              lambda: svm.svm_error(K, Kt, ds.y_train,
                                                    ds.y_test, n_classes))
    log(f"  Table IV SVM test error: " + ", ".join(
        f"{k} {v:.4f}" for k, v in svm_err.items()))

    keng = fit(MeasureSpec("sp_krdtw", nu=nu, theta=sel_th.theta), Xtr,
               labels=ds.y_train, sp=sp)
    nn, nnd, stats = timed("sp_krdtw engine.knn (kernel cascade)",
                           lambda: keng.knn(Xte, return_stats=True))
    LG = timed("sp_krdtw engine.gram_log 4000 x 1000 (K3)",
               lambda: keng.gram_log(Xte))
    ref_nn = torch.argmin(-LG, dim=1).to(torch.int32)
    require(torch.equal(nn, ref_nn), "kernel cascade nn != -gram_log argmin")
    require(torch.equal(nnd, (-LG).gather(1, ref_nn[:, None].long())[:, 0]),
            "kernel cascade distance != -gram_log minimum")
    kerr = float(np.mean(ds.y_train[nn.cpu().numpy()] != ds.y_test))
    gerr = float(np.mean(ds.y_train[ref_nn.cpu().numpy()] != ds.y_test))
    require(kerr == gerr, "cascade error != -gram_log argmin error")
    log(f"  kernel cascade nn == -gram_log argmin, bit for bit; 1-NN "
        f"error SP-K_rdtw {kerr:.4f} (-gram_log argmin {gerr:.4f}); "
        f"stats {stats}")

    deng = fit(MeasureSpec("dtw", support="dense"), Xtr)
    seng = fit(MeasureSpec("dtw_sc", support="band", radius=radius), Xtr)
    y = Xtr[nn.long()]
    Pd = timed("dtw engine.pairs 4000 (K5)", lambda: deng.pairs(Xte, y))
    Ps = timed("dtw_sc engine.pairs 4000 (K5, radius)",
               lambda: seng.pairs(Xte, y))
    Pb = timed("ops.dtw_banded_pairs 4000 (K6)",
               lambda: ops.dtw_banded_pairs(Xte, y, radius))
    ab, rel = diff(Pb, Ps)
    log(f"  K6 vs K5 (radius {radius}) on the same pairs: max abs {ab:.3g} "
        f"max rel {rel:.3g}")
    require(rel <= 1e-5, "K6 and K5 disagree on DTW_sc")
    require(bool((Ps >= Pd).all()), "DTW_sc below DTW")
    Gs = timed("dtw_sc engine.gram 4000 x 1000 (K6)", lambda: seng.gram(Xte))
    serr = float(np.mean(
        ds.y_train[torch.argmin(Gs, dim=1).cpu().numpy()] != ds.y_test))
    log(f"  1-NN test error: DTW_sc (radius {radius}) {serr:.4f}")
    launches = launch_counts()
    log(f"  launches on the kernel path: {launches}")
    for k in SLICE2:
        require(launches[k] > 0, f"{k} never launched on the kernel path")
    return {"nu": nu, "sp": sp, "radius": radius, "keng": keng, "LG": LG,
            "nn": nn, "Gs": Gs, "launches": launches, "stages": stage}


# ---------------------------------------------------------------------------
# Phase 3c: the centroid and soft-Gram path
# ---------------------------------------------------------------------------

# the train x train gradient runs on the support of this share of the
# train pairs (8 tiles): the theta = 2 plan's 64 tiles would need ~66 GB of
# stash at 1000 x 1000
GRAD_THETA_SHARE = 0.1
N_GRAD_CHECK = 64       # rows of gA held against the plain backward


def phase_centroid_path(main):
    """fit_centroids (4 classes, 60 Adam steps each: K8 / K9 in paired
    mode, K1 for the medoids), the centroid-seeded cascade (K1, K2) whose
    neighbours must equal phase 3's cascade and the Gram argmin, centroid
    and knn classification, the soft Gram 4000 x 1000 without a gradient
    (K7, held below the hard Gram), and the train x train soft Gram with
    a gradient (K8 then K9 in Gram mode) on the 10 %-share support, with
    gA held against the plain backward and gw zero outside the support.
    Launch counters are set to 0 just before and read just after."""
    import numpy as np
    import torch
    from repro_torch.core.engine import fit
    from repro_torch.core.occupancy import block_sparsify, learn_sparse_paths
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import soft_block as sb
    eng, ds, G = main["engine"], main["ds"], main["G"]
    Xtr = eng.corpus
    Xte = torch.as_tensor(ds.X_test, device=DEVICE)
    gamma = float(eng.spec.gamma)
    stage = {}

    def timed(name, fn):
        ms, out = cuda_ms(fn)
        stage[name] = ms
        log(f"  {name}: {ms:.1f} ms")
        return out

    reset_launch_counts()
    ceng = timed("fit_centroids (4 classes x 60 steps; K8 / K9 paired, K1 "
                 "medoids)", lambda: eng.fit_centroids(n_per_class=1,
                                                       steps=60))
    cm = ceng.centroid_model
    log(f"  centroids: {cm.k}, labels {cm.labels.tolist()}, medoids "
        f"{cm.medoids.tolist()}, gamma {gamma}")
    require(cm.k == 4 and bool(torch.isfinite(cm.centroids).all()),
            "centroids finite, one per class")
    nn, nnd, stats = timed("engine.knn centroid-seeded cascade",
                           lambda: ceng.knn(Xte, return_stats=True))
    require(stats["n_centroids"] == 4, "stats n_centroids != 4")
    require(torch.equal(nn, main["nn"]),
            "centroid-seeded nn != phase 3 cascade nn")
    ref_nn = torch.argmin(G, dim=1).to(torch.int32)
    require(torch.equal(nn, ref_nn), "centroid-seeded nn != Gram argmin")
    require(torch.equal(nnd, G.gather(1, ref_nn[:, None].long())[:, 0]),
            "centroid-seeded nn distance != Gram minimum")
    log(f"  centroid-seeded nn == phase 3 cascade == Gram argmin, bit for "
        f"bit; stats {stats}")
    pc = timed("engine.classify via centroid (K1 4000 x 4)",
               lambda: ceng.classify(Xte, via="centroid"))
    pk = timed("engine.classify via knn (the seeded cascade)",
               lambda: ceng.classify(Xte, via="knn"))
    cerr = float(np.mean(pc != ds.y_test))
    kerr = float(np.mean(pk != ds.y_test))
    log(f"  test error: nearest centroid {cerr:.4f}, 1-NN {kerr:.4f}")

    def soft_gram():
        with torch.no_grad():
            return ceng.soft_gram(Xte)

    Gs = timed(f"engine.soft_gram {N_TEST} x {N_TRAIN}, no gradient (K7)",
               soft_gram)
    fin = G < 1e29
    require(tuple(Gs.shape) == tuple(G.shape), "soft Gram shape")
    require(bool(torch.isfinite(Gs[fin]).all()),
            "soft Gram not finite where the hard Gram is")
    require(bool((Gs <= G + 1e-3 * G.abs()).all()),
            "soft Gram above the hard Gram (beyond 1e-3 relative)")
    log(f"  soft Gram <= hard Gram everywhere (1e-3 relative slack); max "
        f"hard - soft {float((G - Gs)[fin].max()):.4g}, min "
        f"{float((G - Gs)[fin].min()):.4g}")

    # the train x train gradient on the 10 %-share support
    n_pairs = N_TRAIN * (N_TRAIN - 1) // 2
    sp = learn_sparse_paths(None, theta=GRAD_THETA_SHARE * n_pairs,
                            gamma=eng.spec.weight_gamma,
                            counts=eng.sp.counts)
    geng = fit(eng.spec, Xtr, labels=ds.y_train, sp=sp, device=DEVICE)
    bsp = geng.bsp
    g_out = sb.result_tile_step(bsp.plan(), bsp.tile, T_MAIN)
    walked = g_out + 1
    stash_gb = N_TRAIN * N_TRAIN * walked * bsp.tile ** 2 * 4 / 1e9
    log(f"  gradient support: theta {GRAD_THETA_SHARE:g} x pairs, "
        f"{sp.n_cells} cells, {bsp.n_active} tiles; stash "
        f"{N_TRAIN} x {N_TRAIN} pairs x {walked} walked tiles x "
        f"{bsp.tile}^2 x 4 B = {stash_gb:.2f} GB")
    gbar = torch.as_tensor(np.random.default_rng(5).normal(
        size=(N_TRAIN, N_TRAIN)).astype(np.float32), device=DEVICE)
    A = Xtr.clone().requires_grad_()
    W = geng.weights.clone().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    Gv = timed(f"soft_gram {N_TRAIN} x {N_TRAIN} with grad, forward (K8)",
               lambda: sb.soft_spdtw_gram_batch(A, Xtr, W, gamma))
    timed(f"soft_gram {N_TRAIN} x {N_TRAIN} backward (K9)",
          lambda: (Gv * gbar).sum().backward())
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    require(bool(torch.isfinite(A.grad).all()), "gA finite")
    n = N_GRAD_CHECK
    v_p, st_p = sb.gram_soft_fwd_stash(Xtr[:n], Xtr, bsp, gamma)
    require(torch.equal(v_p, Gv.detach()[:n]),
            "K8 values != the plain forward, not bit for bit")
    log(f"  K8 values [:{n}] == plain forward, bit for bit")
    gb_n = gbar[:n] * (v_p < 1e29)
    gA_p, _, _ = sb.gram_soft_bwd_scan(Xtr[:n], Xtr, bsp, gamma, st_p, gb_n)
    ab, rel, exc = _soft_diff(A.grad[:n], gA_p, GRAD_RTOL,
                              GRAD_RTOL * float(gA_p.abs().max()))
    log(f"  K9 gA[:{n}] vs plain backward on {n} x {N_TRAIN} pairs: max abs "
        f"{ab:.3g} max rel {rel:.3g} (limit rtol {GRAD_RTOL}, atol "
        f"{GRAD_RTOL} x max |gA|)")
    require(exc <= 0, "K9 gA disagrees with the plain backward")
    off = geng.weights == 0
    require(bool((W.grad[off] == 0).all()), "gw nonzero outside the support")
    log(f"  gw zero on all {int(off.sum())} cells outside the support; "
        f"max |gw| inside {float(W.grad.abs().max()):.4g}")
    launches = launch_counts()
    log(f"  launches on the centroid path: {launches}")
    for k in SOFT + SLICE1:
        require(launches[k] > 0, f"{k} never launched on the centroid path")
    paired = _check_paired_main(eng, int(cm.labels[0]), gamma)
    return {"ceng": ceng, "Gs": Gs, "geng": geng, "gbar": gbar,
            "gA": A.grad, "launches": launches, "stages": stage,
            "grad_err": ab, "paired": paired}


def _bwd_bare(z, X, bsp, gamma, stash, gbar, template):
    """Device time (ms) of K9's bare launch into buffers allocated and
    zeroed beforehand, and the template the launch took."""
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import series_dim, to_tile_major
    S = bsp.tile
    T = z.shape[1]
    kw = dict(gram=False, d=series_dim(z), r=(T - 1) % S, gamma=gamma,
              g_out=sb.result_tile_step(bsp.plan(), S, T), template=template)
    zp, Xp = to_tile_major(z, S, bsp.T), to_tile_major(X, S, bsp.T)
    gb = gbar.reshape(-1).contiguous()
    out = sb.soft_bwd_launch(zp, Xp, bsp, stash, gb, **kw)
    ms, _ = device_ms(lambda: sb.soft_bwd_launch(zp, Xp, bsp, stash, gb,
                                                 out=out, **kw))
    geo = sb.soft_geometry(S, kw["d"], bsp.T, X.shape[0], _width(bsp, T),
                           backward=True, template=template)
    return ms, geo["template"]


def _width(bsp, T):
    """Tiles on the widest tile anti-diagonal of ``bsp``'s walked plan."""
    import numpy as np
    from repro_torch.kernels import soft_block as sb
    g_out = sb.result_tile_step(bsp.plan(), bsp.tile, T)
    _, dptr = sb.tile_diagonals(bsp.plan()[:g_out + 1])
    return int(np.diff(dptr).max())


def _check_paired_main(eng, label, gamma):
    """K8 / K9 in paired mode at the shapes ``fit_centroids`` gives them:
    the members of one class against their Euclidean mean (the inputs of
    the first Adam step) on the engine's plan, with the barycenter loss's
    cotangent 1 / B per pair. K8's values and stash equal the plain
    version (``soft_spdtw_fwd_stash``) bit for bit under both templates;
    K9 fed the kernel's stash against ``soft_spdtw_bwd_block``
    fed the same at GRAD_RTOL / GRAD_ATOL, and K9's two templates with
    equal gx, gy and E blocks. Times each kernel's wrapper (what a step of
    the fit calls: layout, allocation, the launch and, for K9, the gw sum
    and scatter) and its bare launch under each template (device time).
    Returns each kernel's max abs difference and its times. Run after the
    path's launches were read, so these launches count nowhere."""
    import numpy as np
    import torch
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import to_tile_major
    Xtr = eng.corpus
    idx = np.nonzero(np.asarray(eng.labels) == label)[0]
    X = Xtr[torch.as_tensor(idx, device=Xtr.device)]
    B, T = X.shape[0], X.shape[1]
    z = X.mean(dim=0).expand(X.shape).contiguous()
    bsp = sb.soft_plan(eng.bsp)
    S = bsp.tile
    ms8, (v8, L8) = cuda_ms(lambda: sb.soft_fwd_stash_block(
        z, X, bsp, gamma, gram=False), reps=3, warmup=1)
    pms8, (vp, Lp) = cuda_ms(lambda: sb.soft_spdtw_fwd_stash(z, X, bsp,
                                                              gamma))
    fails, err = [], {}
    for what, got, want in (("values", v8, vp), ("stash", L8, Lp)):
        ab, rel, _ = _soft_diff(got, want, 0.0, 0.0)
        err["soft_tiles_stash"] = max(err.get("soft_tiles_stash", 0.0), ab)
        log(f"  K8 paired {what}, class {label} ({B} pairs, "
            f"{L8.shape[0]} walked tiles): max abs {ab:.3g} max rel "
            f"{rel:.3g}")
        if not torch.equal(got, want):
            fails.append(f"K8 paired {what} != plain, not bit for bit")
    gbar = torch.full((B,), 1.0 / B, device=X.device) * (vp < 1e29)
    ms9, gk = cuda_ms(lambda: sb.soft_bwd_block(z, X, bsp, gamma, L8, gbar,
                                                gram=False), reps=3,
                      warmup=1)
    pms9, gp = cuda_ms(lambda: sb.soft_spdtw_bwd_block(z, X, bsp, gamma,
                                                       L8, gbar))
    for name, a, b in zip(("gx", "gy", "gw"), gk, gp):
        ab, rel, exc = _soft_diff(a, b, GRAD_RTOL, GRAD_ATOL)
        err["soft_tiles_bwd"] = max(err.get("soft_tiles_bwd", 0.0), ab)
        log(f"  K9 paired {name}: max abs {ab:.3g} max rel {rel:.3g}")
        if exc > 0:
            fails.append(f"K9 paired {name} beyond rtol {GRAD_RTOL} atol "
                         f"{GRAD_ATOL}")
    _template_gates(f"paired, class {label}",
                    _fwd_templates(z, X, bsp, gamma, T, False), vp, Lp,
                    _bwd_templates(z, X, bsp, gamma, T, False, L8, gbar),
                    fails)
    # bare launches under each template (device time)
    g_out = sb.result_tile_step(bsp.plan(), S, T)
    zp, Xp = to_tile_major(z, S, bsp.T), to_tile_major(X, S, bsp.T)
    bare = {}
    for tmpl in ("auto",) + TEMPLATES:
        b8, _ = device_ms(lambda: sb.soft_fwd_cuda(
            zp, Xp, bsp, gram=False, d=1, g_out=g_out, r=(T - 1) % S,
            gamma=gamma, stash=True, template=tmpl))
        b9, t9 = _bwd_bare(z, X, bsp, gamma, L8, gbar, tmpl)
        bare[tmpl] = (b8, b9, t9)
    K, Tp = int(L8.shape[0]), bsp.T
    cells, stash_bytes = B * K * S * S, B * K * S * S * 4
    b8 = _bound_cells(cells, _soft_fwd_flops(1), SOFT_FWD_SFU,
                      2 * B * Tp * 4, B * 4 + stash_bytes)
    b9 = _bound_cells(cells, _soft_bwd_flops(1), SOFT_BWD_SFU,
                      2 * B * Tp * 4 + stash_bytes + B * 4,
                      2 * B * Tp * 4 + Tp * Tp * 4)
    n_diag = len(sb.tile_diagonals(bsp.plan()[:g_out + 1])[1]) - 1
    log(f"  paired mode per Adam step of class {label} ({B} pairs, {K} "
        f"tiles on {n_diag} tile diagonals, widest {_width(bsp, T)}): "
        f"K8 wrapper {ms8:.3f} ms (plain {pms8:.1f} ms, bound {b8[0]:.4f} ms "
        f"by {b8[1]}), K9 wrapper {ms9:.3f} ms (plain {pms9:.1f} ms, bound "
        f"{b9[0]:.4f} ms by {b9[1]})")
    for tmpl, (t8, t9, chosen) in bare.items():
        log(f"  bare launch, template {tmpl} (K9 took {chosen}): K8 "
            f"{t8:.4f} ms, K9 {t9:.4f} ms")
    require(not fails, "; ".join(fails))
    return {"err": err, "ms": {"soft_tiles_stash": (ms8, pms8, b8),
                               "soft_tiles_bwd": (ms9, pms9, b9)},
            "bare": bare}


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------

def _bound_cells(cells, flops, sfu, in_bytes, out_bytes):
    """Least time (ms) for ``cells`` needed DP cells of ``flops`` FP32
    operations and ``sfu`` special-function results each, against the
    bytes read and written once; and what bounds it."""
    t_ops = max(cells * flops / FP32_PEAK, cells * sfu / SFU_RATE)
    t_bytes = (in_bytes + out_bytes) / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


# per needed cell of log K_rdtw: kappa (sub, mul, mul by -nu), K1 (2 add,
# 2 mul), K2 (3 add, 5 mul), the rescale (4 mul) = 19 FP32 operations
# and one expf
KRDTW_FLOPS = 19
# per pair and diagonal k = 1 .. 2T-2, whatever the support: the rescale's
# logf and division, 2 special-function results (lg2, rcp) and 2 FP32
# operations (the log's scale multiply, the running sum's add)
KRDTW_DIAG_SFU, KRDTW_DIAG_FLOPS = 2, 2


def _krdtw_bound(pairs, T, cells, in_bytes, out_bytes):
    """Least time (ms) of ``pairs`` log K_rdtw sweeps of ``cells``
    admissible cells each over series of length T: the cells' operations
    and expf, and the (2T - 2) per-diagonal rescales of every pair."""
    diags = pairs * (2 * T - 2)
    t_ops = max((pairs * cells * KRDTW_FLOPS + diags * KRDTW_DIAG_FLOPS)
                / FP32_PEAK,
                (pairs * cells + diags * KRDTW_DIAG_SFU) / SFU_RATE)
    t_bytes = (in_bytes + out_bytes) / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def _admissible_cells(T, radius=None, support=None):
    """Cells of the T x T grid inside the corridor and the support."""
    import numpy as np
    i = np.arange(T)
    ok = np.ones((T, T), bool) if support is None else np.asarray(support)
    if radius is not None:
        ok = ok & (np.abs(i[:, None] - i[None, :]) <= radius)
    return int(ok.sum())
# per needed cell of DTW: d sub, d mul, d - 1 add, then 2 min and 1 add
def _dtw_flops(d):
    return 3 * d + 2


# per needed cell of SP-DTW: DTW's, and 1 weight multiply
def _spdtw_flops(d):
    return 3 * d + 3


def phase_timing_slice2(kp, ds):
    """K3-K6 at the kernel path's shapes against their plain versions,
    with their bounds. K3 is timed at each of its shapes (the learned
    support 4000 x 1000, the full grid and the radius-0 corridor 1000 x
    1000); plain K3 and plain K6 are timed on 64 x 1000 slices (both are
    launch-bound loops over diagonals / rows)."""
    import torch
    from repro_torch.core.dtw import band_cells
    from repro_torch.kernels import dtw_banded as kb
    from repro_torch.kernels import dtw_wavefront as kw
    from repro_torch.kernels import gram_block as gb
    from repro_torch.kernels import krdtw_wavefront as kk
    Xtr = torch.as_tensor(ds.X_train, device=DEVICE)
    Xte = torch.as_tensor(ds.X_test, device=DEVICE)
    Na, Nb, T = Xte.shape[0], Xtr.shape[0], Xte.shape[1]
    nu, sp, radius = kp["nu"], kp["sp"], kp["radius"]
    sup = sp.support.cpu().numpy()
    rows = []

    def row(name, ms, plain_ms, ab, bound, what):
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "max_abs_err": ab, "bound_ms": bound[0],
                     "bound_by": bound[1]})
        log(f"  {name} {what}: {ms:.3f} ms (plain {plain_ms:.1f} ms, "
            f"bound {bound[0]:.4f} ms by {bound[1]}, max abs err {ab:.3g})")

    # K3 at each shape the kernel path launches it at: the sp_krdtw Gram of
    # the SVM and the cascade's reference (the main shape, in the kernels
    # line), the full-grid Grams of select_nu and the radius-0 corridor
    # Grams of krdtw_sc; each held bit for bit against its plain version
    # on a slice of rows
    n_sl = 64
    shapes = (("sp_krdtw learned support", Xte, {"support": sup}),
              ("full grid (select_nu, krdtw)", Xtr, {}),
              ("radius-0 corridor (krdtw_sc)", Xtr, {"radius": 0}))
    k3 = {}
    for what, Q, kw_ in shapes:
        ms, G = cuda_ms(lambda: gb.gram_log_krdtw_block(Q, Xtr, nu, **kw_),
                        reps=3, warmup=1)
        if "support" in kw_:
            require(torch.equal(G, kp["LG"]),
                    "K3 not deterministic across runs")
        pms, Gp = cuda_ms(lambda: gb.gram_log_krdtw_plain(Q[:n_sl], Xtr, nu,
                                                          **kw_))
        require(torch.equal(G[:n_sl], Gp),
                f"K3 {what}: not bit for bit with the plain version")
        ab, _ = diff(G[:n_sl], Gp)
        cells = _admissible_cells(T, kw_.get("radius"), kw_.get("support"))
        geo = kk.krdtw_geometry(T, kw_.get("radius"), None if "support"
                                not in kw_ else kk.pack_diagonal_mask(
                                    kk.mask_to_diagonal_major(sup), T,
                                    "cpu"))
        bound = _krdtw_bound(Q.shape[0] * Nb, T, cells,
                             (Q.shape[0] + Nb) * T * 4, Q.shape[0] * Nb * 4)
        k3[what] = (ms, pms, ab, bound)
        log(f"  krdtw_gram {Q.shape[0]}x{Nb} {what} ({cells} cells, hull "
            f"W {geo.W}, {'wide' if geo.wide else f'narrow G {geo.G}'}): "
            f"{ms:.3f} ms (plain {pms:.1f} ms on {n_sl}x{Nb}, bound "
            f"{bound[0]:.4f} ms by {bound[1]})")
    ms, pms, ab, bound = k3["sp_krdtw learned support"]
    rows.append({"name": "krdtw_gram", "ms": ms, "plain_ms": pms,
                 "max_abs_err": ab, "bound_ms": bound[0],
                 "bound_by": bound[1]})

    # K4: the cascade's seed shapes, seed_k = 2 pairs per query
    nn = kp["nn"].long()
    g = torch.Generator(device="cpu").manual_seed(3)
    other = torch.randint(0, Nb, (Na,), generator=g).to(DEVICE)
    x = Xte.repeat_interleave(2, dim=0)
    y = Xtr[torch.stack([nn, other], dim=1).reshape(-1)]
    md = kk.mask_to_diagonal_major(sup)
    ms, P = cuda_ms(lambda: kk.wavefront_log_krdtw(x, y, nu, mask_diag=md),
                    reps=5, warmup=1)
    pms, Pp = cuda_ms(lambda: kk.wavefront_log_krdtw_plain(x, y, nu,
                                                           mask_diag=md))
    ab, rel = diff(P, Pp)
    require(torch.equal(P, Pp), f"K4 at main shapes: rel {rel}")
    B = x.shape[0]
    row("krdtw_paired", ms, pms, ab,
        _krdtw_bound(B, T, sp.n_cells, 2 * B * T * 4, B * 4),
        f"{B} pairs sp_krdtw")

    # K5: DTW over the 4000 (query, nearest) pairs of engine.pairs
    y1 = Xtr[nn]
    ms, P = cuda_ms(lambda: kw.wavefront_dtw(Xte, y1), reps=5, warmup=1)
    pms, Pp = cuda_ms(lambda: kw.wavefront_dtw_plain(Xte, y1))
    ab, rel = diff(P, Pp)
    require(rel <= REL_LIMIT, f"K5 at main shapes: rel {rel}")
    row("dtw_wavefront", ms, pms, ab,
        _bound_cells(Na * T * T, _dtw_flops(1), 0, 2 * Na * T * 4, Na * 4),
        f"{Na} pairs full grid")

    # K6: the dtw_sc Gram at the selected radius, then the widest strip
    # the path runs (select_radius's last candidate, over train x train)
    ms, G6 = cuda_ms(lambda: kb.banded_dtw_gram(Xte, Xtr, radius), reps=3,
                     warmup=1)
    require(torch.equal(G6, kp["Gs"]), "K6 not deterministic across runs")
    log(f"  dtw_banded {Na}x{Nb} radius {radius} (the dtw_sc Gram): "
        f"{ms:.3f} ms")
    w = max(int(round(f * T)) for f in RADIUS_FRACS)
    ms, G6 = cuda_ms(lambda: kb.banded_dtw_gram(Xtr, Xtr, w), reps=3,
                     warmup=1)
    n6 = 64
    pms, Gp6 = cuda_ms(lambda: kb.banded_dtw_gram_plain(Xtr[:n6], Xtr, w,
                                                        block=n6 * Nb))
    ab, rel = diff(G6[:n6], Gp6)
    require(rel <= REL_LIMIT, f"K6 at main shapes: rel {rel}")
    cells = band_cells(T, T, w)
    row("dtw_banded", ms, pms, ab,
        _bound_cells(Nb * Nb * cells, _dtw_flops(1), 0, 2 * Nb * T * 4,
                     Nb * Nb * 4),
        f"{Nb}x{Nb} radius {w} ({cells} cells; plain on {n6}x{Nb})")
    return rows


# per needed cell of the soft forward: the logit (3d + 1: d sub, d mul,
# d - 1 add, the weight and the -1/gamma multiplies), the top / top-left
# logaddexp and the in-row one (sub, max, abs, add each) with their two
# adds, = 3d + 11 FP32 operations; and an expf and a log1pf per
# logaddexp: 4 special-function results
def _soft_fwd_flops(d):
    return 3 * d + 11


SOFT_FWD_SFU = 4
# per needed cell of the reverse sweep: three transition coefficients
# (add, sub, two clamps, three compares; an expf each), f = a E + c E' + inj
# (4), the in-row recurrence (2), the logit (3d + 2) and the cotangent
# terms (E w, E phi gbar, 2d for the row and column sums)
SOFT_BWD_SFU = 3


def _soft_bwd_flops(d):
    return 5 * d + 29


def phase_timing_soft(main, cp):
    """K7 over the 4000 x 1000 soft Gram (theta = 2 plan) and K8 / K9 over
    the 1000 x 1000 train Gram with a gradient (10 %-share plan), against
    their plain versions on slices (plain K7 on 16 x 1000 pairs, plain
    K8 / K9 on 64 x 1000), with their bounds. K8 / K9 times are the bare
    launch's device time, their wrappers' beside them. Then K8 / K9 in
    paired mode on the main plan under both templates on either side of
    ``PAIRS_MIN_FWD`` / ``PAIRS_MIN_BWD``."""
    import numpy as np
    import torch
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import to_tile_major
    eng, ds = main["engine"], main["ds"]
    Xtr = eng.corpus
    Xte = torch.as_tensor(ds.X_test, device=DEVICE)
    gamma = float(eng.spec.gamma)
    T, S = T_MAIN, eng.bsp.tile
    rows = []

    def row(name, ms, plain_ms, ab, bound, what):
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "max_abs_err": ab, "bound_ms": bound[0],
                     "bound_by": bound[1]})
        log(f"  {name} {what}: {ms:.3f} ms (plain {plain_ms:.1f} ms, "
            f"bound {bound[0]:.4f} ms by {bound[1]}, max abs err {ab:.3g})")

    # K7: the soft Gram of phase 3c
    bsp = eng.bsp
    g_out = sb.result_tile_step(bsp.plan(), S, T)
    Na, Nb = Xte.shape[0], Xtr.shape[0]
    geo = sb.soft_geometry(S, 1, bsp.T, Na * Nb, _width(bsp, T))
    ms, G7 = cuda_ms(lambda: sb.gram_soft_spdtw_block(Xte, Xtr, bsp, gamma))
    require(torch.equal(G7, cp["Gs"]), "K7 not deterministic across runs")
    n7 = 16
    pms, Gp = cuda_ms(lambda: sb.gram_soft_spdtw_scan(Xte[:n7], Xtr, bsp,
                                                      gamma, block_a=n7))
    require(torch.equal(G7[:n7], Gp), "K7 != plain at main shapes")
    ab, _ = diff(G7[:n7], Gp)
    cells = Na * Nb * (g_out + 1) * S * S
    row("soft_tiles_fwd", ms, pms, ab,
        _bound_cells(cells, _soft_fwd_flops(1), SOFT_FWD_SFU,
                     (Na + Nb) * T * 4, Na * Nb * 4),
        f"{Na}x{Nb} ({g_out + 1} walked tiles, template {geo['template']}, "
        f"{geo['threads']} threads; plain on {n7}x{Nb})")

    # K8 / K9: the train x train Gram with a gradient of phase 3c
    gb_ = cp["geng"].bsp
    g_out = sb.result_tile_step(gb_.plan(), S, T)
    K = g_out + 1
    r = (T - 1) % S
    wid = _width(gb_, T)
    Xp = to_tile_major(Xtr, S, gb_.T)
    kw = dict(gram=True, d=1, g_out=g_out, r=r, gamma=gamma)
    ms8, (v8, L8) = device_ms(lambda: sb.soft_fwd_cuda(Xp, Xp, gb_,
                                                       stash=True, **kw))
    wms8, _ = cuda_ms(lambda: sb.soft_fwd_stash_block(Xtr, Xtr, gb_, gamma,
                                                      gram=True))
    n = N_GRAD_CHECK
    pms8, (vp, Lp) = cuda_ms(lambda: sb.gram_soft_fwd_stash(
        Xtr[:n], Xtr, gb_, gamma, block_a=n))
    require(torch.equal(L8[:, :n * Nb], Lp),
            "K8 stash != plain at main shapes")
    require(torch.equal(v8[:n * Nb], vp.reshape(-1)),
            "K8 values != plain at main shapes")
    ab8, _ = diff(L8[:, :n * Nb], Lp)
    cells = Nb * Nb * K * S * S
    stash_bytes = Nb * Nb * K * S * S * 4
    # the error in the kernels line: the worst of Gram mode here and of
    # paired mode at the barycenter fit's shapes (phase 3c)
    perr = cp["paired"]["err"]
    g8 = sb.soft_geometry(S, 1, gb_.T, Nb * Nb, wid)
    row("soft_tiles_stash", ms8, pms8, max(ab8, perr["soft_tiles_stash"]),
        _bound_cells(cells, _soft_fwd_flops(1), SOFT_FWD_SFU,
                     2 * Nb * T * 4, Nb * Nb * 4 + stash_bytes),
        f"{Nb}x{Nb} bare launch ({K} walked tiles, stash "
        f"{stash_bytes / 1e9:.2f} GB, template {g8['template']}; wrapper "
        f"{wms8:.3f} ms; plain on {n}x{Nb})")
    gbar = (cp["gbar"] * (v8.reshape(Nb, Nb) < 1e29)).reshape(-1) \
        .contiguous()
    out = sb.soft_bwd_launch(Xp, Xp, gb_, L8, gbar, **kw)
    ms9, _ = device_ms(lambda: sb.soft_bwd_launch(Xp, Xp, gb_, L8, gbar,
                                                  out=out, **kw))
    del out
    wms9, (gx, _, _, _) = cuda_ms(lambda: sb.soft_bwd_cuda(
        Xp, Xp, gb_, L8, gbar, **kw))
    del L8
    gA = gx.reshape(Nb, Nb, -1).sum(1)[:, :T]
    del gx
    pms9, (gA_p, _, _) = cuda_ms(lambda: sb.gram_soft_bwd_scan(
        Xtr[:n], Xtr, gb_, gamma, Lp, gbar.reshape(Nb, Nb)[:n], block_a=n))
    ab9, _, exc = _soft_diff(gA[:n], gA_p, GRAD_RTOL,
                             GRAD_RTOL * float(gA_p.abs().max()))
    require(exc <= 0, "K9 gA at main shapes")
    g9 = sb.soft_geometry(S, 1, gb_.T, Nb * Nb, wid, backward=True)
    row("soft_tiles_bwd", ms9, pms9, max(ab9, perr["soft_tiles_bwd"]),
        _bound_cells(cells, _soft_bwd_flops(1), SOFT_BWD_SFU,
                     2 * Nb * T * 4 + stash_bytes + Nb * Nb * 4,
                     2 * Nb * T * 4 + T * T * 4),
        f"{Nb}x{Nb} bare launch ({K} walked tiles, template "
        f"{g9['template']}; wrapper with the zeroing and the gw sum "
        f"{wms9:.3f} ms; plain on {n}x{Nb})")
    for r_ in rows:
        if r_["name"] != "soft_tiles_fwd":
            pm = cp["paired"]["ms"][r_["name"]]
            bare = cp["paired"]["bare"]["auto"]
            log(f"  {r_['name']} at the barycenter shapes: bare "
                f"{bare[0 if r_['name'] == 'soft_tiles_stash' else 1]:.4f} "
                f"ms, wrapper {pm[0]:.4f} ms, bound {pm[2][0]:.4f} ms")
    _template_sweep(eng, gamma)
    return rows


# the pair counts on either side of PAIRS_MIN_BWD (K9) and PAIRS_MIN_FWD
# (K7 / K8)
SWEEP_P = (2048, 4096, 16384, 32768)


def _template_sweep(eng, gamma):
    """Bare K8 / K9 launches in paired mode on the main plan under both
    templates at P in SWEEP_P pairs (device time, ms): a record of where
    each threshold sits, not a gate."""
    import numpy as np
    import torch
    from repro_torch.kernels import soft_block as sb
    from repro_torch.kernels.backends import to_tile_major
    bsp = sb.soft_plan(eng.bsp)
    S, T = bsp.tile, T_MAIN
    g_out = sb.result_tile_step(bsp.plan(), S, T)
    kw = dict(gram=False, d=1, g_out=g_out, r=(T - 1) % S, gamma=gamma)
    rng = np.random.default_rng(9)
    C = eng.corpus
    log(f"  template sweep, paired mode, {g_out + 1} tiles (bare launch, "
        f"device ms): P, K8 pairs, K8 tiles, K9 pairs, K9 tiles")
    for P in SWEEP_P:
        ia = torch.as_tensor(rng.integers(0, C.shape[0], P), device=DEVICE)
        ib = torch.as_tensor(rng.integers(0, C.shape[0], P), device=DEVICE)
        xp, yp = to_tile_major(C[ia], S, bsp.T), to_tile_major(C[ib], S,
                                                                bsp.T)
        t8, t9 = {}, {}
        for tmpl in TEMPLATES:
            t8[tmpl], (v, L) = device_ms(lambda: sb.soft_fwd_cuda(
                xp, yp, bsp, stash=True, template=tmpl, **kw), reps=3)
            gb = torch.full((P,), 1.0 / P, device=DEVICE) * (v < 1e29)
            out = sb.soft_bwd_launch(xp, yp, bsp, L, gb, template=tmpl, **kw)
            t9[tmpl], _ = device_ms(lambda: sb.soft_bwd_launch(
                xp, yp, bsp, L, gb, template=tmpl, out=out, **kw), reps=3)
            del out, L
        log(f"    {P:6d} {t8['pairs']:9.4f} {t8['tiles']:9.4f} "
            f"{t9['pairs']:9.4f} {t9['tiles']:9.4f}")


def phase_timing(main):
    import torch
    from repro_torch.kernels import gram_block as gb
    from repro_torch.kernels.spdtw_block import spdtw_block
    eng, G = main["engine"], main["G"]
    bsp = eng.bsp
    Q = torch.as_tensor(main["X_test"], device=DEVICE)
    C = eng.corpus
    T, S = Q.shape[1], bsp.tile
    meta_b = bsp.plan().nbytes + bsp.blocks.nbytes
    rows = []

    # K1 at the Gram's shapes
    ms, Gk = cuda_ms(lambda: gb.gram_spdtw_block(Q, C, bsp), reps=5,
                     warmup=1)
    plain_ms, Gp = cuda_ms(lambda: gb.gram_spdtw_scan(Q, C, bsp,
                                                      block_a=500))
    ab, rel = diff(Gk, Gp)
    require(torch.equal(Gk, Gp), f"K1 at main shapes: rel {rel}")
    require(torch.equal(Gk, G), "K1 not deterministic across runs")
    Na, Nb = Q.shape[0], C.shape[0]
    bound_ms, bound_by = _bound_cells(Na * Nb * bsp.n_active * S * S,
                                      _spdtw_flops(1), 0,
                                      (Na + Nb) * T * 4 + meta_b, Na * Nb * 4)
    rows.append({"name": "spdtw_tiles_gram", "ms": ms, "plain_ms": plain_ms,
                 "max_abs_err": ab, "bound_ms": bound_ms,
                 "bound_by": bound_by})
    log(f"  K1 gram {Na}x{Nb}: {ms:.2f} ms (plain {plain_ms:.1f} ms, "
        f"bound {bound_ms:.3f} ms by {bound_by})")

    # K2 at the cascade's seed shapes: seed_k = 2 pairs per query
    nn = main["nn"].long()
    g = torch.Generator(device="cpu").manual_seed(3)
    other = torch.randint(0, Nb, (Na,), generator=g).to(DEVICE)
    x = Q.repeat_interleave(2, dim=0)
    y = C[torch.stack([nn, other], dim=1).reshape(-1)]
    ms2, Pk = cuda_ms(lambda: spdtw_block(x, y, bsp), reps=5, warmup=1)
    plain2, Pp = cuda_ms(lambda: gb.spdtw_paired_scan(x, y, bsp,
                                                      block_p=8192))
    ab2, rel2 = diff(Pk, Pp)
    require(torch.equal(Pk, Pp), f"K2 at main shapes: rel {rel2}")
    B = x.shape[0]
    b2_ms, b2_by = _bound_cells(B * bsp.n_active * S * S, _spdtw_flops(1),
                                0, 2 * B * T * 4 + meta_b, B * 4)
    rows.append({"name": "spdtw_tiles_paired", "ms": ms2,
                 "plain_ms": plain2, "max_abs_err": ab2, "bound_ms": b2_ms,
                 "bound_by": b2_by})
    log(f"  K2 paired {B}: {ms2:.3f} ms (plain {plain2:.1f} ms, bound "
        f"{b2_ms:.4f} ms by {b2_by})")
    return rows


def kernels_line(rows, launches):
    """The ``{"kernels": [...]}`` entries: each kernel's launches come from
    the path it belongs to (K1 / K2 the SP-DTW path, K3-K6 the kernel
    path, K7-K9 the centroid and soft-Gram path)."""
    out = []
    for r in rows:
        out.append({"name": r["name"], "route": "cuda",
                    "source": KERNELS[r["name"]][1],
                    "replaces": KERNELS[r["name"]][0],
                    "launches": launches[r["name"]],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None})
    return out


def phase_profile(main, kp=None, cp=None):
    """Device time by kernel over one ``engine.knn``, one ``engine.gram``
    and the occupancy counts of 200 train series (torch.profiler), and,
    after the kernel path, one sp_krdtw ``engine.knn``, one SVM Gram
    series, ``select_nu`` and ``select_theta_gamma``, and after the centroid path, one 10-step barycenter fit of a
    class and one centroid-seeded ``engine.knn``; with the device's busy
    share of the wall time of each call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.occupancy import pairwise_path_counts
    eng, X = main["engine"], main["X_test"]
    calls = [("engine.knn", lambda: eng.knn(X)),
             ("engine.gram", lambda: eng.gram(X)),
             ("pairwise_path_counts, 200 train series",
              lambda: pairwise_path_counts(eng.corpus[:200]))]
    if kp is not None:
        from repro_torch.classify import crossval, svm
        keng = kp["keng"]
        Xtr, ytr = keng.corpus, main["ds"].y_train
        n_pairs = N_TRAIN * (N_TRAIN - 1) // 2
        calls += [("sp_krdtw engine.knn", lambda: keng.knn(X)),
                  ("svm_gram_series sp_krdtw",
                   lambda: svm.svm_gram_series(keng.corpus, X,
                                               kind="sp_krdtw", sp=kp["sp"],
                                               nu=kp["nu"])),
                  ("select_nu krdtw",
                   lambda: crossval.select_nu(Xtr, ytr, grid=NU_GRID)),
                  ("select_theta_gamma sp_krdtw",
                   lambda: crossval.select_theta_gamma(
                       Xtr, ytr, name="sp_krdtw",
                       thetas=[f * n_pairs for f in THETA_SHARES],
                       nu=kp["nu"], counts=eng.sp.counts))]
    if cp is not None:
        ceng = cp["ceng"]
        members = eng.corpus[torch.as_tensor(
            main["ds"].y_train == 0, device=eng.corpus.device)]
        calls += [("barycenter of class 0, 10 steps",
                   lambda: ceng.barycenter(members, steps=10)),
                  ("centroid-seeded engine.knn", lambda: ceng.knn(X))]
    for what, fn in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # rows whose device is the card are the kernels themselves
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]
        busy = sum(r[1] for r in rows)
        if not rows:
            log(f"  {what}: profiler saw no device time (not measured)")
            continue
        log(f"  {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / wall_ms:.1f}%), idle "
            f"{100 * (1 - busy / wall_ms):.1f}%")
        ours = [e.device_time_total / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and any(k in e.name for k in ("gram_kernel", "paired_kernel",
                                              "thread_kernel",
                                              "narrow_kernel", "wide_kernel",
                                              "wavefront_kernel",
                                              "banded_kernel", "fwd_kernel",
                                              "bwd_kernel"))]
        log(f"    CUDA kernel launches in order (ms): "
            f"{', '.join(f'{t:.2f}' for t in ours)}")
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"    {ms:9.2f} ms  x{n:<5d} {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stop-after", type=int, default=4,
                    help="last phase to run (1-4); a run that stops early "
                         "prints no result")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log("phase 1: environment and build")
    phase_build()
    if args.stop_after < 2:
        return 0
    log(f"phase 2: kernels against their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    phase_kernels()
    if args.stop_after < 3:
        return 0
    log(f"phase 3: main path, TwoPatterns {N_TRAIN}/{N_TEST}, T={T_MAIN} "
        f"({time.perf_counter() - t0:.1f} s)")
    main_out = phase_main_path()
    log(f"phase 3b: kernel-measure and baseline path, TwoPatterns "
        f"{N_TRAIN}/{N_TEST}, T={T_MAIN} ({time.perf_counter() - t0:.1f} s)")
    kp = phase_kernel_path(main_out)
    log(f"phase 3c: centroid and soft-Gram path, TwoPatterns "
        f"{N_TRAIN}/{N_TEST}, T={T_MAIN} ({time.perf_counter() - t0:.1f} s)")
    cp = phase_centroid_path(main_out)
    log("profile: device time by kernel")
    phase_profile(main_out, kp, cp)
    if args.stop_after < 4:
        return 0
    log(f"phase 4: kernel timing at the paths' shapes "
        f"({time.perf_counter() - t0:.1f} s)")
    rows = phase_timing(main_out) + phase_timing_slice2(kp, main_out["ds"]) \
        + phase_timing_soft(main_out, cp)
    launches = {k: main_out["launches"][k] for k in SLICE1}
    launches.update({k: kp["launches"][k] for k in KERNELS
                     if k not in SLICE1 and k not in SOFT})
    launches.update({k: cp["launches"][k] for k in SOFT})
    for what, lc in (("SP-DTW path (phase 3)", main_out["launches"]),
                     ("kernel-measure path (phase 3b)", kp["launches"]),
                     ("centroid path (phase 3c)", cp["launches"])):
        log(f"  K1-K4 launches on the {what}: " + ", ".join(
            f"{k} {lc[k]}" for k in ("spdtw_tiles_gram", "spdtw_tiles_paired",
                                     "krdtw_gram", "krdtw_paired")))
    kernels = kernels_line(rows, launches)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
