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
     tile edge S, d in {1, 3}, random sparse supports and a learned one,
     and at T = 60 and 96 on their default tiles;
   - K3 (``krdtw_gram``) and K4 (``krdtw_paired``) against
     ``gram_log_krdtw_plain`` / ``wavefront_log_krdtw_plain`` at T in
     {24, 60, 96, 100, 128, 300, 1024}, nu in {0.1, 0.5, 2}, on the full
     grid, a corridor and a support; K3 and K4 must agree bit for bit;
   - K5 (``dtw_wavefront``) and K6 (``dtw_banded``, pairs and Gram) against
     ``wavefront_dtw_plain`` / ``banded_dtw_plain`` over the radius grid
     up to w = 26, at d in {1, 3} and T in {24, 60, 96, 100, 128, 300},
     and K6 at T = 1024, w = 204; then at
     every template boundary: K6 at 2w + 1 in {1, 3, 7, 15, 31, 33, 63,
     65, 255, 257} and T in {5, 24, 128, 129}, each template that takes
     the width forced, and K5 at T in {1, 2, 31, 33, 128, 129, 512, 513}.
   - K7 (``soft_tiles_fwd``), K8 (``soft_tiles_stash``) and K9
     (``soft_tiles_bwd``) against ``gram_soft_spdtw_scan`` /
     ``soft_spdtw_paired_scan``, ``gram_soft_fwd_stash`` /
     ``soft_spdtw_fwd_stash`` and ``gram_soft_bwd_scan`` /
     ``soft_spdtw_bwd_block`` (values, stash, gx / gy / gw, E blocks) at
     (S, d, T) in {(8, 1, 40), (16, 1, 70), (16, 3, 70)}, Gram and paired
     mode, on a random support, a masked corner cell, a ragged T_orig and
     an inactive corner tile, under each launch template ("pairs",
     "tiles") forced and the wrappers' own choice.
   K1-K8 must equal their plain versions bit for bit (K7 = K8, and K9's
   two templates give equal gx, gy and E blocks); the limit is rtol 1e-4
   / atol 1e-5 for K9's gradients and E blocks (f32 sums in another
   order).
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
3d. The paper's tables (the protocol of ``benchmarks/common.py`` and
   ``benchmarks/table{2,4,6}*.py``, through the port's public API:
   ``paper_tables``). Equality pass: each of the seven synthetic
   datasets at its generator's default size (T = 60, 96, 100, 128);
   its selected radius, SP-DTW theta / gamma, nu and SP-K_rdtw theta,
   the LOO errors, the eight Table II 1-NN errors, the four Table IV
   SVM errors, the visited cells of every measure and the active tiles
   at tile 16 must equal the reference's values in
   ``tests/torch_tables_reference.json`` (made on the CPU by
   ``tools/paper_tables_reference.py``); then the mean ranks and
   Wilcoxon p-values. Timed pass: the same protocol on the TwoPatterns
   1000 / 4000 split, each stage timed; the spdtw and dtw ``cross``
   argmins must equal ``engine.knn``'s neighbours bit for bit.
3e. The sketch tier on phase 3's engine: ``sketch_r`` in {8, 16, 32},
   ``knn(mode="sketch")`` at top_c in {8, 16, 32, 64, N} and
   ``approx=True`` (K1 embeddings, K2 seed and re-rank), recall@1
   against phase 3's neighbours, the stage times; one soft embedding
   (gamma 0.1, K7); ``svm_rws_series`` at R = 32. At top_c = N the
   neighbours must equal the exact cascade's bit for bit, recall@1 must
   not fall as top_c grows, and the card's features must equal the same
   call on the CPU (rel 1e-6; 1e-5 for the soft ones).
3f. Serving, through ``repro_torch.launch`` and ``repro_torch.monitor``
   on phase 3's split: ``stream_search`` (batch 64, the 4000 test
   series) in cascade mode, sketch mode (phase 3e's R = 16 engine, top_c
   = N) and centroid mode (phase 3c's model), each equal bit for bit to
   ``engine.knn`` / ``nearest_centroid``, with its prune rates and
   per-stage p50 / p95 / p99; the offline, server (seeded Poisson
   arrivals at half the calibrated capacity) and single-stream (256
   queries) load shapes on the retrieval workload; ``refresh_run`` at
   full width (750 series, 250 arrivals in mini-batches of 25, the
   learner threaded on its own CUDA stream): versions monotone, the final
   snapshot equal to a fresh fit, every served batch equal to the answers
   of the snapshot that served it; the same with a centroid model
   refreshed by 4 Adam steps a batch (K8 / K9); ``anomaly_run`` (R = 16,
   256 calibration rows, window 64, 25 % injected outliers): decisions
   equal to the exact cascade's, the sketch map's axes orthonormal to
   1e-6, and ROC-AUC, escalation rate, the p99 overhead and the drift
   monitor printed beside the reference schema's limits (a finding, not
   a gate: the port's anchors are its own).
   For each path (each part of 3f) the launch counters are set to 0 just
   before and read just after, and each of its kernels must have
   launched. Then a torch.profiler pass gives the device time by kernel
   and the device's idle share for calls of the paths.
4. Timing at the paths' shapes: each kernel against its plain version,
   with its bound (K8 / K9 as their bare launches' device time, with the
   template each launch takes); K6 at each ``select_radius`` width under
   each of its templates that takes the width, and at T = 1024, w = 204;
   K5 with and without a radius; both K8 / K9 templates at the pair counts
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
    # T = 60 and 96 on their default tiles (8, padded to 64; 16): the
    # lengths of the paper tables' datasets
    cases = [(8, 1, 60), (8, 1, 70), (8, 3, 70), (16, 1, 96), (16, 1, 100),
             (16, 3, 100), (32, 1, 150), (32, 3, 150), (64, 1, 150),
             (128, 1, 200), (128, 3, 200)]
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
    versions at T in {24, 60, 96, 100, 128, 300}: K3 / K4 for nu in {0.1,
    0.5, 2} on the full grid, a corridor and a support (learned from CBF
    at T = 128); K5 / K6 over the TwoPatterns radius grid up to w = 26, at
    d in {1, 3}. Past the old length and width limits, at T = 1024: K3 /
    K4 at nu = 0.5 on the full grid (the wide sweep), the radius-6
    corridor and a band support (the narrow sweep), and K6 at w = 204 (a
    409-cell strip, the shared-memory sweep) and K5 on the full grid (its
    shared-memory diagonals past T = 512). K3-K6 must equal their plain
    versions bit for bit, and K3 and K4 each other; so must K5 and K6 at
    their template boundaries (``_check_dtw_templates``)."""
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

    def record(kernel, what, got, want, limit):
        ab, rel = diff(got, want)
        worst[kernel][0] = max(worst[kernel][0], ab)
        worst[kernel][1] = max(worst[kernel][1], rel)
        log(f"  {what}: max abs {ab:.3g} max rel {rel:.3g}")
        require(rel <= limit, f"{what}: rel {rel} > {limit}")
        require(torch.equal(got, want), f"{what}: not bit for bit")

    ds = make_cbf(n_train=40, n_test=24, T=128)
    learned = learn_sparse_paths(torch.as_tensor(ds.X_train), theta=2.0)
    for T in (24, 60, 96, 100, 128, 300, 1024):
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
                       kw.wavefront_dtw_plain(x, y, radius=r), REL_LIMIT)
                if r is None:
                    continue
                record("dtw_banded", f"K6 {label}", kb.banded_dtw(x, y, r),
                       kb.banded_dtw_plain(x, y, r), REL_LIMIT)
                record("dtw_banded", f"K6 gram {label}",
                       kb.banded_dtw_gram(x[:6], y, r),
                       kb.banded_dtw_gram_plain(x[:6], y, r), REL_LIMIT)
    _check_dtw_templates(record, rng)
    log(f"  K3 == K4 bit for bit on every case; K3-K6 == plain")
    return worst


# K6's half-widths at its template boundaries: 2w + 1 = 1, 3, 7, 15, 31,
# 33, 63 ("thread" up to 64 cells), 65, 255 ("lanes" up to 256), 257
# ("wide")
K6_BOUNDARY_RADII = (0, 1, 3, 7, 15, 16, 31, 32, 127, 128)


def _check_dtw_templates(record, rng):
    """K5 and K6 against their plain versions bit for bit at every
    launch-template boundary: K6 pairs and Gram (the wrappers' template,
    and each template that takes the width, forced) at T in {5, 24, 128,
    129} (strips wider than the series; the thread template's staged row
    chunks), d in {1, 3}; K5 at T in {1, 2, 31, 33, 128, 129, 512, 513}
    (1-16 positions per lane, the shared-memory diagonals past 512),
    radius None, 0, 3, 26, and at d = 5 (past its 4 register channels)."""
    import numpy as np
    import torch
    from repro_torch.kernels import dtw_banded as kb
    from repro_torch.kernels import dtw_wavefront as kw
    dev = torch.device(DEVICE)
    for T in (5, 24, 128, 129):
        for d in (1, 3):
            x, y = (torch.as_tensor(rng.normal(size=(9, T, d)).astype(
                np.float32), device=dev) for _ in range(2))
            for w in K6_BOUNDARY_RADII:
                label = f"T={T} d={d} w={w}"
                record("dtw_banded", f"K6 {label}", kb.banded_dtw(x, y, w),
                       kb.banded_dtw_plain(x, y, w), REL_LIMIT)
                want = kb.banded_dtw_gram_plain(x[:4], y, w)
                for tmpl in kb.TEMPLATES:
                    try:
                        kb.banded_geometry(w, T, d, tmpl)
                    except ValueError:
                        continue   # this template does not take the width
                    record("dtw_banded", f"K6 gram {tmpl} {label}",
                           kb.dtw_banded_cuda(x[:4].contiguous(), y, w,
                                              gram=True, template=tmpl),
                           want, REL_LIMIT)
    for T in (1, 2, 31, 33, 128, 129, 512, 513):
        for d in ((1, 3, 5) if T <= 129 else (1,)):
            x, y = (torch.as_tensor(rng.normal(size=(6, T, d)).astype(
                np.float32), device=dev) for _ in range(2))
            for r in (None, 0, 3, 26):
                record("dtw_wavefront", f"K5 T={T} d={d} radius {r}",
                       kw.wavefront_dtw(x, y, radius=r),
                       kw.wavefront_dtw_plain(x, y, radius=r), REL_LIMIT)
    log("  K5 / K6 at their template boundaries: bit for bit")


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
# Phase 3d: the paper's tables (benchmarks/common.py's protocol)
# ---------------------------------------------------------------------------

# the protocol's grids and tables, as benchmarks/common.py DatasetBench and
# benchmarks/table{2,4,6}*.py
TABLE_THETAS = (0, 1, 2, 4, 8)
TABLE_GAMMAS = (0.0, 0.5)
TABLE_NUS = (0.1, 0.5, 2.0)
TABLE2 = ("corr", "daco", "euclidean", "dtw", "dtw_sc", "krdtw", "spdtw",
          "sp_krdtw")
TABLE4 = ("euclidean_rbf", "krdtw", "krdtw_sc", "sp_krdtw")
TABLE_TILE = 16
RBF_GAMMA = 0.1
# the reference's rows at the generators' default sizes, made on the CPU
# by tools/paper_tables_reference.py
TABLES_FIXTURE = "tests/torch_tables_reference.json"
# the entries of a protocol row held against the fixture
TABLE_KEYS = ("T", "n_train", "n_test", "n_classes", "radius", "radius_loo",
              "spdtw_theta", "spdtw_gamma", "spdtw_loo", "nu",
              "sp_krdtw_theta", "sp_krdtw_loo", "knn_error", "svm_error",
              "visited_cells", "tile", "active_tiles", "tiles_total")
TABLES_DEPENDS = ("spdtw_tiles_gram", "spdtw_tiles_paired", "krdtw_gram",
                  "krdtw_paired", "dtw_wavefront", "dtw_banded")


def _rbf_gram(X, Y, gamma=RBF_GAMMA, block=256):
    """exp(-gamma ||x - y||^2) for all pairs, rows in blocks (the Table IV
    Euclidean baseline, ``benchmarks/table4_svm.py``)."""
    import torch
    return torch.cat([torch.exp(-gamma * torch.sum(
        (X[s:s + block, None, :] - Y[None, :, :]) ** 2, dim=-1))
        for s in range(0, X.shape[0], block)])


def paper_tables(ds, device, timer=None):
    """The protocol of ``benchmarks/common.py`` (``DatasetBench``, with
    Tables II, IV and VI) on one dataset through the port's public API,
    on ``device``: occupancy counts, ``select_radius``,
    ``select_theta_gamma`` for spdtw and sp_krdtw, ``select_nu``; the
    eight 1-NN errors from ``make_measure(...).cross``; the SVM errors of
    the Euclidean RBF and the three K_rdtw kernels (``gram_log`` and one
    batched ``logk`` for the self-similarities); visited cells and the
    active tiles at tile 16. ``timer(name, fn)`` runs each stage (default:
    just calls it). Returns (row, extras): the row has the keys of
    ``tools/paper_tables_reference.py``; extras hold the measures and the
    spdtw / dtw cross matrices."""
    import torch
    from repro_torch.classify import (knn_error, select_nu, select_radius,
                                      select_theta_gamma, svm_error)
    from repro_torch.core import (block_sparsify, make_measure,
                                  normalized_gram, pairwise_path_counts)
    run = timer or (lambda name, fn: fn())
    Xtr = torch.as_tensor(ds.X_train, device=device)
    Xte = torch.as_tensor(ds.X_test, device=device)
    ytr, yte, T = ds.y_train, ds.y_test, ds.T
    counts = run("pairwise_path_counts", lambda: pairwise_path_counts(Xtr))
    sel_r = run("select_radius (K6)",
                lambda: select_radius(Xtr, ytr, device=device))
    sel_sp = run("select_theta_gamma spdtw (K1)",
                 lambda: select_theta_gamma(
                     Xtr, ytr, name="spdtw", counts=counts,
                     thetas=TABLE_THETAS, gammas=TABLE_GAMMAS,
                     device=device))
    nu = run("select_nu krdtw (K3)",
             lambda: select_nu(Xtr, ytr, name="krdtw", grid=TABLE_NUS,
                               device=device)).nu
    sel_spk = run("select_theta_gamma sp_krdtw (K3)",
                  lambda: select_theta_gamma(
                      Xtr, ytr, name="sp_krdtw", counts=counts,
                      thetas=TABLE_THETAS, nu=nu, device=device))

    def measure(name):
        sp = {"spdtw": sel_sp.sp, "sp_krdtw": sel_spk.sp}.get(name)
        return make_measure(name, T, sp=sp, nu=nu, radius=sel_r.radius,
                            device=device)

    measures = {m: measure(m) for m in TABLE2 + ("krdtw_sc",)}
    knn, crosses = {}, {}
    for m in TABLE2:
        C = run(f"Table II cross {m}",
                lambda m=m: measures[m].cross(Xte, Xtr))
        knn[m] = knn_error(C, ytr, yte)
        if m in ("spdtw", "dtw"):
            crosses[m] = C
    svm = {"euclidean_rbf": run("Table IV euclidean_rbf Grams + svm_error",
                                lambda: svm_error(
                                    _rbf_gram(Xtr, Xtr), _rbf_gram(Xte, Xtr),
                                    ytr, yte, ds.n_classes))}
    for m in TABLE4[1:]:
        msr = measures[m]

        def grams(msr=msr):
            lg_tt = msr.gram_log(Xtr, Xtr)
            lg_et = msr.gram_log(Xte, Xtr)
            d_tt = torch.diagonal(lg_tt)
            d_ee = msr.logk(Xte, Xte)
            return (normalized_gram(lg_tt, d_tt, d_tt),
                    normalized_gram(lg_et, d_ee, d_tt))

        Ktr, Kte = run(f"Table IV {m} Grams (K3) + self-similarities (K4)",
                       grams)
        svm[m] = run(f"Table IV {m} svm_error",
                     lambda: svm_error(Ktr, Kte, ytr, yte, ds.n_classes))
    bsp = block_sparsify(sel_sp.sp, tile=TABLE_TILE)
    row = {"T": int(T), "n_train": len(ds.X_train),
           "n_test": len(ds.X_test), "n_classes": int(ds.n_classes),
           "radius": int(sel_r.radius), "radius_loo": float(sel_r.loo),
           "spdtw_theta": float(sel_sp.theta),
           "spdtw_gamma": float(sel_sp.gamma),
           "spdtw_loo": float(sel_sp.loo), "nu": float(nu),
           "sp_krdtw_theta": float(sel_spk.theta),
           "sp_krdtw_loo": float(sel_spk.loo), "knn_error": knn,
           "svm_error": svm,
           "visited_cells": {m: int(v.visited_cells)
                             for m, v in measures.items()},
           "tile": TABLE_TILE, "active_tiles": int(bsp.n_active),
           "tiles_total": int(bsp.active.size)}
    return row, {"measures": measures, "crosses": crosses,
                 "sel_sp": sel_sp, "Xtr": Xtr, "Xte": Xte}


# errors and LOOs are float32 fractions k / n, which the two packages
# round differently in the last bit (XLA's mean multiplies by 1 / n): two
# values within FRACTION_ATOL are the same fraction for any n <= 10^5
FRACTION_ATOL = 1e-6


def _same(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, (int, float)):
        return abs(g - w) <= FRACTION_ATOL
    return g == w


def compare_rows(got, want):
    """The entries of TABLE_KEYS where a protocol row differs from the
    reference's, as "key: got != want" strings (every count and selection
    equal; errors and LOOs the same fraction, within FRACTION_ATOL)."""
    bad = []
    for k in TABLE_KEYS:
        g, w = got.get(k), want.get(k)
        if isinstance(w, dict):
            g = g or {}
            bad += [f"{k}.{m}: {g.get(m)} != {w[m]}"
                    for m in w if not _same(g.get(m), w[m])]
        elif not _same(g, w):
            bad.append(f"{k}: {g} != {w}")
    return bad


def mean_ranks(mat, names):
    """Mean rank of each column over the rows of an error matrix, ties
    taking their average rank (``benchmarks/table2_knn.py``)."""
    import numpy as np
    ranks = np.argsort(np.argsort(mat, axis=1), axis=1) + 1.0
    for i in range(mat.shape[0]):
        for v in np.unique(mat[i]):
            sel = mat[i] == v
            if sel.sum() > 1:
                ranks[i, sel] = ranks[i, sel].mean()
    return {m: float(r) for m, r in zip(names, ranks.mean(axis=0))}


def wilcoxon_signed_rank(a, b) -> float:
    """Two-sided Wilcoxon signed-rank p-value (normal approximation), as
    ``benchmarks/common.py`` computes it: zeros dropped, ties averaged,
    1.0 below six nonzero differences."""
    import numpy as np
    from math import erf, sqrt
    d = np.asarray(a, float) - np.asarray(b, float)
    d = d[d != 0]
    n = len(d)
    if n < 6:
        return 1.0
    ranks = np.argsort(np.argsort(np.abs(d))) + 1.0
    order = np.abs(d)
    for v in np.unique(order):
        sel = order == v
        if sel.sum() > 1:
            ranks[sel] = ranks[sel].mean()
    w = min(ranks[d > 0].sum(), ranks[d < 0].sum())
    mu = n * (n + 1) / 4
    sigma = np.sqrt(n * (n + 1) * (2 * n + 1) / 24)
    z = (w - mu + 0.5) / sigma
    p = 2 * 0.5 * (1 + erf(z / sqrt(2)))
    return min(max(p, 0.0), 1.0)


def _summary(rows, names, key):
    """Mean ranks and pairwise Wilcoxon p-values of one table."""
    import numpy as np
    mat = np.array([[rows[d][key][m] for m in names] for d in rows])
    wil = {f"{a}|{b}": wilcoxon_signed_rank(mat[:, i], mat[:, j])
           for i, a in enumerate(names) for j, b in enumerate(names)
           if j > i}
    return mean_ranks(mat, names), wil


def phase_tables(main):
    """The paper's tables through the port. Equality pass: each of the
    seven datasets at its generator's default size through
    ``paper_tables``, every selection, error, visited-cell and
    active-tile count equal to the reference's fixture; then the mean
    ranks and Wilcoxon p-values of Tables II and IV. Timed pass: the same
    protocol on phase 3's TwoPatterns split (1000 / 4000, T = 128), each
    stage timed with CUDA events, the spdtw and dtw ``cross`` argmins
    equal to ``engine.knn``'s neighbours bit for bit, and the dtw nearest
    distances of ``Measure.pair`` (K5) against the cross minima. Launch
    counters are set to 0 just before each pass and read just after."""
    import numpy as np
    import torch
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data import DATASETS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    fixture = json.loads((ROOT / TABLES_FIXTURE).read_text())["datasets"]
    reset_launch_counts()
    rows = {}
    for name, make in DATASETS.items():
        t0 = time.perf_counter()
        rows[name], _ = paper_tables(make(), DEVICE)
        r = rows[name]
        log(f"  {name} (T={r['T']}, {r['n_train']}/{r['n_test']}, "
            f"{time.perf_counter() - t0:.1f} s): radius {r['radius']}, "
            f"spdtw theta {r['spdtw_theta']:g} gamma {r['spdtw_gamma']:g}, "
            f"nu {r['nu']:g}, sp_krdtw theta {r['sp_krdtw_theta']:g}; "
            f"1-NN " + " ".join(f"{m} {v:.4f}"
                                for m, v in r["knn_error"].items())
            + "; SVM " + " ".join(f"{m} {v:.4f}"
                                  for m, v in r["svm_error"].items()))
        cells = r["visited_cells"]
        T2 = r["T"] ** 2
        log(f"    Table VI: T^2 {T2}, " + ", ".join(
            f"{m} {cells[m]} (S {100 * (1 - cells[m] / T2):.1f}%)"
            for m in ("dtw", "dtw_sc", "spdtw", "sp_krdtw"))
            + f"; tiles {r['active_tiles']} of {r['tiles_total']} at "
            f"{TABLE_TILE} (S {100 * (1 - r['active_tiles'] / r['tiles_total']):.1f}%)")
        bad = compare_rows(r, fixture[name])
        require(not bad, f"{name} differs from the reference: {bad}")
    eq_launches = launch_counts()
    log(f"  every dataset equals the reference's fixture ({TABLES_FIXTURE}): "
        f"selections, errors, visited cells, active tiles")
    log(f"  launches on the equality pass: {eq_launches}")
    for what, names, key in (("Table II", TABLE2, "knn_error"),
                             ("Table IV", TABLE4, "svm_error")):
        ranks, wil = _summary(rows, names, key)
        log(f"  {what} mean ranks: " + ", ".join(
            f"{m} {v:.2f}" for m, v in ranks.items()))
        log(f"  {what} Wilcoxon p: " + ", ".join(
            f"{k} {v:.3f}" for k, v in wil.items()))

    # the timed pass on the main path's split
    ds = main["ds"]
    stage = {}

    def timed(name, fn):
        ms, out = cuda_ms(fn)
        stage[name] = ms
        log(f"  {name}: {ms:.1f} ms")
        return out

    log(f"  timed pass: TwoPatterns {N_TRAIN}/{N_TEST}, T={T_MAIN}")
    reset_launch_counts()
    t0 = time.perf_counter()
    row, ex = paper_tables(ds, DEVICE, timer=timed)
    wall = time.perf_counter() - t0
    Xtr, Xte = ex["Xtr"], ex["Xte"]
    sel = ex["sel_sp"]
    seng = fit(MeasureSpec("spdtw", theta=sel.theta,
                           weight_gamma=sel.gamma), Xtr, sp=sel.sp,
               device=DEVICE)
    deng = fit(MeasureSpec("dtw", support="dense"), Xtr, device=DEVICE)
    for fam, eng in (("spdtw", seng), ("dtw", deng)):
        nn, _ = timed(f"{fam} engine.knn (the cascade)",
                      lambda eng=eng: eng.knn(Xte))
        C = ex["crosses"][fam]
        require(torch.equal(torch.argmin(C, dim=1).to(torch.int32), nn),
                f"{fam} cross argmin != engine.knn neighbours")
        if fam == "dtw":
            P = timed("dtw Measure.pair on the 4000 neighbour pairs (K5)",
                      lambda: ex["measures"]["dtw"].pair(Xte,
                                                         Xtr[nn.long()]))
            want = C.gather(1, nn[:, None].long())[:, 0]
            ab, rel = diff(P, want)
            log(f"  dtw Measure.pair (K5) vs cross minima (K1): max abs "
                f"{ab:.3g} max rel {rel:.3g}, bit for bit "
                f"{bool(torch.equal(P, want))}")
            require(rel <= REL_LIMIT, "K5 pair != K1 cross minimum")
    launches = launch_counts()
    log(f"  spdtw and dtw cross argmins == engine.knn neighbours, bit for "
        f"bit; protocol {wall:.1f} s wall")
    log(f"  selections {row['radius']} / {row['spdtw_theta']:g} / "
        f"{row['spdtw_gamma']:g} / {row['nu']:g} / "
        f"{row['sp_krdtw_theta']:g}; 1-NN " + " ".join(
            f"{m} {v:.4f}" for m, v in row["knn_error"].items())
        + "; SVM " + " ".join(f"{m} {v:.4f}"
                              for m, v in row["svm_error"].items()))
    log(f"  Table VI: visited {row['visited_cells']}, tiles "
        f"{row['active_tiles']} of {row['tiles_total']}")
    log(f"  launches on the timed pass: {launches}")
    for k in TABLES_DEPENDS:
        require(launches[k] > 0, f"{k} never launched on the tables' path")
    return {"rows": rows, "row": row, "launches": launches,
            "eq_launches": eq_launches, "stages": stage}


# ---------------------------------------------------------------------------
# Phase 3e: the sketch tier
# ---------------------------------------------------------------------------

SKETCH_RS = (8, 16, 32)
SKETCH_TOP_C = (8, 16, 32, 64)          # and the whole corpus
SKETCH_SOFT_R = 16
SKETCH_RWS_R = 32
N_SKETCH_CHECK = 64                      # rows held against the CPU
SKETCH_DEPENDS = ("spdtw_tiles_gram", "spdtw_tiles_paired",
                  "soft_tiles_fwd")


def phase_sketch(main):
    """The sketch tier on phase 3's engine: refit with ``sketch_r`` in
    {8, 16, 32} on its support and plan, ``knn(mode="sketch")`` at top_c
    in {8, 16, 32, 64, N} and ``approx=True`` for the 4000 queries
    (recall@1 against phase 3's exact neighbours, time per query, the
    embed / shortlist / re-rank times, DP pairs); one R = 16 run on the
    soft embedding (gamma 0.1, K7); ``svm_rws_series`` at R = 32 and its
    SVM error. Gates: at top_c = N the neighbours and distances equal the
    exact cascade's bit for bit; recall@1 does not fall as top_c grows;
    the card's sketch features equal the same call on the CPU to rel 1e-6
    on 64 rows. Launch counters are set to 0 just before and read just
    after."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.classify import svm
    from repro_torch.core import sketch as sk
    from repro_torch.core.engine import fit
    from repro_torch.kernels import launch_counts, reset_launch_counts
    eng, ds = main["engine"], main["ds"]
    exact_nn = main["nn"]
    exact_d = main["G"].gather(1, exact_nn[:, None].long())[:, 0]
    Xte = torch.as_tensor(ds.X_test, device=DEVICE)
    N, B = eng.corpus_size, Xte.shape[0]
    exact_ms = main["stages"]["engine.knn cascade"]
    n_classes = int(ds.y_train.max()) + 1
    stage = {}

    def timed(name, fn):
        ms, out = cuda_ms(fn)
        stage[name] = ms
        log(f"  {name}: {ms:.1f} ms")
        return out

    def report(label, ms, nn, st):
        recall = float((nn == exact_nn).to(torch.float32).mean())
        log(f"    {label}: recall@1 {recall:.4f}, {1e3 * ms / B:.2f} us "
            f"per query (exact cascade {1e3 * exact_ms / B:.2f}), embed "
            f"{1e3 * st['t_embed_s']:.2f} / shortlist "
            f"{1e3 * st['t_shortlist_s']:.2f} / re-rank "
            f"{1e3 * st['t_rerank_s']:.2f} ms, dp_pairs {st['dp_pairs']}")
        return recall

    reset_launch_counts()
    curve = []
    for R in SKETCH_RS:
        seng = timed(f"fit with sketch_r = {R} (K1 {N} x {R} embedding)",
                     lambda R=R: fit(eng.spec.replace(sketch_r=R),
                                     eng.corpus, labels=ds.y_train,
                                     sp=eng.sp, bsp=eng.bsp, device=DEVICE))
        prev = -1.0
        for c in SKETCH_TOP_C + (N,):
            ms, (nn, d, st) = cuda_ms(lambda c=c: seng.knn(
                Xte, mode="sketch", top_c=c, return_stats=True), warmup=1)
            rec = report(f"R {R} top_c {c}", ms, nn, st)
            curve.append({"R": R, "C": c, "approx": False, "recall": rec,
                          "ms": ms, "dp_pairs": st["dp_pairs"]})
            require(rec >= prev, f"recall@1 fell from {prev} to {rec} at "
                    f"R {R}, top_c {c}")
            prev = rec
            if c == N:
                require(torch.equal(nn, exact_nn) and
                        torch.equal(d, exact_d),
                        f"R {R}: top_c = N != the exact cascade")
        ms, (nn, _, st) = cuda_ms(lambda: seng.knn(
            Xte, mode="sketch", approx=True, return_stats=True), warmup=1)
        rec = report(f"R {R} approx (top_c {st['shortlist_c']})", ms, nn, st)
        curve.append({"R": R, "C": st["shortlist_c"], "approx": True,
                      "recall": rec, "ms": ms, "dp_pairs": st["dp_pairs"]})
        if R == SKETCH_SOFT_R:
            soft_eng = seng
    log(f"  top_c = N equals the exact cascade bit for bit at every R; "
        f"recall@1 never falls as top_c grows")
    # the soft embedding (K7) on the R = 16 anchors
    idx = soft_eng.index
    si = timed(f"soft sketch index R = {SKETCH_SOFT_R}, gamma {SOFT_GAMMA} "
               f"(K7 {N} x {SKETCH_SOFT_R})",
               lambda: sk.build_sketch_index(
                   eng.corpus, idx.sketch.anchors, bsp=idx.bsp,
                   weights=idx.weights, gamma=SOFT_GAMMA))
    require(bool(torch.isfinite(si.sketch).all()), "soft sketch finite")
    soft_idx = dataclasses.replace(idx, sketch=si)
    for c in (32, N):
        ms, (nn, d, st) = cuda_ms(lambda c=c: sk.sketch_knn(
            Xte, soft_idx, top_c=c, return_stats=True), warmup=1)
        report(f"soft R {SKETCH_SOFT_R} top_c {c}", ms, nn, st)
        if c == N:
            require(torch.equal(nn, exact_nn),
                    "soft sketch at top_c = N != the exact cascade")
    # svm_rws_series on the split
    K, Kt = timed(f"svm_rws_series R = {SKETCH_RWS_R} (K1 embeddings)",
                  lambda: svm.svm_rws_series(ds.X_train, Xte, sp=eng.sp,
                                             R=SKETCH_RWS_R, seed=0,
                                             device=DEVICE))
    require(bool(torch.isfinite(K).all()) and bool(torch.isfinite(Kt).all()),
            "RWS Gram blocks finite")
    err = timed("svm_error RWS", lambda: svm.svm_error(
        K, Kt, ds.y_train, ds.y_test, n_classes))
    log(f"  RWS SVM test error (R = {SKETCH_RWS_R}): {err:.4f}")
    launches = launch_counts()
    log(f"  launches on the sketch path: {launches}")
    for k in SKETCH_DEPENDS:
        require(launches[k] > 0, f"{k} never launched on the sketch path")
    # the card's features against the same call on the CPU
    n = N_SKETCH_CHECK
    for what, s_idx in (("hard", idx), ("soft", soft_idx)):
        s = s_idx.sketch
        got = sk.sketch_embed(Xte[:n], s.anchors, bsp=s_idx.bsp,
                              weights=s_idx.weights, gamma=s.gamma)
        want = sk.sketch_embed(Xte[:n].cpu(), s.anchors.cpu(),
                               bsp=s_idx.bsp, weights=s_idx.weights.cpu(),
                               gamma=s.gamma)
        ab, rel = diff(got.cpu(), want)
        log(f"  {what} sketch features, card vs CPU, {n} x {s.R}: max abs "
            f"{ab:.3g} max rel {rel:.3g}")
        # the soft features go through expf / log1pf, whose CUDA and CPU
        # versions may differ in the last bit
        limit = REL_LIMIT if s.gamma is None else SOFT_REL_LIMIT
        require(rel <= limit, f"{what} sketch features: card != CPU")
    log(f"  reference figure (BENCH_sketch.json, CPU, 512-series corpus, "
        f"not this corpus): R 8, C 32, recall@1 0.969")
    return {"curve": curve, "launches": launches, "stages": stage,
            "rws_error": err, "engine": soft_eng}


# ---------------------------------------------------------------------------
# Phase 3f: serving (SearchEngine, load shapes, refresh, monitoring)
# ---------------------------------------------------------------------------

SERVE_BATCH = 64
N_SINGLE_STREAM = 256
# refresh: 750 initial series, 250 arrivals in mini-batches of 25
REFRESH_ARRIVAL_FRAC, REFRESH_LEARNER_BATCH = 0.25, 25
REFRESH_CENTROID_STEPS, CENTROID_FIT_STEPS = 4, 10
ANOMALY_SKETCH_R, ANOMALY_N_CAL, ANOMALY_WINDOW = 16, 256, 64
# the reference schema's limits (benchmarks/check_artifacts.py), printed
# beside the port's values: the port's anchors are its own
AUC_LIMIT = 0.9
# the kernels each part of the serving path must launch
SERVING_DEPENDS = {
    "stream search": ("spdtw_tiles_gram", "spdtw_tiles_paired"),
    "load shapes": ("spdtw_tiles_gram", "spdtw_tiles_paired"),
    "refresh": ("spdtw_tiles_gram", "spdtw_tiles_paired"),
    "centroid refresh": ("spdtw_tiles_gram", "spdtw_tiles_paired",
                         "soft_tiles_stash", "soft_tiles_bwd"),
    "anomaly": ("spdtw_tiles_gram", "spdtw_tiles_paired"),
}


def _log_serving(name, sc):
    p = sc["latency_ms"]
    log(f"    {name}: {sc['throughput_qps']:.1f} queries/s, p50 "
        f"{p['p50']:.2f} / p95 {p['p95']:.2f} / p99 {p['p99']:.2f} ms "
        f"({sc['n_queries']} queries, batch {sc['batch']})")


def _log_stats(label, st):
    prune = {k: round(v, 4) for k, v in st.items()
             if k.endswith("_prune") or k == "dp_abandoned"}
    lat = ", ".join(f"{k} {v['p50']:.2f} / {v['p95']:.2f} / {v['p99']:.2f}"
                    for k, v in st["latency_ms"].items())
    log(f"    {label} stats: prune {prune}, dp pairs {st['pairs_dp']}; "
        f"batch p50 / p95 / p99 ms: {lat}")


def _recorder():
    """An ``on_batch`` hook for ``server_scenario`` and the list it fills
    with (snapshot engine, first row, rows, nn, dist) per served batch."""
    records = []

    def hook(serve, lo, take, nn, dist):
        records.append((serve.engine, lo, take, nn, dist))

    return records, hook


def _check_served(records, queries, what):
    """Every served batch equals the answers its snapshot gives the whole
    query set (computed once per version), bit for bit. Returns the
    versions that served."""
    import numpy as np
    answers = {}
    for eng, lo, take, nn, dist in records:
        if eng.version not in answers:
            a, b = eng.knn(queries)
            answers[eng.version] = (a.cpu().numpy(), b.cpu().numpy())
        want_nn, want_d = answers[eng.version]
        require(np.array_equal(nn[:take], want_nn[lo:lo + take]) and
                np.array_equal(dist[:take], want_d[lo:lo + take]),
                f"{what}: a batch served by version {eng.version} != that "
                f"snapshot's answers")
    return sorted(answers)


def phase_serving(main, cp, skp):
    """The serving tier through the port's public API, on phase 3's
    TwoPatterns split and engines. Stream search (``stream_search``, batch
    64, 4000 test series) in cascade mode (neighbours and distances equal
    to phase 3's ``engine.knn``, accuracy equal to ``classify``'s), sketch
    mode on phase 3e's R = 16 engine at top_c = N (the same) and centroid
    mode on phase 3c's model (equal to ``nearest_centroid``'s argmin); the
    offline, server and single-stream load shapes on the retrieval
    workload; ``refresh_run`` at full width (750 + 250 arrivals in
    mini-batches of 25, the learner threaded on its own stream: versions
    monotone, the final snapshot equal to a fresh fit, every served batch
    equal to its snapshot's answers), then the same with a centroid model
    refreshed by 4 Adam steps a batch (K8 / K9); ``anomaly_run`` (R = 16,
    256 calibration rows, window 64, 25 % outliers: decisions equal to
    the exact path; ROC-AUC, escalation, overhead and drift printed) and
    the sketch map's orthonormality. Launch counters are set to 0 before
    each part and read after it."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.cluster import nearest_centroid
    from repro_torch.core import SnapshotStore
    from repro_torch.core.engine import fit
    from repro_torch.core.occupancy import learn_sparse_paths
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data import load
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import scenarios as sc
    from repro_torch.launch.learner import Learner
    from repro_torch.launch.search import (SearchEngine, _make_workload,
                                           stream_search)
    eng, ds = main["engine"], main["ds"]
    Xte = ds.X_test
    exact_nn = main["nn"].cpu().numpy()
    exact_d = main["G"].gather(1, main["nn"][:, None].long())[:, 0] \
        .cpu().numpy()
    N = eng.corpus_size
    parts, stage = {}, {}

    def part(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t0) * 1e3
        lc = launch_counts()
        parts[name] = lc
        log(f"  {name}: {stage[name]:.1f} ms; launches: " + ", ".join(
            f"{k} {v}" for k, v in lc.items() if v))
        for k in SERVING_DEPENDS[name]:
            require(lc[k] > 0, f"{k} never launched in the serving part "
                    f"{name!r}")

    # ---- stream search, three modes
    def stream():
        acc_want = float(np.mean(ds.y_train[exact_nn] == ds.y_test))
        se = SearchEngine(None, engine=eng)
        res = stream_search(se, Xte, batch=SERVE_BATCH)
        nn = np.array([r.nn for r in res])
        d = np.array([r.dist for r in res], np.float32)
        acc = float(np.mean(np.array([r.label for r in res]) == ds.y_test))
        require(np.array_equal(nn, exact_nn) and np.array_equal(d, exact_d),
                "stream_search cascade != phase 3's engine.knn")
        require(acc == acc_want, "stream_search accuracy != classify's")
        log(f"    cascade: neighbours and distances == phase 3's "
            f"engine.knn, bit for bit; accuracy {acc:.4f} == classify's")
        _log_stats("cascade", se.stats())
        sk = SearchEngine(None, engine=skp["engine"], mode="sketch",
                          top_c=N)
        res = stream_search(sk, Xte, batch=SERVE_BATCH)
        require(np.array_equal(np.array([r.nn for r in res]), exact_nn) and
                np.array_equal(np.array([r.dist for r in res], np.float32),
                               exact_d),
                "stream_search sketch at top_c = N != engine.knn")
        log(f"    sketch R {skp['engine'].index.sketch.R}, top_c = N: == "
            f"phase 3's engine.knn, bit for bit")
        _log_stats("sketch", sk.stats())
        cm = cp["ceng"].centroid_model
        ce = SearchEngine(None, engine=eng, mode="centroid",
                          centroid_model=cm)
        res = stream_search(ce, Xte, batch=SERVE_BATCH)
        idx, dist = nearest_centroid(Xte, cm)
        require(np.array_equal(np.array([r.nn for r in res]),
                               idx.cpu().numpy()) and
                np.array_equal(np.array([r.dist for r in res], np.float32),
                               dist.cpu().numpy()),
                "stream_search centroid != nearest_centroid")
        log(f"    centroid ({cm.k} centroids): == nearest_centroid's "
            f"argmin, bit for bit")
        _log_stats("centroid", ce.stats())

    part("stream search", stream)

    # ---- load shapes on the retrieval workload
    queries = _make_workload(ds, "retrieval", N_TEST, 0)

    def shapes():
        se = SearchEngine(None, engine=eng)
        out = {"offline": sc.offline_scenario(se, queries, SERVE_BATCH),
               "server": sc.server_scenario(se, queries, SERVE_BATCH),
               "single_stream": sc.single_stream_scenario(
                   se, queries[:N_SINGLE_STREAM])}
        for name, r in out.items():
            _log_serving(name, r)
        log(f"    server: offered {out['server']['rate_qps']:.1f} "
            f"queries/s (half the calibrated capacity), mean batch "
            f"{out['server']['mean_batch']:.1f}")

    part("load shapes", shapes)

    # ---- refresh: the threaded learner behind live serving
    n_train = N_TRAIN
    rds = load("TwoPatterns", n_train=n_train, T=T_MAIN)
    rq = _make_workload(rds, "retrieval", N_TEST, 0)

    def refresh():
        records, hook = _recorder()
        p = sc.refresh_run(dataset="TwoPatterns", n_queries=N_TEST,
                           batch=SERVE_BATCH, n_train=n_train, T=T_MAIN,
                           seed=0, arrival_frac=REFRESH_ARRIVAL_FRAC,
                           learner_batch=REFRESH_LEARNER_BATCH,
                           threaded=True, device=DEVICE, on_batch=hook)
        require(p["versions_monotone"], "refresh: versions not monotone")
        require(p["exact_final"], "refresh: final snapshot != a fresh fit")
        want = -(-p["n_arrivals"] // REFRESH_LEARNER_BATCH)
        require(p["n_snapshots"] == want, f"refresh: {p['n_snapshots']} "
                f"snapshots, not {want}")
        served = _check_served(records, rq, "refresh")
        log(f"    {p['corpus_initial']} + {p['n_arrivals']} arrivals in "
            f"batches of {p['learner_batch']}: {p['n_snapshots']} "
            f"snapshots, versions monotone, final == a fresh fit; "
            f"{len(records)} batches served by versions {served}, each "
            f"== its snapshot's answers")
        _log_serving("server (frozen)", p["server"])
        _log_serving("server + learner", p["server_refresh"])
        st = p["staleness"]
        log(f"    snapshot cadence {1e3 * p['snapshot_cadence_s']:.1f} ms; "
            f"staleness: {st['n_refreshes']} refreshes, mean lag "
            f"{st['mean_lag']:.3f}, max lag {st['max_lag']}; p99 "
            f"{p['server']['latency_ms']['p99']:.2f} -> "
            f"{p['server_refresh']['latency_ms']['p99']:.2f} ms")

    part("refresh", refresh)

    def centroid_refresh():
        n0 = len(rds.X_train) - int(len(rds.X_train) * REFRESH_ARRIVAL_FRAC)
        sp = learn_sparse_paths(torch.as_tensor(rds.X_train[:32],
                                                device=DEVICE), theta=8.0)
        e0 = fit(MeasureSpec("spdtw"), rds.X_train[:n0],
                 labels=rds.y_train[:n0], sp=sp, device=DEVICE)
        e0 = e0.fit_centroids(1, steps=CENTROID_FIT_STEPS)
        store = SnapshotStore(e0, keep_history=True)
        serve = SearchEngine(None, refresh=store)
        learner = Learner(store, rds.X_train[n0:], labels=rds.y_train[n0:],
                          batch=REFRESH_LEARNER_BATCH,
                          centroid_steps=REFRESH_CENTROID_STEPS)
        records, hook = _recorder()
        learner.start()
        try:
            r = sc.server_scenario(serve, rq, SERVE_BATCH, on_batch=hook)
        finally:
            learner.join()
        versions = [s.version for s in store.history]
        want = 1 + -(-(len(rds.X_train) - n0) // REFRESH_LEARNER_BATCH)
        require(versions == list(range(want)),
                f"centroid refresh: versions {versions}")
        last = store.current().engine
        z0, z1 = e0.centroid_model.centroids, last.centroid_model.centroids
        require(bool(torch.isfinite(z1).all()) and not torch.equal(z0, z1),
                "centroid refresh: centroids not refreshed")
        served = _check_served(records, rq, "centroid refresh")
        nn_a, d_a = last.knn(rq)
        nn_b, d_b = dataclasses.replace(last, centroid_model=None).knn(rq)
        require(torch.equal(nn_a, nn_b) and torch.equal(d_a, d_b),
                "centroid refresh: seeded cascade != unseeded")
        log(f"    {len(store.history) - 1} snapshots with {last.centroid_model.k} "
            f"centroids refreshed ({REFRESH_CENTROID_STEPS} Adam steps a "
            f"batch; max centroid move {float((z1 - z0).abs().max()):.4f}); "
            f"{len(records)} batches served by versions {served}, each == "
            f"its snapshot's answers")
        _log_serving("server + centroid learner", r)

    part("centroid refresh", centroid_refresh)

    # ---- anomaly: the monitor on every batch
    def anomaly():
        p = sc.anomaly_run(dataset="TwoPatterns", n_queries=N_TEST,
                           batch=SERVE_BATCH, n_train=n_train, T=T_MAIN,
                           seed=0, sketch_r=ANOMALY_SKETCH_R,
                           n_cal=ANOMALY_N_CAL, window=ANOMALY_WINDOW,
                           device=DEVICE)
        require(p["decisions_exact"], "anomaly: decide != decide_exact")
        emb = p["embed_map"]
        require(emb["orthonormal_err"] <= 1e-6,
                "sketch_map axes not orthonormal")
        dr = p["drift"]
        log(f"    decisions == the exact cascade's, bit for bit; tau "
            f"{p['tau']:.4f}, {p['n_outliers']} outliers, flag rate "
            f"{p['flag_rate']:.4f}, escalation rate "
            f"{p['escalation_rate']:.4f} ({p['n_escalated']} rows)")
        log(f"    finding (not gated; the port's anchors): ROC-AUC "
            f"{p['roc_auc']:.4f} (reference limit >= {AUC_LIMIT}); drift "
            f"events i.i.d. {dr['events_iid']} (limit 0), shifted "
            f"{dr['events_shift']} (limit >= 1)")
        _log_serving("server, monitor off", p["server"])
        _log_serving("server, monitor on", p["server_monitor"])
        lat = p["stage_latency_ms"]
        log(f"    monitored batches, p50 / p99 ms: monitor stage "
            f"{lat['monitor']['p50']:.2f} / {lat['monitor']['p99']:.2f}, "
            f"search {lat['total']['p50']:.2f} / {lat['total']['p99']:.2f}")
        log(f"    p99 overhead of monitoring {p['p99_overhead_ms']:+.2f} ms "
            f"(ratio {p['p99_overhead_ratio']:.3f}); sketch map: "
            f"explained variance {[round(v, 4) for v in emb['explained_var']]}"
            f", orthonormality error {emb['orthonormal_err']:.3g}")

    part("anomaly", anomaly)
    total = {k: sum(lc[k] for lc in parts.values()) for k in KERNELS}
    return {"launches": total, "stages": stage}


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
    1000); K5 without a radius and at the selected one; K6 at each
    ``select_radius`` width (1000 x 1000) under its "thread" and "lanes"
    templates, and a 128 x 128 Gram at T = 1024, w = 204 ("wide"). Plain
    K3 and plain K6 are timed on 64 x 1000 slices (both are launch-bound
    loops over diagonals / rows). The kernels line takes K5's device time
    without a radius and K6's at w = 26 under the wrapper's template."""
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

    # K5: DTW over the 4000 (query, nearest) pairs of engine.pairs, without
    # a radius (dtw) and at the selected one (dtw_sc); device time, and the
    # wrapper's time with the host's share
    y1 = Xtr[nn]
    k5 = {}
    for r in (None, radius):
        ms, P = cuda_ms(lambda: kw.wavefront_dtw(Xte, y1, radius=r),
                        reps=5, warmup=1)
        dms, _ = device_ms(lambda: kw.wavefront_dtw(Xte, y1, radius=r))
        pms, Pp = cuda_ms(lambda: kw.wavefront_dtw_plain(Xte, y1, radius=r))
        ab, rel = diff(P, Pp)
        require(torch.equal(P, Pp), f"K5 at main shapes, radius {r}: rel "
                f"{rel}")
        cells = _admissible_cells(T, r)
        bound = _bound_cells(Na * cells, _dtw_flops(1), 0, 2 * Na * T * 4,
                             Na * 4)
        k5[r] = (dms, pms, ab, bound)
        log(f"  dtw_wavefront {Na} pairs radius {r} ({cells} cells): "
            f"{dms:.4f} ms device, {ms:.4f} ms with the wrapper (plain "
            f"{pms:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]})")
    dms, pms, ab, bound = k5[None]
    row("dtw_wavefront", dms, pms, ab, bound, f"{Na} pairs full grid")

    # K6: the dtw_sc Gram at the selected radius; the five select_radius
    # Grams (train x train) under the thread template and the lanes one it
    # replaced there, each held bit for bit against its plain version on a
    # slice of rows; and the long strip, T = 1024, w = 204, which phase 2
    # checks
    geo = kb.banded_geometry(radius, T, 1)
    ms, G6 = cuda_ms(lambda: kb.banded_dtw_gram(Xte, Xtr, radius), reps=3,
                     warmup=1)
    require(torch.equal(G6, kp["Gs"]), "K6 not deterministic across runs")
    A3 = Xtr[..., None].contiguous()
    # the lanes template is the one the thread template replaced at this
    # width
    G6l = kb.dtw_banded_cuda(Xte[..., None].contiguous(), A3, radius,
                             gram=True, template="lanes")
    require(torch.equal(G6, G6l), "the dtw_sc Gram differs between the "
            "thread and lanes templates")
    log(f"  dtw_banded {Na}x{Nb} radius {radius} (the dtw_sc Gram, "
        f"{geo['template']}): {ms:.3f} ms; equal to the lanes template's, "
        f"bit for bit")
    n6 = 64
    k6 = {}
    for w in sorted({int(round(f * T)) for f in RADIUS_FRACS}):
        auto = kb.banded_geometry(w, T, 1)["template"]
        pms, Gp6 = cuda_ms(lambda: kb.banded_dtw_gram_plain(
            Xtr[:n6], Xtr, w, block=n6 * Nb))
        cells = band_cells(T, T, w)
        bound = _bound_cells(Nb * Nb * cells, _dtw_flops(1), 0,
                             2 * Nb * T * 4, Nb * Nb * 4)
        times = {}
        for tmpl in ("thread", "lanes"):     # every width here takes both
            dms, G6 = device_ms(lambda: kb.dtw_banded_cuda(
                A3, A3, w, gram=True, template=tmpl), reps=3)
            require(torch.equal(G6[:n6], Gp6), f"K6 {tmpl} w = {w}: not "
                    f"bit for bit with the plain version")
            times[tmpl] = dms
        ms, G6 = cuda_ms(lambda: kb.banded_dtw_gram(Xtr, Xtr, w), reps=3,
                         warmup=1)
        ab, _ = diff(G6[:n6], Gp6)
        k6[w] = (times[auto], pms, ab, bound)
        log(f"  dtw_banded {Nb}x{Nb} radius {w} ({cells} cells, auto "
            f"{auto}): device " + ", ".join(
                f"{t} {v:.3f} ms" for t, v in times.items()) +
            f"; {ms:.3f} ms with the wrapper (plain {pms:.1f} ms on "
            f"{n6}x{Nb}, bound {bound[0]:.4f} ms by {bound[1]})")
    log(f"  dtw_banded select_radius widths, device ms summed: "
        f"{sum(v[0] for v in k6.values()):.3f}")
    w = max(k6)
    row("dtw_banded", *k6[w], f"{Nb}x{Nb} radius {w} (auto, device; "
        f"plain on {n6}x{Nb})")
    TL, wl, nl = 1024, 204, 128
    g = torch.Generator(device="cpu").manual_seed(5)
    L = torch.randn((nl, TL, 1), generator=g).to(DEVICE)
    geo = kb.banded_geometry(wl, TL, 1)
    dms, GL = device_ms(lambda: kb.dtw_banded_cuda(L, L, wl, gram=True),
                        reps=3)
    pms, GLp = cuda_ms(lambda: kb.banded_dtw_gram_plain(L[:2], L, wl,
                                                        block=2 * nl))
    require(torch.equal(GL[:2], GLp), "K6 at T = 1024, w = 204: not bit for "
            "bit with the plain version")
    cells = band_cells(TL, TL, wl)
    bound = _bound_cells(nl * nl * cells, _dtw_flops(1), 0,
                         2 * nl * TL * 4, nl * nl * 4)
    log(f"  dtw_banded {nl}x{nl} T={TL} radius {wl} ({cells} cells, "
        f"{geo['template']}): {dms:.3f} ms device (plain {pms:.1f} ms on "
        f"2x{nl}, bound {bound[0]:.4f} ms by {bound[1]})")
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


def phase_profile(main, kp=None, cp=None, tp=None, serving=False):
    """Device time by kernel over one ``engine.knn``, one ``engine.gram``
    and the occupancy counts of 200 train series (torch.profiler), and,
    after the kernel path, one sp_krdtw ``engine.knn``, one SVM Gram
    series, ``select_nu`` and ``select_theta_gamma``; after the centroid
    path, one 10-step barycenter fit of a class and one centroid-seeded
    ``engine.knn``; after the tables, the whole protocol of phase 3d's
    timed pass; with the device's busy share of the wall time of each
    call."""
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
    if tp is not None:
        calls += [(f"paper-table protocol, TwoPatterns {N_TRAIN}/{N_TEST}",
                   lambda: paper_tables(main["ds"], DEVICE))]
    if serving:
        from repro_torch.launch.search import SearchEngine, stream_search
        calls += [(f"stream_search cascade, {N_TEST} queries at batch "
                   f"{SERVE_BATCH}",
                   lambda: stream_search(SearchEngine(None, engine=eng),
                                         main["ds"].X_test,
                                         batch=SERVE_BATCH))]
    for what, fn in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the profiler's raw device records (kernels and copies), summed
        # here: building its per-event objects for a call of ~10^5
        # launches (the protocol's SVM loops) would take minutes
        dev = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA),
                     key=lambda e: e.start_ns())
        if not dev:
            log(f"  {what}: profiler saw no device time (not measured)")
            continue
        by_name = {}
        for e in dev:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        busy = sum(ms for ms, _ in by_name.values())
        log(f"  {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / wall_ms:.1f}%), idle "
            f"{100 * (1 - busy / wall_ms):.1f}%")
        ours = [e.duration_ns() / 1e6 for e in dev
                if any(k in e.name() for k in (
                    "gram_kernel", "paired_kernel", "thread_kernel",
                    "narrow_kernel", "wide_kernel", "regs_kernel",
                    "wavefront_kernel", "banded_kernel", "fwd_kernel",
                    "bwd_kernel"))]
        log(f"    CUDA kernel launches in order (ms): "
            f"{', '.join(f'{t:.2f}' for t in ours)}")
        for key, (ms, n) in sorted(by_name.items(),
                                   key=lambda r: -r[1][0])[:8]:
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
    log(f"phase 3d: the paper's tables, seven datasets at default sizes, "
        f"then TwoPatterns {N_TRAIN}/{N_TEST} timed "
        f"({time.perf_counter() - t0:.1f} s)")
    tp = phase_tables(main_out)
    log(f"phase 3e: the sketch tier, TwoPatterns {N_TRAIN}/{N_TEST} "
        f"({time.perf_counter() - t0:.1f} s)")
    skp = phase_sketch(main_out)
    log(f"phase 3f: serving, TwoPatterns {N_TRAIN}/{N_TEST} "
        f"({time.perf_counter() - t0:.1f} s)")
    sv = phase_serving(main_out, cp, skp)
    log("profile: device time by kernel")
    phase_profile(main_out, kp, cp, tp, serving=True)
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
                     ("centroid path (phase 3c)", cp["launches"]),
                     ("tables' timed pass (phase 3d)", tp["launches"]),
                     ("sketch path (phase 3e)", skp["launches"]),
                     ("serving path (phase 3f)", sv["launches"])):
        log(f"  launches on the {what}: " + ", ".join(
            f"{k} {lc[k]}" for k in KERNELS))
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
