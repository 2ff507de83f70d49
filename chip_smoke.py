#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --stop-after 2 # build and kernel checks only

Phases (each one fails the run on a mismatch, with a nonzero exit):

1. Environment and build: the card's name and power limit, the torch and
   CUDA versions; builds the kernels of ``src/repro_torch/kernels/csrc``
   and prints the build time and the compiler's register report.
2. Kernels against their plain PyTorch versions, on the card: K2
   (``spdtw_tiles_paired``) against ``spdtw_paired_scan``, K1
   (``spdtw_tiles_gram``: plain, thresholded with ``alive0``, prefix mode)
   against ``gram_spdtw_scan`` / ``gram_prefix_bound``, for every tile
   edge S, d in {1, 3}, random sparse supports and a learned one. The
   limit is rel 1e-6 (the kernels repeat the plain versions' operations,
   so the expected difference is 0), and the 1-NN of each kernel Gram
   must equal the plain Gram's.
3. The main path at the UCR TwoPatterns shape (1000 train / 4000 test,
   T = 128, 4 classes): ``fit`` learns the support from all 499,500
   train pairs on the card, ``engine.gram`` runs K1 over 4000 x 1000,
   ``engine.knn`` the cascade (K2 seeds, K1 prefix bound and survivors),
   whose neighbours must equal the Gram argmin bit for bit;
   ``engine.classify`` gives the error rate, and the DTW Gram (K1 over
   the all-ones plan) the SP-DTW / DTW time ratio. The launch counters
   are set to 0 just before and read just after; both kernels must have
   launched. A slice of the Gram is held against the dense core DP, and
   the Gram is timed again on sparser supports learned from the same
   counts. Then a torch.profiler pass gives the device time by kernel
   and the device's idle share for engine.knn, engine.gram and the
   occupancy counts.
4. Timing at the main path's shapes: each kernel against its plain
   version, with its roofline bound; one JSON line ``{"kernels": ...}``.

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
REL_LIMIT = 1e-6
DEVICE = "cuda"
# the main path: UCR TwoPatterns' published split and length
N_TRAIN, N_TEST, T_MAIN = 1000, 4000, 128

KERNELS = {
    "spdtw_tiles_gram": "src/repro/kernels/gram_block.py:98",
    "spdtw_tiles_paired": "src/repro/kernels/spdtw_block.py:148",
}
SOURCE = "src/repro_torch/kernels/csrc/spdtw_tiles.cu"


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


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import _build
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library("spdtw_tiles")
    log(f"build: spdtw_tiles.cu in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.get("spdtw_tiles", {}).get("log",
                                                            "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


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
        require(rel <= REL_LIMIT, f"{label} {what}: rel {rel} > {REL_LIMIT}")

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
    cases = [(8, 1, 70), (16, 1, 100), (16, 3, 100), (32, 1, 150),
             (64, 1, 150), (128, 1, 200), (128, 3, 200)]
    for S, d, T in cases:
        bsp = block_sparsify(_random_support(T, seed=S + d), tile=S)
        shape = (lambda n: (n, T)) if d == 1 else (lambda n: (n, T, d))
        A = torch.as_tensor(rng.normal(size=shape(24)).astype(np.float32),
                            device=dev)
        B = torch.as_tensor(rng.normal(size=shape(40)).astype(np.float32),
                            device=dev)
        w = _check_case(f"S={S} d={d} T={T} random", bsp, A, B, T)
        for k in worst:
            worst[k] = [max(a, b) for a, b in zip(worst[k], w[k])]
    ds = make_cbf(n_train=40, n_test=24, T=128)
    Xtr = torch.as_tensor(ds.X_train, device=dev)
    sp = learn_sparse_paths(Xtr, theta=2.0, gamma=0.5)
    bsp = block_sparsify(sp, tile=16)
    w = _check_case("S=16 d=1 T=128 learned(CBF)", bsp,
                    torch.as_tensor(ds.X_test, device=dev), Xtr, 128)
    for k in worst:
        worst[k] = [max(a, b) for a, b in zip(worst[k], w[k])]
    log(f"phase 2 ok: worst (abs, rel) {worst}")
    return worst


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
    for k in KERNELS:
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
    return {"engine": eng, "X_test": ds.X_test, "G": G, "nn": nn,
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
# Phase 4
# ---------------------------------------------------------------------------

def _bound(cells, d, in_bytes, out_bytes):
    # per cell: d subtractions, d multiplications, d - 1 channel
    # additions and 1 weight multiply for the cost, then 2 min and 1 add
    # for D = cost + min(top, topleft, left)
    ops = cells * (3 * d + 3)
    t_ops, t_bytes = ops / FP32_PEAK, (in_bytes + out_bytes) / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


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
    require(rel <= REL_LIMIT, f"K1 at main shapes: rel {rel}")
    require(torch.equal(Gk, G), "K1 not deterministic across runs")
    Na, Nb = Q.shape[0], C.shape[0]
    bound_ms, bound_by = _bound(Na * Nb * bsp.n_active * S * S, 1,
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
    require(rel2 <= REL_LIMIT, f"K2 at main shapes: rel {rel2}")
    B = x.shape[0]
    b2_ms, b2_by = _bound(B * bsp.n_active * S * S, 1,
                          2 * B * T * 4 + meta_b, B * 4)
    rows.append({"name": "spdtw_tiles_paired", "ms": ms2,
                 "plain_ms": plain2, "max_abs_err": ab2, "bound_ms": b2_ms,
                 "bound_by": b2_by})
    log(f"  K2 paired {B}: {ms2:.3f} ms (plain {plain2:.1f} ms, bound "
        f"{b2_ms:.4f} ms by {b2_by})")
    out = []
    for r in rows:
        out.append({"name": r["name"], "route": "cuda", "source": SOURCE,
                    "replaces": KERNELS[r["name"]],
                    "launches": main["launches"][r["name"]],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None})
    return out


def phase_profile(main):
    """Device time by kernel over one ``engine.knn``, one ``engine.gram``
    and the occupancy counts of 200 train series (torch.profiler), and
    the device's busy share of the wall time of each call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.occupancy import pairwise_path_counts
    eng, X = main["engine"], main["X_test"]
    for what, fn in (("engine.knn", lambda: eng.knn(X)),
                     ("engine.gram", lambda: eng.gram(X)),
                     ("pairwise_path_counts, 200 train series",
                      lambda: pairwise_path_counts(eng.corpus[:200]))):
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
                and ("gram_kernel" in e.name or "paired_kernel" in e.name)]
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
    log("phase 2: kernels against their plain versions")
    phase_kernels()
    if args.stop_after < 3:
        return 0
    log(f"phase 3: main path, TwoPatterns {N_TRAIN}/{N_TEST}, T={T_MAIN}")
    main_out = phase_main_path()
    log("profile: device time by kernel")
    phase_profile(main_out)
    if args.stop_after < 4:
        return 0
    log("phase 4: kernel timing at the main path's shapes")
    kernels = phase_timing(main_out)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
