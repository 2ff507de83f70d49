"""Measure the serial in-row association of the soft forward against the
Hillis-Steele scan that K7 / K8 and the plain versions use.

Each row of a soft tile solves L_j = logaddexp(g_j, L_{j-1} + t_j). The
scan (``soft_block._logaddexp_scan_lanes``) pays 1 + log2 S logaddexps per
cell; the serial solve, column by column, pays 2, the count the kernels'
bound assumes. The two round differently. The port keeps the scan (ROADMAP
section C); this script swaps the serial solve into the plain version for
the length of a call and reports, at the main path's shapes (UCR
TwoPatterns 1000 train / 4000 test, T = 128, the theta = 2 plan):

- the 4000 x 1000 soft Gram, serial plain version against K7, and both
  against a float64 run on the query row of the largest relative gap;
- gA of the 1000 x 1000 train soft Gram on the 10 %-share support, rows
  0..63, through the serial stash and through the scan stash, each
  against a float64 run (the same cotangents as ``chip_smoke.py``).

Run from the repository root on a CUDA card:
    python3 tools/soft_association.py
``--device cpu`` with small ``--n-train`` / ``--n-test`` runs the same
comparison on the CPU (the wrappers then run the plain scan).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SOFT_REL_LIMIT = 1e-5
GRAD_THETA_SHARE = 0.1
N_GRAD_ROWS = 64


def serial_lanes(g, s, width):
    """L_0 = g_0, L_j = logaddexp(g_j, L_{j-1} + s_j), column by column;
    the signature of ``_logaddexp_scan_lanes``, whose place it takes."""
    import torch
    from repro_torch.core.krdtw import logaddexp
    cols = [g[:, 0:1]]
    for j in range(1, g.shape[1]):
        cols.append(logaddexp(g[:, j:j + 1], cols[-1] + s[:, j:j + 1]))
    return torch.cat(cols, dim=1)


def serial():
    """Context in which the plain soft forwards use the serial solve."""
    from repro_torch.kernels import soft_block as sb
    return mock.patch.object(sb, "_logaddexp_scan_lanes", serial_lanes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=1000)
    ap.add_argument("--n-test", type=int, default=4000)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.core.engine import fit
    from repro_torch.core.occupancy import learn_sparse_paths
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data.synthetic_ucr import make_two_patterns
    from repro_torch.kernels import soft_block as sb
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("soft_association: no CUDA device", file=sys.stderr)
        return 1
    n_tr, n_te = args.n_train, args.n_test
    ds = make_two_patterns(n_train=n_tr, n_test=n_te, T=128)
    spec = MeasureSpec("spdtw", theta=2.0, weight_gamma=0.5)
    eng = fit(spec, ds.X_train, labels=ds.y_train, device=dev)
    Xtr = eng.corpus
    Xte = torch.as_tensor(ds.X_test, device=dev)
    gamma, bsp = float(eng.spec.gamma), eng.bsp

    # the soft Gram: K7 (the scan) against the serial plain version
    G7 = sb.gram_soft_spdtw_block(Xte, Xtr, bsp, gamma)
    with serial():
        Gs = sb.gram_soft_spdtw_scan(Xte, Xtr, bsp, gamma, block_a=1000)
    fin = G7 < 1e29
    assert torch.equal(fin, Gs < 1e29), "serial and scan reach other pairs"
    gap = (Gs.double() - G7.double()).abs()
    rel = torch.where(fin, gap / G7.double().abs().clamp_min(1e-30),
                      torch.zeros_like(gap))
    q, c = divmod(int(rel.argmax()), G7.shape[1])
    G64 = sb.gram_soft_spdtw_scan(Xte[q:q + 1].double(), Xtr.double(), bsp,
                                  gamma, dtype=torch.float64)[0]
    print(f"soft Gram {n_te} x {n_tr}, serial plain vs K7: max abs "
          f"{float(gap[fin].max()):.4g}, max rel {float(rel.max()):.4g}, "
          f"{int((rel > SOFT_REL_LIMIT).sum())} pairs beyond rel "
          f"{SOFT_REL_LIMIT}; worst pair ({q}, {c}): float64 "
          f"{float(G64[c]):.7g}, scan {float(G7[q, c]):.7g}, serial "
          f"{float(Gs[q, c]):.7g}; row {q} max |f32 - f64|: scan "
          f"{float((G7[q].double() - G64).abs().max()):.3g}, serial "
          f"{float((Gs[q].double() - G64).abs().max()):.3g}")
    del Gs, G7, gap, rel

    # gA of the train soft Gram on the 10 %-share support
    n_pairs = n_tr * (n_tr - 1) // 2
    sp = learn_sparse_paths(None, theta=GRAD_THETA_SHARE * n_pairs,
                            gamma=eng.spec.weight_gamma,
                            counts=eng.sp.counts)
    gbsp = fit(spec, Xtr, labels=ds.y_train, sp=sp, device=dev).bsp
    n = min(N_GRAD_ROWS, n_tr)
    gbar = torch.as_tensor(np.random.default_rng(5).normal(
        size=(n_tr, n_tr)).astype(np.float32), device=dev)
    v, st = sb.gram_soft_fwd_stash(Xtr[:n], Xtr, gbsp, gamma)
    gb = gbar[:n] * (v < 1e29)
    gA = sb.gram_soft_bwd_scan(Xtr[:n], Xtr, gbsp, gamma, st, gb)[0]
    with serial():
        _, st_s = sb.gram_soft_fwd_stash(Xtr[:n], Xtr, gbsp, gamma)
    gA_s = sb.gram_soft_bwd_scan(Xtr[:n], Xtr, gbsp, gamma, st_s, gb)[0]
    X64 = Xtr.double()
    _, st_d = sb.gram_soft_fwd_stash(X64[:n], X64, gbsp, gamma,
                                     dtype=torch.float64)
    gA_d = sb.gram_soft_bwd_scan(X64[:n], X64, gbsp, gamma, st_d,
                                 gb.double(), dtype=torch.float64)[0]
    reach = st > -0.5e30
    top = float(gA_d.abs().max())
    print(f"gA[:{n}] of the {n_tr} x {n_tr} train soft Gram "
          f"({sp.n_cells} cells): serial stash vs scan stash max abs "
          f"{float((gA_s - gA).abs().max()):.4g} of max |gA| "
          f"{float(gA.abs().max()):.4g}; stash max |L| "
          f"{float(st[reach].abs().max()):.4g}, serial - scan max abs "
          f"{float((st_s - st)[reach].abs().max()):.4g}; max |f32 - f64| / "
          f"max |gA|: scan {float((gA - gA_d).abs().max()) / top:.3g}, "
          f"serial {float((gA_s - gA_d).abs().max()) / top:.3g}")
    if dev == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
