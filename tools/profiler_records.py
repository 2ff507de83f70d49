"""Count the device records torch.profiler keeps for one call as a process
ages.

``engine.gram`` (K1 and its copies) and ``engine.knn`` of the main path's
engine (UCR TwoPatterns 1000 / 4000, T = 128) are profiled right after the
process's first profiler session, then 30 and 60 s after it, the card idle
in between. Each line holds a session's device records against its host
calls that each put one on the device, and the records of the port's
kernels against the launches counted. ``chip_smoke.py``'s profile pass
holds the run's first sessions because of what this shows.

Run from the repository root on a CUDA card (about 80 s after a short
build). ``--pad 0.5`` sleeps that long inside each session before and
after the call; ``TEARDOWN_CUPTI=0`` in the environment keeps CUPTI
between sessions:
    python3 tools/profiler_records.py [--pad 0.5]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pad", type=float, default=0.0,
                    help="seconds slept inside each session around the call")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data.synthetic_ucr import make_two_patterns
    from repro_torch.kernels import (_build, launch_counts,
                                     reset_launch_counts)
    cs.log(f"{cs.card_line()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}; pad {args.pad} s")
    _build.build("spdtw_tiles")
    ds = make_two_patterns(n_train=cs.N_TRAIN, n_test=cs.N_TEST,
                           T=cs.T_MAIN)
    eng = fit(MeasureSpec("spdtw", theta=2.0, weight_gamma=0.5),
              ds.X_train, labels=ds.y_train, device="cuda")

    def padded(fn):
        time.sleep(args.pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(args.pad)

    t0 = None
    for age in (0, 30, 60):
        if t0 is not None:
            time.sleep(max(0.0, age - (time.perf_counter() - t0)))
        for what, fn in (("engine.gram", lambda: eng.gram(ds.X_test)),
                         ("engine.gram", lambda: eng.gram(ds.X_test)),
                         ("engine.knn", lambda: eng.knn(ds.X_test))):
            reset_launch_counts()
            _, dev, calls = cs.profiled(lambda: padded(fn))
            t0 = time.perf_counter() if t0 is None else t0
            ours = sum(1 for e in dev if cs.PORT_KERNEL.match(e.name()))
            cs.log(f"{age} s after the first session: {what}: device "
                   f"records {len(dev)} for {calls} launch / copy / fill "
                   f"calls; of the port's kernels {ours} for "
                   f"{sum(launch_counts().values())} launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
