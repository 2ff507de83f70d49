"""Full paper protocol on one dataset through the PyTorch port: the
meta-parameters by leave-one-out on the training series, then the 1-NN
and SVM test errors of every measure, with their visited cells (the twin
of ``examples/classify_ucr.py``, on ``repro_torch.classify.protocol.
DatasetBench``).

  PYTHONPATH=src python examples/classify_ucr_torch.py --dataset Trace

Without ``--device`` it runs on the CUDA card (and raises where there is
none); ``--device cpu`` runs the plain versions on the CPU. ``--full``
takes the dataset's default split, not the harness's fast one.
"""
import argparse

from repro_torch.classify.protocol import DatasetBench

KNN_MEASURES = ("euclidean", "dtw", "dtw_sc", "spdtw", "krdtw", "sp_krdtw")
SVM_MEASURES = ("krdtw", "sp_krdtw")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="Trace")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to compute (default: the CUDA card)")
    args = ap.parse_args(argv)
    db = DatasetBench(args.dataset, fast=not args.full, device=args.device)
    print(f"{args.dataset}: T={db.T}, selected radius={db.sel_radius.radius},"
          f" theta={float(db.sel_sp.theta)}, gamma={float(db.sel_sp.gamma)}")
    for m in KNN_MEASURES:
        err, cells, dt = db.knn_err(m)
        print(f"1-NN {m:10s} err={err:.3f} cells={cells:8d} ({dt:.1f}s)")
    for m in SVM_MEASURES:
        err, cells, dt = db.svm_err(m)
        print(f"SVM  {m:10s} err={err:.3f} cells={cells:8d} ({dt:.1f}s)")


if __name__ == "__main__":
    main()
