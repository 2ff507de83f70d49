"""Quickstart of the PyTorch / CUDA port: spec -> fit -> engine.

The twin of ``examples/quickstart.py`` on ``repro_torch``. Learn a
sparsified alignment search space from training data, fit a
SimilarityEngine once, and run every workload (distances, exact 1-NN,
classification, gradients, barycenters, the sketch tier) through it.

  PYTHONPATH=src python examples/quickstart_torch.py               # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import MeasureSpec, fit, knn_error
from repro_torch.data import load

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda",
                help="where to compute: cuda (default) or cpu")
dev = ap.parse_args().device

# 1. a UCR-like dataset (synthesized offline; z-normalized)
ds = load("CBF", n_train=24, n_test=60)
Xtr, Xte = ds.X_train, ds.X_test
print(f"CBF: {len(Xtr)} train / {len(Xte)} test, T={ds.T}, on {dev}")

# 2. describe the measure, then fit it: the occupancy prior (paper
#    Fig. 3), the block-sparse tile plan and the 1-NN search index are
#    all resolved exactly once here
spec = MeasureSpec("spdtw", theta=2.0, weight_gamma=0.5, gamma=0.1)
engine = fit(spec, Xtr, labels=ds.y_train, device=dev)
print(f"sparse support: {engine.sp.n_cells} of {ds.T**2} cells "
      f"({100 * (1 - engine.sp.n_cells / ds.T**2):.1f}% pruned); "
      f"plan: {engine.bsp.n_active} active of {engine.bsp.active.size} "
      f"tiles ({100 * engine.bsp.tile_sparsity:.1f}% skipped)")

# 3. SP-DTW between two series (vs a plain-DTW engine)
d_sp = float(engine.pairs(Xte[:1], Xtr[:1])[0])
d_dtw = float(fit(MeasureSpec("dtw"), Xtr, device=dev)
              .pairs(Xte[:1], Xtr[:1])[0])
print(f"SP-DTW={d_sp:.3f}  DTW={d_dtw:.3f}")

# 4. retrieval + classification: the exact 1-NN lower-bound cascade and
#    label prediction, both on the fitted index
nn, dist = engine.knn(Xte[:8])
pred = engine.classify(Xte)
acc = float(np.mean(pred == np.asarray(ds.y_test)))
print(f"1-NN spdtw accuracy={acc:.3f} "
      f"(first neighbours: {nn.cpu().numpy()[:4]})")

# 5. the differentiable layer: soft-SP-DTW gradients and a barycenter,
#    both restricted to the learned support
val, gx = engine.grad(Xte[:4], Xtr[:4])
z, losses = engine.barycenter(Xtr[:8], steps=20)
print(f"soft values {val.cpu().numpy().round(2)}; barycenter loss "
      f"{float(losses[0]):.2f} -> {float(losses[-1]):.2f}")

# 6. every measure family through the same engine API
for family in ("euclidean", "dtw", "spdtw", "sp_krdtw"):
    eng = fit(MeasureSpec(family, nu=0.5) if family != "spdtw" else spec,
              Xtr, labels=ds.y_train, sp=engine.sp, device=dev)
    err = knn_error(eng.gram(Xte), ds.y_train, ds.y_test)
    print(f"1-NN {family:10s} err={err:.3f} "
          f"visited={eng.measure.visited_cells}")

# 7. the sketch tier: a matmul shortlist over 8 random warping anchors,
#    re-ranked exactly (equal to the cascade when the shortlist holds the
#    true neighbour)
seng = fit(spec.replace(sketch_r=8), Xtr, sp=engine.sp, device=dev)
snn, _ = seng.knn(Xte, mode="sketch", top_c=8)
enn, _ = engine.knn(Xte)
print(f"sketch R=8 top_c=8: recall@1 "
      f"{float((snn == enn).float().mean()):.3f}")
