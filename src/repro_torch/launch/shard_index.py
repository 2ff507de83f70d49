"""Sharded-corpus serving: the fitted index partitioned over ranks, with a
global top-k merge. The counterpart of ``repro.launch.shard_index``.

The per-candidate rows of a fitted ``SimilarityEngine``'s corpus index
(series, LB_Keogh envelopes, sketch rows) are split into contiguous
shards, queries go to every shard, each shard runs the whole lower-bound
cascade and survivor DP against its own candidates only (K2 seeds, K1
prefix bound and survivors on the card), and the per-shard winners are
merged into a global top-k. Answers equal the single-host cascade's bit
for bit.

Layout (``ShardedIndex``): shard s owns global rows ``[offsets[s],
offsets[s+1])`` (``np.array_split`` sizes, ragged by at most one row).
For the equal-block layout every shard pads to the largest shard with
copies of global row 0 carrying global id 0. A pad is a real candidate,
so the cascade needs no mask: its distance equals (or, abandoned,
upper-bounds) real row 0's, so whenever a pad wins its shard, real row 0
wins shard 0 with a distance no larger and the same id, and the merge's
tie rule returns the real row.

Merge (``merge_topk``): the gathered candidates are ordered by global id
(a stable sort), then a stable sort by distance takes the k smallest:
ties go to the smallest global id, the first-index rule of the single-host
argmin (``jax.lax.top_k``'s earliest-position rule in the reference;
``torch.topk`` promises no order among ties, so it is not used).

Two execution paths with the same arithmetic, chosen as the reference
chooses between its mesh and host paths:

  * ``dist``: a ``torch.distributed`` group of S ranks (``launch/
    mesh.py``), rank r serving shard r of the equal-block layout on its
    own device; each rank runs ``local_topk``, maps local ids to global
    ids, the group all-gathers the (B, k) winners (``mesh.
    all_gather_cat``) and every rank runs the same merge. Taken when the
    default group has exactly S ranks.
  * ``host``: a loop over ``engine.shard(S)`` in one process (no pads);
    taken otherwise, as the reference does with fewer devices than
    shards.

The backend is resolved with the ``SHARDED`` capability (scan, cuda; the
dense oracle does not serve). ``launch/search.py`` serves through this
with ``shards > 1``, and ``launch/scenarios.run`` measures it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import SimilarityEngine
from repro_torch.kernels import backends as bk
from repro_torch.launch import mesh


def shard_offsets(n: int, n_shards: int) -> np.ndarray:
    """Global row offsets of the contiguous shard partition: (S + 1,),
    shard s covering rows [offsets[s], offsets[s+1]) (``np.array_split``
    sizes, ragged by at most one row)."""
    sizes = [len(ids) for ids in np.array_split(np.arange(n), n_shards)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """Stacked, padded per-shard corpus state (the distributed path's
    operands).

    corpus:          (S, Nmax, T[, d]) corpus rows, shard-major; rows past
                     a shard's true size are copies of global row 0.
    gid:             (S, Nmax) int32 global corpus id of each row (pads
                     carry 0, the id of the row they copy).
    env_lo, env_hi:  (S, Nmax, T[, d]) LB_Keogh candidate envelopes,
                     sliced from the fitted index.
    sketch:          (S, Nmax, R) sketch rows when the engine was fit with
                     ``sketch_r > 0``, else None.
    sizes, offsets:  true shard sizes (S,) and global offsets (S + 1,).
    """
    corpus: torch.Tensor
    gid: torch.Tensor
    env_lo: torch.Tensor
    env_hi: torch.Tensor
    sketch: Optional[torch.Tensor]
    sizes: np.ndarray
    offsets: np.ndarray

    @property
    def n_shards(self) -> int:
        """Number of shards S."""
        return int(self.corpus.shape[0])

    @property
    def n_max(self) -> int:
        """Padded per-shard candidate count."""
        return int(self.corpus.shape[1])

    @property
    def n_total(self) -> int:
        """True (unpadded) corpus size across all shards."""
        return int(self.sizes.sum())

    def balance(self) -> dict:
        """Shard-balance stats for the serving payload: per-shard sizes,
        spread, and the padding overhead of the equal-block layout."""
        sizes = self.sizes.astype(np.float64)
        return {
            "n_shards": self.n_shards,
            "sizes": [int(s) for s in self.sizes],
            "min_size": int(sizes.min()), "max_size": int(sizes.max()),
            "imbalance": float(sizes.max() / sizes.mean()),
            "pad_frac": float(1.0 - sizes.sum()
                              / (self.n_shards * self.n_max)),
        }


def shard_corpus_state(engine: SimilarityEngine,
                       n_shards: int) -> ShardedIndex:
    """Partition a fitted engine's per-candidate index state into the
    stacked equal-block layout of ``ShardedIndex`` (contiguous shards,
    each padded to the largest with copies of global row 0, global id 0;
    the module docstring says why the pads are exact). The measure
    statics (weights, plan, support windows) are shared, not stacked."""
    index = engine.index
    if index is None:
        raise ValueError("sharded serving needs an engine fit with a "
                         "corpus index")
    n = index.size
    S = max(1, min(int(n_shards), n))
    offs = shard_offsets(n, S)
    sizes = np.diff(offs)
    n_max = int(sizes.max())

    def stack(a):
        rows = []
        for s in range(S):
            blk = a[int(offs[s]):int(offs[s + 1])]
            pad = n_max - blk.shape[0]
            if pad:
                blk = torch.cat([blk, a[0:1].expand((pad,) + a.shape[1:])])
            rows.append(blk)
        return torch.stack(rows)

    gid = np.stack([np.pad(np.arange(int(offs[s]), int(offs[s + 1]),
                                     dtype=np.int32),
                           (0, n_max - int(sizes[s])))   # pads -> id 0
                    for s in range(S)])
    return ShardedIndex(
        corpus=stack(index.corpus),
        gid=torch.as_tensor(gid, device=index.device),
        env_lo=stack(index.env_lo), env_hi=stack(index.env_hi),
        sketch=None if index.sketch is None else stack(index.sketch.sketch),
        sizes=sizes, offsets=offs)


# ---------------------------------------------------------------------------
# Per-shard search + global merge
# ---------------------------------------------------------------------------

def local_topk(Q: torch.Tensor, index, k: int, *, impl: str = "auto",
               seed_k: int = 2, prefix_frac: float = 0.5,
               block_a: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of one shard: (B, T[, d]) queries against the shard's index.

    k = 1 runs the exact lower-bound cascade (``ops._knn_cascade``, the
    1-NN serving path); k > 1 runs the Gram (K1 on the card) and a stable
    sort (exact values, no bound pruning). Returns (dists, local_ids),
    both (B, min(k, shard size)); ties go to the lowest local index, as
    ``argmin``'s do.
    """
    from repro_torch.kernels import ops
    if k == 1:
        nn, nnd = ops._knn_cascade(Q, index, impl=impl, seed_k=seed_k,
                                   prefix_frac=prefix_frac, block_a=block_a)
        return nnd[:, None], nn[:, None]
    D = ops._spdtw_gram(Q, index.corpus, bsp=index.bsp,
                        weights=index.weights, impl=impl, block_a=block_a)
    ids = torch.sort(D, dim=1, stable=True).indices[:, :min(k, D.shape[1])]
    return D.gather(1, ids), ids.to(torch.int32)


def merge_topk(dists: torch.Tensor, gids: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce gathered per-shard candidates to the global top-k.

    dists / gids: (B, M) candidate distances and global corpus ids.
    Candidates are ordered by global id (stable), then a stable sort by
    distance picks the k best, so ties go to the smallest global id, the
    single-host ``argmin`` rule. Returns (gids, dists), both
    (B, min(k, M)), ascending distance.
    """
    ordg = torch.sort(gids, dim=1, stable=True).indices
    dg, gg = dists.gather(1, ordg), gids.gather(1, ordg)
    pos = torch.sort(dg, dim=1, stable=True).indices[:, :min(
        k, dists.shape[1])]
    return gg.gather(1, pos), dg.gather(1, pos)


class ShardedSearch:
    """Sharded k-NN serving over a fitted ``SimilarityEngine``.

    Partitions the engine's corpus state into ``n_shards`` shards (clamped
    to the corpus size) and answers ``knn`` through the per-shard cascade
    and the global merge. ``use_dist=None`` picks the distributed path
    when the default process group has exactly ``n_shards`` ranks (rank
    r serves shard r; every rank calls ``knn`` with the same queries and
    gets the same answer) and the host loop otherwise; ``True`` requires
    such a group, ``False`` forces the host loop. Either path returns the
    single-host cascade's answers.
    """

    def __init__(self, engine: SimilarityEngine, n_shards: int, *,
                 k: int = 1, impl: str = "auto", seed_k: int = 2,
                 prefix_frac: float = 0.5,
                 use_dist: Optional[bool] = None):
        bk.resolve(impl, device=engine.device, require=(bk.SHARDED,))
        if engine.index is None:
            raise ValueError("sharded serving needs an engine fit with a "
                             "corpus index")
        self.engine = engine
        self.k = int(k)
        self.impl = impl
        self.seed_k = seed_k
        self.prefix_frac = prefix_frac
        self.shidx = shard_corpus_state(engine, n_shards)
        S = self.shidx.n_shards
        rank, size = mesh.world()
        if use_dist is None:
            use_dist = S > 1 and size == S
        if use_dist and size != S:
            raise ValueError(f"the distributed path needs a process group "
                             f"of {S} ranks; this one has {size}")
        self._rank = rank
        self._local = None
        self._shard_engines: Optional[Tuple[SimilarityEngine, ...]] = None
        if use_dist:
            sh = self.shidx
            self._local = dataclasses.replace(
                engine.index, corpus=sh.corpus[rank], env_lo=sh.env_lo[rank],
                env_hi=sh.env_hi[rank], sketch=None)
            self._gid = sh.gid[rank]
        else:
            self._shard_engines = engine.shard(S)

    @property
    def n_shards(self) -> int:
        """Number of corpus shards."""
        return self.shidx.n_shards

    @property
    def path(self) -> str:
        """Which execution path serves: "dist" or "host"."""
        return "dist" if self._local is not None else "host"

    def balance(self) -> dict:
        """Shard-balance stats plus the execution path: the serving
        payload's shard story."""
        out = self.shidx.balance()
        out["path"] = self.path
        return out

    def _topk(self, Q, index):
        return local_topk(Q, index, self.k, impl=self.impl,
                          seed_k=self.seed_k, prefix_frac=self.prefix_frac)

    def _rank_winners(self, Q) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's (B, min(k, Nmax)) winners and their global ids."""
        if self.k == 1:
            d, i = self._topk(Q, self._local)
            return d, self._gid[i.long()]
        # k > 1: a pad copies row 0 with its id, so it could repeat gid 0
        # in the merged set; the shard's real rows are searched instead
        # and the columns padded to the common width with (inf, N), which
        # rank after every real candidate
        size = int(self.shidx.sizes[self._rank])
        d, i = self._topk(Q, self._local.take(slice(0, size)))
        g = self._gid[i.long()]
        width = min(self.k, self.shidx.n_max)
        if d.shape[1] < width:
            fill = (Q.shape[0], width - d.shape[1])
            d = torch.cat([d, d.new_full(fill, float("inf"))], dim=1)
            g = torch.cat([g, g.new_full(fill, self.shidx.n_total)], dim=1)
        return d, g

    def knn(self, Q) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global top-k over all shards: (B, T[, d]) -> (nn, dist), each
        (B,) when k == 1, else (B, k'), k' = min(k, corpus size). The
        top-1 equals the single-host cascade's bit for bit."""
        Q = self.engine._series(Q)
        if self._local is not None:
            d, g = self._rank_winners(Q)
            g, d = merge_topk(mesh.all_gather_cat(d, dim=1),
                              mesh.all_gather_cat(g, dim=1), self.k)
            g, d = g[:, :self.shidx.n_total], d[:, :self.shidx.n_total]
        else:
            ds, gs = [], []
            for s, eng in enumerate(self._shard_engines):
                d_loc, i_loc = self._topk(Q, eng.index)
                ds.append(d_loc)
                gs.append(i_loc + int(self.shidx.offsets[s]))
            g, d = merge_topk(torch.cat(ds, dim=1), torch.cat(gs, dim=1),
                              self.k)
        if self.k == 1:
            return g[:, 0], d[:, 0]
        return g, d
