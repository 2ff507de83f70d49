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
     mode on the grid and on an ``alive0`` list) against
     ``gram_spdtw_scan`` / ``gram_prefix_bound``, for every
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
   survivors), with and without stats, whose neighbours must equal the
   Gram argmin bit for bit; the cascade's own masks (the prefix pass's
   and the exact pass's pairs) give ``spdtw_pair_list``'s lists, each
   equal to ``pair_list_plain``'s, and K1's list mode on them must equal,
   on the listed pairs, ``gram_prefix_bound`` (prefix pass) and K1's
   thresholded grid (exact pass) bit for bit;
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
3g. Multi-device jobs. In this process, on phase 3's engine:
   ``engine.shard(S)`` for S in {1, 2, 4, 8} (each shard's index equal to
   ``with_corpus(shard)``'s bit for bit); the host path of
   ``ShardedSearch`` for S in {2, 4, 8} on the 4000 test series (top-1
   equal to phase 3's ``engine.knn``, top-3 to a stable argsort of phase
   3's Gram, bit for bit); ``SearchEngine(shards=4)`` through
   ``stream_search`` (batch 64) equal to ``engine.knn``, its batch p50 /
   p99 beside the unsharded engine's; ``scenarios.run(shards=4)`` on 512
   retrieval queries, ``exact`` true. Then through ``python -m
   torch.distributed.run --standalone``: ``repro_torch.launch.gram``
   (``--mode gram --kind spdtw``, ``--kind sp_krdtw``, ``--mode knn``; n
   = 2048, T = 128), ``repro_torch.launch.cluster`` (k = 512, N = 2048,
   T = 128, 30 steps) and ``repro_torch.launch.search --shards 2`` on the
   split, each with 2 gloo ranks on this card, then gram spdtw and search
   with 1 nccl rank; each must equal the same call in this process bit
   for bit, launch its kernels (K1, K2, K3, K8, K9) on every rank (the
   counts come back through ``--out``), and the 2-rank search must take
   the distributed path.
3h. The LM / Whisper serving path (plain PyTorch: the LM stack has no
   TPU kernel). gemma3-4b at full width and depth (3.88 B parameters,
   bf16, seeded): ``serve(..., batch=4, prompt_len=16, gen_tokens=16,
   use_reduced=False)`` and its tokens/s; the decode step at batch 4,
   in ``serve``'s loop (``generate``, a CUDA event after each step) and
   captured as one CUDA graph, beside its bound (weights and cache over
   3.35 TB/s); then 1100 teacher-forced positions at batch 1
   (the local layers' 1024-row ring wraps) against ``forward_hidden`` on
   the same tokens, in bf16 (atol 0.4 / rtol 0.1: bf16 drift over 34
   layers) and in a float32 twin of the same weights (atol / rtol 1e-3),
   each side of the wrap. The other nine configurations at their
   published widths (jamba-v0.1-52b at 1 of 4 groups, deepseek-v2-236b
   at the layers that fit in 50 GB): ``make_prefill`` at batch 4 x 16
   tokens (+ 1500 Whisper frames, + 256 Pixtral patches), then
   ``generate``: the prompt step by step and 8 greedy steps through
   ``make_serve_step``, every output finite, the times beside the decode
   bound (for MoE, only the experts the step's tokens routed to count).
   Then each reduced configuration on the same weights: prefill and one
   decode step on the card equal the CPU's within ``LM_CARD_FRAC`` of
   each output's RMS (``lm_card_vs_cpu``, which
   ``tests/test_torch_lm_cuda.py`` runs too).
3i. LM / Whisper training (plain PyTorch, as 3h). gemma3-4b at full width
   and depth: 6 steps of ``make_train_step`` at the reference CLI's shape
   (batch 8 x 64 tokens of ``TokenPipeline(seed=0)``, microbatch 1,
   ``AdamW(lr=cosine_schedule(1e-3, 1, 6))`` with float32 moments and
   master), each step's host and CUDA-event time, loss, grad norm,
   tokens/s and peak memory beside the step's bound (its products,
   counted by FlopCounterMode, over 989 TFLOP/s plus the optimizer's
   bytes over 3.35 TB/s); ``flash_attention`` forward + backward at one
   attention layer's shape (B 1, S 2048, window 1024) beside
   ``scaled_dot_product_attention``'s (a record). whisper-medium whole:
   4 steps at microbatch 1, then 2. Gates: every loss and grad norm
   finite, the first loss within 2.0 of ln V, every parameter leaf
   changed, microbatch 2's first loss equal to microbatch 1's within
   0.02. The other eight reduced configurations on the same weights:
   ``train_loss`` and every gradient card against CPU
   (``lm_train_card_vs_cpu``, bf16 and float32 twin) and flash's
   backward in float32 (``flash_card_vs_cpu``), which
   ``tests/test_torch_lm_train_cuda.py`` runs too. Then
   ``launch.train.train("minicpm-2b", 12 steps)`` with checkpoints and
   its resume to 14: the loss falls, the resume runs steps 12-13.
3j. Multi-rank LM training over the data axis (plain PyTorch and
   torch.distributed, as 3i). deepseek-v2-lite-16b at published width,
   cut to the most layers whose two ranks' bf16 parameters and gradients
   and float32 AdamW state fit in 60 GB (``_dp_cut``, from
   ``param_count``), on 2 gloo ranks sharing the card (each capped at
   ``DP_MEM_FRACTION`` of it), data axis 2, batch 8 x 64, 4 steps, the
   MoE expert-parallel: each step's time, loss, grad norm, peak memory
   per rank, and each collective's calls, host time and bytes. Gates:
   every loss and grad norm finite and equal on the ranks, every leaf
   moved on its owner, the replicated leaves equal bit for bit across
   the ranks after each step (two int64 checksums of their bits), the
   parameters saved at two ranks restored at one rank here equal, block
   by block, to each rank's bits. Then yi-6b, gemma3-4b,
   deepseek-v2-lite-16b and jamba-v0.1-52b reduced, float32 twins: one
   step's synced gradients per microbatch, deferred at m = 2 and deferred
   + int8 on 2 gloo ranks on the card against 2 on the CPU; ``python -m
   torch.distributed.run ... repro_torch.launch.train`` on 1 nccl rank
   and its resume; ``examples/align_whisper_torch.py`` on the card (its
   support and anchors equal to the CPU's on the same weights) and
   ``examples/serve_lm_torch.py``. A rank that fails fails the phase.
3k. Tensor parallelism over the model axis (plain PyTorch and
   torch.distributed, as 3j). yi-6b at published width, cut to the most
   layers whose two model ranks' blocks (16 bytes a parameter; the
   leaves not split over "model" whole on each) fit in 60 GB
   (``_tp_cut``), on 2 gloo ranks sharing the card at (data, model) =
   (1, 2), batch 8 x 64, 4 steps: each step's time, loss, grad norm,
   peak memory per rank, each collective's calls, host time and bytes.
   Gates as 3j's: equal finite losses, every leaf moved, the leaves not
   split over "model" equal bit for bit across the ranks after each
   step, the two-rank save restored at one rank to each rank's bits.
   jamba-v0.1-52b at published width, one group (8 of 32 layers): a
   decode of batch 4 (an 8-token prompt fed step by step, then greedy
   steps, 32 in all) from ``init_cache`` at one rank on the card, freed,
   then on 2 model ranks through caches split over the sequence
   (``make_serve_step(api, layout)``), in bf16 and on its float32 draw:
   row by row, the tokens equal up to the first near-tie and the logits
   within 0.1 (float32) or 0.4 (bf16, whose row-split sums round
   otherwise) of the one-rank logits' RMS, a row leaving the comparison
   where its MoE routing leaves one rank's, which must be at a router
   near-tie; ms a step beside the weight-bytes bound. The ten reduced configurations
   (and yi-6b with ``attn_shard="head_dim"``) at (1, 2), and
   deepseek-v2-lite-16b and jamba-v0.1-52b at (2, 2) (expert- and
   model-parallel at once), float32 twins: the loss and every gathered
   gradient on the card against the CPU; ``python -m
   torch.distributed.run ... repro_torch.launch.train --model-axis 2``
   (gloo, reduced minicpm-2b) and its resume at ``--model-axis 1``.
3l. The dry run (``repro_torch.launch.dryrun``): its traces run in two
   background processes from the start of phase 3 (host work beside the
   card's phases) and are read after 3k. Phase 3i's step (gemma3-4b at
   full width and depth, one card, batch 8 x 64, microbatch 1, AdamW with
   float32 moments and master) traced on fake CUDA tensors: its FLOPs
   must equal the FLOPs FlopCounterMode counted on the card's step in
   3i, its MemTracker peak be within 10 % of 3i's measured peak. The
   production cells gemma3-4b train_4k (meta tensors), deepseek-v2-236b
   decode_32k, jamba-v0.1-52b long_500k and whisper-medium prefill_32k on
   a fake 16 x 16 group with probes, deepseek-v2-236b decode_32k on 2 x
   16 x 16: each "ok", its roofline terms finite, its trace time logged.
   The Gram and cluster dry runs at their command lines' defaults on
   both layouts; the one-rank Gram dry run's cells equal to the real
   one-rank job's ``visited_cells`` (K1 on the card).
   For each path (each part of 3f and 3g) the launch counters are set to
   0 just before and read just after, and each of its kernels must have
   launched. A torch.profiler pass, after 3g and before 3h, gives the
   device time by kernel and the device's idle share for calls of the
   paths; a call with no device record fails the run.
4. Timing at the paths' shapes: each kernel against its plain version,
   with its bound (K8 / K9 as their bare launches' device time, with the
   template each launch takes); K6 at each ``select_radius`` width under
   each of its templates that takes the width, and at T = 1024, w = 204;
   K5 with and without a radius; both K8 / K9 templates at the pair counts
   on either side of ``PAIRS_MIN_FWD`` / ``PAIRS_MIN_BWD`` (a record, not
   a gate); the pair list at the cascade's prefix mask; one JSON line
   ``{"kernels": ...}`` of all nine kernels and the pair list.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository's ``src/`` beside it, the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet: FP32 outside the tensor cores, HBM3
# bandwidth, the special-function unit) and the kernels' work a needed DP
# cell, which the dry run counts too (fails outside the repository)
from repro_torch.launch.cost_analysis import (  # noqa: E402
    FP32_PEAK, HBM_BW as HBM_RATE, KRDTW_DIAG_FLOPS, KRDTW_DIAG_SFU,
    KRDTW_FLOPS, SFU_RATE, SOFT_BWD_SFU, SOFT_FWD_SFU,
    admissible_cells as _admissible_cells, bound_cells as _bound_cells,
    dtw_flops as _dtw_flops, krdtw_bound as _krdtw_bound,
    soft_bwd_flops as _soft_bwd_flops, soft_fwd_flops as _soft_fwd_flops,
    spdtw_flops as _spdtw_flops)
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
    # K1's list: the TPU's grid took no list, so it replaces nothing
    "spdtw_pair_list": (None, CSRC + "spdtw_tiles.cu"),
}
LIBRARIES = ("spdtw_tiles", "krdtw_wavefront", "dtw_wavefront", "soft_tiles")
SOFT = ("soft_tiles_fwd", "soft_tiles_stash", "soft_tiles_bwd")
# the kernels of the SP-DTW path (phase 3) and of the kernel-measure and
# baseline path (phase 3b)
SLICE1 = ("spdtw_tiles_gram", "spdtw_tiles_paired", "spdtw_pair_list")
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
        Ll = gb.gram_spdtw_block(A, B, bsp, T_orig=T, n_prefix=n_prefix,
                                 alive0=alive0)
        record("spdtw_tiles_gram", f"prefix({n_prefix}) alive0 list",
               Ll[alive0], Lbp[alive0])
        require(bool((Ll[~alive0] >= 1e29).all()),
                f"{label} prefix alive0 list: unlisted pairs not +INF")
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
    nn0, nnd0 = timed("engine.knn cascade, no stats (both passes listed)",
                      lambda: eng.knn(ds.X_test))
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
    require(torch.equal(nn0, nn) and torch.equal(nnd0, nnd),
            "cascade without stats != Gram argmin")
    log(f"  cascade nn == Gram argmin, bit for bit, with and without "
        f"stats; stats {stats}")
    alive2 = _check_cascade_lists(eng, ds.X_test, G, stats["prefix_tiles"])
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
            "alive2": alive2, "launches": launches, "stages": stage}


def _check_cascade_lists(eng, X_test, G, n_prefix):
    """The cascade's own pair lists at the main shape. ``engine.knn``
    without stats gives K1's list mode two masks: the pairs left after
    the bounds and seeds (``alive2``, the prefix pass) and the survivors
    (``alive``, the exact pass). Each mask's ``pair_list_cuda`` must equal
    ``pair_list_plain``; K1's prefix mode on the ``alive2`` list must
    equal ``gram_prefix_bound`` on the listed pairs, and read +INF on the
    others; K1's thresholded exact mode on the ``alive`` list must equal
    K1's thresholded grid on the listed pairs. All bit for bit. Returns
    ``alive2``."""
    import torch
    from repro_torch.kernels import gram_block as gb
    masks = []
    listed = gb.pair_list

    def keep(mask):
        masks.append(mask.clone())
        return listed(mask)

    gb.pair_list = keep
    try:
        eng.knn(X_test)
    finally:
        gb.pair_list = listed
    require(len(masks) == 2, f"the cascade built {len(masks)} pair lists, "
            f"expected 2 (its prefix and exact passes)")
    alive2, alive = masks
    require(not bool((alive & ~alive2).any()),
            "the exact pass lists a pair the prefix pass did not")
    for what, m in (("prefix pass (alive2)", alive2),
                    ("exact pass (alive)", alive)):
        ids, count = gb.pair_list_cuda(m)
        want, n = gb.pair_list_plain(m.cpu())
        require(torch.equal(count.cpu(), n) and
                torch.equal(ids[:int(n)].cpu(), want),
                f"pair_list_cuda != pair_list_plain on the {what} mask")
        log(f"  pair list of the cascade's {what}: {int(n)} of "
            f"{m.numel()} pairs ({100 * int(n) / m.numel():.2f} %) == "
            f"pair_list_plain")
    Q = torch.as_tensor(X_test, device=DEVICE)
    C, bsp, T = eng.corpus, eng.bsp, Q.shape[1]
    Ll = gb.gram_spdtw_block(Q, C, bsp, T_orig=T, n_prefix=n_prefix,
                             alive0=alive2)
    Lbp = gb.gram_prefix_bound(Q, C, bsp, n_prefix, T_orig=T, block_a=500)
    ab, rel = diff(Ll[alive2], Lbp[alive2])
    require(torch.equal(Ll[alive2], Lbp[alive2]),
            f"K1 prefix({n_prefix}) on the alive2 list != gram_prefix_bound "
            f"(rel {rel})")
    require(bool((Ll[~alive2] >= 1e29).all()),
            "K1 prefix on the alive2 list: unlisted pairs not +INF")
    thr = torch.quantile(G.double(), 0.3, dim=1).float()
    El = gb.gram_spdtw_block(Q, C, bsp, T_orig=T, thresholds=thr,
                             alive0=alive)
    Eg = gb.gram_spdtw_block(Q, C, bsp, T_orig=T, thresholds=thr)
    require(torch.equal(El[alive], Eg[alive]),
            "K1 thresholded on the alive list != K1's thresholded grid")
    require(bool((El[~alive] >= 1e29).all()),
            "K1 on the alive list: unlisted pairs not +INF")
    log(f"  K1 prefix({n_prefix}) on the alive2 list == gram_prefix_bound, "
        f"thresholded on the alive list == K1's grid, on the listed "
        f"pairs, bit for bit (max abs {ab:.3g})")
    return alive2


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

# the reference's rows at the generators' default sizes, made on the CPU
# by tools/paper_tables_reference.py
TABLES_FIXTURE = "tests/torch_tables_reference.json"
TABLES_DEPENDS = ("spdtw_tiles_gram", "spdtw_tiles_paired", "krdtw_gram",
                  "krdtw_paired", "dtw_wavefront", "dtw_banded")


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
    import torch
    from repro_torch.classify.protocol import (TABLE2, TABLE4, TABLE_TILE,
                                               compare_rows, paper_tables,
                                               summary)
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
        ranks, wil = summary(rows, names, key)
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
    "stream search": ("spdtw_tiles_gram", "spdtw_tiles_paired",
                      "spdtw_pair_list"),
    "load shapes": ("spdtw_tiles_gram", "spdtw_tiles_paired",
                    "spdtw_pair_list"),
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
# Phase 3g: multi-device jobs (the sharded index, the launched jobs)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)
SHARDS_SERVED = 4
SCENARIO_QUERIES = 512
# the reference's job CLIs' defaults (launch/gram.py, launch/cluster.py)
JOB_N, JOB_T = 2048, 128
CLUSTER_K, CLUSTER_STEPS = 512, 30
LAUNCH_TIMEOUT_S = 300
# the launcher passes: (collective backend, ranks)
LAUNCHES = (("gloo", 2), ("nccl", 1))


def _jobs():
    """The launched jobs: (name, module, arguments, kernels each rank must
    launch, run on the nccl pass too)."""
    gram = ["--n", str(JOB_N), "--t", str(JOB_T)]
    return (
        ("gram spdtw", "repro_torch.launch.gram",
         gram + ["--mode", "gram", "--kind", "spdtw"],
         ("spdtw_tiles_gram",), True),
        ("gram sp_krdtw", "repro_torch.launch.gram",
         gram + ["--mode", "gram", "--kind", "sp_krdtw"],
         ("krdtw_gram",), False),
        ("knn", "repro_torch.launch.gram",
         gram + ["--mode", "knn", "--kind", "spdtw"],
         ("spdtw_tiles_gram", "spdtw_tiles_paired"), False),
        ("cluster", "repro_torch.launch.cluster",
         ["--k", str(CLUSTER_K), "--n", str(JOB_N), "--t", str(JOB_T),
          "--steps", str(CLUSTER_STEPS)],
         ("soft_tiles_stash", "soft_tiles_bwd"), False),
        ("search", "repro_torch.launch.search",
         ["--shards", "2", "--dataset", "TwoPatterns", "--n-train",
          str(N_TRAIN), "--t", str(T_MAIN), "--queries", str(N_TEST),
          "--batch", str(SERVE_BATCH), "--check"],
         ("spdtw_tiles_gram", "spdtw_tiles_paired"), True),
    )


MULTI_DEPENDS = {
    "shards": (),
    "sharded search": ("spdtw_tiles_gram", "spdtw_tiles_paired",
                       "spdtw_pair_list"),
    "sharded serving": ("spdtw_tiles_gram", "spdtw_tiles_paired",
                        "spdtw_pair_list"),
    "scenarios.run": ("spdtw_tiles_gram", "spdtw_tiles_paired"),
}


def _one_process(name):
    """The launched job ``name``'s call in this process (no group): its
    result arrays."""
    from repro_torch.launch import cluster, gram, search
    if name == "gram spdtw":
        return {"G": gram.run(JOB_N, JOB_T, "spdtw", device=DEVICE)}
    if name == "gram sp_krdtw":
        return {"G": gram.run(JOB_N, JOB_T, "sp_krdtw", device=DEVICE)}
    if name == "knn":
        nn, dist = gram.run(JOB_N, JOB_T, "spdtw", mode="knn",
                            device=DEVICE)
        return {"nn": nn, "dist": dist}
    if name == "cluster":
        Z, loss = cluster.run(CLUSTER_K, JOB_N, JOB_T, steps=CLUSTER_STEPS,
                              device=DEVICE)
        return {"Z": Z, "loss": loss}
    res = search.run("TwoPatterns", n_queries=N_TEST, batch=SERVE_BATCH,
                     n_train=N_TRAIN, T=T_MAIN, check=True, shards=2,
                     device=DEVICE)
    return {"nn": res["nn"], "dist": res["dist"]}


def _launch(backend, nproc, module, args, out_dir):
    """``python -m torch.distributed.run --standalone`` with ``nproc``
    ranks of ``module``; returns (exit code, output, wall s). The launcher
    and its ranks run in a session of their own, killed whole at the
    time limit."""
    import os
    import signal
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    # "--" keeps the job's options (--n, --t) from being read as
    # abbreviations of the launcher's
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "--", module, *args,
           "--backend", backend, "--out", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=LAUNCH_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{module} with {nproc} {backend} ranks passed "
                             f"{LAUNCH_TIMEOUT_S} s")
    return proc.returncode, out, time.perf_counter() - t0


def phase_multi(main):
    """The multi-device tier on phase 3's engine and through the launcher.

    In this process: ``engine.shard(S)`` for S in {1, 2, 4, 8}, each
    shard's index equal to ``with_corpus(shard)``'s bit for bit; the host
    path of ``ShardedSearch`` for S in {2, 4, 8} on the 4000 test series,
    top-1 equal to phase 3's ``engine.knn`` and top-3 to a stable argsort
    of phase 3's Gram, bit for bit; ``SearchEngine(shards=4)`` through
    ``stream_search`` (batch 64) equal to ``engine.knn``, its batch p50 /
    p99 beside the unsharded engine's in the same call; and
    ``scenarios.run(shards=4)`` (512 retrieval queries): ``exact`` true.
    Launch counters are set to 0 before each part and read after it.

    Through ``torch.distributed.run``: the gram (spdtw, sp_krdtw), knn,
    cluster and sharded search CLIs with 2 gloo ranks on this card, then
    gram spdtw and search with 1 nccl rank. Each rank's launch counts
    come back through ``--out``; every rank must have launched its
    kernels, the sharded search must report the distributed path on 2
    ranks, and each result must equal the same call in this process bit
    for bit. A rank that fails fails the run."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import scenarios as sc
    from repro_torch.launch.search import SearchEngine, stream_search
    from repro_torch.launch.shard_index import ShardedSearch, shard_offsets
    eng, ds, G = main["engine"], main["ds"], main["G"]
    Xte = torch.as_tensor(ds.X_test, device=DEVICE)
    exact_nn = main["nn"]
    exact_d = G.gather(1, exact_nn[:, None].long())[:, 0]
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
        for k in MULTI_DEPENDS[name]:
            require(lc[k] > 0, f"{k} never launched in the multi-device "
                    f"part {name!r}")

    def shards():
        for S in SHARD_COUNTS:
            offs = shard_offsets(N, S)
            for s, se in enumerate(eng.shard(S)):
                want = eng.with_corpus(
                    eng.corpus[int(offs[s]):int(offs[s + 1])]).index
                for f in ("corpus", "env_lo", "env_hi"):
                    require(torch.equal(getattr(se.index, f),
                                        getattr(want, f)),
                            f"shard {s} of {S}: {f} != with_corpus's")
        log(f"    engine.shard(S), S in {SHARD_COUNTS}: every shard's index "
            f"== with_corpus(shard), bit for bit")

    part("shards", shards)

    def search():
        ids3 = torch.sort(G, dim=1, stable=True).indices[:, :3]
        for S in SHARD_COUNTS[1:]:
            sh = ShardedSearch(eng, S)
            require(sh.path == "host", f"S = {S}: path {sh.path}")
            ms, (g, d) = cuda_ms(lambda: sh.knn(Xte))
            require(torch.equal(g, exact_nn) and torch.equal(d, exact_d),
                    f"sharded top-1, S = {S} != phase 3's engine.knn")
            ms3, (g3, d3) = cuda_ms(
                lambda: ShardedSearch(eng, S, k=3).knn(Xte))
            require(torch.equal(g3.long(), ids3) and
                    torch.equal(d3, G.gather(1, ids3)),
                    f"sharded top-3, S = {S} != stable argsort of the Gram")
            log(f"    S = {S} (host path, sizes "
                f"{sh.balance()['sizes'][:2]}...): top-1 == engine.knn in "
                f"{ms:.1f} ms, top-3 == stable argsort of the Gram in "
                f"{ms3:.1f} ms, bit for bit")

    part("sharded search", search)

    def serving():
        rows = {}
        for S in (0, SHARDS_SERVED):
            se = SearchEngine(None, engine=eng, shards=S)
            res = stream_search(se, ds.X_test, batch=SERVE_BATCH)
            nn = np.array([r.nn for r in res])
            d = np.array([r.dist for r in res], np.float32)
            require(np.array_equal(nn, exact_nn.cpu().numpy()) and
                    np.array_equal(d, exact_d.cpu().numpy()),
                    f"stream_search with shards={S} != engine.knn")
            rows[S] = se.stats()["latency_ms"]["total"]
        log(f"    stream_search batch {SERVE_BATCH}, shards="
            f"{SHARDS_SERVED}: == engine.knn, bit for bit; batch p50 / "
            f"p99 {rows[SHARDS_SERVED]['p50']:.2f} / "
            f"{rows[SHARDS_SERVED]['p99']:.2f} ms (unsharded, same call: "
            f"{rows[0]['p50']:.2f} / {rows[0]['p99']:.2f} ms)")

    part("sharded serving", serving)

    def scenarios():
        p = sc.run(dataset="TwoPatterns", n_queries=SCENARIO_QUERIES,
                   batch=SERVE_BATCH, shards=SHARDS_SERVED, n_train=N_TRAIN,
                   T=T_MAIN, device=DEVICE)
        require(p["exact"], "scenarios.run: sharded top-1 != single host")
        log(f"    scenarios.run, {p['n_shards']} shards ({p['shard_path']} "
            f"path, imbalance {p['shard_balance']['imbalance']:.3f}): "
            f"exact")
        for name, r in p["scenarios"].items():
            _log_serving(name, r)

    part("scenarios.run", scenarios)

    # ---- the launched jobs
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-jobs-"))
    launched = {}
    try:
        for backend, nproc in LAUNCHES:
            for name, module, args, kernels, on_nccl in _jobs():
                if backend == "nccl" and not on_nccl:
                    continue
                if name not in launched:
                    t0 = time.perf_counter()
                    launched[name] = _one_process(name)
                    torch.cuda.synchronize()
                    log(f"  {name}, one process: "
                        f"{time.perf_counter() - t0:.1f} s")
                out_dir = tmp / f"{backend}-{name.replace(' ', '-')}"
                rc, out, wall = _launch(backend, nproc, module, args,
                                        str(out_dir))
                if rc != 0:
                    log(out[-4000:])
                require(rc == 0, f"{name}: {nproc} {backend} ranks exited "
                        f"{rc}")
                meta = json.loads((out_dir / "result.json").read_text())
                got = np.load(out_dir / "result.npz")
                require(meta["world_size"] == nproc and
                        meta["backend"] == backend,
                        f"{name}: group {meta['world_size']} "
                        f"{meta['backend']}")
                for r, lc in enumerate(meta["launches"]):
                    for k in kernels:
                        require(lc[k] > 0, f"{name}: {k} never launched on "
                                f"rank {r} of {nproc} {backend}")
                want = launched[name]
                require(set(got.files) == set(want),
                        f"{name}: result holds {got.files}")
                for k, v in want.items():
                    require(np.array_equal(got[k], v),
                            f"{name}: {k} on {nproc} {backend} ranks != one "
                            f"process (max abs difference "
                            f"{np.abs(got[k] - v).max()})")
                what = ""
                if name == "search":
                    path = meta["payload"]["stats"]["shard_balance"]["path"]
                    require(path == ("dist" if nproc > 1 else "host"),
                            f"search on {nproc} {backend} ranks took the "
                            f"{path} path")
                    lat = meta["payload"]["stats"]["latency_ms"]["total"]
                    what = (f", {path} path, batch p50 / p99 "
                            f"{lat['p50']:.2f} / {lat['p99']:.2f} ms")
                log(f"  {name}, {nproc} {backend} rank(s): == one process, "
                    f"bit for bit; job {meta['wall_s']:.2f} s, launch "
                    f"{wall:.1f} s{what}; launches per rank: " + "; ".join(
                        ", ".join(f"{k} {lc[k]}" for k in kernels)
                        for lc in meta["launches"]))
                lc_sum = {k: sum(lc[k] for lc in meta["launches"])
                          for k in KERNELS}
                parts[f"{name} ({backend})"] = lc_sum
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = {k: sum(lc[k] for lc in parts.values()) for k in KERNELS}
    return {"launches": total, "stages": stage}


# ---------------------------------------------------------------------------
# Phase 3h
# ---------------------------------------------------------------------------

# gemma3-4b at full width and depth: serve's shape, then a teacher-forced
# decode long enough for the local layers' 1024-row ring to wrap
LM_FULL_ARCH = "gemma3-4b"
LM_SERVE = (4, 16, 16)        # batch, prompt, generated tokens
LM_WRAP_POSITIONS = 1100
# the reference's decode-against-forward rtol (tests/test_smoke_archs.py)
LM_RTOL = 0.1
# gemma3-4b at full width and depth: bf16 decode against bf16 forward
# (rtol as above), and the float32 twin's decode against its forward. The
# reference's atol 0.15 does not hold at 34 layers: bf16 rounding drifts
# with depth (decode and forward each ~0.3 from the float32 twin, 0.16 at
# 17 layers), while the twin's decode equals its forward within 1e-4 on
# both sides of the ring's wrap, so the cache is right.
LM_FULL_ATOL = 0.4
LM_F32_ATOL, LM_F32_RTOL = 1e-3, 1e-3
# the other nine at their published widths: batch, prompt, greedy steps
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 16, 8
# deepseek-v2-236b keeps as many layers as fit in this many bytes
LM_DEPTH_BYTES = 50e9
# reduced configurations, card against CPU on the same weights: each
# output within a fraction of the CPU output's RMS, never above the
# reference's atol 0.15. Measured worst |error| / RMS on an H100 over the
# ten: logits 0.0 (3e-4 in an earlier run), hidden states 0.0137 and
# cache leaves 0.027 (gemma3-4b)
LM_CARD_FRAC = {"logits": 1e-3, "hidden": 0.04, "cache": 0.08}
LM_ATOL_MAX = 0.15


def _lm_cut(cfg):
    """The depth a published configuration runs at on one card: jamba at
    one group of its pattern, deepseek-v2-236b at as many layers as fit in
    ``LM_DEPTH_BYTES``; every other configuration whole."""
    import dataclasses
    if cfg.name == "jamba-v0.1-52b":
        return dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    if cfg.name == "deepseek-v2-236b":
        n = 1
        while (n < cfg.n_layers and 2 * dataclasses.replace(
                cfg, n_layers=n + 1).param_count() <= LM_DEPTH_BYTES):
            n += 1
        return dataclasses.replace(cfg, n_layers=n)
    return cfg


def _lm_free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_expert_bytes(params):
    """(bytes of every routed expert's weights, bytes of one expert in one
    layer): the MoE leaves ``gate`` / ``up`` / ``down``, each (G, E, ...)."""
    from repro_torch.models.lm import param_bytes
    leaves = [g[k] for g in params["groups"] for k in ("gate", "up", "down")
              if k in g]
    if not leaves:
        return 0, 0
    total = sum(param_bytes(t) for t in leaves)
    per_layer = sum(t.shape[0] * t.shape[1] for t in leaves) // 3
    return total, total // per_layer


def _lm_bound_ms(params, cache, routed=0.0):
    """A decode step's least time: the bytes it must read once over the
    memory rate. Every weight and the cache, except that of the routed
    experts only the ones this run's tokens chose count: ``routed``
    experts a step, summed over its MoE layers (the local path reads
    every expert; ``_lm_expert_bytes``)."""
    from repro_torch.models.lm import param_bytes
    every, one = _lm_expert_bytes(params)
    need = param_bytes(params) - every + routed * one + param_bytes(cache)
    return need / HBM_RATE * 1e3


def _lm_all_finite(tree) -> bool:
    import torch
    from repro_torch.models.lm import tree_leaves
    return all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(tree))


def _lm_generate(api, params, tokens, gen_tokens):
    """``serve``'s loop (``launch.serve.generate``) on the card, a CUDA
    event recorded after each step and the experts each MoE layer routes
    to kept. Returns (generated tokens, ms of each step after the first,
    the final cache, distinct experts a step summed over its MoE
    layers)."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    events, ids, last = [], [], {}

    def on_step(pos, cache):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        last["cache"] = cache

    router = moe._router

    def logged(x, w_router, top_k):
        out = router(x, w_router, top_k)
        ids.append(out[0])
        return out

    moe._router = logged
    try:
        gen, _ = generate(api, params, tokens, gen_tokens, DEVICE,
                          on_step=on_step)
    finally:
        moe._router = router
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    routed = sum(int(torch.unique(i).numel()) for i in ids) / len(events)
    return gen, ms, last["cache"], routed


def _lm_captured(api, params, cache, B):
    """One decode step captured in a CUDA graph, to be replayed at any
    position (the position is a device tensor the step reads). Returns
    ``replay(token (B, 1), pos) -> logits (B, V)``, writing into
    ``cache``."""
    import torch
    from repro_torch.models.lm import tree_map
    tok = torch.zeros((B, 1), dtype=torch.long, device=DEVICE)
    pos = torch.zeros((), dtype=torch.long, device=DEVICE)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up before capture
        for _ in range(2):
            api.decode_step(params, cache, tok, pos)
    torch.cuda.current_stream().wait_stream(side)
    tree_map(lambda t: t.zero_(), cache)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = api.decode_step(params, cache, tok, pos)

    def replay(token, p):
        tok.copy_(token)
        pos.fill_(p)
        graph.replay()
        return logits

    return replay


def _lm_busy(fn):
    """(wall ms, device-busy ms, device records, host calls that each put
    one record on the device) of ``fn()`` under torch.profiler."""
    wall, dev, calls = profiled(fn)
    return wall, sum(e.duration_ns() for e in dev) / 1e6, len(dev), calls


def _lm_decode_logits(api, params, cache, toks):
    """Teacher-forced decode of every position of ``toks`` (1, T) through
    a captured step: the (T, V) float32 logits."""
    import torch
    replay = _lm_captured(api, params, cache, 1)
    T = toks.shape[1]
    out = None
    for t in range(T):
        lg = replay(toks[:, t:t + 1], t)[0]
        if out is None:
            out = torch.empty((T, lg.shape[0]), dtype=lg.dtype,
                              device=DEVICE)
        out[t] = lg
    return out


def _lm_compare(got, want, ring, atol, rtol):
    """Per segment (rows before ``ring``, rows from it on): the worst
    |got - want|, the worst excess over atol + rtol |want|, and the rows
    whose argmax agree."""
    d = (got - want).abs()
    ex = d - atol - rtol * want.abs()
    agree = got.argmax(-1) == want.argmax(-1)
    return [(float(d[sl].max()), float(ex[sl].max()), int(agree[sl].sum()))
            for sl in (slice(0, ring), slice(ring, None))]


def _lm_full_width():
    """gemma3-4b at full width and depth: ``serve`` on the card, its decode
    step (eager and captured) against its bound, and 1100 teacher-forced
    decode positions against ``forward_hidden`` through the ring's wrap,
    in bf16 and in a float32 twin of the same weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, serve
    from repro_torch.models import build, lm
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train.train_step import make_prefill
    batch, prompt, gen = LM_SERVE
    t0 = time.perf_counter()
    out = serve(LM_FULL_ARCH, batch=batch, prompt_len=prompt,
                gen_tokens=gen, use_reduced=False, device=DEVICE)
    wall = time.perf_counter() - t0
    require(tuple(out["generated"]) == (batch, gen) and out["tokens_per_s"]
            > 0, f"serve {LM_FULL_ARCH}: {out}")
    cfg = get_config(LM_FULL_ARCH)
    require(all(0 <= t < cfg.vocab for t in out["sample"]),
            f"serve {LM_FULL_ARCH}: tokens out of range {out['sample']}")
    log(f"  serve({LM_FULL_ARCH!r}, batch={batch}, prompt_len={prompt}, "
        f"gen_tokens={gen}, use_reduced=False): {out['tokens_per_s']} "
        f"tokens/s ({wall:.1f} s with the weights' draw); sample "
        f"{out['sample']}")

    api = build(cfg)
    gen_t = torch.Generator(device=DEVICE).manual_seed(0)
    params = api.init_params(gen_t)
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen_t,
                         device=DEVICE)
    pre_ms, (h, _) = cuda_ms(lambda: make_prefill(api, prompt + gen)(
        params, {"tokens": toks}), reps=3, warmup=1)
    require(_lm_all_finite(h), f"{LM_FULL_ARCH}: prefill is not finite")
    host_toks = toks.cpu().numpy()
    _, times, cache, _ = _lm_generate(api, params, host_toks, gen)
    bound = _lm_bound_ms(params, cache)
    ms = statistics.median(times)
    busy = _lm_busy(lambda: generate(api, params, host_toks[:, :1], 4,
                                     DEVICE))
    replay = _lm_captured(api, params, cache, batch)
    tok = toks[:, :1]
    graph_ms, _ = cuda_ms(lambda: replay(tok, prompt), reps=10, warmup=2)
    gbusy = _lm_busy(lambda: [replay(tok, prompt) for _ in range(4)])
    log(f"  {LM_FULL_ARCH}, {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters: prefill of {batch} x {prompt} tokens {pre_ms:.2f} "
        f"ms; decode step of generate at batch {batch} {ms:.3f} ms eager "
        f"(median of {len(times)}; {min(times):.3f}-{max(times):.3f}), "
        f"{graph_ms:.3f} ms replayed as one CUDA graph; bound {bound:.3f} "
        f"ms (weights and cache over {HBM_RATE / 1e12:.2f} TB/s): "
        f"{ms / bound:.1f}x eager, {graph_ms / bound:.2f}x captured")
    for what, (wall_ms, busy_ms, n, calls) in (("eager (generate)", busy),
                                               ("captured", gbusy)):
        log(f"    profile of 4 {what} steps: wall {wall_ms:.1f} ms, device "
            f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
            f"{100 * (1 - busy_ms / wall_ms):.1f}%, {n} device records "
            f"({n / 4:.0f} a step) for {calls} launch / copy / fill calls "
            f"(graph launches not counted)")
    rows = {"arch": LM_FULL_ARCH, "tokens_per_s": out["tokens_per_s"],
            "prefill_ms": pre_ms, "decode_ms": ms, "graph_ms": graph_ms,
            "bound_ms": bound}
    del cache, replay

    # 1100 teacher-forced positions: the 1024-row ring of the local layers
    # wraps; bf16, and a float32 twin of the same weights (its rounding
    # cannot hide a wrong cache row)
    T = LM_WRAP_POSITIONS
    ring = min(s.window for s in cfg.pattern if s.window)
    toks = torch.randint(0, cfg.vocab, (1, T), generator=gen_t,
                         device=DEVICE)
    logits = {}
    for name in ("bf16", "f32"):
        p = params if name == "bf16" else lm.tree_map(lambda t: t.float(),
                                                      params)
        t0 = time.perf_counter()
        hid, _ = lm.forward_hidden(p, toks, cfg)
        fwd = lm.logits_of(p, hid)[0]
        del hid
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        cache = lm.init_cache(cfg, 1, T, dtype=lm.act_dtype(p),
                              device=DEVICE)
        t0 = time.perf_counter()
        dec = _lm_decode_logits(api, p, cache, toks)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        logits[name] = (dec, fwd)
        log(f"  {LM_FULL_ARCH} {name}: forward_hidden over {T} tokens "
            f"{fwd_s:.2f} s; {T} teacher-forced decode positions at batch "
            f"1 through the captured step {dec_s:.1f} s "
            f"({1e3 * dec_s / T:.2f} ms a position)")
        del cache, p
    del params
    _lm_free()
    bf, f32 = logits["bf16"], logits["f32"]
    checks, gates = {}, []
    for what, (a, b), (atol, rtol), gate in (
            ("bf16 decode vs bf16 forward", bf, (LM_FULL_ATOL, LM_RTOL),
             True),
            ("f32 decode vs f32 forward", f32, (LM_F32_ATOL, LM_F32_RTOL),
             True),
            ("bf16 decode vs f32 forward", (bf[0], f32[1]),
             (LM_FULL_ATOL, LM_RTOL), False),
            ("bf16 forward vs f32 forward", (bf[1], f32[1]),
             (LM_FULL_ATOL, LM_RTOL), False)):
        segs = _lm_compare(a, b, ring, atol, rtol)
        checks[what] = [e for e, _, _ in segs]
        log(f"    {what}: worst |logit error| {segs[0][0]:.5f} before "
            f"position {ring}, {segs[1][0]:.5f} from {ring} on (the "
            f"{ring}-row ring wraps); argmax equal at {segs[0][2]} / "
            f"{ring} and {segs[1][2]} / {T - ring}" + (
                f"; limit atol {atol} / rtol {rtol}" if gate else ""))
        if gate:
            gates += [(ex <= 0, f"{LM_FULL_ARCH} {what} {side} the wrap: "
                       f"worst |error| {err}, over atol {atol} / rtol "
                       f"{rtol}")
                      for (err, ex, _), side in zip(segs, ("before",
                                                           "after"))]
    for ok, what in gates:
        require(ok, what)
    rows["wrap"] = checks
    del logits, bf, f32
    _lm_free()
    return rows


def _lm_published(arch):
    """One configuration at its published width (depth cut where one card
    cannot hold it): prefill with the encoder or patch path, then
    ``serve``'s loop (the prompt step by step, ``LM_STEPS`` greedy steps
    through ``make_serve_step``; Whisper cross-attends to the all-zero
    cross cache, as ``serve`` does)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train.train_step import make_prefill
    full = get_config(arch)
    cfg = _lm_cut(full)
    api = build(cfg)
    gen_t = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = api.init_params(gen_t)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, P = LM_BATCH, LM_PROMPT
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=gen_t,
                                     device=DEVICE)}
    what = f"{P} tokens"
    if cfg.family == "audio":
        batch["frames"] = torch.randn(B, cfg.n_frames, cfg.d_model,
                                      generator=gen_t, device=DEVICE
                                      ).to(torch.bfloat16)
        what += f" + {cfg.n_frames} frames"
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(B, cfg.n_patches, cfg.d_model,
                                       generator=gen_t, device=DEVICE
                                       ).to(torch.bfloat16)
        what += f" + {cfg.n_patches} patches"
    prefill = make_prefill(api, P + LM_STEPS)
    pre_ms, (h, pcache) = cuda_ms(lambda: prefill(params, batch), reps=3,
                                  warmup=1)
    require(_lm_all_finite(h) and _lm_all_finite(pcache),
            f"{arch}: prefill is not finite")
    del pcache
    toks, times, cache, routed = _lm_generate(
        api, params, batch["tokens"].cpu().numpy(), LM_STEPS)
    require(toks.shape == (B, LM_STEPS) and bool(
        ((toks >= 0) & (toks < cfg.vocab)).all()) and _lm_all_finite(cache),
        f"{arch}: decode is not finite")
    ms = statistics.median(times)
    bound = _lm_bound_ms(params, cache, routed)
    n_params = sum(t.numel() for t in tree_leaves(params))
    depth = (f"{cfg.n_layers} of {full.n_layers} layers"
             if cfg.n_layers != full.n_layers else f"{cfg.n_layers} layers")
    moe = ""
    if routed:
        every, one = _lm_expert_bytes(params)
        moe = (f" ({routed:.1f} routed experts a step over its MoE layers;"
               f" every expert, as the local path reads them, "
               f"{_lm_bound_ms(params, cache, every / one):.3f} ms)")
    log(f"  {arch} ({depth}, {n_params / 1e9:.3f} B parameters, drawn in "
        f"{init_s:.2f} s): prefill of {B} x ({what}) {pre_ms:.2f} ms; "
        f"decode step of generate at batch {B} {ms:.3f} ms (median of "
        f"{len(times)}, {min(times):.3f}-{max(times):.3f}); bound "
        f"{bound:.3f} ms{moe}, {ms / bound:.1f}x; finite")
    del params, cache, batch, h
    _lm_free()
    return {"arch": arch, "layers": cfg.n_layers, "of": full.n_layers,
            "prefill_ms": pre_ms, "decode_ms": ms, "bound_ms": bound,
            "routed": routed}


def lm_card_vs_cpu(arch, device=None):
    """``reduced(cfg)`` of ``arch`` on the same weights: prefill and one
    decode step from ``init_cache`` on ``device`` (``DEVICE`` by default)
    against the same calls on the CPU (cuBLAS rounds its bf16 products otherwise). Returns one
    row per output, (kind, worst |error|, the CPU output's RMS, limit):
    the logits, prefill's hidden state, every cache leaf; the limit is
    ``LM_CARD_FRAC[kind]`` of the RMS, at most ``LM_ATOL_MAX``. Also the
    check of ``tests/test_torch_lm_cuda.py``."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    from repro_torch.models.lm import tree_leaves, tree_map
    device = DEVICE if device is None else device
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    B, S = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(B, cfg.n_frames, cfg.d_model,
                                      generator=gen)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(B, cfg.n_patches, cfg.d_model,
                                       generator=gen)
    outs = []
    for dev in ("cpu", device):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            h, cache = api.prefill(p, b, S + 4)
            logits, new = api.decode_step(
                p, api.init_cache(B, S + 4, device=dev), b["tokens"][:, :1],
                S)
        outs.append([("logits", logits), ("hidden", h)]
                    + [("cache", t) for t in tree_leaves((cache, new))])
    rows = []
    for (kind, want), (_, got) in zip(*outs):
        got, want = got.float().cpu(), want.float()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"{arch} reduced: card output {len(rows)} malformed")
        rms = float(want.pow(2).mean().sqrt())
        rows.append((kind, float((got - want).abs().max()), rms,
                     min(LM_CARD_FRAC[kind] * rms, LM_ATOL_MAX)))
    return rows


def phase_lm():
    """The LM / Whisper serving path on the card (no kernel of the port
    runs on it: the LM stack has no TPU kernel)."""
    import torch
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    log(f"  card: {card_line()}; {free / 1e9:.1f} of {total / 1e9:.1f} GB "
        f"free")
    reset_launch_counts()
    with torch.inference_mode():
        full = _lm_full_width()
        rows = [_lm_published(a) for a in ARCH_IDS if a != LM_FULL_ARCH]
    card = {a: lm_card_vs_cpu(a) for a in ARCH_IDS}
    worst = {}
    for a, rs in card.items():
        worst[a] = {k: max((err / rms if rms else 0.0, err)
                           for kind, err, rms, _ in rs if kind == k)
                    for k in LM_CARD_FRAC}
    log("  reduced configs, card against CPU on the same weights (worst "
        "|error| / RMS (|error|) of the decode logits, prefill's hidden "
        "state and every cache leaf; limits " + ", ".join(
            f"{k} {f} of the RMS" for k, f in LM_CARD_FRAC.items())
        + f", at most {LM_ATOL_MAX}): " + "; ".join(
            f"{a} " + " / ".join(f"{r:.2e} ({e:.2e})" for r, e in w.values())
            for a, w in worst.items()))
    lc = launch_counts()
    log(f"  launches of the port's CUDA kernels on the LM path: "
        f"{sum(lc.values())} (the LM stack has no TPU kernel)")
    wall = time.perf_counter() - t0
    log(f"  phase 3h wall time {wall:.1f} s")
    for a, rs in card.items():
        for i, (kind, err, rms, limit) in enumerate(rs):
            require(err <= limit, f"{a} reduced: card != CPU in output {i} "
                    f"({kind}): |error| {err} over {limit}")
    return {"full": full, "rows": rows, "card_vs_cpu": worst, "wall": wall}


# ---------------------------------------------------------------------------
# Phase 3i
# ---------------------------------------------------------------------------

# gemma3-4b at full width and depth, trained at the reference CLI's shape
# (``repro.launch.train``: batch 8, seq 64, microbatch 1, a cosine
# schedule with one warm-up step)
TRAIN_FULL_ARCH = "gemma3-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 6
TRAIN_LR = 1e-3
# a record beside it: the same steps from the same weights at a tenth of
# the lr (at TRAIN_LR the loss rises for two steps before it falls)
TRAIN_LR_LOW = TRAIN_LR / 10
# whisper-medium whole, at microbatch 1 and 2
WHISPER_ARCH, WHISPER_STEPS = "whisper-medium", 4
# the first loss within this of ln V (the reference's smoke check,
# tests/test_smoke_archs.py)
TRAIN_LOSS_SLACK = 2.0
# microbatch 2's first loss against microbatch 1's on the same batch and
# weights: the same mean, its halves' bf16 products shaped otherwise
# (equal to the last bit on an H100)
MICRO_LOSS_ATOL = 0.02
# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_PEAK = 989e12
# one gemma3-4b attention layer: batch and sequence (two KV chunks of
# 1024, the local window 1024)
FLASH_SHAPE = (1, 2048)
# reduced configurations, card against CPU on the same weights: the loss
# within TRAIN_LOSS_ATOL, every gradient leaf within TRAIN_GRAD_RTOL |cpu|
# + TRAIN_GRAD_FRAC of the CPU leaf's RMS; bf16 gradients of the MoE
# configurations are not compared (a router near-tie moves whole expert
# gradients; their float32 twins are). The bf16 limits are the CPU
# parity tests' (tests/torch_train_helpers.py); the float32 twin's are
# float32 sums in another order. Measured worst on an H100 over the
# eight: losses 4.8e-7; bf16 gradients 9.3e-5 of the RMS beyond the
# rtol, float32 twins 1.1e-5.
TRAIN_LOSS_ATOL = {"bf16": 1e-3, "f32": 1e-5}
TRAIN_GRAD_RTOL = {"bf16": 2.0 ** -6, "f32": 0.0}
TRAIN_GRAD_FRAC = {"bf16": 0.3, "f32": 1e-4}
# flash attention's backward, card against CPU in float32 at a windowed
# shape of four KV chunks (measured worst |error| on an H100: 7.2e-7),
# and on the card against autograd through layers.attention in float32
# at FLASH_SHAPE with gemma3-4b's heads
FLASH_CARD_CASE = (2, 64, 4, 2, 32, 20, 16)   # B, S, Hq, Hkv, hd, window, ck
FLASH_CARD_ATOL, FLASH_CARD_RTOL = 1e-5, 1e-4
# the checkpoint and resume run, the reference's own test shape
# (tests/test_train_stack.py::test_train_loss_decreases_end_to_end)
RESUME_ARCH = "minicpm-2b"
RESUME_RUN = dict(use_reduced=True, batch=4, seq=32, ckpt_every=6,
                  lr=5e-3, log_every=100)
RESUME_STEPS = (12, 14)


def _is_moe(cfg) -> bool:
    return any(s.ffn == "moe" for s in cfg.pattern)


def _train_batch(cfg, batch, seq, seed, step, device):
    from repro_torch.launch.train import to_device
    from repro_torch.train.data import TokenPipeline
    return to_device(TokenPipeline(cfg, batch, seq, seed=seed).batch_at(step),
                     device)


def _train_flops(api, params, batch) -> float:
    """The matrix-product operations of one loss-and-gradient pass as the
    port runs it (forward, each group's and each loss chunk's recomputed
    forward, backward), counted by torch's FlopCounterMode on this
    batch."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.train.train_step import value_and_grad
    with FlopCounterMode(display=False) as fc:
        value_and_grad(api, params, batch)
    return float(fc.get_total_flops())


def _opt_bytes(params, opt) -> int:
    """Bytes one AdamW step must move: each leaf's gradient read twice
    (the norm, the update), its m, v and master read and written, its
    parameter written."""
    import torch
    from repro_torch.models.lm import tree_leaves
    mom = torch.tensor([], dtype=opt.moment_dtype).element_size()
    total = 0
    for p in tree_leaves(params):
        per = 2 * p.element_size() + 4 * mom + p.element_size()
        per += 8 if opt.keep_master else 4
        total += p.numel() * per
    return total


def _train_steps(api, params, opt, cfg, steps, microbatch, seed=0):
    """``steps`` steps of ``make_train_step`` from a fresh optimizer state
    on ``TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed)``'s batches,
    each step between two synchronisations: its host time, its CUDA-event
    time, loss, grad norm and peak memory. Returns (params, rows)."""
    import torch
    from repro_torch.train.train_step import make_train_step
    step_fn = make_train_step(api, opt, microbatch=microbatch)
    state = opt.init(params)
    rows = []
    for s in range(steps):
        b = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, s, DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        params, state, met = step_fn(params, state, b)
        e1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rows.append({"wall_ms": wall, "cuda_ms": e0.elapsed_time(e1),
                     "loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del state
    return params, rows


def _train_gates(what, cfg, rows, params, host):
    """Every loss and grad norm finite, the first loss within
    ``TRAIN_LOSS_SLACK`` of ln V, every parameter leaf changed."""
    import math
    import torch
    from repro_torch.models.lm import tree_leaves
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in rows), f"{what}: a loss or grad norm is not finite")
    ln_v = math.log(cfg.vocab)
    require(abs(rows[0]["loss"] - ln_v) < TRAIN_LOSS_SLACK,
            f"{what}: first loss {rows[0]['loss']} not within "
            f"{TRAIN_LOSS_SLACK} of ln V = {ln_v:.3f}")
    same = [i for i, (t, h) in enumerate(zip(tree_leaves(params), host))
            if torch.equal(t.cpu(), h)]
    require(not same, f"{what}: parameter leaves {same} did not change")


def _log_steps(what, rows, tokens, bound_ms=None):
    for i, r in enumerate(rows):
        extra = (f"; bound {bound_ms:.2f} ms, {r['wall_ms'] / bound_ms:.1f}x"
                 if bound_ms else "")
        log(f"    {what} step {i}: {r['wall_ms']:.1f} ms host, "
            f"{r['cuda_ms']:.1f} ms CUDA events, loss {r['loss']:.4f}, "
            f"grad norm {r['grad_norm']:.4f}, "
            f"{tokens / r['wall_ms'] * 1e3:.0f} tokens/s, peak "
            f"{r['peak_gb']:.2f} GB{extra}")


def _flash_vs_sdpa(cfg):
    """Flash attention's forward + backward at one gemma3-4b attention
    layer's shape (bf16, causal within the local window) beside
    ``scaled_dot_product_attention``'s at the same shape and mask, and
    the least time the work could take (a record); flash in float32 on
    the same inputs against autograd through ``layers.attention`` within
    ``FLASH_CARD_ATOL`` + ``FLASH_CARD_RTOL`` |plain| (a gate), and each
    bf16 result's distance from that float32 plain one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import attention
    B, S = FLASH_SHAPE
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = min(s.window for s in cfg.pattern if s.window)
    g = torch.Generator(device=DEVICE).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE).to(
            torch.bfloat16)

    q, k, v, dout = (rnd(B, S, H, hd), rnd(B, S, Hkv, hd),
                     rnd(B, S, Hkv, hd), rnd(B, S, H, hd))
    ours_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_in = [t.transpose(1, 2).contiguous().requires_grad_(True)
              for t in (q, k, v)]
    i = torch.arange(S, device=DEVICE)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    dlib = dout.transpose(1, 2).contiguous()

    def ours():
        o = flash_attention(*ours_in, True, window, 0, 1024, None)
        return (o,) + torch.autograd.grad(o, ours_in, dout)

    def lib():
        o = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                           enable_gqa=True)
        return (o,) + torch.autograd.grad(o, lib_in, dlib)

    ms, got = cuda_ms(ours, reps=5, warmup=1)
    lib_ms, want = cuda_ms(lib, reps=5, warmup=1)
    errs = []
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.detach().transpose(1, 2).float()
        errs.append(float((a - b).abs().max())
                    / float(b.pow(2).mean().sqrt()))
    # float32 on the same inputs: flash against autograd through the
    # plain chunked attention (gated), and each bf16 result's distance
    # from it
    f32_in = [t.float().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*f32_in, True, window, 0, 1024, None)
    fl32 = [t.detach() for t in
            (o,) + torch.autograd.grad(o, f32_in, dout.float())]
    o = attention(*f32_in, causal=True, window=window, kv_chunk=1024)
    ref32 = [t.detach() for t in
             (o,) + torch.autograd.grad(o, f32_in, dout.float())]
    f32_err = [float((a - b).abs().max()) for a, b in zip(fl32, ref32)]
    f32_ex = [float(((a - b).abs() - FLASH_CARD_ATOL
                     - FLASH_CARD_RTOL * b.abs()).max())
              for a, b in zip(fl32, ref32)]
    rms = [float(b.pow(2).mean().sqrt()) for b in ref32]
    ours_bf16 = [float((a.detach().float() - b).abs().max()) / r
                 for a, b, r in zip(got, ref32, rms)]
    lib_bf16 = [float((a.detach().transpose(1, 2).float() - b).abs().max())
                / r for a, b, r in zip(want, ref32, rms)]
    pairs = int(mask.sum()) * B
    flops = 12 * pairs * H * hd        # QK^T, PV; dV, dP, dQ, dK
    nbytes = 2 * (q.numel() * 4 + 2 * k.numel() * 2)   # q, out, dout, dq;
    #                                                    k, v, dk, dv
    bound = max(flops / BF16_PEAK, nbytes / HBM_RATE) * 1e3
    log(f"  flash_attention forward + backward at one {cfg.name} attention "
        f"layer (B {B}, S {S}, {H} heads / {Hkv} KV heads, head dim {hd}, "
        f"causal window {window}, KV chunks of 1024): {ms:.3f} ms; "
        f"scaled_dot_product_attention (same mask, bf16) {lib_ms:.3f} ms; "
        f"bound {bound:.4f} ms ({flops / 1e9:.1f} GFLOP over "
        f"{BF16_PEAK / 1e12:.0f} TFLOP/s); out / dq / dk / dv differ by "
        + " / ".join(f"{e:.2e}" for e in errs) + " of the library's RMS")
    log(f"  the same in float32: flash against autograd through "
        f"layers.attention, worst |error| out / dq / dk / dv "
        + " / ".join(f"{e:.2e}" for e in f32_err)
        + f" (limit atol {FLASH_CARD_ATOL} + rtol {FLASH_CARD_RTOL}); "
        f"worst |error| over the float32 RMS of flash in bf16 "
        + " / ".join(f"{e:.2e}" for e in ours_bf16)
        + ", of scaled_dot_product_attention in bf16 "
        + " / ".join(f"{e:.2e}" for e in lib_bf16))
    require(max(f32_ex) <= 0, f"flash float32 != autograd through "
            f"attention at {cfg.name}'s shape: {f32_err}")
    del ours_in, lib_in, got, want, f32_in, fl32, ref32
    return {"ms": ms, "sdpa_ms": lib_ms, "bound_ms": bound, "err": errs,
            "f32_err": f32_err, "bf16_err": ours_bf16,
            "sdpa_bf16_err": lib_bf16}


def _train_full_width():
    """gemma3-4b at full width and depth: ``TRAIN_STEPS`` steps of
    ``make_train_step`` (AdamW, float32 moments and master) from
    ``TokenPipeline(seed=0)``, each beside its bound; the same steps
    from the same weights at ``TRAIN_LR_LOW`` (a record); flash against
    SDPA at one attention layer's shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    cfg = get_config(TRAIN_FULL_ARCH)
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    flops = _train_flops(api, params, _train_batch(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 0, 0, DEVICE))
    host = [t.to("cpu", copy=True) for t in tree_leaves(params)]
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS))
    nbytes = _opt_bytes(params, opt)
    bound = (flops / BF16_PEAK + nbytes / HBM_RATE) * 1e3
    params, rows = _train_steps(api, params, opt, cfg, TRAIN_STEPS, 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  {TRAIN_FULL_ARCH}, {cfg.n_layers} layers, {n_params / 1e9:.3f} "
        f"B parameters (bf16), AdamW with float32 moments and master, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, microbatch 1 "
        f"({time.perf_counter() - t0:.1f} s with the weights' draw); "
        f"bound of a step {bound:.2f} ms = {flops / 1e12:.2f} TFLOP of "
        f"products over {BF16_PEAK / 1e12:.0f} TFLOP/s "
        f"({flops / BF16_PEAK * 1e3:.2f} ms) + {nbytes / 1e9:.1f} GB of "
        f"optimizer traffic over {HBM_RATE / 1e12:.2f} TB/s "
        f"({nbytes / HBM_RATE * 1e3:.2f} ms)")
    _log_steps(TRAIN_FULL_ARCH, rows, tokens, bound)
    _train_gates(TRAIN_FULL_ARCH, cfg, rows, params, host)
    later = rows[1:]
    ms = statistics.median(r["wall_ms"] for r in later)
    log(f"  {TRAIN_FULL_ARCH}: median step after the first {ms:.1f} ms "
        f"host ({statistics.median(r['cuda_ms'] for r in later):.1f} ms "
        f"CUDA events), {tokens / ms * 1e3:.0f} tokens/s, {ms / bound:.1f}x "
        f"the bound; peak memory {max(r['peak_gb'] for r in rows):.2f} GB; "
        f"losses finite, the first within {TRAIN_LOSS_SLACK} of ln V, "
        f"every leaf changed")
    with torch.no_grad():
        for t, h in zip(tree_leaves(params), host):
            t.copy_(h)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR_LOW, 1, TRAIN_STEPS))
    params, low = _train_steps(api, params, opt, cfg, TRAIN_STEPS, 1)
    log(f"  {TRAIN_FULL_ARCH} from the same weights at lr {TRAIN_LR_LOW:g} "
        f"(a record): losses " + ", ".join(f"{r['loss']:.4f}" for r in low)
        + "; at lr " + f"{TRAIN_LR:g}: "
        + ", ".join(f"{r['loss']:.4f}" for r in rows))
    del params, host
    _lm_free()
    flash = _flash_vs_sdpa(cfg)
    _lm_free()
    return {"rows": rows, "bound_ms": bound, "flops": flops,
            "opt_bytes": nbytes, "step_ms": ms, "flash": flash,
            "low_lr_losses": [r["loss"] for r in low]}


def _train_whisper():
    """whisper-medium whole: ``WHISPER_STEPS`` steps at microbatch 1, then
    from the same weights at microbatch 2; the same gates, and the first
    losses of the two equal within ``MICRO_LOSS_ATOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    cfg = get_config(WHISPER_ARCH)
    api = build(cfg)
    out = {}
    for m in (1, 2):
        params = api.init_params(
            torch.Generator(device=DEVICE).manual_seed(0))
        host = [t.to("cpu", copy=True) for t in tree_leaves(params)]
        opt = AdamW(lr=cosine_schedule(TRAIN_LR, 1, WHISPER_STEPS))
        params, rows = _train_steps(api, params, opt, cfg, WHISPER_STEPS, m)
        log(f"  {WHISPER_ARCH} ({sum(h.numel() for h in host) / 1e9:.3f} B "
            f"parameters), batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens + "
            f"{cfg.n_frames} frames, microbatch {m}:")
        _log_steps(f"{WHISPER_ARCH} mb{m}", rows, TRAIN_BATCH * TRAIN_SEQ)
        _train_gates(f"{WHISPER_ARCH} microbatch {m}", cfg, rows, params,
                     host)
        out[m] = rows
        del params, host
        _lm_free()
    d = abs(out[2][0]["loss"] - out[1][0]["loss"])
    log(f"  {WHISPER_ARCH}: first loss at microbatch 2 minus microbatch 1: "
        f"{d:.2e} (limit {MICRO_LOSS_ATOL})")
    require(d <= MICRO_LOSS_ATOL, f"{WHISPER_ARCH}: microbatch 2's first "
            f"loss differs from microbatch 1's by {d}")
    return out


def lm_train_card_vs_cpu(arch, device=None):
    """``reduced(cfg)`` of ``arch`` on the same weights (bf16, and their
    float32 twin): ``train_loss`` and its gradients on ``device``
    (``DEVICE`` by default) against the same call on the CPU. Returns one
    row per output, (kind, what, worst error, scale, limit): the loss
    (error |card - cpu|, limit ``TRAIN_LOSS_ATOL``), and every gradient
    leaf (error max(|card - cpu| - rtol |cpu|), scale the CPU leaf's RMS,
    limit ``TRAIN_GRAD_FRAC`` of it); bf16 gradients of an MoE
    configuration are left out. Also the check of
    ``tests/test_torch_lm_train_cuda.py``."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.train.train_step import value_and_grad
    device = DEVICE if device is None else device
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(4))
    batch = _train_batch(cfg, 2, 16, 4, 0, "cpu")
    rows = []
    for kind, p in (("bf16", params),
                    ("f32", tree_map(lambda t: t.float(), params))):
        res = []
        for dev in ("cpu", device):
            loss, grads = value_and_grad(
                api, tree_map(lambda t: t.to(dev), p),
                {k: v.to(dev) for k, v in batch.items()})
            res.append((float(loss), [t.float().cpu()
                                      for t in tree_leaves(grads)]))
        (wl, wg), (gl, gg) = res
        require(all(bool(torch.isfinite(t).all()) for t in gg),
                f"{arch} reduced {kind}: card gradients not finite")
        rows.append((kind, "loss", abs(gl - wl), abs(wl),
                     TRAIN_LOSS_ATOL[kind]))
        if kind == "bf16" and _is_moe(cfg):
            continue
        for g, w in zip(gg, wg):
            rms = float(w.pow(2).mean().sqrt())
            err = float(((g - w).abs() - TRAIN_GRAD_RTOL[kind] * w.abs()
                         ).max())
            rows.append((kind, "grad", max(err, 0.0), rms,
                         TRAIN_GRAD_FRAC[kind] * rms))
    return rows


def flash_card_vs_cpu(device=None):
    """Flash attention's forward and backward in float32 at a windowed
    GQA shape of four KV chunks on ``device`` against the CPU. Returns
    (worst |error| of out / dq / dk / dv, each over ``FLASH_CARD_ATOL`` +
    ``FLASH_CARD_RTOL`` |cpu| at most 0 when it agrees)."""
    import torch
    from repro_torch.models.flash import flash_attention
    device = DEVICE if device is None else device
    B, S, H, Hkv, hd, window, ck = FLASH_CARD_CASE
    g = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn(*s, generator=g) for s in (
        (B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, H, hd)))
    outs = []
    for dev in ("cpu", device):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        o = flash_attention(*leaves, True, window, 0, ck, None)
        outs.append([t.detach().cpu() for t in (o,) + torch.autograd.grad(
            o, leaves, dout.to(dev))])
    err, excess = [], []
    for w, c in zip(*outs):
        d = (c - w).abs()
        err.append(float(d.max()))
        excess.append(float((d - FLASH_CARD_ATOL
                             - FLASH_CARD_RTOL * w.abs()).max()))
    return err, excess


def _train_resume():
    """``launch.train.train`` on the card at the reference's test shape:
    ``RESUME_STEPS[0]`` steps with checkpoints, then a resume to
    ``RESUME_STEPS[1]``; the last loss below the first, the resume runs
    exactly the missing steps."""
    import shutil
    import tempfile
    from repro_torch.launch.train import train
    from repro_torch.train.checkpoint import list_checkpoints
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        losses = train(RESUME_ARCH, steps=RESUME_STEPS[0], ckpt_dir=d,
                       device=DEVICE, **RESUME_RUN)
        t1 = time.perf_counter()
        resumed = train(RESUME_ARCH, steps=RESUME_STEPS[1], ckpt_dir=d,
                        device=DEVICE, **RESUME_RUN)
        t2 = time.perf_counter()
        kept = list_checkpoints(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"  launch.train.train({RESUME_ARCH!r}, steps={RESUME_STEPS[0]}, "
        f"reduced, batch 4 x 32, ckpt_every 6) on the card: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} in {t1 - t0:.2f} s; resumed "
        f"to {RESUME_STEPS[1]}: {len(resumed)} steps, losses "
        + ", ".join(f"{x:.4f}" for x in resumed)
        + f" in {t2 - t1:.2f} s; checkpoints kept {kept}")
    require(len(losses) == RESUME_STEPS[0] and losses[-1] < losses[0],
            f"{RESUME_ARCH}: the loss did not fall: {losses}")
    require(len(resumed) == RESUME_STEPS[1] - RESUME_STEPS[0],
            f"{RESUME_ARCH}: the resume ran {len(resumed)} steps")
    return {"losses": losses, "resumed": resumed}


def phase_train():
    """LM / Whisper training on the card (plain PyTorch: the LM stack has
    no TPU kernel): gemma3-4b at full width and depth, whisper-medium
    whole at microbatch 1 and 2, the other eight reduced configurations
    card against CPU, flash's backward card against CPU, and the
    checkpoint and resume run."""
    import torch
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    _lm_free()
    free, total = torch.cuda.mem_get_info()
    log(f"  card: {card_line()}; {free / 1e9:.1f} of {total / 1e9:.1f} GB "
        f"free")
    reset_launch_counts()
    full = _train_full_width()
    whisper = _train_whisper()
    others = [a for a in ARCH_IDS if a not in (TRAIN_FULL_ARCH,
                                                WHISPER_ARCH)]
    card = {a: lm_train_card_vs_cpu(a) for a in others}
    for a, rs in card.items():
        worst = {}
        for kind, what, err, scale, limit in rs:
            key = f"{kind} {what}"
            r = err if what == "loss" else (err / scale if scale else 0.0)
            worst[key] = max(worst.get(key, 0.0), r)
        log(f"  {a} reduced, card against CPU: " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items())
            + " (loss: |error|; gradients: worst excess over rtol / RMS)")
    ferr, fex = flash_card_vs_cpu()
    log(f"  flash_attention float32 card against CPU (B, S, Hq, Hkv, hd, "
        f"window, chunk = {FLASH_CARD_CASE}): worst |error| out / dq / dk "
        f"/ dv " + " / ".join(f"{e:.2e}" for e in ferr)
        + f" (limit atol {FLASH_CARD_ATOL} + rtol {FLASH_CARD_RTOL})")
    resume = _train_resume()
    lc = launch_counts()
    log(f"  launches of the port's CUDA kernels on the training path: "
        f"{sum(lc.values())} (the LM stack has no TPU kernel)")
    wall = time.perf_counter() - t0
    log(f"  phase 3i wall time {wall:.1f} s")
    for a, rs in card.items():
        for i, (kind, what, err, scale, limit) in enumerate(rs):
            require(err <= limit, f"{a} reduced {kind}: card != CPU in "
                    f"output {i} ({what}): {err} over {limit}")
    require(max(fex) <= 0, f"flash card != CPU: {ferr}")
    return {"full": full, "whisper": whisper, "card_vs_cpu": card,
            "resume": resume, "wall": wall}


# ---------------------------------------------------------------------------
# Phase 3j: multi-rank LM training over the data axis
# ---------------------------------------------------------------------------

DP_ARCH = "deepseek-v2-lite-16b"
DP_RANKS = 2
DP_BATCH, DP_SEQ, DP_STEPS = 8, 64, 4
# the two ranks' bf16 parameters and gradients and float32 m, v and master
# (16 bytes a parameter a rank) must fit in this much of the card
DP_BYTES = 60e9
# each rank's share of the card (its caching allocator's cap)
DP_MEM_FRACTION = 0.47
DP_LAUNCH_TIMEOUT_S = 600
# card against CPU: reduced configurations, float32 twins, each mode's
# synced gradients of one step: (grad_sync, microbatch, grad_compression)
DP_CARD_ARCHS = ("yi-6b", "gemma3-4b", "deepseek-v2-lite-16b",
                 "jamba-v0.1-52b")
DP_MODES = (("per_microbatch", 1, None), ("deferred", 2, None),
            ("deferred", 2, "int8"))
DP_CARD_BATCH, DP_CARD_SEQ = 4, 16
# the loss within DP_LOSS_ATOL; every gradient leaf within DP_GRAD_FRAC of
# the CPU leaf's RMS (float32 sums in another order), and under int8 also
# two quanta (a rank's rounding of an entry near a half step may go the
# other way): 2 max|cpu| / 127
DP_LOSS_ATOL, DP_GRAD_FRAC = 1e-5, 1e-4
DP_COLLECTIVES = ("all_reduce", "all_to_all_single", "all_gather",
                  "barrier")


def _dp_cut(cfg):
    """The most layers of ``cfg`` whose ``DP_RANKS`` ranks' parameters,
    gradients and AdamW state fit in ``DP_BYTES``: each rank holds the
    non-routed parameters and 1 / ``DP_RANKS`` of the routed experts, 16
    bytes a parameter (``param_count``)."""
    import dataclasses

    def rank_bytes(n):
        c = dataclasses.replace(cfg, n_layers=n)
        routed = n * c.n_experts * 3 * c.d_model * c.moe_d_ff
        return 16 * (c.param_count() - routed + routed // DP_RANKS)

    n = 1
    while n < cfg.n_layers and DP_RANKS * rank_bytes(n + 1) <= DP_BYTES:
        n += 1
    return dataclasses.replace(cfg, n_layers=n), DP_RANKS * rank_bytes(n)


class _CollectiveLog:
    """Host time, calls and bytes of each collective this process calls
    (torch.distributed's functions wrapped while it is entered); a
    collective's bytes are those of the tensor it is handed."""

    def __init__(self):
        self.rows = {k: [0, 0.0, 0] for k in DP_COLLECTIVES}

    def __enter__(self):
        import torch.distributed as dist
        self._orig = {k: getattr(dist, k) for k in DP_COLLECTIVES}

        def wrap(kind, fn):
            def timed(*a, **kw):
                t = next((x for x in a if hasattr(x, "element_size")), None)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                row = self.rows[kind]
                row[0] += 1
                row[1] += time.perf_counter() - t0
                row[2] += 0 if t is None else t.numel() * t.element_size()
                return out
            return timed

        for k, fn in self._orig.items():
            setattr(dist, k, wrap(k, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self._orig.items():
            setattr(dist, k, fn)

    def take(self):
        """{kind: (calls, host s, bytes)} since the last take."""
        out = {k: tuple(v) for k, v in self.rows.items() if v[0]}
        self.rows = {k: [0, 0.0, 0] for k in DP_COLLECTIVES}
        return out


def _bits_sums(t):
    """Two int64 checksums of a leaf's bits (their sum, and their sum
    weighted by position mod 65521 + 1), in blocks: equal leaves give
    equal sums, and any one entry that differs changes the first."""
    import torch
    flat = t.detach().reshape(-1)
    bits = flat.view(torch.int16 if flat.element_size() == 2
                     else torch.int32)
    s1 = s2 = 0
    for i in range(0, bits.numel(), 1 << 24):
        b = bits[i:i + (1 << 24)].to(torch.int64)
        w = (torch.arange(i, i + b.numel(), device=b.device) % 65521) + 1
        s1 += int(b.sum())
        s2 += int((b * w).sum())
    return [s1, s2]


def _full_kind(kind):
    """The full-width multi-rank training run of phase 3j ("dp") or 3k
    ("tp"): (architecture, depth cut, the layout's shape for n ranks,
    batch, sequence, steps)."""
    if kind == "dp":
        return (DP_ARCH, _dp_cut, lambda n: (n, 1), DP_BATCH, DP_SEQ,
                DP_STEPS)
    return TP_ARCH, _tp_cut, lambda n: (1, n), TP_BATCH, TP_SEQ, TP_STEPS


def _full_rank(out, kind):
    """One gloo rank on the card of ``_full_kind(kind)``'s run: the
    architecture at published width, cut in depth, on a (data, model)
    layout, its steps; then the parameters saved under the layout. Writes
    ``OUT/<kind>_r<rank>.json``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    from repro_torch.models import build
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.train_step import leaf_specs, make_train_step
    arch, cut, shape, batch, seq, steps = _full_kind(kind)
    device = mesh.init_group("gloo")
    torch.cuda.set_per_process_memory_fraction(DP_MEM_FRACTION, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = mesh.world()
    layout = mesh.make_host_mesh(*shape(size))
    cfg, budget = cut(get_config(arch))
    api = build(cfg)
    pspecs = api.param_pspecs()
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             layout=layout)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = leaf_specs(params, pspecs)
    host = [t.to("cpu", copy=True) for t in tree_leaves(params)]
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, 1, steps))
    step_fn = make_train_step(api, opt, layout=layout)
    state = opt.init(params)
    rows = []
    with _CollectiveLog() as coll:
        for s in range(steps):
            b = _train_batch(cfg, batch, seq, 0, s, device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            coll.take()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            e0.record()
            params, state, met = step_fn(params, state, b)
            e1.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            kinds = coll.take()
            sums = [_bits_sums(t) for t, sp in zip(tree_leaves(params), specs)
                    if not mesh.sharded_dims(sp, layout)]
            rows.append({"wall_ms": wall, "cuda_ms": e0.elapsed_time(e1),
                         "loss": float(met["loss"]),
                         "grad_norm": float(met["grad_norm"]),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "collectives": kinds,
                         "replicated_sums": sums})
    moved = [not torch.equal(t.cpu(), h)
             for t, h in zip(tree_leaves(params), host)]
    del host, state
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    save_checkpoint(str(Path(out) / f"{kind}_ckpt"), steps,
                    {"params": params}, specs={"params": pspecs},
                    layout=layout)
    save_s = time.perf_counter() - t1
    blocks = [_bits_sums(t) for t in tree_leaves(params)]
    Path(out, f"{kind}_r{rank}.json").write_text(json.dumps({
        "n_layers": cfg.n_layers, "budget": budget, "init_s": init_s,
        "params": sum(t.numel() for t in tree_leaves(params)),
        "rows": rows, "moved": moved, "save_s": save_s, "blocks": blocks,
        "split_dims": [[d for d, _ in mesh.sharded_dims(sp, layout)]
                       for sp in specs]}))
    mesh.destroy_group()


def _card_rank(out, device, shape, modes, *cases):
    """A gloo rank on ``device`` of a (data, model) layout of ``shape``
    ("D,M"): for each case (``_tp_case``), the reduced float32 twin of
    seeded weights (drawn on the CPU), the loss and synced gradients of
    one step (gathered whole) in each sync mode (``modes``: "all" for
    ``DP_MODES``, "plain" for per microbatch alone). Rank 0 writes
    ``OUT/<device>_<D>_<M>.npz``."""
    import numpy as np
    import torch
    from repro_torch.launch import mesh
    from repro_torch.launch.mesh import gather_leaf
    from repro_torch.models import build
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import leaf_specs, make_train_step
    dev = mesh.init_group("gloo", device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    d, m = (int(x) for x in shape.split(","))
    layout = mesh.make_host_mesh(d, m)
    res = {}
    for case in cases:
        cfg = _tp_case(case)
        api = build(cfg)
        params = tree_map(lambda t: t.float().to(dev), api.init_params(
            torch.Generator().manual_seed(4), layout=layout))
        specs = leaf_specs(params, api.param_pspecs())
        batch = _train_batch(cfg, DP_CARD_BATCH, DP_CARD_SEQ, 4, 0, dev)
        for sync, mb, comp in (DP_MODES if modes == "all"
                               else (DP_MODES[0],)):
            loss, g = make_train_step(
                api, AdamW(), layout=layout, microbatch=mb, grad_sync=sync,
                grad_compression=comp).grads(params, batch)
            key = f"{case}|{sync}|{mb}|{comp}"
            res[key + "|loss"] = np.asarray(float(loss))
            for i, (t, sp) in enumerate(zip(tree_leaves(g), specs)):
                res[f"{key}|{i}"] = gather_leaf(t, sp, layout).float().cpu(
                ).numpy()
    if mesh.world()[0] == 0:
        np.savez(Path(out) / f"{torch.device(device).type}_{d}_{m}.npz",
                 **res)
    mesh.destroy_group()


def _dp_rank_main(argv) -> int:
    """The rank program of phases 3j and 3k (``chip_smoke.py --dp-rank JOB
    OUT [ARGS]`` under ``python -m torch.distributed.run``)."""
    job, out, *rest = argv
    if job in ("dp", "tp"):
        _full_rank(out, job)
    elif job == "card":
        _card_rank(out, *rest)
    else:
        _tp_rank_decode(out)
    return 0


def _dp_launch(nproc, args, backend_args=(), module=False):
    """``python -m torch.distributed.run --standalone`` with ``nproc``
    ranks of this script's rank program (or of ``args`` as a module when
    ``module``), in a session of its own killed whole at the time limit;
    returns (the process, its start time)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}"]
    cmd += (["-m", "--", *args] if module
            else [str(ROOT / "chip_smoke.py"), "--dp-rank", *args])
    return subprocess.Popen(cmd + list(backend_args), cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True), \
        time.perf_counter()


def _dp_wait(proc, t0, what):
    """Wait for a launch; fails the phase on a nonzero exit or past
    ``DP_LAUNCH_TIMEOUT_S``. Returns (output, wall s)."""
    import os
    import signal
    try:
        out = proc.communicate(timeout=DP_LAUNCH_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{what} passed {DP_LAUNCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"{what} failed (exit "
            f"{proc.returncode}):\n{out[-4000:]}")
    return out, wall


def _full_run(tmp, kind):
    """``_full_kind(kind)``'s run on ``DP_RANKS`` gloo ranks sharing the
    card (3j: data axis 2, the MoE expert-parallel; 3k: model axis 2),
    then its save restored whole at one rank here. Gates: every loss and
    grad norm finite and equal on the ranks, every leaf moved, the
    leaves no rank splits equal bit for bit across the ranks after each
    step, each rank's block of the restored leaves equal to its bits."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import map_schema, model_schema
    from repro_torch.pytree import tree_leaves
    from repro_torch.train.checkpoint import restore_checkpoint
    arch, _, shape, batch, seq, steps = _full_kind(kind)
    proc, t0 = _dp_launch(DP_RANKS, [kind, str(tmp)])
    _, wall = _dp_wait(proc, t0, f"{arch} on {DP_RANKS} gloo ranks")
    ranks = [json.loads((tmp / f"{kind}_r{r}.json").read_text())
             for r in range(DP_RANKS)]
    r0 = ranks[0]
    full = get_config(arch)
    if kind == "dp":
        what = (f"MLA kv_lora {full.kv_lora_rank}, {full.n_experts} routed "
                f"experts top-{full.top_k}, {full.n_shared_experts} shared, "
                f"moe_ff {full.moe_d_ff}")
    else:
        what = (f"{full.n_heads} query heads, {full.n_kv_heads} KV heads, "
                f"ff {full.d_ff}, attn_shard {full.attn_shard!r}")
    log(f"  {arch} at published width (d {full.d_model}, {what}, vocab "
        f"{full.vocab}), {r0['n_layers']} of {full.n_layers} layers (the "
        f"most whose {DP_RANKS} ranks' state fits in {DP_BYTES / 1e9:.0f} "
        f"GB: {r0['budget'] / 1e9:.1f} GB), {DP_RANKS} gloo ranks on one "
        f"card, (data, model) = {shape(DP_RANKS)}, batch {batch} x {seq}, "
        f"{steps} steps; {r0['params'] / 1e9:.3f} B parameters a rank; "
        f"launch {wall:.1f} s (draw {r0['init_s']:.1f} s, save "
        f"{r0['save_s']:.1f} s)")
    for s in range(steps):
        rs = [rk["rows"][s] for rk in ranks]
        coll = "; ".join(
            f"{k} {c} calls {t * 1e3:.1f} ms {b / 1e6:.1f} MB"
            for k, (c, t, b) in rs[0]["collectives"].items())
        log(f"  step {s}: loss {rs[0]['loss']:.4f}, grad norm "
            f"{rs[0]['grad_norm']:.4f}; " + ", ".join(
                f"rank {r} {x['wall_ms']:.1f} ms host / {x['cuda_ms']:.1f} ms "
                f"events, peak {x['peak_gb']:.2f} GB"
                for r, x in enumerate(rs)) + f"; rank 0's collectives: "
            + coll)
        require(all(math.isfinite(x["loss"]) and math.isfinite(
            x["grad_norm"]) for x in rs), f"{arch}: step {s} not finite")
        require(all(x["loss"] == rs[0]["loss"] for x in rs),
                f"{arch}: step {s}'s loss differs across ranks")
        require(all(x["replicated_sums"] == rs[0]["replicated_sums"]
                    for x in rs), f"{arch}: a replicated leaf differs "
                f"across ranks after step {s}")
    for r, rk in enumerate(ranks):
        still = [i for i, m in enumerate(rk["moved"]) if not m]
        require(not still, f"{arch}: rank {r}'s leaves {still} did not "
                f"move")
    # the two-rank save, restored whole at one rank: each leaf's blocks
    # (along the dimensions the layout splits) carry each rank's bits
    cfg = dataclasses.replace(full, n_layers=r0["n_layers"])
    like = map_schema(model_schema(cfg),
                      lambda shp, sc, ps: torch.empty(0, device=DEVICE))
    t1 = time.perf_counter()
    back = restore_checkpoint(str(tmp / f"{kind}_ckpt"), steps,
                              {"params": like})
    restore_s = time.perf_counter() - t1
    for i, t in enumerate(tree_leaves(back["params"])):
        for r, rk in enumerate(ranks):
            p = t
            for dim in r0["split_dims"][i]:
                p = torch.chunk(p, DP_RANKS, dim=dim)[r]
            require(_bits_sums(p.contiguous()) == rk["blocks"][i],
                    f"{arch}: the one-rank restore of leaf {i} differs "
                    f"from rank {r}'s block")
    del back
    _lm_free()
    log(f"  the two-rank save restored at one rank in {restore_s:.1f} s: "
        f"every block equal to its rank's bits; every loss and grad norm "
        f"finite and equal on the ranks, every leaf moved on its rank, the "
        f"leaves no rank splits equal bit for bit across the ranks after "
        f"each step")
    later = [max(rk["rows"][s]["wall_ms"] for rk in ranks)
             for s in range(1, steps)]
    coll_s = [sum(t for _, t, _ in ranks[0]["rows"][s]["collectives"]
                  .values()) for s in range(1, steps)]
    return {"ranks": ranks, "step_ms": statistics.median(later),
            "collective_ms": statistics.median(coll_s) * 1e3, "wall": wall}


def _card_vs_cpu(tmp, runs, what):
    """``_card_rank``'s runs, each (shape, modes, cases), on gloo ranks on
    the card against the same on the CPU, every launch started together:
    the loss within ``DP_LOSS_ATOL``, every gradient leaf within
    ``DP_GRAD_FRAC`` of the CPU leaf's RMS (float32 sums in another
    order), and under int8 also two quanta (a rank's rounding of an
    entry near a half step may go the other way): 2 max|cpu| / 127."""
    import math
    import numpy as np
    procs = []
    for shape, modes, cases in runs:
        n = math.prod(int(x) for x in shape.split(","))
        for dev in ("cuda", "cpu"):
            procs.append((_dp_launch(n, ["card", str(tmp), dev, shape, modes,
                                         *cases]), f"{shape} on {dev}"))
    for (p, t0), label in procs:
        _dp_wait(p, t0, f"reduced configurations at ({label})")
    worst = {}
    for shape, _, _ in runs:
        tag = shape.replace(",", "_")
        card, cpu = (np.load(tmp / f"{d}_{tag}.npz") for d in ("cuda", "cpu"))
        for key in cpu.files:
            case, sync, m, comp, leaf = key.split("|")
            w, g = cpu[key], card[key]
            mode = (f"{case} at ({shape.replace(',', ', ')}) {sync} m={m}"
                    + (f" {comp}" if comp != "None" else ""))
            if leaf == "loss":
                err, limit = abs(float(g) - float(w)), DP_LOSS_ATOL
            else:
                rms = float(np.sqrt(np.mean(w * w)))
                err = float(np.max(np.abs(g - w)))
                limit = DP_GRAD_FRAC * rms + (
                    2 * float(np.abs(w).max()) / 127 if comp == "int8"
                    else 0.0)
            require(err <= limit, f"{mode}: card != CPU in {leaf}: {err} "
                    f"over {limit}")
            if leaf != "loss":
                worst[mode] = max(worst.get(mode, 0.0),
                                  err / max(rms, 1e-30))
    log(f"  {what}, gloo ranks on the card against the same on the CPU, "
        f"float32 twins, loss and every synced gradient (worst |error| / "
        f"RMS): " + "; ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def _dp_nccl(tmp):
    """``launch.train`` on one nccl rank on the card at the reference's
    test shape, then its resume."""
    args = ["repro_torch.launch.train", "--arch", RESUME_ARCH, "--batch",
            "4", "--seq", "32", "--ckpt-every", "6", "--lr", "5e-3",
            "--backend", "nccl", "--ckpt-dir",
            str(tmp / "nccl")]
    res = []
    for steps in RESUME_STEPS:
        proc, t0 = _dp_launch(1, args + ["--steps", str(steps)],
                              module=True)
        out, wall = _dp_wait(proc, t0, f"launch.train on 1 nccl rank, "
                             f"{steps} steps")
        line = json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][-1])
        res.append((line, wall))
    (first, w1), (second, w2) = res
    log(f"  launch.train({RESUME_ARCH!r}) on 1 nccl rank: loss "
        f"{first['first_loss']:.4f} -> {first['last_loss']:.4f} over "
        f"{first['steps_run']} steps ({w1:.1f} s with the launcher); "
        f"resumed to {RESUME_STEPS[1]}: {second['steps_run']} steps "
        f"({w2:.1f} s)")
    require(first["steps_run"] == RESUME_STEPS[0]
            and first["last_loss"] < first["first_loss"],
            f"nccl launch.train: the loss did not fall: {first}")
    require(second["steps_run"] == RESUME_STEPS[1] - RESUME_STEPS[0],
            f"nccl launch.train: the resume ran {second['steps_run']}")
    return res


def _dp_examples():
    """The example twins on the card: the alignment on the card equals the
    CPU's on the same weights; serving yields its batch's tokens."""
    import dataclasses
    import importlib.util
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    from repro_torch.pytree import tree_map

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    align = load("align_whisper_torch")
    cfg = dataclasses.replace(reduced(get_config("whisper-medium")),
                              n_frames=align.N_FRAMES)
    params = build(cfg).init_params(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    card = align.main(["--device", "cuda"],
                      params=tree_map(lambda t: t.to(DEVICE), params))
    t1 = time.perf_counter()
    cpu = align.main(["--device", "cpu"], params=params)
    require(bool((card["support"] == cpu["support"]).all())
            and card["anchors"] == cpu["anchors"]
            and card["miss"] == cpu["miss"],
            f"align_whisper_torch: card {card['anchors']} != CPU "
            f"{cpu['anchors']}")
    t2 = time.perf_counter()
    served = load("serve_lm_torch").main(["--arch", "yi-6b"])
    t3 = time.perf_counter()
    require(served["generated"] == (4, 24),
            f"serve_lm_torch generated {served['generated']}")
    log(f"  examples/align_whisper_torch.py on the card ({t1 - t0:.1f} s): "
        f"support {100 * card['fraction']:.1f}% of the grid and anchors "
        f"{card['anchors']}, equal to the CPU's; "
        f"examples/serve_lm_torch.py on the card ({t3 - t2:.1f} s): "
        f"{served}")
    return {"align": card["anchors"], "serve": served}


def phase_dp():
    """Multi-rank LM training over the data axis (plain PyTorch and
    torch.distributed: the LM stack has no TPU kernel): ``DP_ARCH`` at
    published width on two gloo ranks sharing the card, the reduced
    configurations' modes card against CPU, one nccl rank's
    ``launch.train`` and resume, and the example twins."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    _lm_free()
    free, total = torch.cuda.mem_get_info()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    disk = shutil.disk_usage(tmp)
    log(f"  card: {card_line()}; {free / 1e9:.1f} of {total / 1e9:.1f} GB "
        f"free; {disk.free / 1e9:.1f} GB free on the disk of {tmp}")
    reset_launch_counts()
    try:
        card = _card_vs_cpu(tmp, [(f"{DP_RANKS},1", "all", DP_CARD_ARCHS)],
                            "reduced configurations over the data axis")
        full = _full_run(tmp, "dp")
        nccl = _dp_nccl(tmp)
        examples = _dp_examples()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lc = launch_counts()
    wall = time.perf_counter() - t0
    log(f"  {DP_ARCH}: median step after the first {full['step_ms']:.1f} ms "
        f"(the slower rank, host clock), of it rank 0's collectives "
        f"{full['collective_ms']:.1f} ms host; launches of the port's CUDA "
        f"kernels in this process {sum(lc.values())} (the LM stack has no "
        f"TPU kernel); phase 3j wall time {wall:.1f} s")
    return {"full": full, "card_vs_cpu": card, "nccl": nccl,
            "examples": examples, "wall": wall}


# ---------------------------------------------------------------------------
# Phase 3k: tensor parallelism over the model axis
# ---------------------------------------------------------------------------

TP_ARCH = "yi-6b"
TP_RANKS = DP_RANKS
TP_BATCH, TP_SEQ, TP_STEPS = 8, 64, 4
# each rank's bf16 blocks and gradients and float32 m, v and master (16
# bytes a parameter; the leaves the specs do not split over "model" whole
# on each rank) must fit, for both ranks, in DP_BYTES of the card
# jamba-v0.1-52b at published width, one group of its pattern (8 of 32
# layers): batch, prompt fed step by step, decode steps from init_cache
TP_DECODE_ARCH = "jamba-v0.1-52b"
TP_DECODE = (4, 8, 32)
# the decode's dtypes: the bf16 model, then its float32 draw
TP_DECODE_DTYPES = (("bf16", "bfloat16"), ("float32", "float32"))
# the model ranks' decode logits against one rank's: the float32 draw
# within this share of the one-rank logits' RMS (torch_lm_helpers.
# FRAC["logits"], the CPU tests' decode bound), the tokens equal up to
# the first near-tie
TP_DECODE_FRAC = 0.1
# the bf16 model: bf16 rounding of the row-split partials (each rank's
# product rounded, then their sum) drifts from one rank's single rounding
# through the layers, as phase 3h's decode against forward does at depth
# (the rows whose routing held read 0.076-0.125 of the RMS at published
# width on an H100; the reduced jamba on the CPU 0.046, a bf16 ulp of its
# largest logit being ~0.023 of its RMS)
TP_DECODE_BF16_FRAC = 0.4
# a row's routing may leave one rank's only at a router near-tie: the
# one-rank gap between its k-th and (k+1)-th expert probability within
# this (at published width on an H100 all four rows moved, at gaps of
# 1.6e-4 to 8.8e-4; the reduced jamba on the CPU one row at 0.0)
TP_ROUTER_TIE = 0.05
# card against CPU: the reduced configurations, float32 twins, at (1, 2)
# (and yi-6b with attn_shard="head_dim"), and the MoE ones at (2, 2)
TP_CARD_CASES = ("yi-6b", "yi-6b:head_dim", "gemma3-4b", "gemma3-12b",
                 "minicpm-2b", "pixtral-12b", "falcon-mamba-7b",
                 "jamba-v0.1-52b", "deepseek-v2-lite-16b",
                 "deepseek-v2-236b", "whisper-medium")
TP_CARD_EP = ("deepseek-v2-lite-16b", "jamba-v0.1-52b")


def _tp_cut(cfg):
    """The most layers of ``cfg`` whose ``TP_RANKS`` ranks' blocks fit in
    ``DP_BYTES`` at 16 bytes a parameter: a leaf split over "model" counts
    1 / ``TP_RANKS`` of it on each rank, any other leaf whole. Returns
    (the cut config, the two ranks' bytes)."""
    import dataclasses
    import math
    from repro_torch.launch.mesh import spec_axes
    from repro_torch.models.lm import map_schema, model_schema
    from repro_torch.pytree import tree_leaves

    def rank_bytes(n):
        c = dataclasses.replace(cfg, n_layers=n)
        sizes = tree_leaves(map_schema(model_schema(c), lambda shp, sc, ps: (
            math.prod(shp) // (TP_RANKS if "model" in spec_axes(ps)
                               else 1))))
        return 16 * sum(sizes)

    n = 1
    while n < cfg.n_layers and TP_RANKS * rank_bytes(n + 1) <= DP_BYTES:
        n += 1
    return dataclasses.replace(cfg, n_layers=n), TP_RANKS * rank_bytes(n)


def _tp_case(case):
    """A case ``ARCH`` or ``ARCH:MODE`` as its reduced config."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    arch, _, mode = case.partition(":")
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, attn_shard=mode) if mode else cfg


def _tp_decode_run(api, params, cache, layout=None):
    """``TP_DECODE``'s protocol through ``make_serve_step(api, layout)``:
    the prompt (seed 5) fed step by step, then greedy steps. Returns a
    dict: the logits of every step on the host, the tokens fed, each
    step's ms by CUDA events after the first, and each step's routing at
    every MoE layer (each token's top-k experts, sorted, (steps, layers,
    B, k)) with the router's gap between its k-th and (k+1)-th
    probability ((steps, layers, B))."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import moe
    from repro_torch.train.train_step import make_serve_step
    B, P, steps = TP_DECODE
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, api.cfg.vocab, (B, P)), device=DEVICE)
    logits, fed, events, routes = [], [], [], []

    def recording(*a, **kw):
        lg, c = api.decode_step(*a, **kw)
        logits.append(lg.to("cpu", copy=True))
        return lg, c

    router = moe._router

    def routed(x, w_router, top_k):
        out = router(x, w_router, top_k)
        top = torch.sort(torch.softmax((x @ w_router).float(), dim=-1),
                         dim=-1, descending=True).values
        routes.append((out[0].sort(dim=-1).values,
                       top[:, top_k - 1] - top[:, top_k]))
        return out

    step = make_serve_step(dataclasses.replace(api, decode_step=recording),
                           layout)
    tok = prompt[:, :1]
    moe._router = routed
    try:
        for pos in range(steps):
            fed.append(tok[:, 0].cpu())
            nxt, cache = step(params, cache, tok, pos)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            tok = prompt[:, pos + 1:pos + 2] if pos + 1 < P else nxt
        torch.cuda.synchronize()
    finally:
        moe._router = router
    n = len(routes) // steps
    return {"logits": torch.stack(logits), "fed": torch.stack(fed),
            "ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
            "ids": torch.stack([r[0] for r in routes]).cpu().reshape(
                steps, n, B, -1),
            "gap": torch.stack([r[1] for r in routes]).cpu().reshape(
                steps, n, B)}


def _tp_decode_model(layout, device, dtype):
    """``TP_DECODE_ARCH`` cut as phase 3h cuts it, seeded in ``dtype``
    (each leaf drawn whole and cut to this rank's block under
    ``layout``, so every layout holds the same weights), and its empty
    decode cache under ``layout`` (the sequence over the model ranks)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build, lm
    cfg = _lm_cut(get_config(TP_DECODE_ARCH))
    dtype = getattr(torch, dtype)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(
        0), dtype=dtype, layout=layout)
    B, _, steps = TP_DECODE
    cache = lm.init_cache(cfg, B, steps, dtype=dtype, device=device,
                          layout=layout)
    return build(cfg), params, cache


def _tp_rank_decode(out):
    """One of ``TP_RANKS`` gloo ranks on the card: ``TP_DECODE``'s steps
    of ``TP_DECODE_ARCH`` at (1, ``TP_RANKS``) in bf16, then on its
    float32 draw. Rank 0 writes ``OUT/tp_decode.pt``."""
    import torch
    from repro_torch.launch import mesh
    from repro_torch.models.lm import param_bytes
    device = mesh.init_group("gloo")
    torch.cuda.set_per_process_memory_fraction(DP_MEM_FRACTION, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, size = mesh.world()
    layout = mesh.make_host_mesh(1, size)
    res = {}
    for name, dtype in TP_DECODE_DTYPES:
        api, params, cache = _tp_decode_model(layout, device, dtype)
        with _CollectiveLog() as coll:
            res[name] = _tp_decode_run(api, params, cache, layout)
            res[name]["collectives"] = coll.take()
        res[name]["param_bytes"] = param_bytes(params)
        del params, cache
        _lm_free()
    if rank == 0:
        torch.save(res, Path(out) / "tp_decode.pt")
    mesh.destroy_group()


def _tp_compare(name, tp, one, frac):
    """One dtype's decode on the model ranks against one rank, row by row
    (the rows of a decode batch are independent: at batch 4 and top-2 no
    expert reaches its capacity of 8). A row is compared while its
    routing (its top-k experts at every MoE layer) and its fed tokens
    equal one rank's: its logits within ``frac`` of the one-rank logits'
    RMS, its argmax equal unless the one-rank top two are within twice
    that (a near-tie; the row then leaves, its next token may differ).
    A row whose routing differs leaves too, and only at a router
    near-tie: the one-rank gap between the k-th and (k+1)-th expert
    probability at the layer that moved within ``TP_ROUTER_TIE`` (bf16
    drift moves such a tie, and the expert outputs then differ whole, as
    the bf16 MoE gradients do, ROADMAP C). Returns (the worst |error| /
    RMS, the steps each row was compared, each step's worst, the rows'
    (step, router gap) where their routing left)."""
    import torch
    _, P, steps = TP_DECODE
    lg, lw = tp["logits"], one["logits"]
    B = lg.shape[1]
    left, done = {}, {}
    errs = []
    for t in range(steps):
        for b in range(B):
            if b in left or b in done:
                continue
            if not torch.equal(tp["ids"][t, :, b], one["ids"][t, :, b]):
                moved = (tp["ids"][t, :, b] != one["ids"][t, :, b]).any(-1)
                left[b] = (t, float(one["gap"][t, :, b][moved].min()))
                require(left[b][1] <= TP_ROUTER_TIE, f"{TP_DECODE_ARCH} "
                        f"{name}: row {b}'s routing moved at step {t} with "
                        f"the router's top-k gap {left[b][1]}")
        keep = [b for b in range(B) if b not in left and b not in done]
        for b in keep:
            require(int(tp["fed"][t, b]) == int(one["fed"][t, b]),
                    f"{TP_DECODE_ARCH} {name}: row {b} was fed another "
                    f"token at step {t}")
        rms = float(lw[t].pow(2).mean().sqrt())
        err = max((float((lg[t, b] - lw[t, b]).abs().max()) for b in keep),
                  default=0.0) / rms
        errs.append(err)
        require(err <= frac, f"{TP_DECODE_ARCH} {name}: step {t}'s logits "
                f"{err:.4f} of the RMS from the one-rank decode's, over "
                f"{frac}")
        for b in keep:
            if t + 1 >= P and int(lg[t, b].argmax()) != int(lw[t, b].argmax()):
                top = lw[t, b].sort().values
                require(float(top[-1] - top[-2]) <= 2 * frac * rms,
                        f"{TP_DECODE_ARCH} {name}: step {t}'s token of row "
                        f"{b} differs with no near-tie")
                done[b] = t
    compared = [min(left.get(b, (steps,))[0], done.get(b, steps - 1) + 1)
                for b in range(B)]
    return max(errs), compared, errs, left


def _tp_decode(tmp):
    """``TP_DECODE_ARCH``'s one-rank decode on the card (bf16, then its
    float32 draw; each freed before the next), then the same weights on
    ``TP_RANKS`` gloo ranks at (1, ``TP_RANKS``) through sequence-split
    caches (``_tp_compare``: bf16 within ``TP_DECODE_BF16_FRAC``, the
    float32 draw within ``TP_DECODE_FRAC``)."""
    import statistics as st
    import torch
    from repro_torch.configs import get_config
    from repro_torch.pytree import tree_leaves
    B, P, steps = TP_DECODE
    one = {}
    t0 = time.perf_counter()
    for name, dtype in TP_DECODE_DTYPES:
        api, params, cache = _tp_decode_model(None, DEVICE, dtype)
        one[name] = _tp_decode_run(api, params, cache)
        ids = one[name]["ids"]
        routed = sum(int(ids[t, i].unique().numel()) for t in
                     range(ids.shape[0]) for i in range(ids.shape[1]))
        one[name]["bound"] = _lm_bound_ms(params, cache,
                                          routed / max(ids.shape[0], 1))
        one[name]["n_params"] = sum(t.numel() for t in tree_leaves(params))
        del params, cache
        _lm_free()
    one_s = time.perf_counter() - t0
    proc, t1 = _dp_launch(TP_RANKS, ["tp_decode", str(tmp)])
    _, wall = _dp_wait(proc, t1, f"{TP_DECODE_ARCH} decode on {TP_RANKS} "
                       f"model ranks")
    tp = torch.load(tmp / "tp_decode.pt")
    out = {}
    for name, _ in TP_DECODE_DTYPES:
        frac = TP_DECODE_BF16_FRAC if name == "bf16" else TP_DECODE_FRAC
        worst, compared, errs, left = _tp_compare(name, tp[name], one[name],
                                                  frac)
        coll = "; ".join(f"{k} {c} calls {s * 1e3:.1f} ms {b / 1e6:.2f} MB"
                         for k, (c, s, b) in tp[name]["collectives"].items())
        o, r = one[name], tp[name]
        log(f"  {TP_DECODE_ARCH} {name} at published width, "
            f"{api.cfg.n_layers} of {get_config(TP_DECODE_ARCH).n_layers} "
            f"layers ({o['n_params'] / 1e9:.2f} B parameters, "
            f"{r['param_bytes'] / 1e9:.2f} GB a model rank), batch {B}, "
            f"{P}-token prompt, {steps} steps from init_cache: one rank "
            f"{st.median(o['ms']):.2f} ms a step (median after the "
            f"first), {TP_RANKS} model ranks {st.median(r['ms']):.2f} ms "
            f"(rank 0's events), weight-bytes bound {o['bound']:.2f} ms "
            f"(one card, the one-rank weights and cache, the experts the "
            f"one-rank steps routed to); logits within {worst:.3e} of the "
            f"one-rank RMS, the rows compared over {compared} steps "
            f"(limit {frac}; each step: "
            + ", ".join(f"{e:.2e}" for e in errs) + f"); rows whose "
            f"routing left the one-rank routing (step, the one-rank router "
            f"gap there): {left or 'none'}; rank 0's "
            f"collectives over the steps: {coll}")
        out[name] = {"one_ms": st.median(o["ms"]),
                     "tp_ms": st.median(r["ms"]), "bound_ms": o["bound"],
                     "worst": worst, "compared": compared, "left": left}
    log(f"  one-rank decodes {one_s:.1f} s with the draws; the model ranks' "
        f"launch {wall:.1f} s")
    out["wall"] = wall
    return out


def _tp_trainer_start(tmp):
    """Start ``python -m torch.distributed.run ... repro_torch.launch.train
    --model-axis 2`` on 2 gloo ranks sharing the card (reduced, little
    memory: it runs beside the other parts); ``_tp_trainer_finish`` waits
    for it and resumes its checkpoint at model axis 1."""
    args = ["repro_torch.launch.train", "--arch", RESUME_ARCH, "--batch",
            "4", "--seq", "32", "--ckpt-every", "6", "--lr", "5e-3",
            "--backend", "gloo", "--ckpt-dir", str(tmp / "tp_train"),
            "--steps", str(RESUME_STEPS[0]), "--model-axis", str(TP_RANKS)]
    return _dp_launch(TP_RANKS, args, module=True)


def _tp_trainer_finish(tmp, started):
    """The trainer's launch checked, then ``launch.train.train`` resumed at
    ``model_axis=1`` in this process (the one-rank layout the CLI's
    ``--model-axis 1`` gives)."""
    import math
    from repro_torch.launch.train import train
    proc, t0 = started
    out, w1 = _dp_wait(proc, t0, f"launch.train --model-axis {TP_RANKS}")
    first = json.loads([ln for ln in out.splitlines()
                        if ln.startswith("{")][-1])
    t1 = time.perf_counter()
    resumed = train(RESUME_ARCH, steps=RESUME_STEPS[1], use_reduced=True,
                    ckpt_dir=str(tmp / "tp_train"), batch=4, seq=32,
                    ckpt_every=6, lr=5e-3, model_axis=1, log_every=100,
                    device=DEVICE)
    w2 = time.perf_counter() - t1
    log(f"  launch.train({RESUME_ARCH!r}) --model-axis {TP_RANKS} on "
        f"{TP_RANKS} gloo ranks: loss {first['first_loss']:.4f} -> "
        f"{first['last_loss']:.4f} over {first['steps_run']} steps "
        f"({w1:.1f} s with the launcher, beside the other parts); resumed "
        f"at model_axis 1 to {RESUME_STEPS[1]}: {len(resumed)} steps "
        f"({w2:.1f} s)")
    require(first["steps_run"] == RESUME_STEPS[0] and first["ranks"] ==
            TP_RANKS and first["last_loss"] < first["first_loss"],
            f"launch.train --model-axis {TP_RANKS}: {first}")
    require(len(resumed) == RESUME_STEPS[1] - RESUME_STEPS[0] and all(
        math.isfinite(x) for x in resumed), f"launch.train resumed at "
            f"model_axis 1 ran {resumed}")
    return first, resumed


def phase_tp():
    """Tensor parallelism over the model axis (plain PyTorch and
    torch.distributed: the LM stack has no TPU kernel): ``TP_ARCH``
    training at published width on two model ranks sharing the card,
    ``TP_DECODE_ARCH``'s decode on two model ranks against one, the
    reduced configurations card against CPU, and ``launch.train
    --model-axis 2`` with its resume at one rank."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    _lm_free()
    free, total = torch.cuda.mem_get_info()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    log(f"  card: {card_line()}; {free / 1e9:.1f} of {total / 1e9:.1f} GB "
        f"free; {shutil.disk_usage(tmp).free / 1e9:.1f} GB free on the disk "
        f"of {tmp}")
    reset_launch_counts()
    parts = {}

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn(tmp)
        parts[name] = time.perf_counter() - t1
        return out

    try:
        started = _tp_trainer_start(tmp)
        card = timed("card against CPU", lambda d: _card_vs_cpu(
            d, [(f"1,{TP_RANKS}", "plain", TP_CARD_CASES),
                ("2,2", "plain", TP_CARD_EP)],
            "reduced configurations over the model axis"))
        full = timed(f"{TP_ARCH} training", lambda d: _full_run(d, "tp"))
        decode = timed(f"{TP_DECODE_ARCH} decode", _tp_decode)
        trainer = timed("launch.train's wait and resume",
                        lambda d: _tp_trainer_finish(d, started))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lc = launch_counts()
    wall = time.perf_counter() - t0
    log("  3k parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                   parts.items()))
    log(f"  {TP_ARCH}: median step after the first {full['step_ms']:.1f} ms "
        f"(the slower rank, host clock), of it rank 0's collectives "
        f"{full['collective_ms']:.1f} ms host; launches of the port's CUDA "
        f"kernels in this process {sum(lc.values())} (the LM stack has no "
        f"TPU kernel); phase 3k wall time {wall:.1f} s")
    return {"full": full, "decode": decode, "card_vs_cpu": card,
            "trainer": trainer, "wall": wall}


# ---------------------------------------------------------------------------
# Phase 3l: the dry run
# ---------------------------------------------------------------------------

# the production cells phase 3l holds: (arch, shape, multi_pod, probes)
DRYRUN_CELLS = (("gemma3-4b", "train_4k", False, True),
                ("deepseek-v2-236b", "decode_32k", False, True),
                ("jamba-v0.1-52b", "long_500k", False, True),
                ("whisper-medium", "prefill_32k", False, True),
                ("deepseek-v2-236b", "decode_32k", True, False))
# the traced peak of phase 3i's step against the card's measured peak
DRYRUN_PEAK_REL = 0.10
DRYRUN_WAIT_S = 600
# the Gram job's command-line defaults (n, T)
DRYRUN_GRAM = (2048, 128)


def _dryrun_start(out):
    """Start the dry run's traces (host work, beside the card's phases):
    the first cell, whose real step traces 16 microbatches at full depth,
    through ``python -m repro_torch.launch.dryrun --meta`` in one process
    (meta tensors: the same counts as fake ones in about 40 % of the host
    time), the trace of phase 3i's step and the other cells on fake CUDA
    tensors in another (``chip_smoke.py --dryrun-job OUT``). Returns
    [(process, start, what)]."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    arch, shape, _, _ = DRYRUN_CELLS[0]
    cmds = [([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
              arch, "--shape", shape, "--meta", "--force", "--out",
              str(out)],
             f"the dry run of {arch} {shape}"),
            ([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-job",
              str(out)], "the dry run of phase 3i's step and the cells")]
    return [(subprocess.Popen(cmd, cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True),
             time.perf_counter(), what) for cmd, what in cmds]


def _dryrun_stop(procs):
    """Kill whatever of the background traces still runs."""
    import os
    import signal
    for proc, _, _ in procs or ():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


def _dryrun_job(out) -> int:
    """The second background process of phase 3l: phase 3i's step traced
    as one card runs it (gemma3-4b at full width and depth, no group,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, microbatch 1, AdamW with
    float32 moments and master) on fake CUDA tensors under MemTracker and
    FlopCounterMode, then ``DRYRUN_CELLS[1:]``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import Cell
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    out = Path(out)
    t0 = time.perf_counter()
    with dryrun.fake_tensors():
        batch = {"tokens": torch.empty((TRAIN_BATCH, TRAIN_SEQ + 1),
                                       dtype=torch.long)}
        cell = Cell("train", (batch,), {}, TRAIN_SEQ, TRAIN_BATCH,
                    TRAIN_BATCH * TRAIN_SEQ)
        _, memory, flops = dryrun.trace_real_step(
            get_config(TRAIN_FULL_ARCH), "train_4k", None, microbatch=1,
            opt=AdamW(lr=cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS)),
            cell=cell, flops=True)
    (out / "step_3i.json").write_text(json.dumps(
        {"memory": memory, "flops": flops,
         "trace_s": time.perf_counter() - t0,
         "device": str(dryrun.trace_device())}))
    for arch, shape, multi, probes in DRYRUN_CELLS[1:]:
        res = dryrun.dryrun_cell(arch, shape, multi, probes=probes)
        (out / f"{dryrun.cell_tag(arch, shape, multi)}.json").write_text(
            json.dumps(res, indent=1))
    return 0


def phase_dryrun(procs, out, train):
    """The dry run against the card. Phase 3i's step traced on fake CUDA
    tensors: its FLOPs must equal the FLOPs FlopCounterMode counted on
    the card's step, and its MemTracker peak be within
    ``DRYRUN_PEAK_REL`` of the card's measured peak. The production cells
    (``DRYRUN_CELLS``, on a fake 256- or 512-rank group): each "ok", its
    roofline terms finite, its trace time logged. The Gram and cluster
    dry runs at their command lines' defaults on both layouts, and the
    one-rank Gram dry run's cells equal to the ``visited_cells`` of the
    real one-rank job (K1 on this card)."""
    import math
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import cluster, gram, mesh
    from repro_torch.launch.dryrun import cell_tag
    out = Path(out)
    t0 = time.perf_counter()
    for proc, start, what in procs:
        try:
            text = proc.communicate(timeout=max(
                1.0, DRYRUN_WAIT_S - (time.perf_counter() - t0)))[0]
        except subprocess.TimeoutExpired:
            _dryrun_stop(procs)
            raise AssertionError(f"{what} passed {DRYRUN_WAIT_S} s of "
                                 f"waiting in phase 3l")
        require(proc.returncode == 0, f"{what} failed (exit "
                f"{proc.returncode}):\n{text[-4000:]}")
        log(f"  {what}: started {t0 - start:.1f} s before phase 3l, "
            f"done {time.perf_counter() - t0:.1f} s into it")
    step = json.loads((out / "step_3i.json").read_text())
    full = train["full"]
    measured = max(r["peak_gb"] for r in full["rows"]) * 1e9
    peak = step["memory"]["peak_bytes_est"]
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  card: {card_line()}; total memory {total / 1e9:.2f} GB")
    log(f"  phase 3i's step ({TRAIN_FULL_ARCH}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, microbatch 1, one card) traced on "
        f"{step['device']} fake tensors in {step['trace_s']:.1f} s: "
        f"{step['flops']:.6e} FLOPs predicted, {full['flops']:.6e} "
        f"counted on the card; peak {peak / 1e9:.3f} GB predicted "
        f"(arguments {step['memory']['argument_bytes'] / 1e9:.3f} GB), "
        f"{measured / 1e9:.3f} GB measured "
        f"({100 * (peak - measured) / measured:+.2f}%)")
    require(step["flops"] == full["flops"],
            f"the traced step's FLOPs {step['flops']} != the card's "
            f"{full['flops']}")
    require(abs(peak - measured) <= DRYRUN_PEAK_REL * measured,
            f"the traced peak {peak} is not within {DRYRUN_PEAK_REL} of the "
            f"measured {measured}")
    cells = []
    for arch, shape, multi, probes in DRYRUN_CELLS:
        res = json.loads((out / f"{cell_tag(arch, shape, multi)}.json"
                          ).read_text())
        require(res["status"] == "ok",
                f"dry run {arch} {shape} {res.get('mesh')}: "
                f"{res['status']} {res.get('error', '')}")
        mem = res["memory"]
        line = (f"  {arch} {shape} on {res['mesh']} ({res['device']}): "
                f"trace {res['trace_s']:.1f} s, peak "
                f"{mem['peak_bytes_est'] / 1e9:.2f} GB a rank (arguments "
                f"{mem['argument_bytes'] / 1e9:.2f}), fits 80 GB "
                f"{mem['fits_80GB']}")
        if probes:
            rl = res["roofline"]
            terms = [rl["compute_s"], rl["memory_s"], rl["collective_s"]]
            require(all(math.isfinite(t) and t >= 0 for t in terms),
                    f"dry run {arch} {shape}: roofline terms {terms}")
            line += (f"; probes {res['probe_s']:.1f} s: "
                     f"{res['flops_per_device']:.4e} FLOPs, "
                     f"{res['bytes_per_device']:.4e} bytes, "
                     f"{res['coll_bytes_per_device']:.4e} wire bytes a "
                     f"rank; predicted compute {rl['compute_s']:.4g} s, "
                     f"memory {rl['memory_s']:.4g} s, collective "
                     f"{rl['collective_s']:.4g} s ({rl['dominant']}), "
                     f"useful FLOPs {res['useful_flops_ratio']:.3f}")
        log(line)
        cells.append(res)
    n, t = DRYRUN_GRAM
    reset_launch_counts()
    stats = {}
    gram.run(n, t, "spdtw", device=DEVICE, stats=stats)
    launches = launch_counts()
    one = gram.dryrun(n, t, "spdtw")
    log(f"  gram, one rank: {one['cells_per_device']} cells counted, "
        f"{stats['visited_cells']} visited by the real job on the card "
        f"(launches {launches})")
    require(one["cells_per_device"] == stats["visited_cells"],
            "the one-rank Gram dry run's cells != the real job's")
    require(launches["spdtw_tiles_gram"] > 0, "the real Gram job ran no K1")
    for ranks, multi in ((256, False), (512, True)):
        with mesh.fake_world(ranks):
            layout = mesh.make_production_mesh(multi_pod=multi)
            for name, res in (("gram", gram.dryrun(n, t, "spdtw",
                                                   layout=layout)),
                              ("cluster", cluster.dryrun(layout=layout))):
                log(f"  {name} --dryrun on {ranks} ranks: " + ", ".join(
                    f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in res.items()))
    log(f"  phase 3l wall time {time.perf_counter() - t0:.1f} s")
    return {"step": step, "cells": cells}


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------

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

    # the pair list at the cascade's prefix mask (its plain version runs
    # on the host: torch.nonzero on the card would read the count back)
    m = main["alive2"]
    ms3, (ids, count) = cuda_ms(lambda: gb.pair_list_cuda(m), reps=5,
                                warmup=1)
    mc = m.cpu()
    plain3, (want, n) = cuda_ms(lambda: gb.pair_list_plain(mc))
    require(torch.equal(ids[:int(n)].cpu(), want), "pair list at main shapes")
    # cumsum: the mask in, the sums out; the kernel: both in, the ids out
    M = m.numel()
    b3_ms, b3_by = _bound_cells(0, 0, 0, 6 * M, 4 * M + 4 * int(n) + 4)
    rows.append({"name": "spdtw_pair_list", "ms": ms3, "plain_ms": plain3,
                 "max_abs_err": 0.0, "bound_ms": b3_ms, "bound_by": b3_by})
    log(f"  pair list {Na}x{Nb} ({int(n)} set): {ms3:.3f} ms (plain, host, "
        f"{plain3:.1f} ms, bound {b3_ms:.4f} ms by {b3_by})")
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


# a device record of one of the port's CUDA kernels (csrc/*.cu, each in
# an anonymous namespace)
PORT_KERNEL = re.compile(
    r"^(void )?\(anonymous namespace\)::(banded|banded_thread|banded_wide|"
    r"gram|narrow|pair_list|paired|pairs_bwd|pairs_fwd|regs|thread|"
    r"tiles_bwd|tiles_fwd|wavefront|wavefront_wide|wide)_kernel\b")


# profiles of one call: the profiler now and then loses a few device
# records even in its first seconds (4 of 22,595 once, at 7.7 s), so a
# profile that lost any is taken again, and the run fails when this many
# in a row did
PROFILE_ATTEMPTS = 3
# a host call that puts one record on the device (a kernel launch, a
# copy, a fill; graph launches are not among them)
DEVICE_CALL = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")


def profiled(fn):
    """``fn()`` under torch.profiler between two synchronisations: (wall
    ms, the session's device records sorted by start, its host calls
    that each put one record on the device). CUDA activity alone (the
    device records and the runtime calls behind them, no operator
    records), and the profiler's raw records, not its per-event
    objects: a call of ~10^5 launches (the protocol's SVM loops) is
    processed in seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = list(prof.profiler.kineto_results.events())
    dev = sorted((e for e in ev if e.device_type() == DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    calls = sum(1 for e in ev if e.device_type() != DeviceType.CUDA
                and DEVICE_CALL.match(e.name()))
    return wall, dev, calls


def phase_profile(main, kp=None, cp=None, tp=None, serving=False):
    """Device time by kernel over one ``engine.knn``, one ``engine.gram``
    and the occupancy counts of 200 train series (torch.profiler), and,
    after the kernel path, one sp_krdtw ``engine.knn``, one SVM Gram
    series, ``select_nu`` and ``select_theta_gamma``; after the centroid
    path, one 10-step barycenter fit of a class and one centroid-seeded
    ``engine.knn``; with ``serving``, a cascade ``stream_search``
    unsharded and on 4 shards; after the tables, last, the whole
    protocol of phase 3d's timed pass; with the device's busy share of
    the wall time of each call. A call fails the run unless its profile
    holds one device record for each launch, copy and fill call the
    runtime saw, and one record of the port's kernels for each launch
    counted, in one of ``PROFILE_ATTEMPTS`` profiles. The pass holds the run's first profiler sessions: from
    about 30 s after a process's first session on, torch.profiler (torch
    2.11, CUDA 12.8) loses device records of later sessions, more as
    time passes, whatever the process did in between
    (``tools/profiler_records.py`` shows it in an idle process)."""
    import torch
    from repro_torch.core.occupancy import pairwise_path_counts
    from repro_torch.kernels import launch_counts, reset_launch_counts
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
    if serving:
        from repro_torch.launch.search import SearchEngine, stream_search
        calls += [(f"stream_search cascade, {N_TEST} queries at batch "
                   f"{SERVE_BATCH}",
                   lambda: stream_search(SearchEngine(None, engine=eng),
                                         main["ds"].X_test,
                                         batch=SERVE_BATCH)),
                  (f"stream_search cascade, {SHARDS_SERVED} shards (host "
                   f"path), {N_TEST} queries at batch {SERVE_BATCH}",
                   lambda: stream_search(
                       SearchEngine(None, engine=eng, shards=SHARDS_SERVED),
                       main["ds"].X_test, batch=SERVE_BATCH))]
    # the protocol last: its ~5 x 10^5 records take the profiler longest
    if tp is not None:
        from repro_torch.classify.protocol import paper_tables
        calls += [(f"paper-table protocol, TwoPatterns {N_TRAIN}/{N_TEST}",
                   lambda: paper_tables(main["ds"], DEVICE))]
    t_first = time.perf_counter()
    for what, fn in calls:
        at = time.perf_counter() - t_first
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            reset_launch_counts()
            wall_ms, dev, n_calls = profiled(fn)
            launched = sum(launch_counts().values())
            ours = [e.duration_ns() / 1e6 for e in dev
                    if PORT_KERNEL.match(e.name())]
            whole = (bool(dev) and len(dev) == n_calls
                     and len(ours) == launched)
            if whole or attempt == PROFILE_ATTEMPTS:
                break
            log(f"  {what}: profile {attempt} holds {len(dev)} device "
                f"records for {n_calls} launch / copy / fill calls, "
                f"{len(ours)} of the port's kernels for {launched} "
                "launches: profiled again")
        by_name = {}
        for e in dev:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        busy = sum(ms for ms, _ in by_name.values())
        log(f"  {what} ({at:.1f} s into the pass): wall {wall_ms:.1f} ms, "
            f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle "
            f"{100 * (1 - busy / wall_ms):.1f}%")
        log(f"    CUDA kernel launches in order (ms): "
            f"{', '.join(f'{t:.2f}' for t in ours)}")
        for key, (ms, n) in sorted(by_name.items(),
                                   key=lambda r: -r[1][0])[:8]:
            log(f"    {ms:9.2f} ms  x{n:<5d} {key[:90]}")
        log(f"    device records {len(dev)} for {n_calls} launch / copy / "
            f"fill calls; of the port's kernels {len(ours)} for "
            f"{launched} launches counted (profile {attempt})")
        require(whole, f"profile of {what}: {PROFILE_ATTEMPTS} profiles in "
                f"a row lost device records (the last: {len(dev)} for "
                f"{n_calls} launch / copy / fill calls, {len(ours)} of the "
                f"port's kernels for {launched} launches)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stop-after", type=int, default=4,
                    help="last phase to run (1-4); a run that stops early "
                         "prints no result")
    ap.add_argument("--dp-rank", nargs="+", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if args.dp_rank:
        # one rank of phase 3j or 3k, started by the phase itself
        return _dp_rank_main(args.dp_rank)
    if args.dryrun_job:
        # phase 3l's background traces, started by main
        return _dryrun_job(args.dryrun_job)
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
    import tempfile
    with tempfile.TemporaryDirectory() as dry_out:
        dry = _dryrun_start(dry_out)
        try:
            return _phases_3_4(args, t0, dry, dry_out)
        finally:
            _dryrun_stop(dry)


def _phases_3_4(args, t0, dry, dry_out) -> int:
    """Phases 3 to 4 (``main``'s), with the dry run's background traces
    ``dry`` writing into ``dry_out``."""
    import torch
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
    log(f"phase 3g: multi-device jobs, the sharded index and the launched "
        f"jobs ({time.perf_counter() - t0:.1f} s)")
    mp = phase_multi(main_out)
    # the run's first profiler sessions (see phase_profile)
    log("profile: device time by kernel")
    phase_profile(main_out, kp, cp, tp, serving=True)
    log(f"phase 3h: the LM / Whisper serving path, {LM_FULL_ARCH} at full "
        f"width and the other nine configurations "
        f"({time.perf_counter() - t0:.1f} s)")
    phase_lm()
    log(f"phase 3i: LM / Whisper training, {TRAIN_FULL_ARCH} at full width, "
        f"{WHISPER_ARCH} whole, the other eight reduced "
        f"({time.perf_counter() - t0:.1f} s)")
    train = phase_train()
    log(f"phase 3j: multi-rank LM training over the data axis, {DP_ARCH} "
        f"at published width on {DP_RANKS} gloo ranks, the modes card "
        f"against CPU, one nccl rank, the example twins "
        f"({time.perf_counter() - t0:.1f} s)")
    phase_dp()
    log(f"phase 3k: tensor parallelism over the model axis, {TP_ARCH} "
        f"training at published width and {TP_DECODE_ARCH} decode on "
        f"{TP_RANKS} model ranks, the reduced configurations card against "
        f"CPU, launch.train --model-axis {TP_RANKS} "
        f"({time.perf_counter() - t0:.1f} s)")
    phase_tp()
    log(f"phase 3l: the dry run, phase 3i's step traced on fake tensors "
        f"against the card, {len(DRYRUN_CELLS)} production cells on fake "
        f"256- and 512-rank groups, the Gram and cluster dry runs "
        f"({time.perf_counter() - t0:.1f} s)")
    phase_dryrun(dry, dry_out, train)
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
                     ("serving path (phase 3f)", sv["launches"]),
                     ("multi-device path (phase 3g)", mp["launches"])):
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
