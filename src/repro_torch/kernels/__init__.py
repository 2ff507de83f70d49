"""repro_torch.kernels — the Hopper kernels and their plain versions.

``csrc/`` holds the CUDA kernels, built at first use by ``_build``:
``spdtw_tiles.cu`` (K1 SP-DTW gram, K2 paired), ``krdtw_wavefront.cu``
(K3 log K_rdtw gram, K4 paired), ``dtw_wavefront.cu`` (K5 wavefront
DTW, K6 Sakoe-Chiba strip) and ``soft_tiles.cu`` (K7 soft-SP-DTW forward,
K8 its L-block stash, K9 the reverse expected-alignment sweep).
``gram_block``, ``spdtw_block``, ``krdtw_wavefront``, ``dtw_wavefront``,
``dtw_banded`` and ``soft_block`` hold their wrappers and plain PyTorch versions; ``backends`` the registry; ``ops``
the execute bodies the fitted engine calls; ``ref`` the dense oracles.
"""
from . import backends, ref
from ._build import launch_counts, reset_launch_counts
from .backends import available_backends, get_backend, resolve, resolve_plan
from .dtw_banded import banded_dtw, banded_dtw_gram
from .dtw_wavefront import wavefront_dtw
from .gram_block import (gram_log_krdtw_block, gram_prefix_bound,
                         gram_spdtw_block, gram_spdtw_scan,
                         prefix_tile_count, spdtw_paired_scan)
from .krdtw_wavefront import (krdtw_sweep, mask_to_diagonal_major,
                              wavefront_log_krdtw)
from .soft_block import (gram_soft_spdtw_block, gram_soft_spdtw_scan,
                         soft_alignment_pairs, soft_spdtw_batch,
                         soft_spdtw_gram_batch, soft_spdtw_paired_block,
                         soft_spdtw_paired_scan)
from .spdtw_block import spdtw_block, tile_sweep
