"""repro_torch.kernels — the Hopper kernels and their plain versions.

``csrc/`` holds the CUDA kernels, built at first use by ``_build``:
``spdtw_tiles.cu`` (K1 SP-DTW gram, K2 paired), ``krdtw_wavefront.cu``
(K3 log K_rdtw gram, K4 paired) and ``dtw_wavefront.cu`` (K5 wavefront
DTW, K6 Sakoe-Chiba strip). ``gram_block``, ``spdtw_block``,
``krdtw_wavefront``, ``dtw_wavefront`` and ``dtw_banded`` hold their
wrappers and plain PyTorch versions; ``backends`` the registry; ``ops``
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
from .spdtw_block import spdtw_block, tile_sweep
