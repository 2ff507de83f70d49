"""repro_torch.kernels — the Hopper kernels of the SP-DTW DP and their
plain versions.

``csrc/spdtw_tiles.cu`` holds the CUDA kernels (K1 gram, K2 paired),
built at first use by ``_build``; ``gram_block`` and ``spdtw_block`` hold
their wrappers and plain PyTorch versions; ``backends`` the registry;
``ops`` the execute bodies the fitted engine calls; ``ref`` the dense
oracles.
"""
from . import backends, ref
from ._build import launch_counts, reset_launch_counts
from .backends import available_backends, get_backend, resolve, resolve_plan
from .gram_block import (gram_prefix_bound, gram_spdtw_block,
                         gram_spdtw_scan, prefix_tile_count,
                         spdtw_paired_scan)
from .spdtw_block import spdtw_block, tile_sweep
