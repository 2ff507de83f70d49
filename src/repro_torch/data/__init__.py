"""repro_torch.data — the offline synthetic UCR-like datasets (numpy, the
reference's generators, so both packages see identical data), and the
sequence pipeline (z-normalization, padding, SP-DTW dedup)."""
from .synthetic_ucr import DATASETS, TSDataset, load
from .pipeline import dedup_by_spdtw, pad_to, znorm_batch
