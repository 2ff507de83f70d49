"""repro_torch.data — the offline synthetic UCR-like datasets (numpy, the
reference's generators, so both packages see identical data)."""
from .synthetic_ucr import DATASETS, TSDataset, load
