"""repro_torch.train — the in-house optimizer the centroid fits use."""
from .optimizer import AdamState, AdamW
