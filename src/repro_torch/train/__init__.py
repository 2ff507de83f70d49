"""repro_torch.train — the in-house optimizer the centroid fits use, and
the LM serve-step factories (``train_step``)."""
from .optimizer import AdamState, AdamW
