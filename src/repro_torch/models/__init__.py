"""repro_torch.models — the assigned-architecture model zoo (decoder LMs
and the Whisper encoder-decoder): training loss and serving path."""
from .config import LayerSpec, ModelConfig
from .registry import ModelAPI, build
