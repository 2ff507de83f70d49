"""PyTorch port, the LM / Whisper serving path on a CUDA card (on a
machine with a card only): each architecture at ``reduced`` size, on the
same weights, gives on the card what it gives on the CPU within the
limits of ``chip_smoke.LM_CARD_FRAC`` (cuBLAS rounds its bf16 products
differently again). The comparison is phase 3h's own
(``chip_smoke.lm_card_vs_cpu``):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_lm_cuda.py``.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_matches_cpu(arch, cuda_device):
    rows = _smoke().lm_card_vs_cpu(arch, cuda_device)
    assert {kind for kind, _, _, _ in rows} == {"logits", "hidden", "cache"}
    for i, (kind, err, rms, limit) in enumerate(rows):
        assert err <= limit, (i, kind, err, rms, limit)
