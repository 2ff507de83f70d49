"""PyTorch port, LM / Whisper training on a CUDA card (on a machine with a
card only): each architecture at ``reduced`` size, on the same weights,
gives on the card the loss and gradients it gives on the CPU, in bf16
and on the float32 twin, within the limits of phase 3i
(``chip_smoke.TRAIN_LOSS_ATOL`` / ``TRAIN_GRAD_RTOL`` /
``TRAIN_GRAD_FRAC``); flash attention's backward agrees card against CPU
in float32. The comparisons are phase 3i's own
(``chip_smoke.lm_train_card_vs_cpu``, ``chip_smoke.flash_card_vs_cpu``):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_lm_train_cuda.py``.
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
def test_train_card_matches_cpu(arch, cuda_device):
    rows = _smoke().lm_train_card_vs_cpu(arch, cuda_device)
    assert {(kind, what) for kind, what, _, _, _ in rows} >= {
        ("bf16", "loss"), ("f32", "loss"), ("f32", "grad")}
    for i, (kind, what, err, scale, limit) in enumerate(rows):
        assert err <= limit, (i, kind, what, err, scale, limit)


@pytest.mark.cuda
def test_flash_backward_card_matches_cpu(cuda_device):
    err, excess = _smoke().flash_card_vs_cpu(cuda_device)
    assert len(err) == 4 and max(excess) <= 0, err
