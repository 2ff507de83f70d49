"""The harness fails, and prints no result, without the card the cell
asks for, and in a checkout that holds only the benchmark; it never
falls back to the CPU."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.bench import card
from perfbench.tests.helpers import ROOT


def _run(cwd, extra_env=None):
    env = {**os.environ, **(extra_env or {})}
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "spdtw-1nn-bulk",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_require_cards_refuses_too_few(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card.require_cards(1)
    with pytest.raises(card.NoCard):
        card.require_cards(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(card.NoCard):
        card.require_cards(1)


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_benchmark_alone_no_result_on_the_card(tmp_path):
    """On a machine with the card, a checkout without the port fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
