"""The card a run measures on: the look for it, its name, and its clocks
and power sampled beside the window with ``nvidia-smi``."""
from __future__ import annotations

import shutil
import subprocess

import torch

SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "power.limit",
              "temperature.gpu")


class NoCard(RuntimeError):
    """The run asks for more CUDA cards than the machine has."""


def require_cards(n: int) -> None:
    """Raise ``NoCard`` unless ``n`` CUDA cards are present: a run never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} CUDA cards, "
                     f"{torch.cuda.device_count()} are present")


def describe(device: torch.device) -> dict:
    """The card's name and power limit (or the CPU's stand-in)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    smi = shutil.which("nvidia-smi")
    if smi:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        if proc.returncode == 0:
            out["smi"] = proc.stdout.strip()
    return out


class Sampler:
    """``nvidia-smi`` reading the card's clocks and power every
    ``period_ms`` while the window runs; ``stop`` ends the process, waits
    for it and summarises what it read (nothing without the tool)."""

    def __init__(self, device: torch.device, period_ms: int = 500):
        self.proc = None
        smi = shutil.which("nvidia-smi")
        if device.type == "cuda" and smi:
            self.proc = subprocess.Popen(
                [smi, f"--query-gpu={','.join(SMI_FIELDS)}",
                 "--format=csv,noheader,nounits", f"--id={device.index or 0}",
                 f"-lms={period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return {}
        cols = list(zip(*rows))
        return {f: {"min": min(c), "max": max(c),
                    "mean": sum(c) / len(c)} for f, c in zip(SMI_FIELDS, cols)
                } | {"samples": len(rows)}
