"""PyTorch port, the multi-rank trainer on the CPU:
``python -m torch.distributed.run ... repro_torch.launch.train
--data-axis 2`` (two gloo ranks) at the reference's own test shape
(``tests/test_train_stack.py::test_train_loss_decreases_end_to_end``:
minicpm-2b reduced, batch 4 x 32, a checkpoint every 6 steps, lr 5e-3).
12 steps lower the loss and the resume to 14 runs the two missing steps;
the same 12-step run resumed from its step-6 checkpoint alone writes the
same step-12 checkpoint, every leaf's sha256 equal, as the uninterrupted
run.
"""
import json
import shutil

import pytest

from torch_dp_helpers import manifest_hashes, start_launcher, wait_all

RUN = ["repro_torch.launch.train", "--arch", "minicpm-2b", "--batch", "4",
       "--seq", "32", "--ckpt-every", "6", "--lr", "5e-3",
       "--data-axis", "2", "--backend", "gloo",
       "--device", "cpu"]


def _result(log):
    """The JSON line rank 0 prints last."""
    lines = [ln for ln in log.splitlines() if ln.startswith("{")]
    assert lines, log[-3000:]
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_train")
    a, b = d / "a", d / "b"
    first = wait_all([start_launcher(RUN + ["--steps", "12",
                                            "--ckpt-dir", a])])
    # the uninterrupted run's step-6 checkpoint alone
    shutil.copytree(a / "step_00000006", b / "step_00000006")
    second = wait_all([
        start_launcher(RUN + ["--steps", "14", "--ckpt-dir", a]),
        start_launcher(RUN + ["--steps", "12", "--ckpt-dir", b])])
    return {"a": a, "b": b, "first": first, "second": second}


def test_train_data_axis_2_lowers_the_loss_and_resumes(runs):
    full = _result(runs["first"][0])
    assert full["ranks"] == 2 and full["steps_run"] == 12
    assert full["last_loss"] < full["first_loss"], full
    resumed = _result(runs["second"][0])
    assert resumed["steps_run"] == 2              # resumed at 12, ran 12, 13
    assert "[resume] step 12 (elastic: mesh 2x1)" in runs["second"][0]


def test_resume_from_step_6_reproduces_the_uninterrupted_run(runs):
    assert _result(runs["second"][1])["steps_run"] == 6
    assert "[resume] step 6 (elastic: mesh 2x1)" in runs["second"][1]
    want = manifest_hashes(runs["a"], 12)
    got = manifest_hashes(runs["b"], 12)
    assert got == want
