"""PyTorch port, LM training on the CPU: the dense and VLM decoders
gemma3-12b, yi-6b, minicpm-2b and pixtral-12b at ``reduced`` size on the
reference's weights (``convert.lm_params_from_reference``):
``train_loss`` and every gradient leaf against
``jax.value_and_grad(api.train_loss)`` on the float32 twin and in bf16,
and (yi-6b, minicpm-2b, pixtral-12b) one ``make_train_step`` at
microbatch 1 and 2 against the reference's ``make_train_step(api, None,
opt, microbatch=m)`` on the float32 twin, within the limits of
``torch_train_helpers``. gemma3-4b is in ``test_torch_lm_train_gemma.py``.
Also the port's own smoke check for all ten configurations, as the
reference's ``tests/test_smoke_archs.py::test_smoke_train_step``: a
finite loss within 2.0 of ln V and finite gradients.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import build
from repro_torch.models.lm import tree_leaves
from repro_torch.train.data import TokenPipeline
from repro_torch.train.train_step import value_and_grad

from torch_train_helpers import TrainCase, check_grads, check_step

ARCHS = ("gemma3-12b", "yi-6b", "minicpm-2b", "pixtral-12b")
STEP_ARCHS = ("yi-6b", "minicpm-2b", "pixtral-12b")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return TrainCase.cached(request.param)


def test_loss_and_grads_float32_twin(case):
    check_grads(case, "f32")


def test_loss_and_grads_bf16(case):
    check_grads(case, "bf16")


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch, microbatch):
    check_step(TrainCase.cached(arch), microbatch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = api.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                                else torch.float32)
             for k, v in TokenPipeline(cfg, 2, 16).batch_at(0).items()}
    loss, grads = value_and_grad(api, params, batch)
    assert np.isfinite(float(loss))
    assert abs(float(loss) - math.log(cfg.vocab)) < 2.0
    assert all(bool(torch.isfinite(g.float()).all())
               for g in tree_leaves(grads))
