"""PyTorch port: K5 (``dtw_wavefront``) and K6 (``dtw_banded``) at their
launch-template boundaries, on a machine with a CUDA card only.

K6 sweeps a strip of 2w + 1 <= 64 cells with one thread per pair (the
"thread" template), up to 256 cells with a lane group per pair ("lanes")
and wider strips through shared memory ("wide"); K5 keeps up to 512
diagonal positions and 4 channels in registers (``test_torch_geometry.py``
holds the split on the CPU). These tests hold both kernels to their plain
versions bit for bit (min and add only: every template and sweep order
gives the same bits) at every boundary:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_dtw_templates.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import dtw_banded as t_k6
from repro_torch.kernels import dtw_wavefront as t_k5

# half-widths at every K6 template boundary: 2w + 1 = 1, 3, 7, 15, 31, 33,
# 63, 65, 255, 257
BOUNDARY_RADII = (0, 1, 3, 7, 15, 16, 31, 32, 127, 128)


# ------------------------------------------------------ card-only checks
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _series(seed, B, T, d):
    rng = np.random.default_rng(seed)
    shape = (B, T) if d == 1 else (B, T, d)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("T", [5, 24, 128, 129])
def test_cuda_k6_equals_plain_at_every_template_boundary(cuda_device, T,
                                                         d):
    x, y = (torch.as_tensor(a, device=cuda_device)
            for a in _series(T + d, 9, T, d))
    before = _build.launch_counts()["dtw_banded"]
    for w in BOUNDARY_RADII:
        want = t_k6.banded_dtw_plain(x, y, w)
        assert torch.equal(t_k6.banded_dtw(x, y, w), want), w
        wantg = t_k6.banded_dtw_gram_plain(x[:4], y, w)
        assert torch.equal(t_k6.banded_dtw_gram(x[:4], y, w), wantg), w
    assert _build.launch_counts()["dtw_banded"] == \
        before + 2 * len(BOUNDARY_RADII)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
def test_cuda_k6_templates_give_equal_bits(cuda_device, d):
    """Every template that takes a width gives the same Gram, bit for
    bit, at T = 128 and at T = 129 (a chunk boundary of the staging)."""
    for T in (128, 129):
        A, B = (torch.as_tensor(a, device=cuda_device)
                for a in _series(40 + T, 130, T, d))
        A3 = A if d > 1 else A[..., None]
        B3 = B if d > 1 else B[..., None]
        for w in (0, 3, 6, 13, 26, 31):
            want = t_k6.banded_dtw_gram_plain(A[:3], B, w)
            for template in ("thread", "lanes", "wide"):
                got = t_k6.dtw_banded_cuda(A3[:3].contiguous(),
                                           B3.contiguous(), w, gram=True,
                                           template=template)
                assert torch.equal(got, want), (T, w, template)


@pytest.mark.cuda
def test_cuda_k6_at_the_long_strip(cuda_device):
    """T = 1024, w = 204: a 409-cell strip, the shared-memory sweep."""
    x, y = (torch.as_tensor(a, device=cuda_device)
            for a in _series(1024, 4, 1024, 1))
    assert torch.equal(t_k6.banded_dtw(x, y, 204),
                       t_k6.banded_dtw_plain(x, y, 204))
    assert torch.equal(t_k6.banded_dtw_gram(x[:2], y, 204),
                       t_k6.banded_dtw_gram_plain(x[:2], y, 204))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 31, 33, 128, 129, 512, 513])
def test_cuda_k5_equals_plain(cuda_device, T):
    for d in ((1, 3, 5) if T <= 129 else (1,)):
        x, y = (torch.as_tensor(a, device=cuda_device)
                for a in _series(T + 7 * d, 6, T, d))
        for r in (None, 0, 3, 26):
            assert torch.equal(t_k5.wavefront_dtw(x, y, radius=r),
                               t_k5.wavefront_dtw_plain(x, y, radius=r)), \
                (T, d, r)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 128, 129])
def test_cuda_k6_equals_k5_on_the_corridor(cuda_device, T):
    """K6 at half-width w and K5 at radius w compute one DTW_sc in two
    associations: within rel 1e-5, the limit chip_smoke.py uses."""
    x, y = (torch.as_tensor(a, device=cuda_device)
            for a in _series(T + 11, 64, T, 1))
    for w in (0, 3, 13, 26, 31, 32):
        k6 = t_k6.banded_dtw(x, y, w).double()
        k5 = t_k5.wavefront_dtw(x, y, radius=w).double()
        assert bool(((k6 - k5).abs() <= 1e-5 * k5.abs()).all()), w
