"""PyTorch port, the public surface: every name of ``repro.__all__``
imports from ``repro_torch`` and is in its ``__all__``, except the nine
deprecated module-level kernel wrappers of ``repro.kernels.ops``
(``_deprecated``, ``src/repro/kernels/ops.py:66``), which every caller
replaced by the fitted engine; also the helpers the reference keeps
beside them (``core.spec.spec``, ``register_backend``) and the plan
resolver's cache.
"""
import pytest

import repro
import repro_torch

DEPRECATED = ("dtw_gram", "dtw_pairs", "knn_cascade", "log_krdtw_gram",
              "log_krdtw_pairs", "soft_spdtw_gram", "soft_spdtw_pairs",
              "spdtw_gram", "spdtw_pairs")
NAMES = [n for n in repro.__all__ if n not in DEPRECATED]


def test_deprecated_names_are_the_reference_wrappers():
    from repro.kernels import ops
    for name in DEPRECATED:
        assert name in repro.__all__
        assert getattr(repro, name) is getattr(ops, name)
        assert not hasattr(repro_torch, name)


@pytest.mark.parametrize("name", NAMES)
def test_public_name_imports(name):
    assert name in repro_torch.__all__
    obj = getattr(repro_torch, name)
    assert callable(obj) or isinstance(obj, (tuple, frozenset, dict))


def test_all_names_resolve():
    assert len(set(repro_torch.__all__)) == len(repro_torch.__all__)
    missing = [n for n in repro_torch.__all__ if not hasattr(repro_torch, n)]
    assert not missing


def test_spec_registry_helpers():
    from repro_torch.core.spec import MeasureSpec, spec
    from repro_torch.kernels.backends import (Backend, _ones_plan,
                                              available_backends,
                                              register_backend, resolve_plan)
    assert spec("spdtw", theta=2.0) == MeasureSpec("spdtw", theta=2.0)
    assert spec().family == "spdtw"
    before = _ones_plan.cache_info()
    resolve_plan(T=17)
    resolve_plan(T=17)
    after = _ones_plan.cache_info()
    assert after.hits + after.misses == before.hits + before.misses + 2
    assert after.hits >= before.hits + 1
    extra = Backend("extra", "cpu", frozenset(), "scan", "a test record")
    register_backend(extra)
    try:
        assert "extra" in available_backends()
        with pytest.raises(ValueError, match="unknown capabilities"):
            register_backend(Backend("bad", "cpu", frozenset({"nope"}), None,
                                     ""))
    finally:
        from repro_torch.kernels import backends
        backends._REGISTRY.pop("extra")
