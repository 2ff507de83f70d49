"""PyTorch port, ``launch.shapes``: the assigned shapes, the cell skip rule
and the decode caches' partition specs equal the reference's.

``cache_pspecs`` is held for the ten configurations, published and
reduced, at batch 1, 4 and 128 over (data, model) = (1, 2) and (2, 2)
and (pod, data, model) = (2, 2, 2). The reference's function reads only
its mesh's axis names and sizes, so it is given a stand-in mesh of those
sizes (no devices); the port's takes {axis: size}.
"""
import types

import pytest
import jax
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.launch import shapes as jshapes
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch import shapes

MESHES = ({"data": 1, "model": 2}, {"data": 2, "model": 2},
          {"pod": 2, "data": 2, "model": 2})
BATCHES = (1, 4, 128)


def _tree(specs):
    if isinstance(specs, dict):
        return {k: _tree(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_tree(v) for v in specs]
    return tuple(specs)


def _reference(tree):
    return _tree(jax.tree.map(tuple, tree,
                              is_leaf=lambda x: isinstance(x, P)))


def test_shapes_equal_reference():
    assert shapes.SHAPES == jshapes.SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_supported_equal_reference(arch):
    for shape in shapes.SHAPES:
        assert (shapes.cell_supported(get_config(arch), shape)
                == jshapes.cell_supported(jget_config(arch), shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_reference(arch):
    for make, jmake in ((get_config, jget_config),
                        (lambda a: reduced(get_config(a)),
                         lambda a: jreduced(jget_config(a)))):
        for sizes in MESHES:
            mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                         shape=dict(sizes))
            for B in BATCHES:
                got = _tree(shapes.cache_pspecs(make(arch), B, sizes))
                want = _reference(jshapes.cache_pspecs(jmake(arch), B,
                                                       mesh))
                assert got == want, (arch, sizes, B)
