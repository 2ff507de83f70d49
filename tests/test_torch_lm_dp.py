"""PyTorch port, multi-rank LM training on the CPU (two gloo ranks): the
rank layout, the partition specs, the data-parallel step, the deferred
sync and the int8 all-reduce.

- ``param_pspecs`` of the ten configurations, published and reduced,
  equal the reference's leaf for leaf (as tuples); ``AdamW.state_pspecs``
  with ZeRO-1 equals the reference's on ``test_zero1_pspecs``'s three
  cases and on yi-6b's and deepseek-v2-lite-16b's real specs at
  ``data_size=16``.
- ``launch.mesh.Layout`` at (2, 1), (1, 2) and (2, 1, 1): row-major rank
  order and one subgroup per slice of every set of axes.
- yi-6b at ``reduced`` size on the reference's weights, two ranks: the
  synced gradients against ``jax.value_and_grad(api.train_loss)`` on one
  device (float32 twin within ``GRAD_FRAC_DP`` of each leaf's RMS, bf16
  within the one-rank parity limits of ``torch_train_helpers``), one step
  against the reference's one-device ``make_train_step`` (every leaf
  left equal on the two ranks), and ``grad_sync="deferred"`` at m
  microbatches against the reference's one-device step at microbatch 2m
  (the same row slices; the reference's own deferred mode raises under
  jax 0.9.0, ROADMAP section C).
- ``int8_all_reduce`` at two ranks against ``_int8_psum`` in a shard_map
  over two forced devices, bit for bit; the deferred + int8 step within
  the quantization bound of the uncompressed one; under a (pod, data,
  model) layout the plain step equal to the (data, model) one and
  ``int8_pod`` (which raises in the reference under jax 0.9.0) within the
  bound of the pods' uncompressed sum.
- ``make_train_step(..., accum_pspecs=state_pspecs(zero1=True).m)``, the
  ZeRO-2 step (gradients reduce-scattered into float32 blocks, the
  optimizer state split over "data"), at microbatch 2 on two ranks: its
  loss and every new parameter equal to the same step without it, bit
  for bit (a sum of two values rounds alike in either collective).
"""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import build as jbuild
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch.train import train
from repro_torch.models import build
from repro_torch.train.optimizer import AdamW

from torch_dp_helpers import (GRAD_FRAC_DP, check_dp_grads, check_dp_step,
                              dp_run, start_forced, start_ranks, under,
                              worker)


def _reference_pspecs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _port_pspecs(tree):
    """The port's spec pytree with every spec a leaf (tuples kept)."""
    if isinstance(tree, dict):
        return {k: _port_pspecs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_pspecs(v) for v in tree]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_reference(arch):
    for make, jmake in ((lambda a: get_config(a), jget_config),
                        (lambda a: reduced(get_config(a)),
                         lambda a: jreduced(jget_config(a)))):
        got = _port_pspecs(build(make(arch)).param_pspecs())
        want = _reference_pspecs(jbuild(jmake(arch)).param_pspecs())
        assert got == want


def test_state_pspecs_zero1_equal_reference():
    shapes = {"a": (32, 64), "b": (64, 37), "c": (7,)}
    specs = {"a": (None, "model"), "b": ("model", None), "c": (None,)}
    st = AdamW().state_pspecs(specs, zero1=True, shapes=shapes,
                              data_size=16)
    assert st.m["a"] == ("data", "model")      # 32 % 16 == 0
    assert st.m["b"] == ("model", None)        # 37 indivisible
    assert st.m["c"] == (None,)                # nothing shardable
    jst = JAdamW().state_pspecs(
        {k: P(*v) for k, v in specs.items()}, zero1=True,
        shapes={k: jax.ShapeDtypeStruct(v, jnp.float32)
                for k, v in shapes.items()}, data_size=16)
    assert {k: tuple(v) for k, v in jst.m.items()} == st.m
    for arch in ("yi-6b", "deepseek-v2-lite-16b"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        japi = jbuild(jcfg)
        for zero1 in (False, True):
            shapes = japi.abstract_params() if zero1 else None
            want = JAdamW().state_pspecs(japi.param_pspecs(), zero1=zero1,
                                         shapes=shapes, data_size=16)
            got = AdamW().state_pspecs(build(cfg).param_pspecs(),
                                       zero1=zero1, shapes=shapes,
                                       data_size=16)
            assert got.step == tuple(want.step) == ()
            for g, w in ((got.m, want.m), (got.v, want.v),
                         (got.master, want.master)):
                assert _port_pspecs(g) == _reference_pspecs(w)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One launch of two ranks for the layout and one for yi-6b's jobs,
    the reference's int8 on two forced devices beside them, and the
    reference's one-device steps at microbatch 1, 2 and 4 meanwhile."""
    d = tmp_path_factory.mktemp("dp")
    return dp_run("yi-6b", d, (1, 2, 4),
                  start_ranks(worker("layout", d / "layout"))
                  + [start_forced(["tests/torch_dp_reference.py", "int8",
                                   d])])


def test_layout_rank_order_and_subgroups(run):
    rows = [json.loads((run["dir"] / "layout" / f"layout_r{r}.json"
                        ).read_text()) for r in range(2)]
    for r, layouts in enumerate(rows):
        for lay in layouts:
            shape = lay["shape"]
            # row-major: rank r sits at unravel_index(r, shape)
            assert lay["coords"] == list(np.unravel_index(r, shape))
            for names, got in lay["sets"].items():
                axes = names.split(",")
                n = int(np.prod([shape[lay["axes"].index(a)]
                                 for a in axes]))
                assert got["size"] == n
                assert got["members"] == ([0, 1] if n == 2 else [r])
                assert got["index"] == (r if n == 2 else 0)
                # the subgroup's all-reduce sums exactly its members
                assert got["sum"] == sum(got["members"])


def test_dp_gradients_float32_twin(run):
    check_dp_grads(run, "f32", GRAD_FRAC_DP)


def test_dp_gradients_bf16(run):
    check_dp_grads(run, "bf16")


def test_dp_step_matches_reference(run):
    check_dp_step(run["out"][102], run["steps"][1], run)


@pytest.mark.parametrize("m", [1, 2])
def test_deferred_matches_reference_at_microbatch_2m(run, m):
    check_dp_step(run["out"][110 + m], run["steps"][2 * m], run)


def test_int8_all_reduce_equals_reference_int8_psum(run):
    want = np.load(run["dir"] / "int8.npz")
    got = run["out"][130]
    for k, shape in (("a", (64,)), ("b", (3, 5))):
        # every device of the shard_map holds the same sum
        assert np.array_equal(want[k][0], want[k][1])
        assert np.array_equal(got[f".out.{k}"], want[k][0]), k
        exact = got[f".in.{k}"].reshape((2,) + shape).sum(0)
        scale = np.abs(got[f".in.{k}"]).max() / 127.0
        assert np.max(np.abs(got[f".out.{k}"] - exact)) <= scale


def test_deferred_int8_within_quantization_bound(run):
    """Each rank's rounding moves an entry by at most half the shared
    scale (max over the ranks of |local sum| / 127), so two ranks' sum,
    divided by 2, moves it by at most scale / 2."""
    q, exact, amax = (under(run["out"][s], ".grads") for s in
                      (120, 121, 122))
    assert abs(float(run["out"][120][".loss"])
               - float(run["out"][121][".loss"])) == 0.0
    for k, e in exact.items():
        bound = float(amax[k]) / 127.0 / 2.0
        err = float(np.max(np.abs(q[k] - e)))
        assert err <= bound * (1 + 1e-5) + 1e-7 * float(np.abs(e).max()), (
            k, err, bound)
        if float(amax[k]) > 0:
            assert err > 0 or bound < 1e-9, k     # it did quantize


def test_pod_layout_syncs_over_pod_and_data(run):
    """Under a (pod, data, model) = (2, 1, 1) layout the plain step sums
    over both data-parallel axes: the same two ranks as the (2, 1)
    layout's data axis, so the same bits."""
    for k, v in run["out"][101].items():
        assert np.array_equal(run["out"][141][k], v), k


def test_int8_pod_sums_the_pods_within_the_quantization_bound(run):
    """``int8_pod``: each pod's gradients (here one rank's) go through
    ``int8_all_reduce`` over the pod axis and are summed, not averaged,
    as the reference does: twice the two pods' mean, within each rank's
    half quantum, amax / 127 in all."""
    q, mean, amax = (under(run["out"][s], ".grads") for s in
                     (140, 141, 122))
    assert float(run["out"][140][".loss"]) == float(run["out"][141][".loss"])
    for k, e in mean.items():
        err = float(np.max(np.abs(q[k] - 2 * e)))
        bound = float(amax[k]) / 127.0
        assert err <= bound * (1 + 1e-5) + 1e-7 * float(np.abs(e).max()), (
            k, err, bound)


def test_zero2_step_equals_the_plain_step(run):
    plain, zero = run["out"][150], run["out"][151]
    assert np.array_equal(plain[".loss"], zero[".loss"])
    params = under(plain, ".params")
    assert params
    for k, v in params.items():
        assert np.array_equal(zero[".params" + k], v), k


def test_model_axis_raises_naming_the_next_item(tmp_path):
    """A model axis that does not split a leaf raises, naming the leaf and
    its shape (reduced minicpm-2b's vocabulary of 256 over 3 ranks); a
    model axis that splits every leaf asks for its ranks (two gloo ranks
    train at --model-axis 2 in tests/test_torch_lm_tp_train.py)."""
    with pytest.raises(ValueError, match=r"leaf embed of shape \(256, 64\)"):
        train("minicpm-2b", steps=1, model_axis=3, ckpt_dir=str(tmp_path),
              device="cpu")
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train("minicpm-2b", steps=1, model_axis=2, ckpt_dir=str(tmp_path),
              device="cpu")
