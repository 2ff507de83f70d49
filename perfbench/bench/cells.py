"""The benchmark's cells, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell, configuration and metric; the files under
``perfbench/`` hold what each one is.

- ``configs/<config>.json``: one deployment: what it runs with its
  parameters, its precision, its guarantees, what it ``assumed`` and
  ``reduced``, the ``limits`` of the comparison, a ``source`` of at most
  200 characters, and the data it runs on (below);
- ``workloads/<cell>.json``: one cell (its configuration, traffic mix
  and its parameters, the driver it runs);
- ``drivers/<driver>.py``: the port's entries a window drives;
- ``traffic/<loop>.py``: the generator of a loop (``closed``,
  ``poisson``);
- ``traffic/<data>.py``: a configuration's data source;
- ``metrics/<metric>.py``: one reader per metric.

A configuration names its data source as ``"data": "<module>"``; one
that names none runs on ``two_patterns``, and carries that source's keys
(``n_train``, ``T``, ``train_seed``, ``n_classes``, ``measure``). A data
source has two functions:

- ``cell_data(cfg, pool, seed) -> dict``: the host arrays of a run, from
  the configuration and the run's seed (``bench/seeds.py``'s streams);
  the driver's ``compare`` gets the same dict, so the plain reference
  starts from what the program was given;
- ``on_device(data, device) -> (setup_args, pool)``: the arguments of
  ``Program.setup(*setup_args)`` (empty for a model whose weights come
  from the configuration or the seed, with no train split) and the
  request pool on the device: a tensor of rows, or a mapping of tensors
  with one row a request, such as ragged token prompts padded beside
  their lengths (``bench/pools.py``).

A loop cuts its jobs or batches as runs of the pool's rows, and a
driver's ``step`` takes one and returns a dict of numpy arrays, one row
an answered request. ``Program.support()``, ``kept()`` and ``counters()``
are optional: a program without a learnt support has none to report.

A cell added as files and an entry of ``BENCHMARK.json`` is found with no
edit of the harness.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


class Cell:
    """One cell of ``BENCHMARK.json`` with its files: ``entry`` (the
    workloads entry), ``wl`` (its workload file), ``cfg`` (its
    configuration file), and the names of the metrics it reports."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = load_benchmark(self.root)
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        self.wl = json.loads((self.root / "perfbench" / "workloads" /
                              f"{name}.json").read_text())
        for key in ("config", "traffic"):
            if self.wl[key] != self.entry[key]:
                raise ValueError(f"{name}: workload file says {key} "
                                 f"{self.wl[key]!r}, BENCHMARK.json "
                                 f"{self.entry[key]!r}")
        conf = [c for c in self.bench["configs"]
                if c["name"] == self.entry["config"]][0]
        self.cfg = json.loads((self.root / conf["file"]).read_text())

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports:
        those listing it under ``workloads``; an entry without the key is
        reported in every cell that reports the metric it moves."""
        out = []
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        for m in self.bench[kind]:
            cells = m.get("workloads")
            if cells is None:
                mine = m["moves"] in e2e if kind == "per_layer" else True
            else:
                mine = self.name in cells
            if mine:
                out.append(m)
        return out


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """The ``read(run)`` function of metric ``name``
    (``perfbench/metrics/<name>.py`` under ``root``)."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    return _load_file(path, "perfbench.metrics._" +
                      name.replace(".", "_").replace("-", "_")).read


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def traffic(loop: str):
    return importlib.import_module(f"perfbench.traffic.{loop}")


def data(cfg: dict):
    """The data source configuration ``cfg`` names (``"data"``), by
    default ``two_patterns``."""
    return importlib.import_module(
        f"perfbench.traffic.{cfg.get('data', 'two_patterns')}")
