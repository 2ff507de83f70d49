"""No module the benchmark runs has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``repro``, and the reference imports nothing of
the port either; names are compared whole (``repro_torch`` is not
``repro``)."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from perfbench.bench.harness import FORBIDDEN, forbidden_modules
from perfbench.tests.helpers import ROOT

PKG = ROOT / "perfbench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names_are_compared():
    assert forbidden_modules(["repro_torch", "repro_torch.core",
                              "reprox", "jaxtyping", "perfbench"]) == []
    assert forbidden_modules(["repro.core.dtw", "jax.numpy", "flax",
                              "repro_torch"]) == ["flax", "jax", "repro"]


def test_sources_import_no_forbidden_module():
    for path in PKG.rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(_top_level_imports(path))
        assert not names & set(FORBIDDEN), (path, names)
        if "reference" in path.parts:
            assert "repro_torch" not in names, path


def _modules_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=300,
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                       "PATH": "/usr/bin:/bin"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_forbidden_module():
    mods = _modules_after(
        "from perfbench.tests.helpers import run_tiny\n"
        "run_tiny('spdtw-1nn-bulk'); run_tiny('spkrdtw-svm-online')")
    assert not set(mods) & set(FORBIDDEN), mods
    assert "repro_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules_after(
        "import perfbench.reference.occupancy, perfbench.reference.spdtw\n"
        "import perfbench.reference.krdtw, perfbench.reference.svm\n"
        "import perfbench.traffic.two_patterns")
    assert not set(mods) & (set(FORBIDDEN) | {"repro_torch"}), mods
