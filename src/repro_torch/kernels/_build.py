"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is one shared library with a plain C interface.
It is compiled at first use with ``nvcc`` for ``sm_90a`` into
``<repo>/build/repro_torch/``, under a name keyed by a hash of the source
and the flags, and loaded with ``ctypes``. Nothing is compiled or loaded
at import time; a failed build raises.

The launch counters live here too: every kernel wrapper adds one to its
entry's count where it launches, so a run can show which kernels its path
went through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of every entry point, by library
SIGNATURES = {
    "spdtw_tiles": {
        "spdtw_tiles_gram": (_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P,
                             _P, _I, _I, _I, _I, _I, _P, _P),
        "spdtw_pair_list": (_P, _P, _I, _P, _P, _P),
        "spdtw_tiles_paired": (_P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _I,
                               _I, _I, _I, _P, _P),
    },
    "krdtw_wavefront": {
        "krdtw_gram": (_P, _P, _I, _I, _I, _F, _P, _P, _P, _I, _I, _I, _I,
                       _P, _P),
        "krdtw_paired": (_P, _P, _I, _I, _I, _F, _P, _P, _P, _I, _I, _I,
                         _I, _P, _P),
    },
    "dtw_wavefront": {
        "dtw_wavefront": (_P, _P, _I, _I, _I, _I, _P, _P),
        "dtw_banded": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                       _P),
    },
    "soft_tiles": {
        "soft_tiles_fwd": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _F,
                           _F, _I, _I, _P, _I, _I, _P, _P, _I, _P),
        "soft_tiles_stash": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I,
                             _F, _F, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                             _P),
        "soft_tiles_bwd": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _F,
                           _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                           _I, _P),
    },
}

# launches per entry point since the last reset
LAUNCHES = {fn: 0 for sigs in SIGNATURES.values() for fn in sigs}
# compiler output of each build, by library (``-Xptxas -v`` register and
# shared-memory report)
BUILD_LOG: dict = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    """A copy of the launch counts, by entry point."""
    return dict(LAUNCHES)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    flag set exists. Returns the library path; raises on a failed build."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                           str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "log": proc.stdout + proc.stderr}
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built at first use), with argtypes and
    restype set for each of its entry points."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(rc: int, fn: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")
