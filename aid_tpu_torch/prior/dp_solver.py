"""ctypes binding of the C++ minimal-spread path solver (``native/dp_solver.cc``).

The port's own binding: the shared library is compiled with ``g++`` at first
use into the git-ignored ``build/aid_tpu_torch/`` at the repository root,
named by a hash of the source and the flags, so an unchanged source is built
once. This is host code (the DP search of the Beta-prior selection), not a
device kernel. :func:`library` raises ``OSError`` when no compiler or no
source is found; ``prior.beta.find_minimal_spread_and_path`` then runs the
Python search.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dp_solver.cc"
BUILD_DIR = _ROOT / "build" / "aid_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdp_solver_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the solver if its hashed library is missing; return its path."""
    if not SOURCE.exists():
        raise OSError(f"the solver's source {SOURCE} is missing")
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the native DP solver cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each install a whole library
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.find_minimal_spread_and_path.restype = ctypes.c_double
    lib.find_minimal_spread_and_path.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(dtype=np.float64, ndim=2, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.int32, ndim=1, flags="C_CONTIGUOUS"),
    ]
    return lib


def find_minimal_spread_and_path(n: int, m: int, weights: np.ndarray):
    """(best spread, path of n node indices) for an (m, m) weight matrix
    (-1 marks an absent edge); raises ValueError when no path exists."""
    w = np.ascontiguousarray(np.asarray(weights, np.float64))
    if w.shape != (m, m) or not 2 <= n <= m:
        raise ValueError(f"weights {w.shape} and n={n} do not describe an n-node path over {m} nodes")
    path = np.zeros(n, np.int32)
    d = library().find_minimal_spread_and_path(n, m, w, path)
    if d < 0:
        raise ValueError("no feasible path")
    return float(d), path.tolist()
