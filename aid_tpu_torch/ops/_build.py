"""Build and load the port's CUDA kernels.

Every ``aid_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds, not
minutes. The library is named by a hash of the sources and flags and lives in
``build/aid_tpu_torch/`` at the repository root (git-ignored): a change to
any source rebuilds it, an unchanged tree reuses it.

Nothing here runs at import time. The first kernel launch calls
:func:`library`, which builds if needed; a failed build raises with nvcc's
stderr, and there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aid_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # lazy: CPU-only installs never need it

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed to build the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libaid_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the hashed library is missing; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    # ptxas -v: registers, shared memory and spills of every kernel
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """ptxas's resource lines from the build of the current sources ('' if none)."""
    log = library_path().with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, with every
    entry point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.aid_flash_attn_bf16.argtypes = [
        vp, vp, vp,          # q, k, v
        vp, vp, vp, vp,      # k_begin, v_begin, k_end, v_end
        vp,                  # out
        vp, vp,              # coef (f32, B), skip (int32, B)
        i64p,                # dims + strides, see flash_interpolated_attention.cu
        ctypes.c_float,      # softmax scale
        i32, i32,            # has_own, n_sets
        vp,                  # cudaStream_t
    ]
    lib.aid_flash_attn_bf16.restype = ctypes.c_int
    lib.aid_conv3x3_bf16.argtypes = [
        vp, vp, vp, vp,      # x (NHWC), w (Cout,3,3,Cin), bias (f32), out (NHWC)
        i32, i32, i32, i32, i32,  # B, H, W, Cin, Cout
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_bf16.restype = ctypes.c_int
    lib.aid_conv3x3_gnsilu_bf16.argtypes = [
        vp, vp, vp, vp,      # x (NHWC), w (Cout,3,3,Cin), bias (f32), out (NHWC)
        vp, vp,              # GN+SiLU scale, shift: (B, Cin) f32
        i32, i32, i32, i32, i32,  # B, H, W, Cin, Cout
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_gnsilu_bf16.restype = ctypes.c_int
    lib.aid_flash_attn_f32_d512.argtypes = [
        vp, vp, vp, vp,      # q, k, v, out (f32)
        i64p,                # dims + strides, see flash_attention_f32_d512.cu
        ctypes.c_float,      # softmax scale
        vp,                  # cudaStream_t
    ]
    lib.aid_flash_attn_f32_d512.restype = ctypes.c_int
    lib.aid_cuda_error_string.argtypes = [i32]
    lib.aid_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().aid_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
