"""Build and load the port's CUDA kernels.

Every ``aid_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds, not minutes. The library is named by a hash of the sources, the
``csrc/*.cuh`` headers they include and the flags, and lives in
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    for src in sources() + sorted(CSRC.glob("*.cuh")):  # the headers the sources include, too
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
    nvcc, tag = _nvcc(), os.getpid()
    srcs = sources()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    # one nvcc per source, all running at once: the build lasts as long as
    # the slowest file, not the sum
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{tag}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): {' '.join(link)}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    # ptxas -v: registers, shared memory and spills of every kernel
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
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
        vp, vp,              # coef (f32, B) or null, skip (bool, B) or null
        i64p,                # dims + strides, see flash_interpolated_attention.cu
        ctypes.c_float,      # softmax scale
        i32, i32,            # has_own, n_sets
        vp,                  # cudaStream_t
    ]
    lib.aid_flash_attn_bf16.restype = ctypes.c_int
    # the same C signature over f16 operands (flash_interpolated_attention.cu),
    # over f32 ones (flash_interpolated_attention_f32.cu),
    # and over bf16 / f16 ones in the short-stream kernel (flash_attention_onepass.cu)
    # and the mid-length stream kernel (flash_attention_midstream.cu)
    for name in ("aid_flash_attn_f16", "aid_flash_attn_f32", "aid_flash_attn_bf16_onepass",
                 "aid_flash_attn_f16_onepass", "aid_flash_attn_bf16_midstream", "aid_flash_attn_f16_midstream"):
        getattr(lib, name).argtypes = lib.aid_flash_attn_bf16.argtypes
        getattr(lib, name).restype = ctypes.c_int
    # the endpoint modes and self mode at D = 161-512 (flash_attention_dmid.cu, flash_attention_dmid_f32.cu):
    # the same signature with the outer modes' f32 workspace (or null) after skip
    # and the wide entries past 512 (flash_attention_dwide.cu), every mode, the same signature
    for name in ("aid_flash_attn_bf16_dmid", "aid_flash_attn_f16_dmid", "aid_flash_attn_f32_dmid",
                 "aid_flash_attn_bf16_dwide", "aid_flash_attn_f16_dwide", "aid_flash_attn_f32_dwide"):
        getattr(lib, name).argtypes = [*lib.aid_flash_attn_bf16.argtypes[:10], vp, *lib.aid_flash_attn_bf16.argtypes[10:]]
        getattr(lib, name).restype = ctypes.c_int
    # the static-shift instances (flash_interpolated_attention_static.cu, _f32_static.cu,
    # flash_attention_midstream_static.cu): the D <= 160 signature with the shift and the
    # clip (f32, times log2(e)) after the scale
    for name in ("aid_flash_attn_bf16_static", "aid_flash_attn_f32_static", "aid_flash_attn_bf16_midstream_static"):
        getattr(lib, name).argtypes = [*lib.aid_flash_attn_bf16.argtypes[:12], ctypes.c_float, ctypes.c_float,
                                       *lib.aid_flash_attn_bf16.argtypes[12:]]
        getattr(lib, name).restype = ctypes.c_int
    lib.aid_conv3x3_bf16.argtypes = [
        vp, vp, vp, vp,      # x (B,Cin/8,H,W,8), w (tiled, see conv.py), bias (f32), out (NHWC)
        i32, i32, i32, i32, i32,  # B, H, W, Cin, Cout
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_bf16.restype = ctypes.c_int
    lib.aid_conv3x3_f16.argtypes = lib.aid_conv3x3_bf16.argtypes  # the same over f16 x, w and out
    lib.aid_conv3x3_f16.restype = ctypes.c_int
    lib.aid_conv3x3_gnsilu_bf16.argtypes = [
        vp, vp, vp, vp,      # x (B,Cin/8,H,W,8), w (tiled, see conv.py), bias (f32), out (NHWC)
        vp, vp,              # GN+SiLU scale, shift: (B, Cin) f32
        i32, i32, i32, i32, i32,  # B, H, W, Cin, Cout
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_gnsilu_bf16.restype = ctypes.c_int
    lib.aid_conv3x3_gnsilu_f16.argtypes = lib.aid_conv3x3_gnsilu_bf16.argtypes
    lib.aid_conv3x3_gnsilu_f16.restype = ctypes.c_int
    lib.aid_conv3x3_blocked_bf16.argtypes = [
        vp, vp,              # x (B, C, H, W) at any strides, xb (B, C/8, H, W, 8)
        i32, i32, i32, i32,  # B, C, H, W
        i64p,                # x's element strides (b, c, h, w)
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_blocked_bf16.restype = ctypes.c_int
    lib.aid_conv3x3_blocked_f16.argtypes = lib.aid_conv3x3_blocked_bf16.argtypes
    lib.aid_conv3x3_blocked_f16.restype = ctypes.c_int
    lib.aid_conv3x3_f32.argtypes = [
        vp, vp, vp, vp,      # x (B,Cin/4,H,W,4), w (tiled, see conv.py), bias, out (NHWC), all f32
        i32, i32, i32, i32, i32,  # B, H, W, Cin, Cout
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_f32.restype = ctypes.c_int
    lib.aid_conv3x3_blocked_f32.argtypes = [
        vp, vp,              # x (B, C, H, W) at any strides, xb (B, C/4, H, W, 4), f32
        i32, i32, i32, i32,  # B, C, H, W
        i64p,                # x's element strides (b, c, h, w)
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_blocked_f32.restype = ctypes.c_int
    lib.aid_conv3x3_gnsilu_f32.argtypes = [
        vp, vp,              # x (B, C, H, W) at any strides, xb = silu(x * scale + shift) as (B, C/4, H, W, 4), f32
        vp, vp,              # scale, shift (B, C) f32
        i32, i32, i32, i32,  # B, C, H, W
        i64p,                # x's element strides (b, c, h, w)
        vp,                  # cudaStream_t
    ]
    lib.aid_conv3x3_gnsilu_f32.restype = ctypes.c_int
    lib.aid_flash_attn_f32_d512.argtypes = [
        vp, vp, vp, vp,      # q, k, v, out (f32)
        i64p,                # dims + strides, see flash_attention_f32_d512.cu
        ctypes.c_float,      # softmax scale
        vp,                  # cudaStream_t
    ]
    lib.aid_flash_attn_f32_d512.restype = ctypes.c_int
    lib.aid_flash_attn_bf16_d512.argtypes = [
        vp, vp, vp, vp,      # q, k, v, out (bf16)
        i64p,                # dims + strides, see flash_attention_bf16_d512.cu
        ctypes.c_float,      # softmax scale
        vp,                  # cudaStream_t
    ]
    lib.aid_flash_attn_bf16_d512.restype = ctypes.c_int
    lib.aid_flash_attn_f16_d512.argtypes = lib.aid_flash_attn_bf16_d512.argtypes  # the same over f16
    lib.aid_flash_attn_f16_d512.restype = ctypes.c_int
    # the static-shift instances of the D=512 self kernels (flash_attention_{f32,bf16}_d512_static.cu),
    # of the D=161-512 ones (flash_attention_dmid_static.cu, flash_attention_dmid_f32_static.cu) and of
    # the wide ones (flash_attention_dwide_static.cu): their exact entry's signature with the shift and
    # the clip (f32, times log2(e)) after the scale
    for name in ("aid_flash_attn_f32_d512_static", "aid_flash_attn_bf16_d512_static"):
        getattr(lib, name).argtypes = [*lib.aid_flash_attn_bf16_d512.argtypes[:6], ctypes.c_float, ctypes.c_float,
                                       *lib.aid_flash_attn_bf16_d512.argtypes[6:]]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("aid_flash_attn_bf16_dmid_static", "aid_flash_attn_f32_dmid_static",
                 "aid_flash_attn_bf16_dwide_static", "aid_flash_attn_f32_dwide_static"):
        getattr(lib, name).argtypes = [*lib.aid_flash_attn_bf16_dmid.argtypes[:13], ctypes.c_float, ctypes.c_float,
                                       *lib.aid_flash_attn_bf16_dmid.argtypes[13:]]
        getattr(lib, name).restype = ctypes.c_int
    lib.aid_cuda_error_string.argtypes = [i32]
    lib.aid_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().aid_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
