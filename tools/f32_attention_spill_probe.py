"""Where the f32 D=512 attention kernel spills registers, and what the spills cost, on an NVIDIA GPU.

    python3 tools/f32_attention_spill_probe.py [--reps 5]

ptxas reports spill stores and loads for ``csrc/flash_attention_f32_d512.cu``
(chip_smoke.py's build phase prints them). This probe reads two things:

  where    ``cuobjdump -sass`` of the built library: each local-memory store
           (STL) and load (LDL) of the kernel with its loop depth, i.e. the
           number of backward branches whose span holds it (depth 0 runs
           once a block; the key-tile loop holds every product, so depth 1
           or more runs at least once per 16-key tile)
  cost     a variant of the source in which the small (hi*lo + lo*hi) terms
           of Q K^T's even and odd k steps share one accumulator chain
           instead of two: 16 fewer registers a thread, the same 3xTF32
           arithmetic summed in another order. It is compiled with the same
           flags, and its ptxas spills and its time stand beside the
           shipped kernel's, both checked against the plain version, at
           (1,1,16384,512) and (7,1,4096,512)

Times are CUDA-event means of --reps launches, the two builds alternated
(shipped, variant, variant, shipped). Prints the card's name and power limit
first and one JSON object last. Needs a CUDA device and nvcc; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KERNEL = "flash_f32_d512_kernel"
# the variant: one chain for the small terms of both k parities
VARIANT_EDITS = (
    ("float big[kQKM][2][4] = {}, small[2][kQKM][2][4] = {};",
     "float big[kQKM][2][4] = {}, small[1][kQKM][2][4] = {};"),
    ("mma_tf32(small[e][mi][nj], alo[mi]", "mma_tf32(small[0][mi][nj], alo[mi]"),
    ("mma_tf32(small[e][mi][nj], ahi[mi]", "mma_tf32(small[0][mi][nj], ahi[mi]"),
    ("big[mi][nj][i] + (small[0][mi][nj][i] + small[1][mi][nj][i])", "big[mi][nj][i] + small[0][mi][nj][i]"),
)
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_spills(lib: Path, cuda_home: Path) -> dict:
    """The kernel's STL/LDL instructions by loop depth, from cuobjdump -sass."""
    out = subprocess.run([str(cuda_home / "bin" / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    return parse_sass(out)


def parse_sass(out: str) -> dict:
    """The STL/LDL count of KERNEL's section of a SASS listing, by loop depth."""
    sections = re.split(r"\n\s*Function : ", out)
    body = next(s for s in sections if KERNEL in s.splitlines()[0])
    instrs, labels = [], {}
    for line in body.splitlines():
        lab = _LABEL.match(line)
        if lab:
            labels[lab.group(1)] = len(instrs)
            continue
        m = _INSTR.search(line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            instrs.append((int(m.group(1), 16), text))
    index_of = {addr: i for i, (addr, _) in enumerate(instrs)}
    loops = []  # (first, last) instruction index of each backward branch's span
    for i, (_, text) in enumerate(instrs):
        if not text.startswith("BRA"):
            continue
        target = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", text)
        if target is None:
            continue
        t = target.group(1)
        j = labels.get(t) if t.startswith(".L") else index_of.get(int(t, 16))
        if j is not None and j <= i:
            loops.append((j, i))
    by_depth = {}
    for i, (_, text) in enumerate(instrs):
        op = text.split()[0]
        if op.startswith(("STL", "LDL")):
            depth = sum(lo <= i <= hi for lo, hi in loops)
            key = f"{op.split('.')[0]} depth {depth}"
            by_depth[key] = by_depth.get(key, 0) + 1
    hmma = [i for i, (_, text) in enumerate(instrs) if text.startswith("HMMA")]
    return {"instructions": len(instrs), "hmma": len(hmma), "loops": len(loops), "spills": by_depth}


def build_variant(src: Path, out_dir: Path, nvcc: str, flags) -> tuple:
    """Compile the variant into its own library; returns (path, ptxas lines)."""
    text = src.read_text()
    for old, new in VARIANT_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit does not apply to {src.name}: {old!r}")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    vsrc, vlib = out_dir / "flash_f32_d512_variant.cu", out_dir / "libflash_f32_d512_variant.so"
    vsrc.write_text(text)
    # -I: the variant includes csrc/tf32_mma.cuh from the source's own directory
    proc = subprocess.run([nvcc, *flags, "-I", str(src.parent), "-shared", "-o", str(vlib), str(vsrc)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant:\n{proc.stderr}")
    return vlib, [ln.strip() for ln in proc.stderr.splitlines() if "spill" in ln or "Used" in ln]


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p
    lib.aid_flash_attn_f32_d512.argtypes = [vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp]
    lib.aid_flash_attn_f32_d512.restype = ctypes.c_int
    return lib


def launcher(lib, q, k, v):
    """A no-argument launch of ``lib``'s f32 kernel on (q, k, v); returns (fn, out)."""
    import torch

    out = torch.empty_like(q)
    dims = list(q.shape[:3]) + [k.shape[2]]
    for x in (q, k, v, out):
        dims += [x.stride(0), x.stride(1), x.stride(2)]
    dims_c = (ctypes.c_longlong * len(dims))(*dims)
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        code = lib.aid_flash_attn_f32_d512(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims_c,
                                           q.shape[-1] ** -0.5, stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    return fn, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    from aid_tpu_torch.ops import _build
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain
    from chip_smoke import cuda_ms

    if not torch.cuda.is_available() or CUDA_HOME is None:
        print("needs a CUDA device and the CUDA toolkit", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version stays f32

    shipped_path = _build.build()
    shipped_ptxas = [ln.strip() for ln in _build.ptxas_report().splitlines()
                     if ("spill" in ln or "Used" in ln)]
    where = sass_spills(shipped_path, Path(CUDA_HOME))
    print(f"shipped kernel, SASS: {where}", flush=True)
    vlib, variant_ptxas = build_variant(_build.CSRC / "flash_attention_f32_d512.cu", _build.BUILD_DIR / "probe",
                                        str(Path(CUDA_HOME) / "bin" / "nvcc"), _build.NVCC_FLAGS)
    variant_where = sass_spills(vlib, Path(CUDA_HOME))
    print(f"variant (one small-term chain): ptxas {variant_ptxas}; SASS: {variant_where}", flush=True)
    libs = {"shipped": _build.library(), "variant": bind(vlib)}

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {}
    for n, S in ((1, 16384), (7, 4096)):
        q, k, v = (torch.randn((n, 1, S, 512), generator=gen, device="cuda") for _ in range(3))
        want = flash_interpolated_attention_plain(q, k, v)
        ref = want.abs().max().item()
        row = {}
        runs = {name: launcher(lib, q, k, v) for name, lib in libs.items()}
        for name, (fn, out) in runs.items():
            fn()
            torch.cuda.synchronize()
            row[f"{name}_rel_err"] = (out - want).abs().max().item() / ref
        times = {name: [] for name in runs}
        for name in ("shipped", "variant", "variant", "shipped"):
            times[name].append(cuda_ms(runs[name][0], args.reps))
        for name, ts in times.items():
            row[f"{name}_ms"] = sum(ts) / len(ts)
        print(f"({n},1,{S},512): shipped {row['shipped_ms']:.3f} ms (rel err {row['shipped_rel_err']:.2e}), "
              f"variant {row['variant_ms']:.3f} ms (rel err {row['variant_rel_err']:.2e})", flush=True)
        shapes[f"({n},1,{S},512)"] = row
        del q, k, v, want, runs
    print(json.dumps({"card": card, "shipped": {"ptxas": shipped_ptxas, "sass": where},
                      "variant": {"ptxas": variant_ptxas, "sass": variant_where}, "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
