"""What the wide attention kernel's time goes to, on an NVIDIA GPU: ablations timed in turns.

    python3 tools/dwide_ablation.py [--reps 5] [--dtype bf16|f16|f32]

There is no ``ncu`` on the machine with the card, so this probe takes parts
out of ``csrc/flash_attention_dwide.cu`` and times what is left. Each
variant is the shipped source with one part removed by a text edit (each
edit must match the source exactly once, or the probe stops). Every
element type has the same variants (the products' edits follow its code):

  shipped      the source as it is
  no_loads     the producer's TMA copies only in each ring slot's first round
               (later rounds arrive on the slot's barrier: stale tiles)
  no_qk        no Q K^T products (the partial scores stay unset)
  no_exchange  no barrier before the partial scores are read from the other
               warpgroup (the scores are read as they are)
  no_softmax   no exponentials and no barrier before the warps' column
               maxima are read
  no_pv        no P V products (the fold of each chunk into O stays)
  no_combine   no combine step after a split launch (nothing is written)
  no_split     the key stream never split (one block a row block)

Every variant but the shipped one computes a wrong result on purpose: its
error against the plain version is printed, not checked; the shipped one
must stay within the dtype's ``chip_smoke`` tolerance. Each is compiled by
nvcc into its own library under ``build/dwide_ablation/`` (one nvcc per
variant, all at once) and called through the same C entry as the port, on
operands ``ops.flash_attention.kernel_operands`` lays out, at phase 22's
shapes (self and fused_outer at (7,1,1024,640) and (7,1,256,1280),
fused_outer at the mid block's (7,1,64,1280), whose grid is split) and at
self (2,1,512,2048); 7 frames with the coef-0/1 end rows as skip rows, or 2
with none. Times are CUDA-event means of --reps launches, the variants
alternated (in order, then reversed); a variant's time saved against the
shipped kernel is what the removed part costs, up to what the rest hides.
Prints the card's name and power limit first and one JSON object last.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = ROOT / "aid_tpu_torch" / "csrc" / "flash_attention_dwide.cu"
OUT = ROOT / "build" / "dwide_ablation"

# variant -> [(text in the shipped source, its replacement)]; the products'
# edits differ by element type (bf16 and f16: both operands in shared memory;
# f32: 3xTF32 with A from registers)
EDITS = {
    "no_loads": [("            mbar_expect_tx(full + 8 * slot, W::kSlotBytes);\n",
                  "            if (round > 0) mbar_arrive(full + 8 * slot);\n"
                  "            else mbar_expect_tx(full + 8 * slot, W::kSlotBytes);\n"),
                 ("            for (int x = 0; x < kWG * CB; ++x) {  // warpgroup",
                  "            for (int x = 0; x < (round > 0 ? 0 : kWG * CB); ++x) {  // warpgroup")],
    "no_qk": {"16": [("              wgmma_ss<T, 0>(s[mb], ", "              if (0) wgmma_ss<T, 0>(s[mb], ")],
              "f32": [("            wgmma_tf32(s[0], fhi[x & 1][kk], qd, x + kk > 0);\n"
                       "            wgmma_tf32(sm, flo[x & 1][kk], qd, x + kk > 0);\n"
                       "            wgmma_tf32(sm, fhi[x & 1][kk], qld, 1);\n", "")]},
    "no_exchange": [("        named_barrier(1, 128 * kWG);\n#pragma unroll\n        for (int i = 0; i < NA; ++i) sc[i] += "
                     "theirs[i * 128];\n",
                     "#pragma unroll\n        for (int i = 0; i < NA; ++i) sc[i] += theirs[i * 128];\n")],
    "no_softmax": [("      named_barrier(1, 128 * kWG);\n      float alpha[NK], ms[NK];\n", "      float alpha[NK], ms[NK];\n"),
                   ("pv[i] = exp2_of<T>(fmaf(sc[i], sl2, -ms[2 * (i >> 2) + (i & 1)]));", "pv[i] = sc[i];")],
    "no_pv": {"16": [("            wgmma_ss<T, 1>(acc[c2 & 1], ", "            if (0) wgmma_ss<T, 1>(acc[c2 & 1], ")],
              "f32": [("            wgmma_tf32(acc[c2 & 1], flo[x & 1][kk], desc_sw128(pd), kh + kk > 0);\n"
                       "            wgmma_tf32(acc[c2 & 1], fhi[x & 1][kk], desc_sw128(pd + W::kPBoxes * W::kQBoxBytes), 1);\n"
                       "            wgmma_tf32(acc[c2 & 1], fhi[x & 1][kk], desc_sw128(pd), 1);\n", "")]},
    "no_combine": [("  if (err != cudaSuccess || p.splits == 1) return (int)err;\n", "  return (int)err;\n")],
    "no_split": [("constexpr int kSplitBlocks = 132;", "constexpr int kSplitBlocks = 1;")],
}
# (mode, frames, tokens, head dim)
SHAPES = [("self", 7, 1024, 640), ("fused_outer", 7, 1024, 640), ("self", 7, 256, 1280), ("fused_outer", 7, 256, 1280),
          ("fused_outer", 7, 64, 1280), ("self", 2, 512, 2048)]


def variants(dtype: str) -> dict:
    """{name: source text}: the shipped source and each ablation of it for
    the design of ``dtype``."""
    src = SRC.read_text()
    out = {"shipped": src}
    for name, edits in EDITS.items():
        if isinstance(edits, dict):
            edits = edits["f32" if dtype == "f32" else "16"]
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit {old.strip()[:60]!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, dtype: str) -> dict:
    """Compile each variant into build/dwide_ablation/<name>.so (nvcc at
    once); {name: the C entry of ``dtype``}, with ptxas's resource lines printed."""
    from aid_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(SRC.parent), "-o", str(OUT / f"{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    entries = {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        res = [line.strip() for line in err.splitlines() if "spill" in line or "Used" in line]
        print(f"{name:12s} ptxas: {' | '.join(res[-6:])}", flush=True)
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), f"aid_flash_attn_{dtype}_dwide")
        fn.argtypes = [vp] * 11 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", choices=("bf16", "f16", "f32"), default="bf16")
    args = ap.parse_args(argv)

    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain, kernel_operands
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms, phase_device

    card = phase_device()  # also sets full f32 matmuls (TF32 off) for the plain version
    entries = build(variants(args.dtype), args.dtype)
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[args.dtype]
    tol = {"bf16": chip_smoke.ATTN_TOL, "f32": chip_smoke.F32_ATTN_TOL}.get(args.dtype) or chip_smoke.F16_ATTN_TOL
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for mode, B, S, D in SHAPES:
        coef = torch.linspace(0.0, 1.0, B, device=dev) if B == 7 else torch.tensor([0.3, 0.6], device=dev)
        q, k, v = (torch.randn((B, 1, S, D), generator=gen, device=dev).to(dtype) for _ in range(3))
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, B)}
        ops = kernel_operands(q, k, v, coef, mode, **kw)
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        args_c = (*(x.data_ptr() for x in ops["tensors"]),
                  *(None if x is None else x.data_ptr() for x in (ops["coef"], ops["skip"], ops["work"])),
                  (ctypes.c_longlong * len(ops["dims"]))(*ops["dims"]), float(ops["scale"]), ops["has_own"],
                  ops["n_sets"], stream)

        def launch(fn):
            code = fn(*args_c)
            if code != 0:
                raise SystemExit(f"launch failed: CUDA error {code}")

        errs = {}
        for name, fn in entries.items():
            launch(fn)
            torch.cuda.synchronize()
            errs[name] = ((ops["out"].float() - want.float()).abs().max() / want.float().abs().max()).item()
        if not errs["shipped"] <= tol:
            raise SystemExit(f"{mode} ({B},1,{S},{D}): the shipped kernel disagrees with the plain version "
                             f"({errs['shipped']:.3e})")
        times = {name: [] for name in entries}
        for name in list(entries) + list(entries)[::-1]:
            times[name].append(cuda_ms(lambda: launch(entries[name]), args.reps))
        skip_rows = int(kw["skip_endpoints"].sum()) if kw else 0
        bound_ms, _ = attention_bound(mode, B, 1, S, S, D, skip_rows=skip_rows, elem=4 if dtype == torch.float32
                                      else 2, tf32_passes=3 if dtype == torch.float32 else None)
        base = min(times["shipped"])
        for name, ts in times.items():
            print(f"{args.dtype} {mode} ({B},1,{S},{D}) {name:11s} {min(ts):.4f}-{max(ts):.4f} ms  saves "
                  f"{base - min(ts):+.4f} ms  (bound {bound_ms:.4f})  max_abs_err/max|ref| {errs[name]:.3e}",
                  flush=True)
            result[f"{args.dtype} {name} {mode} ({B},1,{S},{D})"] = ts
        del q, k, v, want, ops
    print(f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
