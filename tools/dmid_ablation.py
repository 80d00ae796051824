"""What the D=161-512 endpoint kernels' time goes to, on an NVIDIA GPU: ablations timed in turns.

    python3 tools/dmid_ablation.py [--reps 5] [--dtype bf16|f16|f32]

There is no ``ncu`` on the machine with the card, so this probe takes parts
out of ``csrc/flash_attention_dmid.cu`` (bf16, f16) or
``csrc/flash_attention_dmid_f32.cu`` (f32) and times what is left. Each
variant is the shipped source with one part removed or one design choice
changed by a text edit (each edit must match the source as often as it says,
or the probe stops):

  shipped      the source as it is
  no_loads     the producer's TMA copies only in each ring slot's first round
               (later rounds arrive on the slot's barrier: stale tiles)
  no_qk        no Q K^T products (the scores stay unset)
  no_pv        no P V products
  no_softmax   no exponentials (P is the raw scores)
  bf16 and f16 only:
  no_turns     the rows layout's two warpgroups issue their products when
               ready, without taking turns on named barriers
  bk32         the rows layout at 5 chunks (D = 320) on 32-key tiles (three
               slots a ring) instead of 48
  one_wg       one consumer warpgroup a block in the rows layout at every
               grid (64-row blocks)
  f32 only:
  no_exchange  no barrier before the partial scores are read from the other
               warpgroup
  no_klo       K's lo in bf16 not made (the bf16 pass reads what is there)
  bk16         16-key tiles at every head dim (the 32-key tile's gain)

Every variant but the shipped one (and bk32, no_turns, one_wg, bk16, which
change the schedule and not the result) computes a wrong result on purpose:
its error against the plain version is printed, not checked; the shipped one
must stay within the dtype's ``chip_smoke`` tolerance. Each is compiled by
nvcc into its own library under ``build/dmid_ablation/`` (one nvcc per
variant, all at once) and called through the same C entry as the port, on
operands ``ops.flash_attention.kernel_operands`` lays out, at phase 21's
shapes (fused_outer and pure_inner at (7,1,4096,320), fused_outer at
(7,2,1024,320), whose grid takes one warpgroup a block) and at (7,1,4096,384)
(the split layout in bf16 and f16, 16-key tiles in f32); 7 frames with the
coef-0/1 end rows as skip rows. Times are CUDA-event means of --reps
launches, the variants alternated (in order, then reversed); a variant's time
saved against the shipped kernel is what the removed part costs, up to what
the rest hides. Prints the card's name and power limit first and one JSON
object last. Needs a CUDA device and nvcc; imports nothing of JAX.
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

CSRC = ROOT / "aid_tpu_torch" / "csrc"
OUT = ROOT / "build" / "dmid_ablation"

# variant -> [(text in the shipped source, its replacement, times it occurs)]
EDITS16 = {
    "no_loads": [("      mbar_expect_tx(bar, BOXES * BK * 128);\n",
                  "      if (it >= STAGES) {\n        mbar_arrive(bar);\n        continue;\n      }\n"
                  "      mbar_expect_tx(bar, BOXES * BK * 128);\n", 1)],
    "no_qk": [("      wgmma_ss<T>(s, ", "      if (0) wgmma_ss<T>(s, ", 2)],
    "no_pv": [("wgmma_rs192<T, 0>(o, ", "if (0) wgmma_rs192<T, 0>(o, ", 2),
              ("wgmma_rs256<T, 0>(o, ", "if (0) wgmma_rs256<T, 0>(o, ", 2),
              ("if constexpr (NC == 5) wgmma_rs64<T, 128>(o, ", "if constexpr (NC == 5) if (0) wgmma_rs64<T, 128>(o, ",
               1)],
    "no_softmax": [("const float p0 = ex2(fmaf(s[4 * j], p.scale_log2, -ms0)), p1 = ex2(fmaf(s[4 * j + 1], "
                    "p.scale_log2, -ms0));", "const float p0 = s[4 * j], p1 = s[4 * j + 1];", 2),
                   ("const float p2 = ex2(fmaf(s[4 * j + 2], p.scale_log2, -ms1)), p3 = ex2(fmaf(s[4 * j + 3], "
                    "p.scale_log2, -ms1));", "const float p2 = s[4 * j + 2], p3 = s[4 * j + 3];", 2)],
    "no_turns": [("constexpr bool kTurns = true;", "constexpr bool kTurns = false;", 1)],
    "bk32": [("static constexpr int kBK = NC == 5 ? 48 : 64;", "static constexpr int kBK = NC == 5 ? 32 : 64;", 1)],
    "one_wg": [("constexpr int kOneWave = 132;", "constexpr int kOneWave = 1 << 30;", 1)],
}
EDITS32 = {
    "no_loads": [("        mbar_expect_tx(kfull, p.C * BK * 128);\n",
                  "        if (j > 0) {\n          mbar_arrive(kfull);\n          mbar_wait(vempty, (j - 1) & 1);\n"
                  "          mbar_arrive(vfull);\n          continue;\n        }\n"
                  "        mbar_expect_tx(kfull, p.C * BK * 128);\n", 1)],
    "no_qk": [("wgmma_tf32(s, qhi[kk], kd, ", "if (0) wgmma_tf32(s, qhi[kk], kd, ", 2),
              ("wgmma_tf32(sm, qlo[kk], kd, ", "if (0) wgmma_tf32(sm, qlo[kk], kd, ", 2),
              ("wgmma_bf16_rs(sm, qbf[i], ", "if (0) wgmma_bf16_rs(sm, qbf[i], ", 2)],
    "no_pv": [("wgmma_tf32(acc, vhi[", "if (0) wgmma_tf32(acc, vhi[", 1),
              ("wgmma_bf16_rs(acc, vpk[", "if (0) wgmma_bf16_rs(acc, vpk[", 1)],
    "no_softmax": [("pv[i] = exp2f(fmaf(s[i], sl2, (i & 2) ? -ms1 : -ms0));", "pv[i] = s[i];", 1)],
    "no_exchange": [("        asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(128 * kWG) : \"memory\");\n#pragma unroll\n"
                     "        for (int i = 0; i < NK; ++i) s[i] += theirs[i * 128];\n",
                     "#pragma unroll\n        for (int i = 0; i < NK; ++i) s[i] += theirs[i * 128];\n", 1)],
    "no_klo": [("      make_klo<BK>(gbase + ly.k, gbase + ly.klo, cs, nc, ct);\n", "", 1)],
    "bk16": [("constexpr int kWideTileChunks = 10;", "constexpr int kWideTileChunks = 0;", 1)],
}
# variants that change the schedule, not the result: held to the tolerance like the shipped one
EXACT = {"shipped", "no_turns", "bk32", "one_wg", "bk16"}
# (mode, heads, tokens, head dim)
SHAPES = [("fused_outer", 1, 4096, 320), ("pure_inner", 1, 4096, 320), ("fused_outer", 2, 1024, 320),
          ("fused_outer", 1, 4096, 384)]


def variants(dtype: str) -> dict:
    """{name: source text}: the shipped source of ``dtype``'s kernel and each ablation of it."""
    src = (CSRC / ("flash_attention_dmid_f32.cu" if dtype == "f32" else "flash_attention_dmid.cu")).read_text()
    out = {"shipped": src}
    for name, edits in (EDITS32 if dtype == "f32" else EDITS16).items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"{name}: the edit {old.strip()[:60]!r} matches {text.count(old)} times, not {count}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, dtype: str) -> dict:
    """Compile each variant into build/dmid_ablation/<dtype>_<name>.so (nvcc
    at once); {name: the C entry of ``dtype``}, with ptxas's spill lines
    printed."""
    from aid_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{dtype}_{name}.cu"
        src.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(OUT / f"{dtype}_{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    entries = {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        spills = sorted({line.strip() for line in err.splitlines() if "spill stores" in line})
        print(f"{name:12s} ptxas: {' | '.join(spills)}", flush=True)
        fn = getattr(ctypes.CDLL(str(OUT / f"{dtype}_{name}.so")), f"aid_flash_attn_{dtype}_dmid")
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
    f32 = args.dtype == "f32"
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[args.dtype]
    tol = {"bf16": chip_smoke.ATTN_TOL, "f32": chip_smoke.F32_ATTN_TOL}.get(args.dtype) or chip_smoke.F16_ATTN_TOL
    passes = {"elem": 4, **chip_smoke.F32_D512_PASSES} if f32 else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    stream = torch.cuda.current_stream().cuda_stream
    B = 7
    coef = torch.linspace(0.0, 1.0, B, device=dev)
    kw = {"skip_endpoints": skip_mask(coef, B)}
    result = {}
    for mode, H, S, D in SHAPES:
        q, k, v = (torch.randn((B, S, H * D), generator=gen, device=dev).to(dtype).view(B, S, H, D).transpose(1, 2)
                   for _ in range(3))
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
            if name in EXACT and not errs[name] <= tol:
                raise SystemExit(f"{mode} (7,{H},{S},{D}): the {name} kernel disagrees with the plain version "
                                 f"({errs[name]:.3e})")
        times = {name: [] for name in entries}
        for name in list(entries) + list(entries)[::-1]:
            times[name].append(cuda_ms(lambda: launch(entries[name]), args.reps))
        bound_ms, _ = attention_bound(mode, B, H, S, S, D, skip_rows=int(kw["skip_endpoints"].sum()), **passes)
        base = min(times["shipped"])
        for name, ts in times.items():
            print(f"{args.dtype} {mode} (7,{H},{S},{D}) {name:11s} {min(ts):.4f}-{max(ts):.4f} ms  saves "
                  f"{base - min(ts):+.4f} ms  (bound {bound_ms:.4f})  max_abs_err/max|ref| {errs[name]:.3e}",
                  flush=True)
            result[f"{args.dtype} {name} {mode} (7,{H},{S},{D})"] = ts
        del q, k, v, want, ops
    print(f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
