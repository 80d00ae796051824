"""What the short-stream attention kernel's time goes to, on an NVIDIA GPU: ablations timed in turns.

    python3 tools/onepass_ablation.py [--reps 20] [--dtype bf16|f16]

There is no ``ncu`` on the machine with the card, so this probe takes parts
out of ``csrc/flash_attention_onepass.cu`` and times what is left. Each
variant is the shipped source with one part removed or one choice changed by
a text edit (each edit must match the source as often as it says, or the
probe stops):

  shipped      the source as it is
  no_qk        no Q K^T products (the scores stay unset)
  no_softmax   no exponentials (P is the raw scores)
  no_pv        no P V products
  no_store     no TMA store of the output
  one_wg       one consumer warpgroup a block at every shape
  two_wg       at most two consumer warpgroups a block at every head dim
  ring_up      a Q/O buffer more a warpgroup (four up to D = 64, three above)
  ring_down    two Q/O buffers a warpgroup at every head dim
  two_waves    twice the blocks the SMs hold at once (runs half as long)

Every variant but shipped, one_wg, two_wg, ring_up, ring_down and two_waves
(which change the schedule, not the result) computes a wrong result on
purpose: its error against the plain version is printed, not checked; those
six must stay within the dtype's
``chip_smoke`` tolerance. Each is compiled by nvcc into its own library under
``build/onepass_ablation/`` (one nvcc per variant, all at once) and called
through the same C entry as the port, on operands
``ops.flash_attention.kernel_operands`` lays out for the short-stream entry,
at the SDXL 77-key cross calls (self and fused_outer at (7,10,4096,77), D =
64), SD 1.5's IP call (fused_outer at (7,8,4096,16), D = 40) and its D = 80
cross call (self at (7,8,1024,77)); 7 frames with the coef-0/1 end rows as
skip rows. Times are CUDA-event means of --reps launches, the variants
alternated (in order, then reversed); a variant's time saved against the
shipped kernel is what the removed part costs, up to what the rest hides.
ptxas's register and spill lines of each variant, and any line of the
shipped build that names wgmma, are printed. Prints the card's name and power
limit first and one JSON object last. Needs a CUDA device and nvcc; imports
nothing of JAX.
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
OUT = ROOT / "build" / "onepass_ablation"

# variant -> [(text in the shipped source, its replacement, times it occurs)]
EDITS = {
    "no_qk": [("      wgmma_ss<T>(s, ", "      if (0) wgmma_ss<T>(s, ", 1)],
    "no_softmax": [("const float x = ex2(fmaf(s[8 * j + e], p.scale_log2, -((e & 2) ? m1 : m0)));",
                    "const float x = s[8 * j + e];", 1)],
    "no_pv": [("for (int j = 0; j < KT; ++j) wgmma_rs<T>(o, ", "for (int j = 0; j < KT; ++j) if (0) wgmma_rs<T>(o, ", 1)],
    "no_store": [("for (int c = 0; c < C::kChunks; ++c) tma_store(", "for (int c = 0; c < 0; ++c) tma_store(", 1)],
    "one_wg": [("  for (int w = 1; w <= C::kMaxWG; ++w) {\n    const int t = ",
                "  for (int w = 1; w <= 1; ++w) {\n    const int t = ", 1)],
    "two_wg": [("constexpr int kWGNarrow = 3, kWGWide = 2;", "constexpr int kWGNarrow = 2, kWGWide = 2;", 1)],
    "ring_up": [("constexpr int kRingNarrow = 3, kRingWide = 2;", "constexpr int kRingNarrow = 4, kRingWide = 3;", 1)],
    "ring_down": [("constexpr int kRingNarrow = 3, kRingWide = 2;", "constexpr int kRingNarrow = 2, kRingWide = 2;",
                   1)],
    "two_waves": [("const int blocks = per_sm[nwg] * sms < p.units ? per_sm[nwg] * sms : p.units;",
                   "const int blocks = 2 * per_sm[nwg] * sms < p.units ? 2 * per_sm[nwg] * sms : p.units;", 1)],
}
EXACT = {"shipped", "one_wg", "two_wg", "ring_up", "ring_down", "two_waves"}
# (mode, heads, tokens, keys, head dim)
SHAPES = [("self", 10, 4096, 77, 64), ("fused_outer", 10, 4096, 77, 64), ("fused_outer", 8, 4096, 16, 40),
          ("self", 8, 1024, 77, 80)]


def variants() -> dict:
    """{name: source text}: the shipped source and each ablation of it."""
    src = (CSRC / "flash_attention_onepass.cu").read_text()
    out = {"shipped": src}
    for name, edits in EDITS.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"{name}: the edit {old.strip()[:60]!r} matches {text.count(old)} times, not {count}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, dtype: str) -> dict:
    """Compile each variant into build/onepass_ablation/<name>.so (nvcc at
    once); {name: the C entry of ``dtype``}, with ptxas's lines printed."""
    from aid_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    entries = {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        regs = sorted({line.split("Used")[1].strip() for line in err.splitlines() if "Used" in line})
        spills = sorted({line.strip() for line in err.splitlines() if "spill stores" in line})
        print(f"{name:11s} ptxas: {' | '.join(spills)}; {' | '.join(regs)}", flush=True)
        if name == "shipped":
            for line in err.splitlines():
                if "wgmma" in line.lower():
                    print(f"  {line.strip()}", flush=True)
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), f"aid_flash_attn_{dtype}_onepass")
        fn.argtypes = [vp] * 10 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("bf16", "f16"), default="bf16")
    args = ap.parse_args(argv)

    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain, kernel_operands
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms, phase_device

    card = phase_device()
    entries = build(variants(), args.dtype)
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}[args.dtype]
    tol = chip_smoke.ATTN_TOL if args.dtype == "bf16" else chip_smoke.F16_ATTN_TOL
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    stream = torch.cuda.current_stream().cuda_stream
    B = 7
    coef = torch.linspace(0.0, 1.0, B, device=dev)
    kw = {"skip_endpoints": skip_mask(coef, B)}
    result = {}
    for mode, H, S, L, D in SHAPES:
        def heads(n):
            return torch.randn((B, n, H * D), generator=gen, device=dev).to(dtype).view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(S), heads(L), heads(L)
        ops = kernel_operands(q, k, v, coef, mode, onepass=True, **kw)
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        args_c = (*(x.data_ptr() for x in ops["tensors"]),
                  *(None if x is None else x.data_ptr() for x in (ops["coef"], ops["skip"])),
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
                raise SystemExit(f"{mode} (7,{H},{S},{L}) D={D}: the {name} kernel disagrees with the plain version "
                                 f"({errs[name]:.3e})")
        times = {name: [] for name in entries}
        for name in list(entries) + list(entries)[::-1]:
            times[name].append(cuda_ms(lambda: launch(entries[name]), args.reps))
        skip_rows = int(kw["skip_endpoints"].sum()) if mode != "self" else 0
        bound_ms, _ = attention_bound(mode, B, H, S, L, D, skip_rows=skip_rows, kind=args.dtype)
        base = min(times["shipped"])
        for name, ts in times.items():
            print(f"{args.dtype} {mode} (7,{H},{S},{L}) D={D} {name:10s} {min(ts):.4f}-{max(ts):.4f} ms  saves "
                  f"{base - min(ts):+.4f} ms  (bound {bound_ms:.4f})  max_abs_err/max|ref| {errs[name]:.3e}",
                  flush=True)
            result[f"{args.dtype} {name} {mode} (7,{H},{S},{L}) D={D}"] = ts
        del q, k, v, want, ops
    print(f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
