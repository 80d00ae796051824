"""What the mid-length stream attention kernel's time goes to, on an NVIDIA GPU: ablations timed in turns.

    python3 tools/midstream_ablation.py [--reps 20] [--dtype bf16|f16] [--variants a,b,...] [--only TEXT]

There is no ``ncu`` on the machine with the card, so this probe takes parts
out of ``csrc/flash_attention_midstream.cu`` and times what is left. Each
variant is the shipped source with one part removed or one choice changed by
a text edit (each edit must match the source as often as it says, or the
probe stops). The variants marked * are the shipped source with
``tools/midstream_switches.patch`` applied first (and their edits after):
it puts back the earlier design, whose list is head-major with no classes,
walked by block i at items i, i + grid, ..., and, behind compile-time
switches, the parts that measured slower and were taken out (kCounter,
kMulticast, kOverlap; all off in ``stride``):

  shipped        the source as it is
  no_persistent  one block a work item (a grid of every item, no block walks the list)
  stride*        the earlier design: the plain head-major list, block i
                 taking items i, i + grid, ... (shipped: the heaviest items
                 first, walked in a snake)
  counter*       stride with the blocks taking the next item nobody has
                 taken from a counter in device memory (set back by the last
                 block: launches must then not overlap)
  multicast*     128-row work items (two consumer warpgroups) in clusters of
                 two blocks where a (b, h) has an even number of query tiles,
                 each K/V stage loaded once into both by TMA multicast (K by
                 one block, V by the other); compare with tile_128
  tile_128       128-row work items (two consumer warpgroups) at every shape
                 (shipped: 192-row items, three warpgroups, at D = 64)
  overlap*       tile_128 with each warpgroup overlapping a tile's softmax
                 with the next tile's Q K^T and its own last P V (FA3's
                 intra-warpgroup schedule); compare with tile_128
  no_idle_skip   a warpgroup whose rows are all past Sq computes its
                 products and softmax on the zero rows anyway
  stages_up      a K/V stage more in the ring at D = 64 (two shipped at three
                 warpgroups, three at two)
  bk64           64-key tiles at D = 64 (128 shipped), four stages at three
                 warpgroups
  overlap_bk64*  bk64 with the intra-warpgroup overlap at three warpgroups
                 (64-key tiles leave room in 160 registers for the second
                 score and P sets), five stages
  ring_2         two Q/O buffers at D = 64 (three shipped: the store's read
                 wait then comes right after the store)
  no_qk          no Q K^T products (the scores stay unset)
  no_softmax     no exponentials of the scores (P is the raw scores)
  no_pv          no P V products
  no_store       no TMA store of the output

and, beside them, ``streaming``: the D <= 160 streaming kernel
(``csrc/flash_interpolated_attention.cu``, the route before this kernel) on
the same operands. Every variant but no_qk, no_softmax, no_pv and no_store
(which compute a wrong result on purpose: their error against the plain
version is printed, not checked) must stay within the dtype's ``chip_smoke``
tolerance. Each is compiled by nvcc into its own library under
``build/midstream_ablation/`` (one nvcc per variant, all at once) and called
through the same C entry as the port, on operands
``ops.flash_attention.kernel_operands`` lays out, at the paths' mid-length
streams: SDXL's self and fused_outer (7,20,1024,64), SD 2.1's (7,20,576,64)
and its 48^2 level's self (7,10,2304,64), SD 1.5's (7,8,1024,80); 7 frames
with the coef-0/1 end rows as skip rows. Times are CUDA-event means of
--reps launches, the variants alternated (in order, then reversed); a
variant's time saved against the shipped kernel is what the removed part
costs, up to what the rest hides. In self mode SDPA (cuDNN) on the same
inputs is timed beside. ptxas's register and spill lines of each variant
are printed. Prints the card's name and power limit first and one JSON
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
OUT = ROOT / "build" / "midstream_ablation"
SWITCHES = Path(__file__).resolve().parent / "midstream_switches.patch"

# variant -> [(text in the shipped source, its replacement, times it occurs)];
# the variants of SWITCHED edit the source with SWITCHES applied
EDITS = {
    "no_persistent": [("  const int blocks = max_blocks < p.units ? max_blocks : p.units;",
                       "  const int blocks = p.units;", 1)],
    "stride": [],
    "counter": [("constexpr bool kCounter = false;", "constexpr bool kCounter = true;", 1)],
    "multicast": [("constexpr bool kMulticast = false;", "constexpr bool kMulticast = true;", 1),
                  ("  return Mid<D>::kMaxWG;", "  return 2;", 1)],
    "tile_128": [("  constexpr int NWG = Mid<D>::kMaxWG;", "  constexpr int NWG = 2;", 1)],
    "overlap": [("constexpr bool kOverlap = false;", "constexpr bool kOverlap = true;", 1),
                ("  return Mid<D>::kMaxWG;", "  return 2;", 1)],
    "no_idle_skip": [("      if (IDLE && q0 + 64 * wg >= p.Sq) {  // every row", "      if (false) {  // every row", 1)],
    "stages_up": [("struct Mid<64> { static constexpr int kBK = 128, kStages = 3,",
                   "struct Mid<64> { static constexpr int kBK = 128, kStages = 4,", 1)],
    "ring_2": [("kStages = 3, kRing = 3, kMaxWG = 3; };", "kStages = 3, kRing = 2, kMaxWG = 3; };", 1)],
    "bk64": [("struct Mid<64> { static constexpr int kBK = 128, kStages = 3,",
              "struct Mid<64> { static constexpr int kBK = 64, kStages = 5,", 1)],
    "overlap_bk64": [("constexpr bool kOverlap = false;", "constexpr bool kOverlap = true;", 1),
                     ("kOverlapped = kOverlap && NWG == 2;", "kOverlapped = kOverlap;", 1),
                     ("struct Mid<64> { static constexpr int kBK = 128, kStages = 3,",
                      "struct Mid<64> { static constexpr int kBK = 64, kStages = 6,", 1)],
    "no_qk": [("    wgmma_ss<T>(s, desc_sw128(q + ", "    if (0) wgmma_ss<T>(s, desc_sw128(q + ", 1)],
    "no_softmax": [("const float p0 = ex2(fmaf(s[4 * j], scale_log2, -ms0)), p1 = ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));",
                    "const float p0 = s[4 * j], p1 = s[4 * j + 1];", 1),
                   ("const float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, -ms1)), p3 = ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));",
                    "const float p2 = s[4 * j + 2], p3 = s[4 * j + 3];", 1)],
    "no_pv": [("for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<T>(", "for (int kk = 0; kk < BK / 16; ++kk) if (0) wgmma_rs<T>(",
               1)],
    "no_store": [("for (int c = 0; c < C::kChunks; ++c) tma_store(", "for (int c = 0; c < 0; ++c) tma_store(", 1)],
}
SWITCHED = {"stride", "counter", "multicast", "overlap", "overlap_bk64"}
INEXACT = {"no_qk", "no_softmax", "no_pv", "no_store"}
# (mode, heads, tokens, head dim): self-attention calls, keys = tokens
SHAPES = [("self", 20, 1024, 64), ("fused_outer", 20, 1024, 64), ("self", 20, 576, 64), ("fused_outer", 20, 576, 64),
          ("self", 10, 2304, 64), ("self", 8, 1024, 80), ("fused_outer", 8, 1024, 80)]


def apply_patch(text: str, patch: str) -> str:
    """``text`` with the unified diff ``patch`` (one file) applied: each hunk's
    old lines must stand at its line (shifted by the hunks before it), or
    this stops."""
    lines, out, at = text.splitlines(keepends=True), [], 0
    hunks = patch.split("\n@@ ")[1:]
    for hunk in hunks:
        head, _, body = hunk.partition("\n")
        start = int(head.split()[0].lstrip("-").split(",")[0]) - 1
        old = [ln[1:] + "\n" for ln in body.split("\n") if ln[:1] in (" ", "-")]
        new = [ln[1:] + "\n" for ln in body.split("\n") if ln[:1] in (" ", "+")]
        if lines[start:start + len(old)] != old:
            raise SystemExit(f"{SWITCHES.name} does not apply at line {start + 1}: the source has changed")
        out += lines[at:start] + new
        at = start + len(old)
    return "".join(out + lines[at:])


def variants(names) -> dict:
    """{name: (source file, source text)}: the shipped source, each ablation
    of it named in ``names``, and the streaming kernel's source."""
    src = (CSRC / "flash_attention_midstream.cu").read_text()
    out = {"shipped": ("midstream", src)}
    switched = apply_patch(src, SWITCHES.read_text()) if names & SWITCHED else None
    for name, edits in EDITS.items():
        if name not in names:
            continue
        text = switched if name in SWITCHED else src
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"{name}: the edit {old.strip()[:60]!r} matches {text.count(old)} times, not {count}")
            text = text.replace(old, new)
        out[name] = ("midstream", text)
    if "streaming" in names:
        out["streaming"] = ("streaming", (CSRC / "flash_interpolated_attention.cu").read_text())
    return out


def build(sources: dict, dtype: str) -> dict:
    """Compile each variant into build/midstream_ablation/<name>.so (nvcc at
    once); {name: its C entry of ``dtype``}, with ptxas's lines printed."""
    from aid_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, text) in sources.items():
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
        kind = sources[name][0]
        if name == "shipped":  # every instance's registers and spills, and any warning (wgmma serialised)
            for line in err.splitlines():
                if "midstream_kernel" in line or "spill" in line or "Used" in line or "warning" in line.lower():
                    print(f"  {line.strip()}", flush=True)
        elif kind == "midstream":
            regs = sorted({line.split("Used")[1].strip() for line in err.splitlines() if "Used" in line})
            spills = sorted({line.strip() for line in err.splitlines() if "spill stores" in line})
            print(f"{name:13s} ptxas: {' | '.join(spills)}; {' | '.join(regs)}", flush=True)
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")),
                     f"aid_flash_attn_{dtype}_midstream" if kind == "midstream" else f"aid_flash_attn_{dtype}")
        fn.argtypes = [vp] * 10 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("bf16", "f16"), default="bf16")
    ap.add_argument("--variants", default=",".join(["streaming", *EDITS]),
                    help="comma-separated variants besides shipped (default: all, and the streaming kernel)")
    ap.add_argument("--only", default="", help="time only the shapes whose label contains this text")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain, kernel_operands
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms, phase_device

    card = phase_device()
    entries = build(variants(set(args.variants.split(","))), args.dtype)
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}[args.dtype]
    tol = chip_smoke.ATTN_TOL if args.dtype == "bf16" else chip_smoke.F16_ATTN_TOL
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    stream = torch.cuda.current_stream().cuda_stream
    B = 7
    coef = torch.linspace(0.0, 1.0, B, device=dev)
    result = {}
    for mode, H, S, D in SHAPES:
        label = f"{mode} (7,{H},{S},{D})"
        if args.only not in label:
            continue

        def heads(n):
            return torch.randn((B, n, H * D), generator=gen, device=dev).to(dtype).view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(S), heads(S), heads(S)
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, B)}
        ops = kernel_operands(q, k, v, coef, mode, midstream=True, **kw)
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        args_c = (*(x.data_ptr() for x in ops["tensors"]),
                  *(None if x is None else x.data_ptr() for x in (ops["coef"], ops["skip"])),
                  (ctypes.c_longlong * len(ops["dims"]))(*ops["dims"]), float(ops["scale"]), ops["has_own"],
                  ops["n_sets"], stream)

        def launch(fn):
            code = fn(*args_c)
            if code != 0:
                raise SystemExit(f"{label}: launch failed: CUDA error {code}")

        errs = {}
        for name, fn in entries.items():
            ops["out"].zero_()
            launch(fn)
            torch.cuda.synchronize()
            errs[name] = ((ops["out"].float() - want.float()).abs().max() / want.float().abs().max()).item()
            if name not in INEXACT and not errs[name] <= tol:
                raise SystemExit(f"{label}: the {name} kernel disagrees with the plain version ({errs[name]:.3e})")
        times = {name: [] for name in entries}
        for name in list(entries) + list(entries)[::-1]:
            times[name].append(cuda_ms(lambda: launch(entries[name]), args.reps))
        skip_rows = int(kw["skip_endpoints"].sum()) if kw else 0
        bound_ms, by = attention_bound(mode, B, H, S, S, D, skip_rows=skip_rows,
                                       **({"kind": "f16"} if args.dtype == "f16" else {}))
        lib = ""
        if mode == "self":
            with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
                lib_ms = min(cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), args.reps) for _ in range(2))
            lib = f"  cuDNN {lib_ms:.4f} ms"
            result[f"{args.dtype} cudnn {label}"] = [lib_ms]
        base = min(times["shipped"])
        for name, ts in times.items():
            print(f"{args.dtype} {label} {name:13s} {min(ts):.4f}-{max(ts):.4f} ms  saves {base - min(ts):+.4f} ms  "
                  f"(bound {bound_ms:.4f} {by}, {bound_ms / min(ts):.1%}){lib}  max_abs_err/max|ref| "
                  f"{errs[name]:.3e}", flush=True)
            result[f"{args.dtype} {name} {label}"] = ts
        del q, k, v, want, ops
    print(f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
