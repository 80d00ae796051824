"""What the f32 D=512 attention kernel's time goes to, on an NVIDIA GPU: ablations timed in turns.

    python3 tools/f32_d512_ablation.py [--reps 5]

There is no ``ncu`` on the machine with the card, so this probe takes parts
out of ``csrc/flash_attention_f32_d512.cu`` and times what is left. Each
variant is the shipped source with one part removed by a text edit (each
edit must match the source exactly once, or the probe stops):

  shipped      the source as it is
  no_qk_small  Q K^T without its small passes: lo(Q) hi(K) and the bf16
               bf16(Q) bf16(lo(K)) pass (hi*hi only)
  no_pv        no P V products (the softmax, P^T's stores and the fold stay)
  no_klo       the consumers do not make K's lo (the bf16 pass reads stale words)
  no_exchange  no partial-score exchange (each warpgroup keeps its own half)

Every variant but the shipped one computes a wrong result on purpose: its
error against the plain version is printed, not checked; the shipped one
must stay within ``chip_smoke.F32_ATTN_TOL``. Each is compiled by nvcc into
its own library under ``build/f32_d512_ablation/`` (one nvcc per variant,
all at once) and called through the same C entry as the port, on operands
``ops.flash_attention.d512_operands`` lays out, at the D=512 shapes of
``tools/attention_bench.py`` (one 1024px frame, seven 512px frames, the
tiled decode's ragged tile). Times are CUDA-event means of --reps launches,
the variants alternated (in order, then reversed); a variant's time saved
against the shipped kernel is what the removed part costs, up to what the
rest hides. Prints the card's name and power limit first and one JSON
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

SRC = ROOT / "aid_tpu_torch" / "csrc" / "flash_attention_f32_d512.cu"
OUT = ROOT / "build" / "f32_d512_ablation"

# variant -> [(text in the shipped source, its replacement)]
EDITS = {
    "no_qk_small": [
        ("          wgmma_tf32(sm, qlo[kk], kd, c + kk > 0);\n", ""),
        ("          wgmma_bf16_rs(sm, qbf[i], desc_sw128(kls + (box / 2) * (kBK * 128) + (box % 2) * 64 + i * 32));\n",
         ""),
        ("      for (int i = 0; i < 8; ++i) s[i] += sm[i];\n", ""),
    ],
    "no_pv": [
        ("        float acc[32];\n", "        float acc[32] = {};\n"),
        ("        for (int kk = 0; kk < 2; ++kk) wgmma_tf32(acc, vhi[mi & 1][kk], desc_sw64(phs + kk * 32), kk > 0);\n",
         "        for (int kk = 0; kk < 2; ++kk) {}\n"),
        ("        for (int kk = 0; kk < 2; ++kk) wgmma_bf16_rs(acc, vpk[mi & 1][kk], desc_sw64(pbs + kk * 32));\n",
         "        for (int kk = 0; kk < 2; ++kk) {}\n"),
    ],
    "no_klo": [("          make_klo(gbase + kKOff, gbase + kKLoOff, wg, ct);\n", "")],
    "no_exchange": [
        ("        asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(128 * kWG) : \"memory\");\n#pragma unroll\n"
         "        for (int i = 0; i < 8; ++i) s[i] += theirs[i * 128];\n", ""),
    ],
}
SHAPES = [(1, 16384), (7, 4096), (1, 4000)]


def variants() -> dict:
    """{name: source text}: the shipped source and each ablation of it."""
    src = SRC.read_text()
    out = {"shipped": src}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit {old.strip()[:60]!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """Compile each variant into build/f32_d512_ablation/<name>.so (nvcc at
    once); {name: the C entry}, with ptxas's resource lines printed."""
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
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        res = [line.strip() for line in err.splitlines() if "spill" in line or "Used" in line]
        print(f"{name:12s} ptxas: {' | '.join(res[-2:])}", flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).aid_flash_attn_f32_d512
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from aid_tpu_torch.ops.flash_attention import d512_operands, flash_interpolated_attention_plain
    from chip_smoke import F32_ATTN_TOL, F32_D512_PASSES, attention_bound, cuda_ms, phase_device

    card = phase_device()  # also sets full f32 matmuls (TF32 off) for the plain version
    entries = build(variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for n, S in SHAPES:
        q, k, v = (torch.randn((n, 1, S, 512), generator=gen, device=dev) for _ in range(3))
        ops = d512_operands(q, k, v)
        want = flash_interpolated_attention_plain(q, k, v)
        ptrs = [x.data_ptr() for x in ops["tensors"]]
        dims = (ctypes.c_longlong * len(ops["dims"]))(*ops["dims"])

        def launch(fn):
            code = fn(*ptrs, dims, ops["scale"], stream)
            if code != 0:
                raise SystemExit(f"launch failed: CUDA error {code}")

        errs = {}
        for name, fn in entries.items():
            launch(fn)
            torch.cuda.synchronize()
            errs[name] = ((ops["out"] - want).abs().max() / want.abs().max()).item()
        if not errs["shipped"] <= F32_ATTN_TOL:
            raise SystemExit(f"({n},1,{S},512): the shipped kernel disagrees with the plain version ({errs['shipped']:.3e})")
        times = {name: [] for name in entries}
        for name in list(entries) + list(entries)[::-1]:
            times[name].append(cuda_ms(lambda: launch(entries[name]), args.reps))
        bound_ms, _ = attention_bound("self", n, 1, S, S, 512, elem=4, **F32_D512_PASSES)  # the shipped kernel's
        base = min(times["shipped"])
        for name, ts in times.items():
            print(f"({n},1,{S},512) {name:12s} {min(ts):.4f}-{max(ts):.4f} ms  saves {base - min(ts):+.4f} ms  "
                  f"(bound {bound_ms:.4f})  max_abs_err/max|ref| {errs[name]:.3e}", flush=True)
            result[f"{name} ({n},1,{S},512)"] = ts
        del q, k, v, want, ops
    print(f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
