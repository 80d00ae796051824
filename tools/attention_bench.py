"""Time the flash attention kernel launched alone at the main paths' shapes.

    python3 tools/attention_bench.py [--reps 20] [--dtype bf16|f16|f32]
                                     [--d512 | --dmid | --dwide | --onepass | --midstream | --static [--headline N]]
                                     [--only TEXT] [--root DIR]

For each shape class of ``chip_smoke.py`` phase 3 (bf16: SDXL at D=64, SD1.5
at D=40/80/160 and SD1.5's IP-Adapter calls over 16 and 4 image tokens,
which also time the call through the wrapper; f32: every f32 shape of PERF.md's kernel table, SDXL's and SD
2.1's D=64 and SD1.5's D=40/80/160, the latter at 256 and 64 tokens and the
77-key cross-attention; 7 frames, (B, S, H*D) projections viewed as (B, H,
S, D), the coef-0/1 end rows as skip rows; f16 at the bf16 shapes, the
same design's f16 instance; ``--only`` keeps the labels that
contain its text, say ``D=160``) it prepares one launch
with ``ops.flash_attention.kernel_launch`` and times that launch alone with
CUDA events, beside the bound (``chip_smoke.attention_bound``; f32 at three
TF32 passes; the f32 D=512 kernel at its own split, ``F32_D512_PASSES``) and, in self mode, SDPA on the same inputs (bf16: cuDNN; f32:
the efficient backend, the fastest that takes f32). f32 also times the call
through the wrapper, as the model makes it. ``--d512`` times the D=512
self-attention of the VAE's mid block in ``--dtype`` instead (f32: the
reference's VAE; bf16 and f16: a VAE in that dtype), at its three shapes (one 1024px frame,
16384 tokens; seven 512px frames, 4096; the tiled decode's ragged
4000-token tile): launched alone on operands
``ops.flash_attention.d512_launch`` prepared once and through the wrapper,
beside SDPA efficient and the plain version. ``--dwide`` times the wide
entries (head dims 513-2048, csrc/flash_attention_dwide.cu) of ``--dtype`` at
phase 22's shapes (SD 1.x with one head a level: D = 640 over 1024 tokens
and its 77-key cross call, D = 1280 over 256 and 64), at (2,1,512,2048) and
at a ragged D = 520, in every mode: launched alone and through the wrapper,
beside the bound at the caller's D (f32 at three TF32 passes), the plain
version and, in self and the inner modes, the fastest SDPA backend on the
same inputs (the inner modes over [own; K_cross]). ``--dmid`` times the
D=161-512 entries of ``--dtype`` (csrc/flash_attention_dmid.cu,
flash_attention_dmid_f32.cu) at phase 21's shapes (SD 1.x at 320-wide heads:
1 / 2 / 4 / 4 heads over 4096 / 1024 / 256 / 64 tokens, every endpoint mode
and self mode, and the 77-key cross call in fused_outer and self mode), at
D = 200 and 384 (fused_outer and self over 1024 tokens) and, in self mode,
at D = 448, 504 and 512 over 1024 and 4096 tokens (the boundary between
the entries' self instance and the D=512 self kernels: where the wrapper
sends the call to the D=512 self kernels, at 512 and in f32 past 448, the
self instance is laid out by lifting ``DMID_SELF_MAX`` for the one call). Self
mode also times the D=512 self kernels on copies of q, k and v padded to
512 (``d512_launch``: the route before the self instance, and a checkout's
route where it has no self instance, as the parent's: there it is also the
call launched alone). Each case is launched alone (CUDA events over back-to-back launches, and the
kernels' own device time from a profiler trace, which leaves out the host's
launch work that the events of a call of a few microseconds measure) and
through the wrapper, beside the bound at the caller's D (f32 at its 1.5
TF32 + 1.5 bf16 passes, F32_D512_PASSES), the
plain version and, in self mode and the inner modes, the fastest SDPA
backend (the inner modes over [own; K_cross]); (B, S, H*D) projections
viewed as (B, H, S, D), 7 frames with the coef-0/1 end rows as skip rows.
``--onepass`` (bf16 or f16) times the short key streams, the calls the JAX
wrapper sends to `_kernel_onepass` (the 77-key text cross calls, short self
calls, the IP calls), on the short-stream kernel
(csrc/flash_attention_onepass.cu) wherever it fits and on the streaming
kernel, the route before it, in one process (``bench_onepass``).
``--midstream`` (bf16 or f16) does the same for the mid-length streams, the
calls the JAX wrapper sends to `_kernel_onepass` past what the short-stream
kernel holds (SDXL's 1024-token level, SD 2.1's 576 and SD 1.5's 1024 at D =
80 in every mode, SD 2.1's 2304, and SDXL's 4096-token calls past the
contract), on
the mid-length stream kernel (csrc/flash_attention_midstream.cu) and the
streaming kernel in turns, beside cuDNN in self mode; each line says whether
the route sends the call to the new kernel.
``--static`` times the static-shift instances (``static_smax`` = 40: the
streaming kernels' in bf16 and f32, the bf16 mid-length stream kernel's, the
D=161-512 kernels', the D=512 self kernels' and the wide kernels' in bf16 and
f32) at the call
classes the model path's "auto" shifts (``STATIC_SHIFTS``: SDXL's 4096- and
1024-token calls, SD 1.5's 4096 at D = 40 and 1024 at D = 80, SD 2.1's 9216,
2304 and 576, the f32 UNets' 4096 and 1024; the VAE mid block at D = 512 over
one 1024px frame, seven 512px frames and the tiled decode's 4000-token tile;
SD 1.x's 320-wide heads over (7,1,4096) in every mode and (7,2,1024)
fused_outer, the self calls at 448 and 504 that the route sends to each
D=161-512 instance, and the endpoint modes over (7,2,1024) at D = 384 and
512, the bf16 kernel's split layout; SD 1.x with one head a level, D = 640 over
(7,1,1024) in every mode, its 77-key cross call, the 1280-wide levels over 256
and 64 tokens, a ragged 520 and self (2,1,512,2048), f32 fused_outer at 1024)
and at a 77-key call the short-stream kernel
takes exactly, each in PAIRS turns with the exact route on the same inputs
(launched alone, and through the wrapper with static_smax 40 against None;
medians and least times, and the kernels' device time from a profiler trace;
past D = 160 the fastest SDPA backend in self and the inner modes),
held to the plain version's static shift and exact softmax. ``--headline N``
adds the SDXL headline (``chip_smoke.build_headline``: 7 frames at 128^2, N
Euler steps, half fused_outer) in turns under "auto" and exact everywhere
(``FLASH_MIN_KV`` raised past every call, which makes "auto" exact), s/step
of each.
It checks each result against
the plain version (``chip_smoke.ATTN_TOL`` / ``F16_ATTN_TOL`` / ``F32_ATTN_TOL``). ``--root``
imports the package and ``chip_smoke.py`` of another checkout (say, the
parent commit unpacked under ``build/``): run both in one call, in turns, to
compare two versions of the kernel on one card. The last line is one JSON
object {label: ms alone}. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

# (label, mode, H, Sq, L, D)
SHAPES = [
    ("self 4096 D=64", "self", 10, 4096, 4096, 64),
    ("fused_outer 4096 D=64", "fused_outer", 10, 4096, 4096, 64),
    ("self 1024 D=64", "self", 20, 1024, 1024, 64),
    ("fused_outer 1024 D=64", "fused_outer", 20, 1024, 1024, 64),
    ("cross self 4096x77 D=64", "self", 10, 4096, 77, 64),
    ("cross fused_outer 4096x77 D=64", "fused_outer", 10, 4096, 77, 64),
    ("self 4096 D=40", "self", 8, 4096, 4096, 40),
    ("fused_outer 4096 D=40", "fused_outer", 8, 4096, 4096, 40),
    ("self 1024 D=80", "self", 8, 1024, 1024, 80),
    ("fused_outer 1024 D=80", "fused_outer", 8, 1024, 1024, 80),
    ("self 256 D=160", "self", 8, 256, 256, 160),
    ("fused_outer 256 D=160", "fused_outer", 8, 256, 256, 160),
    # SD1.5's IP-Adapter calls: the queries over 16 (Plus) or 4 image tokens, no skip rows
    ("IP self 4096x16 D=40", "self", 8, 4096, 16, 40),
    ("IP fused_outer 4096x16 D=40", "fused_outer", 8, 4096, 16, 40),
    ("IP self 4096x4 D=40", "self", 8, 4096, 4, 40),
    ("IP fused_outer 4096x4 D=40", "fused_outer", 8, 4096, 4, 40),
    ("IP self 1024x16 D=80", "self", 8, 1024, 16, 80),
    ("IP fused_outer 1024x16 D=80", "fused_outer", 8, 1024, 16, 80),
    ("IP self 256x16 D=160", "self", 8, 256, 16, 160),
    ("IP fused_outer 256x16 D=160", "fused_outer", 8, 256, 16, 160),
]
# the f32 shapes of PERF.md's kernel table (SDXL and SD 2.1 at D=64, SD1.5 at D=40/80/160)
F32_SHAPES = [
    ("self 4096 D=64", "self", 10, 4096, 4096, 64),
    ("fused_outer 4096 D=64", "fused_outer", 10, 4096, 4096, 64),
    ("cross self 4096x77 D=64", "self", 10, 4096, 77, 64),
    ("cross fused_outer 4096x77 D=64", "fused_outer", 10, 4096, 77, 64),
    ("self 1024 D=64", "self", 20, 1024, 1024, 64),
    ("fused_outer 1024 D=64", "fused_outer", 20, 1024, 1024, 64),
    ("SD2.1 self 9216 D=64", "self", 5, 9216, 9216, 64),
    ("SD2.1 fused_outer 9216 D=64", "fused_outer", 5, 9216, 9216, 64),
    ("SD2.1 self 576 D=64", "self", 20, 576, 576, 64),
    ("SD2.1 fused_outer 576 D=64", "fused_outer", 20, 576, 576, 64),
    ("SD2.1 self 144 D=64", "self", 20, 144, 144, 64),
    ("SD2.1 fused_outer 144 D=64", "fused_outer", 20, 144, 144, 64),
    ("self 4096 D=40", "self", 8, 4096, 4096, 40),
    ("fused_outer 4096 D=40", "fused_outer", 8, 4096, 4096, 40),
    ("self 1024 D=80", "self", 8, 1024, 1024, 80),
    ("fused_outer 1024 D=80", "fused_outer", 8, 1024, 1024, 80),
    ("self 256 D=160", "self", 8, 256, 256, 160),
    ("fused_outer 256 D=160", "fused_outer", 8, 256, 256, 160),
    ("self 64 (mid block) D=160", "self", 8, 64, 64, 160),
    ("fused_outer 64 (mid block) D=160", "fused_outer", 8, 64, 64, 160),
    ("cross self 256x77 D=160", "self", 8, 256, 77, 160),
    ("cross fused_outer 256x77 D=160", "fused_outer", 8, 256, 77, 160),
]


# (frames, tokens) of the D=512 self-attention: one SDXL frame, SD 1.5's
# batched 512px decode, the tiled decode's ragged tile
D512_SHAPES = [(1, 16384), (7, 4096), (1, 4000)]


def bench_d512(reps: int, name: str) -> dict:
    """The D=512 kernel of one dtype (f32: csrc/flash_attention_f32_d512.cu,
    bounded at its own TF32 and bf16 passes beside three TF32 passes; bf16
    and f16: the two instances of csrc/flash_attention_bf16_d512.cu) at
    D512_SHAPES: {label: ms alone};
    prints each with its time through the wrapper, its bound, SDPA
    efficient's and the plain version's."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from aid_tpu_torch.ops import flash_attention as fa
    from aid_tpu_torch.ops.flash_attention import d512_launch, flash_interpolated_attention_plain
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms

    f32 = name == "f32"
    # each checkout's bound for its own kernel's passes (the mma.sync kernel before this design ran three TF32 passes)
    # (the bound's kind is named for f16 only: a parent checkout's attention_bound may not take it)
    passes = getattr(chip_smoke, "F32_D512_PASSES", {"tf32_passes": 3}) if f32 else (
        {"kind": name} if name == "f16" else {})
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[name]
    tol = {"bf16": "BF16_D512_TOL", "f16": "F16_ATTN_TOL", "f32": "F32_ATTN_TOL"}[name]
    tol, wrapper = getattr(chip_smoke, tol), getattr(fa, f"flash_self_attention_{name}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    result = {}
    for n, S in D512_SHAPES:
        q, k, v = (torch.randn((n, 1, S, 512), generator=gen, device=dev).to(dtype) for _ in range(3))
        out, launch = d512_launch(q, k, v)
        launch()
        want = flash_interpolated_attention_plain(q, k, v)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= tol:
            raise SystemExit(f"({n},1,{S},512): the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, reps)
        wrapper_ms = cuda_ms(lambda: wrapper(q, k, v), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v), max(1, reps // 4))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps)
        bound_ms, by = attention_bound("self", n, 1, S, S, 512, **({"elem": 4, **passes} if f32 else passes))
        label = f"{name} self ({n},1,{S},512)"
        if f32:
            three_ms, _ = attention_bound("self", n, 1, S, S, 512, elem=4, tf32_passes=3)
            by += f", 3xTF32 {three_ms:.4f} ms, {three_ms / ms:.1%}"
        print(f"{label:32s} launch alone {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, {bound_ms / ms:.1%})  through "
              f"the wrapper {wrapper_ms:.4f} ms  SDPA efficient {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)  plain "
              f"{plain_ms:.4f} ms  max_abs_err/max|ref| {err:.3e}", flush=True)
        result[label] = ms
        del q, k, v, out, want, launch
    return result


# (label, mode, frames, tokens, keys, D) of the wide entries
DWIDE_SHAPES = [(f"{m} {Sq}{'x77' if L == 77 else ''} D={D}", m, B, Sq, L, D)
                for B, Sq, L, D in ((7, 1024, 1024, 640), (7, 1024, 77, 640), (7, 256, 256, 1280), (7, 64, 64, 1280),
                                    (2, 512, 512, 2048), (7, 1024, 1024, 520))
                for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")]


def dwide_sdpa(q, k, v, coef, mode: str, want, reps: int) -> tuple:
    """(backend, ms) of the fastest SDPA backend computing the wide call's
    function on the same inputs: self mode over (q, k, v), the inner modes
    over [own; K_cross] (fused) or K_cross (pure), K_cross lerped in f32
    from the rows' endpoints as the wrapper lerps it; (None, None) in the
    outer modes, which no one call computes. A yardstick: the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import cuda_ms

    if mode not in ("self", "fused_inner", "pure_inner"):
        return None, None
    if mode != "self":
        c = coef.view(-1, 1, 1, 1)
        kc = ((1 - c) * k[0].float() + c * k[-1].float()).to(k.dtype)
        vc = ((1 - c) * v[0].float() + c * v[-1].float()).to(v.dtype)
        k, v = (torch.cat([k, kc], 2), torch.cat([v, vc], 2)) if mode == "fused_inner" else (kc, vc)
    best = (None, None)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                got = F.scaled_dot_product_attention(q, k, v)
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps)
        except RuntimeError:  # this backend does not take the input
            continue
        if (got.float() - want.float()).abs().max().item() > 0.1 * want.float().abs().max().item():
            raise SystemExit(f"SDPA {backend.name} computes another function than the {mode} call")
        if best[1] is None or ms < best[1]:
            best = (backend.name, ms)
    return best


def bench_dwide(reps: int, name: str, only: str) -> dict:
    """The wide entry of one dtype at DWIDE_SHAPES (one head; 7 frames with
    the coef-0/1 end rows as skip rows, or 2 frames with none):
    {label: ms alone}; prints each with its time through the wrapper, its
    bound, the plain version's and, in self and the inner modes, the
    fastest SDPA backend's on the same inputs (:func:`dwide_sdpa`)."""
    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import (
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        kernel_launch,
    )
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms

    f32 = name == "f32"
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[name]
    tol = {"bf16": chip_smoke.ATTN_TOL, "f32": chip_smoke.F32_ATTN_TOL}.get(name) or chip_smoke.F16_ATTN_TOL
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    result = {}
    for label, mode, B, Sq, L, D in DWIDE_SHAPES:
        if only not in label:
            continue
        coef = torch.linspace(0.0, 1.0, B, device=dev) if B == 7 else torch.tensor([0.3, 0.6], device=dev)
        q, k, v = (torch.randn((B, 1, n, D), generator=gen, device=dev).to(dtype) for n in (Sq, L, L))
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, B)}
        out, launch = kernel_launch(q, k, v, coef, mode, **kw)
        launch()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= tol:
            raise SystemExit(f"{label}: the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, reps)
        wrapper_ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, coef, mode, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, coef, mode, **kw), max(1, reps // 4))
        skip_rows = int(kw["skip_endpoints"].sum()) if kw else 0
        bound_ms, by = attention_bound(mode, B, 1, Sq, L, D, skip_rows=skip_rows, elem=4 if f32 else 2,
                                       tf32_passes=3 if f32 else None, **({"kind": name} if name == "f16" else {}))
        lib, lib_ms = dwide_sdpa(q, k, v, coef, mode, want, reps)
        sdpa = f"SDPA {lib} {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)" if lib else "SDPA —"
        print(f"{name} {label:26s} ({B},1,{Sq},{D}) launch alone {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, "
              f"{bound_ms / ms:.1%})  through the wrapper {wrapper_ms:.4f} ms  {sdpa}  plain {plain_ms:.4f} ms  "
              f"max_abs_err/max|ref| {err:.3e}", flush=True)
        result[f"{name} {label}"] = ms
        del q, k, v, out, want, launch
    return result


# (label, mode, H, Sq, L, D) of the D=161-512 entries: phase 21's shapes, then
# other head dims, then self mode at the boundary with the D=512 self kernels
DMID_SHAPES = [(f"{m} {Sq} D=320", m, H, Sq, Sq, 320) for H, Sq in ((1, 4096), (2, 1024), (4, 256), (4, 64))
               for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")] + [
    (f"cross {m} 4096x77 D=320", m, 1, 4096, 77, 320) for m in ("fused_outer", "self")] + [
    (f"{m} 1024 D={D}", m, 2, 1024, 1024, D) for D in (200, 384) for m in ("fused_outer", "self")] + [
    (f"self {Sq} D={D}", "self", H, Sq, Sq, D) for D in (448, 504, 512) for H, Sq in ((2, 1024), (1, 4096))]


def device_ms(fn, reps: int, retries: int = 2) -> float:
    """Mean device time in ms of the kernel ``fn`` launches, over ``reps``
    calls, from a profiler trace of the card: the kernel's own durations
    (a mean over the launches the trace holds), with no host time between
    launches (which the CUDA-event time of a call of a few microseconds is
    made of). A trace that holds no launch at all is taken again, up to
    ``retries`` times."""
    import json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [float(e["dur"]) for e in events if e.get("cat") == "kernel"]
    if not kernels:  # the trace may drop an event now and then; none at all means it saw no kernel
        if retries:
            return device_ms(fn, reps, retries - 1)
        raise SystemExit(f"the profiler saw none of {reps} launches")
    return sum(kernels) / len(kernels) / 1000.0


def dmid_self_launch(fa, q, k, v) -> tuple:
    """The self-mode call's (out, launch) on the route of the checkout whose
    flash_attention module is ``fa``: the D=161-512 entries' self instance
    where it has one (at every D up to 512, ``DMID_SELF_MAX`` lifted for the
    layout), else the D=512 self kernels on copies padded to 512."""
    if not hasattr(fa, "DMID_SELF_MAX"):
        return fa.d512_launch(q, k, v)
    kept = fa.DMID_SELF_MAX
    fa.DMID_SELF_MAX = dict.fromkeys(kept, fa.D512)
    try:
        return fa.kernel_launch(q, k, v)
    finally:
        fa.DMID_SELF_MAX = kept


def bench_dmid(reps: int, name: str, only: str) -> dict:
    """The D=161-512 entry of one dtype at DMID_SHAPES: {label: ms alone};
    prints each with its time through the wrapper, its bound at the
    caller's D, the plain version's, in self mode the D=512 self kernels'
    on copies padded to 512 and, in self mode and the inner modes, the
    fastest SDPA backend's (the inner modes over [own; K_cross],
    :func:`dwide_sdpa`)."""
    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops import flash_attention as fa
    from aid_tpu_torch.ops.flash_attention import (
        d512_launch,
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        kernel_launch,
    )
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms

    f32 = name == "f32"
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[name]
    tol = {"bf16": chip_smoke.ATTN_TOL, "f32": chip_smoke.F32_ATTN_TOL}.get(name) or chip_smoke.F16_ATTN_TOL
    passes = {"elem": 4, **chip_smoke.F32_D512_PASSES} if f32 else {"kind": name} if name == "f16" else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    B = 7
    coef = torch.linspace(0.0, 1.0, B, device=dev)
    result = {}
    for label, mode, H, Sq, L, D in DMID_SHAPES:
        if only not in label:
            continue

        def heads(n):
            x = torch.randn((B, n, H * D), generator=gen, device=dev).to(dtype)
            return x.view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(Sq), heads(L), heads(L)
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, B)}
        out, launch = dmid_self_launch(fa, q, k, v) if mode == "self" else kernel_launch(q, k, v, coef, mode, **kw)
        launch()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= tol:
            raise SystemExit(f"{label}: the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, reps)
        dev_ms = device_ms(launch, reps)
        wrapper_ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, coef, mode, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, coef, mode, **kw), max(1, reps // 4))
        skip_rows = int(kw["skip_endpoints"].sum()) if kw else 0
        bound_ms, by = attention_bound(mode, B, H, Sq, L, D, skip_rows=skip_rows, **passes)
        lib, lib_ms = dwide_sdpa(q, k, v, coef, mode, want, reps)
        sdpa = f"SDPA {lib} {lib_ms:.4f} ms (wrapper {wrapper_ms / lib_ms:.2f}x)" if lib else "SDPA —"
        padded = ""
        if mode == "self":  # the D=512 self kernels on copies padded to 512: with the copies, and alone
            _, d512 = d512_launch(q, k, v)
            padded = (f"  D=512 route padded {cuda_ms(lambda: d512_launch(q, k, v)[1](), reps):.4f} ms, alone "
                      f"{cuda_ms(d512, reps):.4f} ms, device {device_ms(d512, reps):.4f} ms")
            del d512
        print(f"{name} {label:32s} (7,{H},{Sq},{D}) launch alone {ms:.4f} ms  device {dev_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({by}, {bound_ms / dev_ms:.1%})  through the wrapper {wrapper_ms:.4f} ms  {sdpa}  "
              f"plain {plain_ms:.4f} ms  max_abs_err/max|ref| {err:.3e}{padded}", flush=True)
        result[f"{name} {label}"] = ms
        del q, k, v, out, want, launch
    return result


# (label, mode, coefficients, H, Sq, L, D): the calls the JAX wrapper sends to
# `_kernel_onepass` on the models' paths (SDXL's, SD 2.1's and SD 1.5's 77-key
# text cross calls in every mode that reaches them, the short self calls of
# SD 2.1's 12^2 and 24^2 levels and SD 1.5's mid block, the IP calls over 16
# and 4 image tokens)
ONEPASS_SHAPES = [
    *[(f"SDXL cross {m} 4096x77 D=64", m, "sdxl", 10, 4096, 77, 64)
      for m in ("self", "fused_outer", "pure_outer", "fused_inner", "pure_inner")],
    *[(f"SDXL cross {m} 1024x77 D=64", m, "sdxl", 20, 1024, 77, 64) for m in ("self", "fused_outer")],
    *[(f"SD2.1 cross {m} 9216x77 D=64", m, "sd", 5, 9216, 77, 64) for m in ("self", "fused_outer")],
    *[(f"SD2.1 {m} {S} D=64", m, "sd", 20, S, S, 64) for S in (144, 576) for m in ("self", "fused_outer")],
    *[(f"SD1.5 cross {m} {Sq}x77 D={D}", m, "sd", 8, Sq, 77, D)
      for Sq, D in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for m in ("self", "fused_outer")],
    *[(f"SD1.5 cross {m} {Sq}x77 D={D}", m, "sd", 8, Sq, 77, D)
      for Sq, D in ((1024, 80), (256, 160)) for m in ("pure_outer", "fused_inner")],
    *[(f"SD1.5 {m} 64 (mid block) D=160", m, "sd", 8, 64, 64, 160) for m in ("self", "fused_outer")],
    *[(f"IP {m} 4096x16 D=40", m, "sd", 8, 4096, 16, 40)
      for m in ("self", "fused_outer", "pure_outer", "fused_inner", "pure_inner")],
    *[(f"IP {m} {Sq}x16 D={D}", m, "sd", 8, Sq, 16, D) for Sq, D in ((1024, 80), (256, 160))
      for m in ("self", "fused_outer")],
    *[(f"IP {m} 4096x4 D=40", m, "sd", 8, 4096, 4, 40) for m in ("self", "fused_outer")],
]


# (label, mode, coefficients, H, Sq, L, D): the calls the JAX wrapper sends to
# `_kernel_onepass` with streams past the short-stream kernel (over 240 keys,
# up to onepass_max = 3072): SDXL's 1024-token level, SD 2.1's 24^2 level and
# SD 1.5's 32^2 level at D = 80 in every mode, SD 2.1's 48^2 level in the
# modes whose stream stays within onepass_max; and, past the contract, SDXL's
# 4096-token calls
_MODES = ("self", "fused_outer", "pure_outer", "fused_inner", "pure_inner")
MIDSTREAM_SHAPES = [
    *[(f"SDXL {m} 1024 D=64", m, "sdxl", 20, 1024, 1024, 64) for m in _MODES],
    *[(f"SD2.1 {m} 576 D=64", m, "sd", 20, 576, 576, 64) for m in _MODES],
    *[(f"SD2.1 {m} 2304 D=64", m, "sd", 10, 2304, 2304, 64) for m in ("self", "pure_inner")],
    *[(f"SD1.5 {m} 1024 D=80", m, "sd", 8, 1024, 1024, 80) for m in _MODES],
    *[(f"SDXL {m} 4096 D=64 (past the contract)", m, "sdxl", 10, 4096, 4096, 64) for m in ("self", "fused_outer")],
]


PAIRS = 10  # the short-stream and mid-length stream benches' turns of the two routes a call


def bench_onepass(reps: int, name: str, only: str, kind: str = "onepass") -> dict:
    """The calls of ONEPASS_SHAPES (``kind`` "midstream": MIDSTREAM_SHAPES)
    in bf16 or f16: {label: ms launched alone}. On a checkout with the
    short-stream kernel (csrc/flash_attention_onepass.cu; the mid-length
    stream kernel, csrc/flash_attention_midstream.cu) each call is timed on
    it (wherever it takes the call, whether or not the route sends the call
    there) and on the D <= 160
    streaming kernel, the route before it, in PAIRS turns of the two (the
    first of each pair alternating; medians and least times): launched
    alone (CUDA events, and the kernel's device time from a profiler trace)
    and with its host work (the operands laid out by kernel_launch and
    launched, as the wrapper does it; how many pairs the new route was no
    slower in), held to the plain version, beside the bound and, in self
    mode
    and the inner modes, the fastest SDPA backend; the wrapper's own time
    follows the route. On a checkout without it (``--root`` at the parent)
    the call is timed on that checkout's route. 7 frames, SDXL's
    coefficients or Beta(25, 25)'s at SD's shapes with the coef-0/1 end rows
    as skip rows; (B, S, H*D) projections viewed as (B, H, S, D)."""
    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops import flash_attention as fa
    from aid_tpu_torch.ops.flash_attention import (
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        kernel_launch,
    )
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms

    has = hasattr(fa, f"takes_{kind}")
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}[name]
    tol = chip_smoke.ATTN_TOL if name == "bf16" else chip_smoke.F16_ATTN_TOL
    wrapper = flash_interpolated_attention if name == "bf16" else fa.flash_interpolated_attention_f16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    B = 7
    coefs = {"sdxl": torch.tensor([0.0, 0.2, 0.35, 0.5, 0.65, 0.8, 1.0], device=dev),
             "sd": chip_smoke.sd15_coef().to(dev)}
    result = {}
    for label, mode, ck, H, Sq, L, D in ONEPASS_SHAPES if kind == "onepass" else MIDSTREAM_SHAPES:
        if only not in label:
            continue
        coef = coefs[ck]

        def heads(n):
            x = torch.randn((B, n, H * D), generator=gen, device=dev).to(dtype)
            return x.view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(Sq), heads(L), heads(L)
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, B)}
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        fits = has and (fa.onepass_tiles(D, L, L, mode) is not None if kind == "onepass" else
                        D in fa.MIDSTREAM_TILES)
        routes = {"new": {kind: True}, "old": {kind: False}} if fits else {"route": {}}
        launches = {}
        for route, extra in routes.items():
            out, launch = kernel_launch(q, k, v, coef, mode, **kw, **extra)
            launch()
            err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
            if not err <= tol:
                raise SystemExit(f"{label} ({route}): the kernel disagrees with the plain version ({err:.3e})")
            launches[route] = launch
            if shift is None:
                exact_want = want
        # the routes in turns, PAIRS times, the first of each pair alternating: each launched alone, and
        # with its host work (the wrapper's: the operands laid out by kernel_launch, then the launch)
        alone, call = {r: [] for r in routes}, {r: [] for r in routes}
        for i in range(PAIRS):
            for route in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
                extra = routes[route]
                alone[route].append(cuda_ms(launches[route], reps))
                call[route].append(cuda_ms(lambda: kernel_launch(q, k, v, coef, mode, **kw, **extra)[1](), reps))
        line = []
        for route in routes:
            try:
                dev_ms = f"{device_ms(launches[route], reps):.4f}"
            except SystemExit:  # the profiler saw no launch: the device time is not measured
                dev_ms = "not measured"
            line.append(f"{route} alone {statistics.median(alone[route]):.4f} ms (least {min(alone[route]):.4f}) "
                        f"device {dev_ms} with host work {statistics.median(call[route]):.4f} "
                        f"(least {min(call[route]):.4f})")
            result[f"{name} {label} {route}"] = statistics.median(alone[route])
        if fits:
            won = sum(n <= o for n, o in zip(call["new"], call["old"]))
            line.append(f"with host work the new route no slower in {won} of {PAIRS} pairs")
        del launches
        wrapper_ms = cuda_ms(lambda: wrapper(q, k, v, coef, mode, **kw), reps)
        skip_rows = int(kw["skip_endpoints"].sum()) if kw else 0
        bound_ms, by = attention_bound(mode, B, H, Sq, L, D, skip_rows=skip_rows, **({"kind": name} if name == "f16"
                                                                                       else {}))
        lib, lib_ms = dwide_sdpa(q, k, v, coef, mode, want, reps)
        sdpa = f"SDPA {lib} {lib_ms:.4f} ms" if lib else "SDPA —"
        routed = fits and kernel_launch(q, k, v, coef, mode, **kw)[1].operands[kind]
        print(f"{name} {label:34s} (7,{H},{Sq},{D}) {' | '.join(line)} | wrapper {wrapper_ms:.4f} ms | bound "
              f"{bound_ms:.4f} ({by}) | {sdpa}{'' if fits or not has else f' | not on the {kind} kernel'}"
              f"{' | routed there' if routed else ' | the route keeps the streaming kernel' if fits else ''}",
              flush=True)
        del q, k, v, want
    return result


# (label, dtype, mode, coefficients, H, Sq, L, D[, B = 7]): the call classes
# "auto" shifts on the paths, and one it keeps exact (a 77-key call the
# short-stream kernel takes; its static instance would be the streaming kernel's)
STATIC_SHIFTS = [
    *[(f"SDXL {m} 4096 D=64", "bf16", m, "sdxl", 10, 4096, 4096, 64) for m in ("self", "fused_outer")],
    *[(f"SDXL {m} 1024 D=64", "bf16", m, "sdxl", 20, 1024, 1024, 64)
      for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner")],
    *[(f"SD1.5 {m} 4096 D=40", "bf16", m, "sd", 8, 4096, 4096, 40) for m in ("self", "fused_outer")],
    ("SD1.5 fused_outer 1024 D=80", "bf16", "fused_outer", "sd", 8, 1024, 1024, 80),
    ("SD2.1 self 9216 D=64", "bf16", "self", "sd", 5, 9216, 9216, 64),
    ("SD2.1 fused_outer 2304 D=64", "bf16", "fused_outer", "sd", 10, 2304, 2304, 64),
    ("SD2.1 fused_outer 576 D=64", "bf16", "fused_outer", "sd", 20, 576, 576, 64),
    *[(f"f32 SDXL {m} 4096 D=64", "f32", m, "sdxl", 10, 4096, 4096, 64) for m in ("self", "fused_outer")],
    ("f32 SDXL fused_outer 1024 D=64", "f32", "fused_outer", "sdxl", 20, 1024, 1024, 64),
    *[(f"f32 SD1.5 {m} 4096 D=40", "f32", m, "sd", 8, 4096, 4096, 40) for m in ("self", "fused_outer")],
    ("f32 SD1.5 fused_outer 1024 D=80", "f32", "fused_outer", "sd", 8, 1024, 1024, 80),
    ("SDXL cross fused_outer 4096x77 D=64", "bf16", "fused_outer", "sdxl", 10, 4096, 77, 64),
    # the VAE mid block: the D=512 self kernels' static instances
    *[(f"{n} VAE self {S} D=512 x{B}", n, "self", "sd", 1, S, S, 512, B)
      for n in ("f32", "bf16") for B, S in ((1, 16384), (7, 4096), (1, 4000))],
    # SD 1.x with 320-wide heads, and self mode at 448 and 504: the D=161-512 kernels' static instances
    *[(f"{n} SD1.x {m} 4096 D=320", n, m, "sd", 1, 4096, 4096, 320) for n in ("bf16", "f32")
      for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")],
    *[(f"{n} SD1.x fused_outer 1024 D=320", n, "fused_outer", "sd", 2, 1024, 1024, 320) for n in ("bf16", "f32")],
    *[(f"{n} self 1024 D={D}", n, "self", "sd", 2, 1024, 1024, D) for n in ("bf16", "f32") for D in (448, 504)],
    # the 16-bit kernel's split layout (6 to 8 chunks: two warpgroups split D) in endpoint modes, f32 beside
    *[(f"{n} split D={D} {m} 1024", n, m, "sd", 2, 1024, 1024, D) for n in ("bf16", "f32") for D in (384, 512)
      for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner")],
    # SD 1.x with one head a level (phase 22): the wide kernels' static instances at D = 640 over 1024 tokens in
    # every mode, bf16 and f32; in bf16 its 77-key cross call, the 1280-wide levels over 256 and 64 tokens (the
    # 64-token one split, with the combine step), a ragged 520 and self (2,1,512,2048) (split); in f32 (where
    # "auto" stops at 1024) fused_outer (7,1,256,1024) and self (2,1,512,2048) at an explicit shift
    *[(f"{n} wide {m} 1024 D=640", n, m, "sd", 1, 1024, 1024, 640) for n in ("bf16", "f32")
      for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")],
    ("bf16 wide cross fused_outer 1024x77 D=640", "bf16", "fused_outer", "sd", 1, 1024, 77, 640),
    *[(f"bf16 wide fused_outer {S} D=1280", "bf16", "fused_outer", "sd", 1, S, S, 1280) for S in (256, 64)],
    ("bf16 wide fused_outer 1024 D=520", "bf16", "fused_outer", "sd", 1, 1024, 1024, 520),
    ("f32 wide fused_outer 256 D=1024", "f32", "fused_outer", "sd", 1, 256, 256, 1024),
    *[(f"{n} wide self 512 D=2048 x2", n, "self", "sd", 1, 512, 512, 2048, 2) for n in ("bf16", "f32")],
]


def bench_static(reps: int, only: str) -> dict:
    """STATIC_SHIFTS: {label: {static / exact: median ms launched alone}}.
    Each call on its static-shift instance (kernel_launch with static_smax =
    STATIC_SHIFT_C, the instance the route gives it) and on its exact route,
    in PAIRS turns (the first of each pair alternating): launched alone and
    through the wrapper (static_smax 40 against None), medians and least
    times, the kernels' device time from a profiler trace, the bound, the
    fastest SDPA backend computing the same function past D = 160 in self
    and the inner modes (:func:`dwide_sdpa`, on the exact result; "—" in the
    outer modes); each held to the plain version (its static shift; the
    exact softmax). 7 frames, (B, S, H*D) projections viewed as (B, H, S,
    D), the coef-0/1 end rows as skip rows."""
    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops import flash_attention as fa
    from aid_tpu_torch.ops.flash_attention import (
        STATIC_SHIFT_C,
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        kernel_launch,
    )
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    B = 7
    coefs = {"sdxl": torch.tensor([0.0, 0.2, 0.35, 0.5, 0.65, 0.8, 1.0], device=dev),
             "sd": chip_smoke.sd15_coef().to(dev)}
    result = {}
    for label, name, mode, ck, H, Sq, L, D, *rows in STATIC_SHIFTS:
        if not any(part in label for part in only.split(",")):  # --only: labels holding any of its parts
            continue
        B = rows[0] if rows else 7
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[name]
        tol = chip_smoke.ATTN_TOL if name == "bf16" else chip_smoke.F32_ATTN_TOL
        coef = coefs[ck][:B] if B < 7 else coefs[ck]
        d512 = fa.takes_d512_self(D, mode, dtype)  # the D=512 self kernels take it: d512_launch lays it out

        def heads(n):
            x = torch.randn((B, n, H * D), generator=gen, device=dev).to(dtype)
            return x.view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(Sq), heads(L), heads(L)
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(coef, B)}
        routes = {"static": STATIC_SHIFT_C, "exact": None}
        launches, exact_want = {}, None
        for route, shift in routes.items():
            if d512:
                out, launch = fa.d512_launch(q, k, v, static_smax=shift)
            else:
                out, launch = kernel_launch(q, k, v, coef, mode, static_smax=shift, **kw)
            launch()
            want = flash_interpolated_attention_plain(q, k, v, coef, mode, static_smax=shift, **kw)
            err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
            if not err <= tol:
                raise SystemExit(f"{label} ({route}): the kernel disagrees with the plain version ({err:.3e})")
            launches[route] = launch
            if shift is None:
                exact_want = want
        alone, call = {r: [] for r in routes}, {r: [] for r in routes}
        for i in range(PAIRS):
            for route in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
                shift = routes[route]
                alone[route].append(cuda_ms(launches[route], reps))
                call[route].append(cuda_ms(
                    lambda: flash_interpolated_attention(q, k, v, coef, mode, static_smax=shift, **kw), reps))
        tag = label if label.startswith(name) else f"{name} {label}"
        line, result[tag] = [], {}
        for route in routes:
            try:
                dev_ms = f"{device_ms(launches[route], reps):.4f}"
            except SystemExit:  # the profiler saw no launch: the device time is not measured
                dev_ms = "not measured"
            entry = launches[route].operands["entry"]
            line.append(f"{route} ({entry}) alone {statistics.median(alone[route]):.4f} ms (least "
                        f"{min(alone[route]):.4f}) device {dev_ms} wrapper {statistics.median(call[route]):.4f} "
                        f"(least {min(call[route]):.4f})")
            result[tag][route] = statistics.median(alone[route])
        won = sum(a <= b for a, b in zip(alone["static"], alone["exact"]))
        ratio = statistics.median(alone["static"]) / statistics.median(alone["exact"])
        skip_rows = int(kw["skip_endpoints"].sum()) if kw else 0
        # f32: three TF32 passes at D <= 160 and past 512, the D=512 design's split (F32_D512_PASSES) between
        passes = ({} if name != "f32" else chip_smoke.F32_D512_PASSES if 160 < D <= 512 else {"tf32_passes": 3})
        bound_ms, by = attention_bound(mode, B, H, Sq, L, D, skip_rows=skip_rows, elem=4 if name == "f32" else 2,
                                       **passes)
        lib, lib_ms = dwide_sdpa(q, k, v, coef, mode, exact_want, reps) if D > 160 else (None, None)
        sdpa = f"SDPA {lib} {lib_ms:.4f} ms" if lib else "SDPA —"
        print(f"{tag:41s} ({B},{H},{Sq},{D}) {' | '.join(line)} | static/exact alone {ratio:.4f}, static no "
              f"slower alone in {won} of {PAIRS} pairs | bound {bound_ms:.4f} ({by}) | {sdpa} | the route under "
              f"auto: {'static' if fa.resolve_static_smax(q, k, mode) is not None else 'exact'}", flush=True)
        del q, k, v, launches, exact_want
    return result


def bench_static_headline(steps: int) -> dict:
    """The SDXL headline's denoise (chip_smoke.build_headline, ``steps`` Euler
    steps, half fused_outer) under "auto" and exact everywhere, in turns
    (a 2-step warmup of each, then four pairs, the first of each pair
    alternating): {mode: [s/step]}."""
    import importlib

    from chip_smoke import build_headline, run_denoise

    attn = importlib.import_module("aid_tpu_torch.ops.attention")
    unet, sample, ehs, uncond, added, coef = build_headline()
    gate = attn.FLASH_MIN_KV
    times = {"auto": [], "exact": []}
    for i, mode in enumerate(("auto", "exact") + ("auto", "exact", "exact", "auto") * 2):
        attn.FLASH_MIN_KV = gate if mode == "auto" else 1 << 30  # past every call: "auto" resolves exact
        try:
            _, elapsed = run_denoise(unet, sample, ehs, uncond, added, coef, steps if i >= 2 else 2)
        finally:
            attn.FLASH_MIN_KV = gate
        if i >= 2:
            times[mode].append(elapsed / steps)
            print(f"SDXL headline, {steps} steps, {mode}: {elapsed / steps:.4f} s/step", flush=True)
    print(f"SDXL headline s/step medians: auto {statistics.median(times['auto']):.4f}, exact "
          f"{statistics.median(times['exact']):.4f}", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("bf16", "f16", "f32"), default="bf16")
    ap.add_argument("--d512", action="store_true", help="the D=512 self-attention of --dtype (VAE mid block)")
    ap.add_argument("--dmid", action="store_true", help="the D=161-512 entries of --dtype (and the D=512 self route)")
    ap.add_argument("--dwide", action="store_true", help="the wide entries (head dims past 512) of --dtype")
    ap.add_argument("--onepass", action="store_true",
                    help="the short key streams of --dtype (bf16 or f16) on the short-stream kernel and the route before")
    ap.add_argument("--midstream", action="store_true",
                    help="the mid-length key streams of --dtype (bf16 or f16) on the mid-length stream kernel and the "
                         "route before")
    ap.add_argument("--static", action="store_true",
                    help="the static-shift instances beside the exact route at the call classes 'auto' shifts")
    ap.add_argument("--headline", type=int, default=0,
                    help="with --static: also the SDXL headline's denoise of this many steps, auto against exact")
    ap.add_argument("--only", default="", help="time only the shapes whose label contains this text (with "
                                               "--static: any of its comma-separated parts)")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose package and chip_smoke.py are timed (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import (
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        kernel_launch,
    )
    import chip_smoke
    from chip_smoke import attention_bound, cuda_ms, phase_device

    card = phase_device()  # also sets full f32 matmuls (TF32 off) for the plain version
    if args.static:
        result = bench_static(args.reps, args.only)
        if args.headline:
            result["headline s/step"] = bench_static_headline(args.headline)
        print(f"on {card}, the package of {Path(args.root).resolve()}", flush=True)
        print(json.dumps(result), flush=True)
        return 0
    if args.d512 or args.dwide or args.dmid or args.onepass or args.midstream:
        result = (bench_d512(args.reps, args.dtype) if args.d512 else
                  bench_onepass(args.reps, args.dtype, args.only) if args.onepass else
                  bench_onepass(args.reps, args.dtype, args.only, "midstream") if args.midstream else
                  bench_dmid(args.reps, args.dtype, args.only) if args.dmid else
                  bench_dwide(args.reps, args.dtype, args.only))
        print(f"on {card}, the package of {Path(args.root).resolve()}", flush=True)
        print(json.dumps(result), flush=True)
        return 0
    f32, kind = args.dtype == "f32", args.dtype
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[kind]
    tol = {"bf16": chip_smoke.ATTN_TOL, "f32": chip_smoke.F32_ATTN_TOL}.get(kind) or chip_smoke.F16_ATTN_TOL
    backend = SDPBackend.EFFICIENT_ATTENTION if f32 else SDPBackend.CUDNN_ATTENTION
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B = 7
    coef = torch.linspace(0.0, 1.0, B, device=dev)
    skip = skip_mask(coef, B)
    result = {}
    for label, mode, H, Sq, L, D in F32_SHAPES if f32 else SHAPES:
        if args.only not in label:
            continue
        def heads(n):
            x = torch.randn((B, n, H * D), generator=gen, device=dev).to(dtype)
            return x.view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(Sq), heads(L), heads(L)
        kw = {} if mode == "self" or label.startswith("IP") else {"skip_endpoints": skip}
        out, launch = kernel_launch(q, k, v, coef, mode, **kw)
        launch()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= tol:
            raise SystemExit(f"{label}: the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, args.reps)
        bound_ms, by = attention_bound(mode, B, H, Sq, L, D, skip_rows=int(skip.sum()) if "skip_endpoints" in kw else 0,
                                       elem=4 if f32 else 2, tf32_passes=3 if f32 else None,
                                       **({"kind": kind} if kind == "f16" else {}))
        line = f"{label:32s} launch alone {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, {bound_ms / ms:.1%})"
        if f32 or label.startswith("IP"):
            wrapper_ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, coef, mode, **kw), args.reps)
            line += f"  through the wrapper {wrapper_ms:.4f} ms"
        if mode == "self":
            with sdpa_kernel(backend):
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), args.reps)
            line += f"  SDPA {backend.name.lower()} {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"
        print(line, flush=True)
        result[label] = ms
    print(f"on {card}, the package of {Path(args.root).resolve()}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
