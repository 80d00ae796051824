"""Time the flash attention kernel launched alone at the main paths' shapes.

    python3 tools/attention_bench.py [--reps 20] [--dtype bf16|f32] [--d512] [--only TEXT] [--root DIR]

For each shape class of ``chip_smoke.py`` phase 3 (bf16: SDXL at D=64, SD1.5
at D=40/80/160; f32: every f32 shape of PERF.md's kernel table, SDXL's and SD
2.1's D=64 and SD1.5's D=40/80/160, the latter at 256 and 64 tokens and the
77-key cross-attention; 7 frames, (B, S, H*D) projections viewed as (B, H,
S, D), the coef-0/1 end rows as skip rows; ``--only`` keeps the labels that
contain its text, say ``D=160``) it prepares one launch
with ``ops.flash_attention.kernel_launch`` and times that launch alone with
CUDA events, beside the bound (``chip_smoke.attention_bound``; f32 at three
TF32 passes) and, in self mode, SDPA on the same inputs (bf16: cuDNN; f32:
the efficient backend, the fastest that takes f32). f32 also times the call
through the wrapper, as the model makes it. ``--d512`` times the bf16 D=512
self-attention of a bf16 VAE's mid block instead, at its three shapes
(one 1024px frame, 16384 tokens; seven 512px frames, 4096; the tiled
decode's ragged 4000-token tile): launched alone on operands
``ops.flash_attention.d512_launch`` prepared once and through the wrapper,
beside SDPA efficient. It checks each result against
the plain version (``chip_smoke.ATTN_TOL`` / ``F32_ATTN_TOL``). ``--root``
imports the package and ``chip_smoke.py`` of another checkout (say, the
parent commit unpacked under ``build/``): run both in one call, in turns, to
compare two versions of the kernel on one card. The last line is one JSON
object {label: ms alone}. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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


# (frames, tokens) of the bf16 D=512 self-attention: one SDXL frame, SD 1.5's
# batched 512px decode, the tiled decode's ragged tile
D512_SHAPES = [(1, 16384), (7, 4096), (1, 4000)]


def bench_d512(reps: int) -> dict:
    """The bf16 D=512 kernel at D512_SHAPES: {label: ms alone}; prints each
    with its time through the wrapper, its bound and SDPA efficient's."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from aid_tpu_torch.ops.flash_attention import (
        d512_launch,
        flash_interpolated_attention_plain,
        flash_self_attention_bf16,
    )
    from chip_smoke import BF16_D512_TOL, attention_bound, cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    result = {}
    for n, S in D512_SHAPES:
        q, k, v = (torch.randn((n, 1, S, 512), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        out, launch = d512_launch(q, k, v)
        launch()
        want = flash_interpolated_attention_plain(q, k, v)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= BF16_D512_TOL:
            raise SystemExit(f"({n},1,{S},512): the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, reps)
        wrapper_ms = cuda_ms(lambda: flash_self_attention_bf16(q, k, v), reps)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps)
        bound_ms, by = attention_bound("self", n, 1, S, S, 512)
        label = f"bf16 self ({n},1,{S},512)"
        print(f"{label:32s} launch alone {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, {bound_ms / ms:.1%})  through "
              f"the wrapper {wrapper_ms:.4f} ms  SDPA efficient {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)", flush=True)
        result[label] = ms
        del q, k, v, out, want, launch
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--d512", action="store_true", help="the bf16 D=512 self-attention (VAE mid block)")
    ap.add_argument("--only", default="", help="time only the shapes whose label contains this text")
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
    from chip_smoke import ATTN_TOL, F32_ATTN_TOL, attention_bound, cuda_ms, phase_device

    card = phase_device()  # also sets full f32 matmuls (TF32 off) for the plain version
    if args.d512:
        result = bench_d512(args.reps)
        print(f"on {card}, the package of {Path(args.root).resolve()}", flush=True)
        print(json.dumps(result), flush=True)
        return 0
    f32 = args.dtype == "f32"
    dtype, tol, backend = ((torch.float32, F32_ATTN_TOL, SDPBackend.EFFICIENT_ATTENTION) if f32
                           else (torch.bfloat16, ATTN_TOL, SDPBackend.CUDNN_ATTENTION))
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
        kw = {} if mode == "self" else {"skip_endpoints": skip}
        out, launch = kernel_launch(q, k, v, coef, mode, **kw)
        launch()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= tol:
            raise SystemExit(f"{label}: the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, args.reps)
        bound_ms, by = attention_bound(mode, B, H, Sq, L, D, skip_rows=0 if mode == "self" else int(skip.sum()),
                                       elem=4 if f32 else 2, tf32_passes=3 if f32 else None)
        line = f"{label:32s} launch alone {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, {bound_ms / ms:.1%})"
        if f32:
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
