"""Time the bf16 flash attention kernel launched alone at the main paths' shapes.

    python3 tools/attention_bench.py [--reps 20]

For each shape class of ``chip_smoke.py`` phase 3 (SDXL at D=64, SD1.5 at
D=40/80/160; 7 frames, (B, S, H*D) projections viewed as (B, H, S, D), the
coef-0/1 end rows as skip rows) it prepares one launch with
``ops.flash_attention.kernel_launch`` and times that launch alone with CUDA
events, beside the bound (``chip_smoke.attention_bound``) and, in self mode,
SDPA's cuDNN backend on the same inputs. It checks each result against the
plain version (``chip_smoke.ATTN_TOL``). Run it in two checkouts within one
call to compare two versions of the kernel on one card. The last line is one
JSON object {label: ms}. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention_plain, kernel_launch
    from chip_smoke import ATTN_TOL, attention_bound, cuda_ms, phase_device

    card = phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B = 7
    coef = torch.linspace(0.0, 1.0, B, device=dev)
    skip = skip_mask(coef, B)
    result = {}
    for label, mode, H, Sq, L, D in SHAPES:
        def heads(n):
            x = torch.randn((B, n, H * D), generator=gen, device=dev).to(torch.bfloat16)
            return x.view(B, n, H, D).transpose(1, 2)

        q, k, v = heads(Sq), heads(L), heads(L)
        kw = {} if mode == "self" else {"skip_endpoints": skip}
        out, launch = kernel_launch(q, k, v, coef, mode, **kw)
        launch()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, **kw)
        err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not err <= ATTN_TOL:
            raise SystemExit(f"{label}: the kernel disagrees with the plain version ({err:.3e})")
        ms = cuda_ms(launch, args.reps)
        bound_ms, by = attention_bound(mode, B, H, Sq, L, D, skip_rows=0 if mode == "self" else int(skip.sum()))
        line = f"{label:32s} launch alone {ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, {bound_ms / ms:.0%})"
        if mode == "self":
            with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), args.reps)
            line += f"  SDPA cuDNN {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"
        print(line, flush=True)
        result[label] = ms
    print(f"on {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
