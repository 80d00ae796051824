"""Time the f32 3x3 conv kernel, alone and through its wrapper, at the f32 UNets' classes.

    python3 tools/conv_bench.py [--reps 5] [--root DIR]

For each f32 conv class of ``chip_smoke.py`` phase 3 (SDXL's three 128^2
classes and SD 2.1's two 96^2 ones, 7 frames) it times
``ops.conv.conv3x3_same`` on an f32 NCHW tensor (the call the model makes:
the layout pass and the launch) and the launch alone on operands
``ops.conv.kernel_operands`` laid out once, beside the 3xTF32 bound
(``chip_smoke.conv_bound``) and cuDNN in f32 with TF32 off (NCHW and
channels-last, the faster counted). Then the f32 GN+SiLU conv
(``conv3x3_gnsilu``) at SDXL's (7, 960, 128, 128) -> 320 and SD 2.1's
960 -> 320 at 96^2, through the wrapper and launched alone (its layout pass
applies the prologue). Each result is checked against the plain version
(``chip_smoke.F32_CONV_TOL``). ``--root`` imports the package and
``chip_smoke.py`` of another checkout (say, the parent commit unpacked
under ``build/``): run both in one call, in turns, to compare two versions
of the kernel on one card. The last line is one JSON object {label: [ms
through the wrapper, ms alone]}. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# (Cin, Cout, H = W)
CLASSES = [(960, 320, 128), (640, 320, 128), (640, 640, 128), (960, 320, 96), (640, 640, 96)]
GNSILU_CLASSES = [(960, 320, 128), (960, 320, 96)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose package and chip_smoke.py are timed (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from aid_tpu_torch.ops import conv
    from chip_smoke import F32_CONV_TOL, conv_bound, cuda_ms, library_conv_ms, phase_device

    card = phase_device()  # also turns TF32 off for cuDNN and the plain version
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B = 7
    result = {}
    for gnsilu, classes in ((False, CLASSES), (True, GNSILU_CLASSES)):
        for cin, cout, hw in classes:
            x = torch.randn((B, cin, hw, hw), generator=gen, device=dev) * (2.0 if gnsilu else 1.0) + (
                1.0 if gnsilu else 0.0)
            w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (9 * cin) ** -0.5
            b = torch.randn((cout,), generator=gen, device=dev)
            if gnsilu:
                gamma = 1.0 + 0.3 * torch.randn(cin, generator=gen, device=dev)
                beta = 0.5 * torch.randn(cin, generator=gen, device=dev)
                wrapper = lambda: conv.conv3x3_gnsilu(x, w, b, gamma, beta, 32)  # noqa: E731
                plain = conv.conv3x3_gnsilu_plain(x, w, b, gamma, beta, 32)
                ops = conv.kernel_operands(x, w, b, *conv.gn_scale_shift(x, gamma, beta, 32, 1e-5))
            else:
                wrapper = lambda: conv.conv3x3_same(x, w, b)  # noqa: E731
                plain = conv.conv3x3_same_plain(x, w, b)
                ops = conv.kernel_operands(x, w, b)
            got = wrapper()
            err = (got - plain).abs().max().item() / plain.abs().max().item()
            if not err <= F32_CONV_TOL:
                raise SystemExit(f"{cin}->{cout} @{hw}: the kernel disagrees with the plain version ({err:.3e})")
            del got, plain
            alone_ms = cuda_ms(lambda: conv.launch_kernel("aid_conv3x3_f32", *ops), args.reps)
            ms = cuda_ms(wrapper, args.reps)
            bound_ms, by = conv_bound(B, hw, hw, cin, cout, prologue=gnsilu, tf32_passes=3)
            label = f"{'gnsilu ' if gnsilu else ''}f32 ({B},{cin},{hw},{hw})->{cout}"
            line = (f"{label:36s} through the wrapper {ms:.3f} ms, launch alone {alone_ms:.3f} ms  bound "
                    f"{bound_ms:.3f} ms ({by}, {bound_ms / alone_ms:.1%} alone)")
            if not gnsilu:
                lib = library_conv_ms(x, w, b, args.reps)
                name = min(lib, key=lib.get)
                line += f"  {name} f32 {lib[name]:.3f} ms (wrapper {ms / lib[name]:.2f}x)"
            print(line, flush=True)
            result[label] = [ms, alone_ms]
            del x, w, b, ops
    print(f"on {card}, the package of {Path(args.root).resolve()}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
