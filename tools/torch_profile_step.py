"""Where the device time of one denoise step goes, for the PyTorch port on an NVIDIA GPU.

    python3 tools/torch_profile_step.py [--model sdxl|sd15] [--out chiprun_out]

Builds one of ``chip_smoke.py``'s programs: ``sdxl`` (the default) is the
headline (full-width SDXL UNet, bf16, N(0, 0.02) random weights, 7 frames at
128x128 latents, Beta(28, 28) coefficients, Euler, guidance 5); ``sd15`` is
the SD1.5 sequence (full-width SD1.5 UNet, bf16, N(0, 0.02) random weights,
7 frames at 64x64 latents, Beta(25, 25) coefficients, DDIM, guidance 7.5).
It runs two steps of each kind untraced to warm up, then traces with
``torch.profiler``:

  warmup step  fused_outer cond forward + vanilla uncond forward
  late step    two vanilla forwards

For each it writes the Chrome trace to ``--out`` and reads the trace's device
events (GPU kernels, memcpys and memsets):

  span     first device event's start to the last one's end, in ms
  busy     length of the union of the device events' intervals, in ms
  idle     1 - busy / span: the share of the span in which the device ran nothing
  classes  summed kernel time by class (the name patterns in ``CLASSES``)

The profiler slows the host's kernel launches, which can stretch the traced
span past the step's own time. So it also times the step without the
profiler (host clock, mean of 3, ending in a synchronize) and reports
1 - busy / that wall time as a second idle reading. The last line is one
JSON object with every number above. Needs a CUDA device; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (class, pattern on the kernel name); the first match wins. The port's
# kernels by source (demangled names, template arguments in order): the
# attention's mode is its HAS_OWN, NSETS arguments after the element type and
# head dim (flash_kernel<T, D, HAS_OWN, NSETS>, flash_f32_kernel<D, HAS_OWN,
# NSETS>, the D=161-512 kernels' <T, chunks, HAS_OWN, NSETS> and
# <M blocks, keys, HAS_OWN, NSETS>): fused_outer is true, 2, self and cross
# true, 0. The mid-length stream kernel (midstream_kernel<T, D, warpgroups,
# IDLE, NSETS>) has a class a mode kind by its NSETS, the last argument:
# 2 the outer modes, 0 self mode, 1 the inner modes. The short-stream kernel
# (onepass_kernel<T, D, stream tiles>, its mode a runtime argument), the
# D=512 self kernels and the wide kernel (its mode a runtime argument too) and
# its combine step have classes of their own. The static-shift instances (the
# same kernels in the namespace static_shift: the D <= 160, mid-length, D=161-512
# and D=512 self ones) land in their exact instances' classes.
_MODED = r"(?:flash_kernel<\w+, \d+, |flash_f32_kernel<\d+, |flash16_dmid_(?:rows|split)_kernel<\w+, \d+, |" \
         r"flash_f32_dmid_kernel<\d+, \d+, )"
CLASSES = [
    ("attention kernel, fused_outer", re.compile(_MODED + r"true, 2>")),
    ("attention kernel, self and cross", re.compile(_MODED + r"true, 0>")),
    ("attention kernel, other modes", re.compile(_MODED)),
    ("attention kernel, short key streams", re.compile(r"onepass_kernel<")),
    ("attention kernel, mid-length streams, outer modes", re.compile(r"midstream_kernel<[^>]*, 2>")),
    ("attention kernel, mid-length streams, self", re.compile(r"midstream_kernel<[^>]*, 0>")),
    ("attention kernel, mid-length streams, inner modes", re.compile(r"midstream_kernel<")),
    ("attention kernel, D=512 self (VAE)", re.compile(r"flash16_d512_kernel<|flash_f32_d512_kernel\b")),
    ("attention kernel, head dims past 512", re.compile(r"flash_dwide_kernel<|flash_dwide_combine_kernel<")),
    ("conv kernel", re.compile(r"conv3x3_kernel<|conv3x3_f32_kernel\b")),
    ("conv layout pass", re.compile(r"blocked_kernel<|blocked_f32_kernel<")),
    ("cuDNN convs", re.compile(r"fprop|implicit_convolve|conv2d|cudnn", re.I)),
    ("cuBLAS GEMMs", re.compile(r"nvjet|gemm|cutlass", re.I)),
    ("GroupNorm / LayerNorm", re.compile(r"norm|Moments|ComputeFusedParams", re.I)),
    ("elementwise and other", re.compile(r"")),
]
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def device_summary(trace_path: Path) -> dict:
    """Span, busy time, idle share and time by class of a Chrome trace's device events."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise SystemExit(f"{trace_path}: no device events in the trace (the profiler did not trace the card)")
    intervals = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, cur_start, cur_end = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    span = intervals[-1][1] - intervals[0][0]
    classes = {name: 0.0 for name, _ in CLASSES}
    for e in dev:
        if e["cat"] != "kernel":
            classes["elementwise and other"] += float(e["dur"])
            continue
        name = next(n for n, pat in CLASSES if pat.search(e["name"]))
        classes[name] += float(e["dur"])
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / span,
            "classes_ms": {k: v / 1e3 for k, v in classes.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("sdxl", "sd15"), default="sdxl", help="which program's step to trace")
    ap.add_argument("--out", default="chiprun_out", help="directory for the Chrome traces")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.pipelines.engine import denoise_sequence
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler
    from chip_smoke import build_headline, build_sd15, phase_device, sd15_coef

    card = phase_device()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.model == "sdxl":
        unet, sample, ehs, uncond, added, coef = build_headline()
        scheduler, guidance = EulerDiscreteScheduler(), 5.0
    else:
        unet, coef = build_sd15(), sd15_coef().cuda()
        gen = torch.Generator(device="cuda").manual_seed(1)
        cfg = unet.config
        sample = torch.randn((7, cfg.in_channels, 64, 64), generator=gen, device="cuda")
        ehs, uncond = (torch.randn((7, 77, cfg.cross_attention_dim), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(2))
        added, scheduler, guidance = None, DDIMScheduler(), 7.5
    state = scheduler.init(1, device=sample.device)

    def step(warmup: bool):
        return denoise_sequence(unet, scheduler, sample, ehs, uncond, coef, state, guidance,
                                early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(),
                                num_steps=1, warmup_steps=int(warmup), added_cond=added)

    result = {"card": card, "model": args.model, "steps": {}}
    for label, warmup in (("warmup step", True), ("late step", False)):
        for _ in range(2):
            step(warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(warmup)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(warmup)
            torch.cuda.synchronize()
        trace = out_dir / f"trace_{args.model}_{label.replace(' ', '_')}.json"
        prof.export_chrome_trace(str(trace))
        summary = device_summary(trace)
        summary.update(wall_ms_unprofiled=wall_ms, idle_share_of_wall=1.0 - summary["busy_ms"] / wall_ms)
        result["steps"][label] = summary
        print(f"### {label}: traced device span {summary['span_ms']:.1f} ms, busy {summary['busy_ms']:.1f} ms, "
              f"idle share {summary['idle_share']:.4f}; unprofiled wall {wall_ms:.1f} ms, "
              f"1 - busy/wall {summary['idle_share_of_wall']:.4f}  ({trace})", flush=True)
        for name, ms in sorted(summary["classes_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {name:36s} {ms:9.2f} ms  {ms / summary['busy_ms']:6.1%}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
