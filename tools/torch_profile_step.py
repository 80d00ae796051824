"""Where the device time of one denoise step goes, for the PyTorch port on an NVIDIA GPU.

    python3 tools/torch_profile_step.py [--out chiprun_out]

Builds the headline program of ``chip_smoke.py`` (full-width SDXL UNet, bf16,
N(0, 0.02) random weights, 7 frames at 128x128 latents, Beta(28, 28)
coefficients, Euler, guidance 5), runs two steps of each kind untraced to warm
up, then traces with ``torch.profiler``:

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

# (class, pattern on the kernel name); the first match wins
CLASSES = [
    ("attention kernel, fused_outer", re.compile(r"flash_kernel<true, 2>")),
    ("attention kernel, self and cross", re.compile(r"flash_kernel<true, 0>")),
    ("attention kernel, other modes", re.compile(r"flash_kernel<")),
    ("conv kernel", re.compile(r"conv3x3_kernel")),
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
    ap.add_argument("--out", default="chiprun_out", help="directory for the Chrome traces")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.pipelines.engine import denoise_sequence
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler
    from chip_smoke import build_headline, phase_device

    card = phase_device()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    unet, sample, ehs, uncond, added, coef = build_headline()
    scheduler = EulerDiscreteScheduler()
    state = scheduler.init(1, device=sample.device)

    def step(warmup: bool):
        return denoise_sequence(unet, scheduler, sample, ehs, uncond, coef, state, 5.0,
                                early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(),
                                num_steps=1, warmup_steps=int(warmup), added_cond=added)

    result = {"card": card, "steps": {}}
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
        trace = out_dir / f"trace_{label.replace(' ', '_')}.json"
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
