"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py            # 4 denoise steps (2 fused_outer warmup + 2 vanilla)
    python3 chip_smoke.py --steps 28 # the full headline schedule

The main path is the port of ``bench.py::build_headline``: ``denoise_sequence``
over the full-width SDXL UNet (bf16, N(0, 0.02) random weights from a seeded
CUDA generator), 7 frames at 128x128 latents, Euler, guidance 5.0, Beta(28, 28)
frame coefficients, fused_outer AID for the first half of the steps and
vanilla after, sequential CFG.

Phases (each prints its own lines; any failure exits non-zero):
  1. device      needs CUDA; prints the card's name and power limit
  2. build       compiles the CUDA kernels from aid_tpu_torch/csrc
  3. kernels     each kernel against its plain PyTorch version at the main
                 path's shapes, with stated tolerances, and both times
  4. whole UNet  one full-width SDXL forward in fused_outer through the
                 kernels and through the plain versions (test-only seam)
  5. main path   the denoise; launch counters, finite checksum, s/step, peak memory
The second-to-last line is the kernels' JSON record, the last the result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# tolerances, each with its reason
# ---------------------------------------------------------------------------

# Attention, bf16 in and out, vs the plain version (f32 logits, softmax and
# PV accumulation, the same bf16 roundings of probabilities and output): the
# kernel rounds UNnormalized tile probabilities to bf16 and sums in another
# order. Each is ~2^-9 relative and averages out over thousands of keys; the
# output's own bf16 rounding is 2^-9 of its size. 2% of max |ref| is several
# times that; a wrong segment, mask, stride or blend is tens of percent.
ATTN_TOL = 2e-2
# Conv, bf16 in and out, f32 accumulation on both sides (cuDNN vs the
# kernel): one output rounding (2^-9 relative) plus summation order over
# K = 9*Cin terms. 1% of max |ref| leaves margin; a wrong tap, halo or
# channel stride is O(1).
CONV_TOL = 1e-2
# Whole UNet, kernels vs plain, relative L2 of the output. Sound kernels
# give 2.4e-3 on an H100 (~90 kernel calls per forward, each ~0.3% from its
# plain version in bf16). Faults planted through the plain versions moved
# the same forward by 2.2e-2 (fused_outer computed as self on every row) and
# 3.6e-2 (begin and end endpoints swapped). 1e-2 lies between: 4x the sound
# reading, under half the smaller fault. Phase 4 measures the first fault
# again in every run and fails if the bound does not separate it.
UNET_TOL = 1e-2


def phase_device():
    import torch

    print("== phase 1: device", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)  # name, power limit: every time below is taken at this limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; devices: {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from aid_tpu_torch.ops import _build

    print("== phase 2: build", flush=True)
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"{'reused' if cached else 'built'} {path.name} from {len(_build.sources())} sources "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(coef):
    """Each kernel vs its plain version at the main path's shapes. Returns
    {kernel name: (max abs err, ms, plain ms) at its heaviest shape}."""
    import torch
    import torch.nn.functional as F

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.conv import conv3x3_same, conv3x3_same_plain
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention, flash_interpolated_attention_plain

    print("== phase 3: kernels vs plain versions", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    coef = coef.to(dev)
    B = coef.shape[0]
    skip = skip_mask(coef, B)  # rows 0 (coef 0) and N-1 (coef 1)
    records = {}

    def heads(x, H):  # a (B, S, H*64) projection viewed as (B, H, S, 64), as the model passes it
        return x.view(x.shape[0], x.shape[1], H, 64).transpose(1, 2)

    # (label, mode, H, Sq, Lkv, reps): self/fused_outer self-attention and
    # the 77-token cross-attention at both SDXL attention levels, then the
    # other three modes at one small shape
    attn_cases = [
        ("self 4096", "self", 10, 4096, 4096, 10),
        ("fused_outer 4096", "fused_outer", 10, 4096, 4096, 5),
        ("self 1024", "self", 20, 1024, 1024, 20),
        ("fused_outer 1024", "fused_outer", 20, 1024, 1024, 20),
        ("cross self 4096x77", "self", 10, 4096, 77, 20),
        ("cross fused_outer 4096x77", "fused_outer", 10, 4096, 77, 20),
        ("cross self 1024x77", "self", 20, 1024, 77, 20),
        ("cross fused_outer 1024x77", "fused_outer", 20, 1024, 77, 20),
        ("pure_outer 256", "pure_outer", 10, 256, 256, 20),
        ("pure_inner 256", "pure_inner", 10, 256, 256, 20),
        ("fused_inner 256", "fused_inner", 10, 256, 256, 20),
    ]
    worst = 0.0
    for label, mode, H, Sq, L, reps in attn_cases:
        q = heads(randn(B, Sq, H * 64), H)
        k, v = heads(randn(B, L, H * 64), H), heads(randn(B, L, H * 64), H)
        sk = skip if mode != "self" else None
        got = flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=sk)
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=sk)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        rel_l2 = ((got.float() - want.float()).norm() / want.float().norm()).item()
        ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=sk), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=sk),
                           max(1, reps // 5))
        ok = math.isfinite(err) and err <= ATTN_TOL * ref
        print(f"attention {label:28s} B={B} H={H}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
              f"tol {ATTN_TOL * ref:.3e}) rel_l2 {rel_l2:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
              f"  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"attention {label}: kernel disagrees with the plain version")
        worst = max(worst, err)
        if label == "fused_outer 4096":
            main = (ms, plain_ms)
        del q, k, v, got, want
    records["flash_interpolated_attention"] = (worst, *main)

    worst = 0.0
    for cin, cout in ((960, 320), (640, 320), (640, 640)):
        x = randn(B, cin, 128, 128)
        w = randn(cout, cin, 3, 3) * (9 * cin) ** -0.5
        b = randn(cout)
        got = conv3x3_same(x, w, b)
        torch.cuda.synchronize()
        want = conv3x3_same_plain(x, w, b)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        ms = cuda_ms(lambda: conv3x3_same(x, w, b), 10)
        plain_ms = cuda_ms(lambda: F.conv2d(x, w, b, padding=1), 10)
        ok = math.isfinite(err) and err <= CONV_TOL * ref
        print(f"conv3x3 B={B} {cin}->{cout} @128x128: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
              f"tol {CONV_TOL * ref:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"conv3x3 {cin}->{cout}: kernel disagrees with the plain version")
        worst = max(worst, err)
        if cin == 960:
            main = (ms, plain_ms)
        del x, w, b, got, want
    records["conv3x3_same"] = (worst, *main)
    return records


def build_headline(frames: int = 7, latent: int = 128, seed: int = 0):
    """The headline program's pieces (bench.py::build_headline, ported)."""
    import torch

    from aid_tpu_torch.models.configs import SDXL_UNET
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.ops.interp import generate_beta_schedule

    dev, dtype = torch.device("cuda"), torch.bfloat16
    cfg = SDXL_UNET
    unet = UNet2DCondition(cfg, device=dev, dtype=dtype).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in unet.parameters():  # every float leaf ~ N(0, 0.02), as bench.py's _random_params
            p.normal_(0.0, 0.02, generator=gen)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    pooled_dim = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    sample = randn(frames, cfg.in_channels, latent, latent)
    ehs = randn(frames, 77, cfg.cross_attention_dim)
    added = {
        "text_embeds": randn(frames, pooled_dim),
        "time_ids": torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]], device=dev).expand(frames, 6),
    }
    uncond = randn(frames, 77, cfg.cross_attention_dim)
    # Beta(28, 28): alpha and beta are the literal 28 of the 28-step headline,
    # whatever the number of steps this run takes
    coef = torch.from_numpy(generate_beta_schedule(frames, 28, 28, force_endpoints=True)).to(dev)
    return unet, sample, ehs, uncond, added, coef


def phase_unet(unet, sample, ehs, added, coef):
    import torch

    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.ops.routing import reference_ops

    print("== phase 4: whole SDXL UNet forward, kernels vs plain (fused_outer)", flush=True)
    aid = AidContext(coef=coef, mode=AidMode.from_name("fused_outer"))
    t = torch.tensor(500.0, device=sample.device)
    with torch.no_grad():
        t0 = time.perf_counter()
        got = unet(sample, t, ehs, aid, added)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with reference_ops():
            want = unet(sample, t, ehs, aid, added)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fault = unet(sample, t, ehs, None, added)  # planted fault: fused_outer computed as self

    def rel_l2(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    if not torch.isfinite(got).all():
        fail("whole-UNet kernel output is not finite")
    rel, fault_rel = rel_l2(got, want), rel_l2(fault, want)
    ok = math.isfinite(rel) and rel <= UNET_TOL
    print(f"unet fused_outer B={sample.shape[0]} 128x128: rel_l2 kernels vs plain {rel:.3e} (tol {UNET_TOL:.0e}; "
          f"planted fault fused_outer->self {fault_rel:.3e}); forward {t1 - t0:.3f} s with kernels (first call), "
          f"{t2 - t1:.3f} s plain  {'ok' if ok else 'FAIL'}", flush=True)
    if not fault_rel > UNET_TOL:
        fail(f"the whole-UNet bound {UNET_TOL:.0e} does not separate a planted fault ({fault_rel:.3e})")
    if not ok:
        fail("whole-UNet output through the kernels disagrees with the plain versions")
    return rel


def phase_main(unet, sample, ehs, uncond, added, coef, steps: int, card: str):
    import torch

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.ops.conv import conv3x3_same
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention
    from aid_tpu_torch.pipelines.engine import denoise_sequence
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler

    print(f"== phase 5: main path, SDXL 7-frame AID denoise, {steps} steps ({steps // 2} fused_outer warmup)",
          flush=True)
    scheduler = EulerDiscreteScheduler()
    state = scheduler.init(steps, device=sample.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_interpolated_attention.launches = 0
    conv3x3_same.launches = 0
    t0 = time.perf_counter()
    out = denoise_sequence(
        unet, scheduler, sample, ehs, uncond, coef, state, 5.0,
        early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(),
        num_steps=steps, warmup_steps=steps // 2, added_cond=added)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_interpolated_attention": flash_interpolated_attention.launches,
                "conv3x3_same": conv3x3_same.launches}
    peak = torch.cuda.max_memory_allocated()
    checksum = float(out.float().sum())
    print(f"launches in the main path: {launches}", flush=True)
    print(f"checksum {checksum!r}; output {tuple(out.shape)} {out.dtype}", flush=True)
    print(f"{elapsed / steps:.3f} s/step ({elapsed:.2f} s for {steps} steps, first steps included); "
          f"peak memory {peak / 2**30:.2f} GiB on {card}", flush=True)
    if tuple(out.shape) != tuple(sample.shape):
        fail(f"output shape {tuple(out.shape)} != {tuple(sample.shape)}")
    if not math.isfinite(checksum):
        fail(f"non-finite output checksum: {checksum}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="denoise steps (half of them fused_outer warmup)")
    args = ap.parse_args(argv)

    card = phase_device()
    import torch

    phase_build()
    unet, sample, ehs, uncond, added, coef = build_headline()
    kernels = phase_kernels(coef)
    phase_unet(unet, sample, ehs, added, coef)
    launches = phase_main(unet, sample, ehs, uncond, added, coef, args.steps, card)

    sources = {"flash_interpolated_attention": ("aid_tpu_torch/csrc/flash_interpolated_attention.cu",
                                                "aid_tpu/ops/flash_attention.py:101",
                                                "aid_tpu/ops/flash_attention.py:339"),
               "conv3x3_same": ("aid_tpu_torch/csrc/conv3x3.cu", "aid_tpu/ops/conv.py:30", None)}
    record = []
    for name, (err, ms, plain_ms) in kernels.items():
        src, replaces, also = sources[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if also:
            entry["also_replaces"] = also
        record.append(entry)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
