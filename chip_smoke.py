"""Drive the PyTorch port's paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py            # 4 denoise steps (2 fused_outer warmup + 2 vanilla)
    python3 chip_smoke.py --steps 28 # the full headline schedule

Three paths, each driven with every launch count set to 0 just before it
and read just after:
  * the denoise (``bench.py::build_headline``, ported): ``denoise_sequence``
    over the full-width SDXL UNet (bf16, N(0, 0.02) random weights from a
    seeded CUDA generator), 7 frames at 128x128 latents, Euler, guidance
    5.0, Beta(28, 28) frame coefficients, fused_outer AID for the first half
    of the steps and vanilla after, sequential CFG;
  * the same UNet with the fused GroupNorm+SiLU resnet prologue switched on
    (``layers._FUSED_GN_CONV``, off by default as in the JAX package);
  * image out: ``InterpolationXLPipeline.interpolate`` from two prompts to
    seven 1024px uint8 frames, through random f32 CLIP ViT-L and OpenCLIP
    bigG text encoders, that UNet and the f32 SDXL VAE decode.

Phases (each prints its own lines; any failure exits non-zero):
  1. device      needs CUDA; prints the card's name and power limit
  2. build       compiles the CUDA kernels from aid_tpu_torch/csrc; ptxas resources
  3. kernels     each kernel against its plain PyTorch version at the paths'
                 shapes, with stated tolerances, and both times
  4. whole UNet  one full-width SDXL forward in fused_outer through the
                 kernels and through the plain versions (test-only seam)
  5. denoise     the main path; launch counts, finite checksum, s/step, peak memory
  6. fused GN    the fused-prologue configuration: a whole-UNet check with a
                 planted halo fault, then a 2-step denoise both ways
  7. image out   interpolate() at 1024px; stage times, launch counts, the raw
                 decoder output through the kernels vs the plain versions
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
# The f32 D=512 attention (VAE mid block), f32 FMA in the kernel against the
# plain version's full-f32 matmuls (TF32 off on both sides, phase 1):
# summation order and exp2 vs exp, ~1e-6 of max |ref| over 16384 keys.
# 1e-4 of max |ref| leaves margin; TF32 rounding (~1e-3) would not pass.
F32_ATTN_TOL = 1e-4
# The GN+SiLU conv kernel against its plain chain (the same one-pass
# statistics and bf16 rounding of silu's output, then cuDNN): as CONV_TOL,
# checked on the one-pixel border ring and the interior separately, since a
# halo that took silu(shift) moves only the ring.
GNSILU_TOL = CONV_TOL
# The fused configuration's whole UNet, kernels vs plain. Sound kernels give
# 2.447e-3 on an H100 (as phase 4's 2.405e-3: the bf16 attention dominates).
# The planted fault, the halo left un-zeroed after the prologue (one ring of
# pixels per conv, small against N(0, 0.02) weights), moved the same forward
# by 5.673e-3, inside phase 4's 1e-2. 4e-3 lies between: 1.6x the sound
# reading, 0.7x the fault, both deterministic for these seeds. The sharper
# check of the halo is phase 3's border ring, per class.
FUSED_UNET_TOL = 4e-3
# The raw decoder output of one 1024px frame, kernels vs plain: only the
# mid-block attention differs (the convs are cuDNN f32 on both sides, TF32
# off), so the output moves by about that attention's ~1e-6 relative error.
VAE_TOL = 1e-4


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, by the name its launch count is reported under."""
    from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_same
    from aid_tpu_torch.ops.flash_attention import flash_interpolated_attention, flash_self_attention_f32

    return {"flash_interpolated_attention": flash_interpolated_attention,
            "flash_self_attention_f32": flash_self_attention_f32,
            "conv3x3_same": conv3x3_same, "conv3x3_gnsilu": conv3x3_gnsilu}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def check_path(path: str, counts: dict, needed) -> None:
    print(f"launches in the {path} path: {counts}", flush=True)
    for name in needed:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


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
    for line in _build.ptxas_report().splitlines():  # registers, shared memory, spills per kernel
        if "entry function" in line or "spill" in line or "Used" in line:
            print(f"  {line.strip()}", flush=True)


def phase_kernels(coef, fused_classes):
    """Each kernel vs its plain version at the paths' shapes. Returns
    {kernel name: (max abs err, ms, plain ms) at its heaviest shape}."""
    import torch
    import torch.nn.functional as F

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_gnsilu_plain, conv3x3_same, conv3x3_same_plain
    from aid_tpu_torch.ops.flash_attention import (
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        flash_self_attention_f32,
    )

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
        rl2 = rel_l2(got, want)
        ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, coef, mode, skip_endpoints=sk), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, coef, mode, skip_endpoints=sk),
                           max(1, reps // 5))
        ok = math.isfinite(err) and err <= ATTN_TOL * ref
        print(f"attention {label:28s} B={B} H={H}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
              f"tol {ATTN_TOL * ref:.3e}) rel_l2 {rl2:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
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

    # TPU kernel #4: conv3x3_same(packed=True), the same kernel instance
    x = randn(B, 640, 128, 128)
    w = randn(320, 640, 3, 3) * (9 * 640) ** -0.5
    b = randn(320)
    got = conv3x3_same(x, w, b, packed=True)
    torch.cuda.synchronize()
    want = conv3x3_same_plain(x, w, b)
    err, ref = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
    ms = cuda_ms(lambda: conv3x3_same(x, w, b, packed=True), 10)
    plain_ms = cuda_ms(lambda: F.conv2d(x, w, b, padding=1), 10)
    ok = math.isfinite(err) and err <= CONV_TOL * ref
    print(f"conv3x3 packed=True B={B} 640->320 @128x128: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
          f"tol {CONV_TOL * ref:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("conv3x3 packed=True: kernel disagrees with the plain version")
    records["conv3x3_same(packed=True)"] = (err, ms, plain_ms)
    del x, w, b, got, want

    # kernel A: the VAE mid-block attention, one head over 16384 tokens in f32
    q, k, v = (torch.randn((1, 1, 16384, 512), generator=gen, device=dev) for _ in range(3))
    got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
    torch.cuda.synchronize()
    want = flash_interpolated_attention_plain(q, k, v)
    err, ref = (got - want).abs().max().item(), want.abs().max().item()
    ms = cuda_ms(lambda: flash_self_attention_f32(q, k, v), 3)
    plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v), 3)
    ok = math.isfinite(err) and err <= F32_ATTN_TOL * ref
    print(f"attention f32 self (1,1,16384,512): max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
          f"tol {F32_ATTN_TOL * ref:.3e}) rel_l2 {rel_l2(got, want):.3e}  kernel {ms:.3f} ms  "
          f"plain {plain_ms:.3f} ms  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("f32 D=512 attention: kernel disagrees with the plain version")
    records["flash_self_attention_f32"] = (err, ms, plain_ms)
    del q, k, v, got, want

    # kernel B at every (H, W, Cin, Cout) class the fused configuration routes
    # to it; inputs off zero mean and gamma/beta off 1/0, so silu(shift) is
    # far from 0 and a halo that took it would show on the border ring
    worst, total_ms, total_plain = 0.0, 0.0, 0.0
    for (H, W, cin, cout), calls in sorted(fused_classes.items()):
        x = (randn(B, cin, H, W).float() * 2.0 + 1.0).to(torch.bfloat16)
        w = randn(cout, cin, 3, 3) * (9 * cin) ** -0.5
        b = randn(cout)
        gamma = 1.0 + 0.3 * torch.randn(cin, generator=gen, device=dev)
        beta = 0.5 * torch.randn(cin, generator=gen, device=dev)
        got = conv3x3_gnsilu(x, w, b, gamma, beta, 32)
        torch.cuda.synchronize()
        want = conv3x3_gnsilu_plain(x, w, b, gamma, beta, 32)
        diff = (got.float() - want.float()).abs()
        ring = torch.zeros(H, W, dtype=torch.bool, device=dev)
        ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
        err_ring, err_in = diff[:, :, ring].max().item(), diff[:, :, ~ring].max().item()
        ref = want.float().abs().max().item()
        ms = cuda_ms(lambda: conv3x3_gnsilu(x, w, b, gamma, beta, 32), 5)
        plain_ms = cuda_ms(lambda: conv3x3_gnsilu_plain(x, w, b, gamma, beta, 32), 5)
        ok = all(math.isfinite(e) and e <= GNSILU_TOL * ref for e in (err_ring, err_in))
        print(f"conv3x3_gnsilu B={B} {cin}->{cout} @{H}x{W} ({calls}/forward): max_abs_err interior {err_in:.3e} "
              f"border {err_ring:.3e} (max|ref| {ref:.3e}, tol {GNSILU_TOL * ref:.3e})  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"conv3x3_gnsilu {cin}->{cout} @{H}x{W}: kernel disagrees with the plain version")
        worst = max(worst, err_ring, err_in)
        total_ms += calls * ms
        total_plain += calls * plain_ms
        if (H, cin, cout) == (128, 960, 320):
            main = (ms, plain_ms)
    print(f"conv3x3_gnsilu per fused UNet forward (B={B}, {sum(fused_classes.values())} calls): "
          f"kernel {total_ms:.2f} ms, plain chain {total_plain:.2f} ms", flush=True)
    # the border-ring check must see a halo that took silu(shift): the
    # planted fault on the last class moves the ring, not the interior
    fault = halo_fault_plain(x, w, b, gamma, beta, 32)
    fdiff = (fault.float() - want.float()).abs()
    f_ring, f_in = fdiff[:, :, ring].max().item(), fdiff[:, :, ~ring].max().item()
    print(f"conv3x3_gnsilu planted halo fault @{H}x{W}: border {f_ring:.3e}, interior {f_in:.3e} "
          f"(tol {GNSILU_TOL * ref:.3e})", flush=True)
    if not f_ring > GNSILU_TOL * ref:
        fail("the border-ring check does not see a halo fault")
    records["conv3x3_gnsilu"] = (worst, *main)
    return records


def fused_conv_classes(unet, sample, ehs, added) -> dict:
    """{(H, W, Cin, Cout): calls per forward} of the convs that the fused
    configuration sends to conv3x3_gnsilu, read off one forward of the model
    with the routing on (one frame, plain versions: no launch is counted)."""
    import torch

    from aid_tpu_torch.models import layers
    from aid_tpu_torch.ops.routing import reference_ops

    seen = {}
    real = layers.conv3x3_gnsilu

    def record(x, w, *args):
        key = (x.shape[2], x.shape[3], x.shape[1], w.shape[0])
        seen[key] = seen.get(key, 0) + 1
        return real(x, w, *args)

    layers.conv3x3_gnsilu, layers._FUSED_GN_CONV = record, True
    try:
        with torch.no_grad(), reference_ops():
            unet(sample[:1], torch.tensor(500.0, device=sample.device), ehs[:1], None,
                 {k: v[:1] for k, v in added.items()})
    finally:
        layers.conv3x3_gnsilu, layers._FUSED_GN_CONV = real, False
    if not seen:
        fail("the fused configuration routed no conv to conv3x3_gnsilu")
    return seen


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


def run_denoise(unet, sample, ehs, uncond, added, coef, steps: int):
    """The denoise of the headline program: (final latents, seconds), host
    clock around work that ends in a synchronize."""
    import torch

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.pipelines.engine import denoise_sequence
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler

    scheduler = EulerDiscreteScheduler()
    state = scheduler.init(steps, device=sample.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = denoise_sequence(
        unet, scheduler, sample, ehs, uncond, coef, state, 5.0,
        early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(),
        num_steps=steps, warmup_steps=steps // 2, added_cond=added)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main(unet, sample, ehs, uncond, added, coef, steps: int, card: str):
    import torch

    print(f"== phase 5: main path, SDXL 7-frame AID denoise, {steps} steps ({steps // 2} fused_outer warmup)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, elapsed = run_denoise(unet, sample, ehs, uncond, added, coef, steps)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    checksum = float(out.float().sum())
    print(f"checksum {checksum!r}; output {tuple(out.shape)} {out.dtype}", flush=True)
    print(f"{elapsed / steps:.3f} s/step ({elapsed:.2f} s for {steps} steps, first steps included); "
          f"peak memory {peak / 2**30:.2f} GiB on {card}", flush=True)
    if tuple(out.shape) != tuple(sample.shape):
        fail(f"output shape {tuple(out.shape)} != {tuple(sample.shape)}")
    if not math.isfinite(checksum):
        fail(f"non-finite output checksum: {checksum}")
    check_path("denoise", launches, ("flash_interpolated_attention", "conv3x3_same"))
    return launches


def halo_fault_plain(x, w, b, gamma, beta, num_groups=32, eps=1e-5):
    """A planted fault: conv3x3_gnsilu_plain with the zero padding applied
    BEFORE the prologue, so the halo takes silu(shift) instead of 0."""
    import torch.nn.functional as F

    from aid_tpu_torch.ops.conv import gn_scale_shift

    scale, shift = gn_scale_shift(x, gamma, beta, num_groups, eps)
    a = F.pad(x.float(), (1, 1, 1, 1)) * scale[:, :, None, None] + shift[:, :, None, None]
    return F.conv2d(F.silu(a).to(x.dtype), w, b)


def phase_fused(unet, sample, ehs, uncond, added, coef, n_fused_calls: int, card: str):
    """The fused GN+SiLU configuration: whole-UNet check with a planted halo
    fault, then a 2-step denoise (1 fused_outer, 1 vanilla) fused and
    unfused in turns. Returns the fused denoise's launch counts."""
    import torch

    from aid_tpu_torch.models import layers
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.ops import conv
    from aid_tpu_torch.ops.routing import reference_ops

    print("== phase 6: fused GroupNorm+SiLU resnet prologue (layers._FUSED_GN_CONV = True)", flush=True)
    aid = AidContext(coef=coef, mode=AidMode.from_name("fused_outer"))
    t = torch.tensor(500.0, device=sample.device)
    times = {True: [], False: []}
    try:
        layers._FUSED_GN_CONV = True
        with torch.no_grad():
            reset_counts()
            got = unet(sample, t, ehs, aid, added)
            torch.cuda.synchronize()
            n_calls = read_counts()["conv3x3_gnsilu"]
            with reference_ops():
                want = unet(sample, t, ehs, aid, added)
                real_plain = conv.conv3x3_gnsilu_plain
                conv.conv3x3_gnsilu_plain = halo_fault_plain
                try:
                    fault = unet(sample, t, ehs, aid, added)
                finally:
                    conv.conv3x3_gnsilu_plain = real_plain
        if not torch.isfinite(got).all():
            fail("fused-configuration UNet output is not finite")
        rel, fault_rel = rel_l2(got, want), rel_l2(fault, want)
        ok = math.isfinite(rel) and rel <= FUSED_UNET_TOL
        print(f"unet fused GN, fused_outer B={sample.shape[0]} 128x128: {n_calls} conv3x3_gnsilu launches; rel_l2 "
              f"kernels vs plain {rel:.3e} (tol {FUSED_UNET_TOL:.0e}; planted fault halo not re-zeroed "
              f"{fault_rel:.3e})  {'ok' if ok else 'FAIL'}", flush=True)
        if n_calls != n_fused_calls:
            fail(f"{n_calls} conv3x3_gnsilu launches in one forward, {n_fused_calls} fused classes' calls expected")
        if not fault_rel > FUSED_UNET_TOL:
            fail(f"the fused-UNet bound {FUSED_UNET_TOL:.0e} does not separate the halo fault ({fault_rel:.3e})")
        if not ok:
            fail("fused-configuration UNet output through the kernels disagrees with the plain versions")
        del got, want, fault

        counts = None
        for fused in (True, False, False, True):  # in turns, so warm-up favours neither
            layers._FUSED_GN_CONV = fused
            reset_counts()
            out, elapsed = run_denoise(unet, sample, ehs, uncond, added, coef, 2)
            if not torch.isfinite(out).all():
                fail(f"2-step denoise ({'fused' if fused else 'unfused'}) is not finite")
            if fused and counts is None:
                counts = read_counts()
            times[fused].append(elapsed / 2)
    finally:
        layers._FUSED_GN_CONV = False
    print(f"2-step denoise (1 fused_outer + 1 vanilla) on {card}: fused GN "
          f"{' / '.join(f'{x:.3f}' for x in times[True])} s/step, unfused "
          f"{' / '.join(f'{x:.3f}' for x in times[False])} s/step", flush=True)
    check_path("fused GN denoise", counts, ("flash_interpolated_attention", "conv3x3_same", "conv3x3_gnsilu"))
    return counts


def phase_image(unet, steps: int, card: str):
    """InterpolationXLPipeline.interpolate at 1024px: stage times, launch
    counts, peak memory, and one frame's raw decoder output through the
    kernels vs the plain versions. Returns the path's launch counts."""
    import numpy as np
    import torch

    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.configs import CLIP_VIT_L_TEXT, SDXL_TEXT_ENCODER_2, SDXL_VAE
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.ops.routing import reference_ops
    from aid_tpu_torch.pipelines import engine
    from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    print(f"== phase 7: image out, InterpolationXLPipeline.interpolate, 7 frames at 1024px, {steps} steps",
          flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(7)  # the modules' default initialisations draw from it
    with torch.no_grad():
        text1 = CLIPTextModel(CLIP_VIT_L_TEXT, device=dev).eval()
        text2 = CLIPTextModel(SDXL_TEXT_ENCODER_2, device=dev).eval()
        vae = AutoencoderKL(SDXL_VAE, device=dev).eval()
    pipe = InterpolationXLPipeline(
        unet=unet, vae=vae, text_encoder=text1, tokenizer=HashTokenizer(CLIP_VIT_L_TEXT.vocab_size),
        scheduler=EulerDiscreteScheduler(), text_encoder_2=text2,
        tokenizer_2=HashTokenizer(SDXL_TEXT_ENCODER_2.vocab_size))
    gen = torch.Generator(device=dev).manual_seed(1)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)

    stages = {"encode": [], "denoise": [], "decode": []}
    decoder_inputs = []
    decode = vae.decode

    def timed(fn, stage):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[stage].append(time.perf_counter() - t0)
            return out
        return run

    def decode_keep_input(z):
        decoder_inputs.append(z)
        return decode(z)

    real_denoise = engine.denoise_sequence
    pipe.encode_prompt = timed(pipe.encode_prompt, "encode")
    vae.decode = timed(decode_keep_input, "decode")
    engine.denoise_sequence = timed(real_denoise, "denoise")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        images = pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", size=7, num_inference_steps=steps)
        elapsed = time.perf_counter() - t0
        counts = read_counts()
    finally:
        engine.denoise_sequence = real_denoise
        del vae.decode, pipe.encode_prompt
    peak = torch.cuda.max_memory_allocated()

    print(f"output {images.shape} {images.dtype}; {elapsed:.2f} s in all on {card}: encode "
          f"{' / '.join(f'{x:.3f}' for x in stages['encode'])} s per prompt pair (prompt + negative), "
          f"denoise {stages['denoise'][0] / steps:.3f} s/step, decode "
          f"{sum(stages['decode']) / len(stages['decode']):.3f} s/frame; peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    if images.shape != (7, 1024, 1024, 3) or images.dtype != np.uint8:
        fail(f"interpolate returned {images.shape} {images.dtype}, want (7, 1024, 1024, 3) uint8")
    inside = float(((images > 0) & (images < 255)).mean())
    print(f"share of output values strictly inside (0, 255): {inside:.4f}", flush=True)
    check_path("image out", counts, ("flash_interpolated_attention", "flash_self_attention_f32", "conv3x3_same"))
    if counts["flash_self_attention_f32"] != 7:
        fail(f"the f32 attention kernel ran {counts['flash_self_attention_f32']} times, once per frame (7) expected")

    frame = 3
    with torch.no_grad():
        got = decode(decoder_inputs[frame])
        with reference_ops():
            want = decode(decoder_inputs[frame])
    frame_inside = float(((images[frame] > 0) & (images[frame] < 255)).mean())
    rel = rel_l2(got, want)
    ok = math.isfinite(rel) and rel <= VAE_TOL and bool(torch.isfinite(got).all())
    print(f"raw decoder output, frame {frame} (1,3,1024,1024) f32: rel_l2 kernels vs plain {rel:.3e} "
          f"(tol {VAE_TOL:.0e}; TF32 off on both sides); its uint8 values strictly inside (0, 255): "
          f"{frame_inside:.4f}  {'ok' if ok else 'FAIL'}", flush=True)
    if frame_inside < 0.5:
        fail("the compared frame is mostly saturated: the comparison would not see the kernel")
    if not ok:
        fail("the decoder output through the kernels disagrees with the plain versions")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps of the main path and of the image-out path (half fused_outer warmup)")
    args = ap.parse_args(argv)

    card = phase_device()
    import torch

    phase_build()
    unet, sample, ehs, uncond, added, coef = build_headline()
    fused_classes = fused_conv_classes(unet, sample, ehs, added)
    kernels = phase_kernels(coef, fused_classes)
    phase_unet(unet, sample, ehs, added, coef)
    paths = [phase_main(unet, sample, ehs, uncond, added, coef, args.steps, card),
             phase_fused(unet, sample, ehs, uncond, added, coef, sum(fused_classes.values()), card)]
    del sample, ehs, uncond, added, coef
    paths.append(phase_image(unet, args.steps, card))
    launches = {name: sum(p[name] for p in paths) for name in kernel_wrappers()}
    print(f"launches over the three paths: {launches}", flush=True)

    flash_src = "aid_tpu_torch/csrc/flash_interpolated_attention.cu"
    conv_src = "aid_tpu_torch/csrc/conv3x3.cu"
    # name -> (source, TPU kernel replaced, the launch count it is read from, extra fields)
    rows = {
        "flash_interpolated_attention": (flash_src, "aid_tpu/ops/flash_attention.py:101",
                                         "flash_interpolated_attention",
                                         {"also_replaces": "aid_tpu/ops/flash_attention.py:339"}),
        "flash_self_attention_f32": ("aid_tpu_torch/csrc/flash_attention_f32_d512.cu",
                                     "aid_tpu/ops/flash_attention.py:101", "flash_self_attention_f32",
                                     {"contract": "f32, head dim 512, self (VAE mid block)"}),
        "conv3x3_same": (conv_src, "aid_tpu/ops/conv.py:30", "conv3x3_same", {}),
        # the packed-K TPU kernel's port is the same (prologue-free) kernel
        # instance, so its launches are that instance's
        "conv3x3_same(packed=True)": (conv_src, "aid_tpu/ops/conv.py:47", "conv3x3_same",
                                      {"shares_kernel_with": "conv3x3_same"}),
        "conv3x3_gnsilu": (conv_src, "aid_tpu/ops/conv.py:78", "conv3x3_gnsilu", {}),
    }
    record = []
    for name, (src, replaces, counter, extra) in rows.items():
        err, ms, plain_ms = kernels[name]
        record.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": launches[counter], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **extra})
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
