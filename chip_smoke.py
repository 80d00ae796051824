"""Drive the PyTorch port's paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py            # SDXL paths at 4 denoise steps (2 fused_outer warmup)
    python3 chip_smoke.py --steps 28 # the SDXL headline schedule; SD1.5 always runs its 25

Each path is driven with every launch count set to 0 just before it and
read just after:
  * the SDXL denoise (``bench.py::build_headline``, ported):
    ``denoise_sequence`` over the full-width SDXL UNet (bf16, N(0, 0.02)
    random weights from a seeded CUDA generator), 7 frames at 128x128
    latents, Euler, guidance 5.0, Beta(28, 28) frame coefficients,
    fused_outer AID for the first half of the steps and vanilla after,
    sequential CFG;
  * the same denoise over 2 steps with batched CFG (one 14-row pass a
    step) and with the fused loop (force_vanilla late steps);
  * the same UNet with the fused GroupNorm+SiLU resnet prologue switched on
    (``layers._FUSED_GN_CONV``, off by default as in the JAX package);
  * SDXL image out: ``InterpolationXLPipeline.interpolate`` from two prompts
    to seven 1024px uint8 frames, through random f32 CLIP ViT-L and OpenCLIP
    bigG text encoders, that UNet and the f32 SDXL VAE decode; then again
    after ``enable_bf16_vae_decode()`` (the bf16 VAE: its mid-block
    attention is the bf16 D=512 kernel);
  * SD1.5 ``InterpolationPipeline.interpolate``: a PAID guide prompt, seven
    512px frames, 25 DDIM steps, the full-width SD1.5 UNet (bf16, N(0, 0.02)
    weights; attention at head dims 40, 80 and 160), random f32 CLIP ViT-L
    and the f32 SD VAE decode of all frames at once; in sequential and in
    batched CFG, then with the bf16 VAE; then ``vae.encode`` of its frames;
  * SD1.5 ``interpolate_single(0.5)``: three 512px frames, the same modules;
  * the f32 SDXL UNet (the reference's default dtype; full width and depth,
    N(0, 0.02) weights): a 2-step Euler denoise, every attention through the
    f32 instance at D=64 and every wide conv through the f32 conv kernel;
  * the f32 SD1.5 UNet in ``InterpolationPipeline.interpolate`` (PAID, 7
    frames, 512px, 25 DDIM steps, f32 CLIP and VAE): the f32 attention at
    D=40/80/160;
  * SD2.1 at 768px through the port's entry point: a full-width diffusers
    directory (SD 2.1's UNet, OpenCLIP ViT-H text encoder and VAE, f16
    weights ~ N(0, 0.02) from a seed, a byte-level tokenizer padding with
    "!", a v-prediction scheduler config) written into the git-ignored
    build/ and loaded as the JAX app loads it,
    ``load_interpolation_pipeline(dir, scheduler_name="unipc",
    guidance_scale=10.0)``; ``interpolate`` to seven 768px frames over 25
    UniPC steps with the bf16 UNet (attention at D=64 over 9216 / 2304 /
    576 / 144 tokens, the conv kernel at 96^2), then the f32 UNet with the
    fused GN+SiLU configuration (the f32 GN+SiLU conv) and 2 UniPC steps;
  * the tiny SD1.x-like UNet (``configs.TINY_UNET``) in f32: its head dims
    16 and 32, which no kernel instance takes, padded to the D=40 instance.

Phases (each prints its own lines; any failure exits non-zero):
  1. device      needs CUDA; prints the card's name and power limit
  2. build       compiles the CUDA kernels from aid_tpu_torch/csrc, one nvcc
                 per source at once; ptxas resources
  3. kernels     each kernel against its plain PyTorch version at the paths'
                 shapes (SDXL, SD1.5 and SD2.1), with stated tolerances; its time
                 through its wrapper and (attention and conv) launched
                 alone on operands already laid out, the plain version's,
                 its bound from the shapes and the card's peaks, and one
                 PyTorch call computing the same function where there is
                 one (cuDNN conv in both layouts, SDPA under each backend)
                 as the yardstick library_ms
  4. whole UNet  one full-width SDXL forward in fused_outer through the
                 kernels and through the plain versions (test-only seam)
  5. denoise     the SDXL main path; launch counts, finite checksum, s/step,
                 peak memory
  6. engine      2 SDXL steps in batched CFG against sequential, and in the
                 fused loop against split, each with a planted fault
  7. fused GN    the fused-prologue configuration: a whole-UNet check with a
                 planted halo fault, then a 2-step denoise both ways
  8. image out   SDXL interpolate() at 1024px with the f32 VAE, then with
                 the bf16 VAE; stage times, launch counts, the raw decoder
                 output through the kernels vs the plain versions (f32 and
                 bf16, the bf16 one with a planted fault), one frame's tiled
                 decode (512px tiles) kernels vs plain
  9. SD1.5 UNet  one full-width SD1.5 forward in fused_outer, kernels vs
                 plain, with two planted faults
 10. SD1.5 out   interpolate() in sequential and batched CFG (s/step, best
                 and p50 of three warm runs each; the two modes' latents
                 against each other, with a planted fault), with the bf16
                 VAE, vae.encode() of its frames, and interpolate_single();
                 stage times, peak memory, launches by head dim, the raw
                 decoder output through the kernels vs the plain versions
 11. f32 SDXL    one full-width f32 SDXL forward in fused_outer, kernels vs
                 plain (largest per-frame relative L2, two planted faults),
                 then 2 Euler steps; checksum, s/step, peak memory, f32
                 launches only
 12. f32 SD1.5   the same forward check on the f32 SD1.5 UNet, then
                 interpolate() with f32 CLIP and VAE; stage times, s/step
                 (best and p50 of three warm runs), peak memory, f32
                 attention launches at D=40, 80 and 160
 13. SD2.1       the loader on a written SD2.1 directory (every module on
                 the card, UNet bf16, VAE f32); a bf16 fused_outer forward
                 kernels vs plain with two planted faults; interpolate() at
                 768px, 25 UniPC steps (checksum, s/step, stage times, peak
                 memory, launches); reloaded in f32: the forward check, the
                 fused GN+SiLU forward with its planted halo fault, 2 steps
 14. padded D    the tiny f32 UNet's fused_outer forward, kernels vs plain
                 with two planted faults; every attention launch lands on
                 the D=40 instance
Phase 1 turns TF32 off for cuBLAS and cuDNN, so every plain f32 version and
library call computes in full f32.
The second-to-last line is the kernels' JSON record, the last the result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

# The package beside this script goes first on the import path, whatever the
# working directory, and also under PYTHONSAFEPATH (which keeps the script's
# own directory off sys.path): the script runs the checkout it lies in.
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


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
# The f32 D=512 attention (VAE mid block), 3xTF32 products in the kernel
# against the plain version's full-f32 matmuls (TF32 off on both sides,
# phase 1): the dropped lo*lo terms, summation order and exp2 vs exp, ~1e-5
# of max |ref| at most over 16384 keys (measured 6e-6). 1e-4 of max |ref|
# leaves margin; plain TF32 (~4e-4, tests/test_torch_ops.py) would not pass.
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
# The raw decoder output of one frame (1024px SDXL, 512px SD1.5), kernels
# vs plain: only the mid-block attention differs (the convs are cuDNN f32 on
# both sides, TF32 off), so the output moves by about that attention's ~1e-6
# relative error.
VAE_TOL = 1e-4
# The SD1.5 whole UNet (phase 8), kernels vs plain: the LARGEST PER-FRAME
# relative L2 of the output, not the whole batch's. Beta(25, 25) puts the
# interior coefficients at 0.43-0.57, so exchanging the endpoints moves a
# frame by about |1 - 2c| of what they differ by: frames 0, 3 and 6 do not
# move, and over the whole batch the swapped fault read 3.94e-3 on an H100,
# beside a sound reading of 3.36e-3. Per frame (H100, these seeds, the same
# to the last digit in a second forward): sound 3.27-3.44e-3 in every
# frame; endpoints swapped 6.09e-3 at most (frame 1); fused_outer computed
# as self 4.38e-2 at most. 4.5e-3 lies between: 1.3x the sound reading,
# 0.74x the smaller fault. Phase 8 measures both faults in every run and
# fails if the bound does not separate either.
SD15_UNET_TOL = 4.5e-3
# The bf16 D=512 attention (a bf16 VAE's mid block) against its plain
# version: both round the probabilities to bf16 before P V (the kernel
# unnormalised per tile, the plain version normalised) and sum in another
# order; with the output's own bf16 rounding that is a few 2^-9 of max |ref|.
# As ATTN_TOL; a wrong mask, scale or tile is tens of percent.
BF16_D512_TOL = ATTN_TOL
# Engine modes (phase 6), 2 SDXL steps from the same inputs, the LARGEST
# PER-FRAME relative L2 of the final latents: batched CFG against
# sequential, and the fused loop against split; phase 6 fails if a bound
# does not separate its fault. Batched CFG changes every GEMM's and conv's
# batch (14 rows for 7) and the attention's call pattern (per-row
# endpoints, the uncond half skipped), so bf16 rounding differs everywhere:
# sound 1.74e-3 at most (frame 6; frame 0 exact) on an H100, the uncond
# rows given the cond endpoints 1.88e-2. 5e-3 lies between: 2.9x the sound
# reading, 0.27x the fault.
BATCHED_CFG_TOL = 5e-3
# The fused loop's late step (fused_outer with every endpoint segment
# dropped) equals split's (self mode) bit for bit on an H100: sound 0.
# Its planted fault, force_vanilla ignored on the late step, reads 9.4e-4
# (5.9e-4 in its smallest interior frame). 1e-4 lies under both.
FUSED_LOOP_TOL = 1e-4
# The bf16 VAE's raw decoder output (phase 8, one 1024px frame; a 512px
# tiled frame; phase 10, one 512px frame) and its encoder's posterior mean
# (phase 10, 7 frames, largest per-frame value), kernels vs plain. Only the
# mid-block attention differs (the bf16 convs are cuDNN's on both sides),
# by ~3e-3 relative; but any difference at all re-rounds every later bf16
# layer, so the decoder output settles at bf16's noise floor: 1.10e-2
# (SDXL frame), 1.05e-2 (tiled), 9.4e-3 (SD1.5 frame), encoder 3.9e-3 on an
# H100, the same in every run. With torch's default initialisation the
# VAE's attention is nearly uniform and its residual ~1% of the decoder's
# output, so faults that only reweight keys or misplace columns hide under
# that floor (softmax scale x sqrt(2): 1.27e-2 / 9.9e-3; output columns
# rolled by 64: 1.49e-2 / 1.06e-2, encoder 0.34); the kernel's own accuracy
# is phase 3's to hold at these shapes. The planted fault here is a gross
# one, the epilogue's 1 / l left out. 2e-2 is 1.8x the largest sound
# reading.
BF16_VAE_TOL = 2e-2
# The SD1.5 interpolate's final latents, batched CFG against sequential
# (phase 10), largest per-frame relative L2 after 25 steps: sound 2.63e-4 on
# an H100, the uncond rows given the cond endpoints 1.81e-3 (1.41e-3 in its
# smallest frame; the fault acts in the 12 warmup steps only). 7e-4 lies
# between: 2.7x the sound reading, 0.39x the fault.
SD15_CFG_TOL = 7e-4
# The f32 attention at the UNet's head dims (D = 40/64/80/160, every mode)
# against its plain version: 3xTF32 products as in the D=512 kernel, so the
# same reasoning and the same bound, F32_ATTN_TOL.
# The f32 conv, 3xTF32 products and each K chunk's sum added in f32, against
# cuDNN in full f32 (TF32 off, phase 1): the dropped lo*lo terms and
# summation order, ~1e-6 of max |ref| at K = 9 * 960; plain TF32 would read
# ~4e-4 (tests/test_torch_ops.py). Measured on an H100: 3.2e-6 of max |ref|
# at 960->320 (the f32 attention: 1e-6..3e-6 at every D and mode). 1e-4 of
# max |ref| as for the attention; a wrong tap, halo or channel block is O(1).
F32_CONV_TOL = 1e-4
# The f32 UNets' whole forward (phases 11 and 12), kernels vs plain, the
# LARGEST PER-FRAME relative L2 of the output. Every attention and wide conv
# differs from its plain version by ~1e-6 of max |ref|. On an H100 (these
# seeds; deterministic): sound 3.68e-7 (SDXL) and 5.40e-7 (SD1.5); planted
# faults fused_outer computed as self 4.48e-2 / 4.34e-2, endpoints swapped
# 8.84e-3 / 3.86e-3. 1e-5 lies between: 18x the larger sound reading, 0.0026x
# the smaller fault; kernels at plain TF32 accuracy (~4e-4 an op) would read
# well over it. Both phases measure both faults in every run and fail if the
# bound does not separate either.
F32_UNET_TOL = 1e-5
# DDIM steps of the SD1.5 sequences (bench.py's SD1.5 workloads), run in
# full; also the Beta(25, 25) of their frame coefficients.
SD15_STEPS = 25

# The card's published dense peaks (NVIDIA H100 SXM data sheet, at its 700 W
# limit): tensor cores in bf16 and TF32, f32 outside the tensor cores, HBM.
# bound_ms of a kernel is the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written once)
# over the memory rate; where a call mixes types, the slowest type sets it.
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(ops: dict, nbytes: float) -> tuple:
    """(least ms on the card, "operations" or "bytes") for ``ops`` {type:
    count} and ``nbytes`` of device-memory traffic."""
    t_ops = max(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def conv_bound(B, H, W, cin, cout, prologue=False, tf32_passes=None) -> tuple:
    """The 3x3 conv's bound: 2 * 9 * Cin flops per output element on the
    bf16 tensor cores, or with ``tf32_passes`` = 3 on f32 operands at three
    TF32 passes (3xTF32); x, w, bias (f32), out read or written once; the
    GN+SiLU prologue adds its (B, Cin) f32 scale and shift and ~6 f32
    operations per input element (fma, halving, tanh, fma)."""
    flops = 2.0 * B * H * W * cout * 9 * cin
    ops = {"bf16": flops} if tf32_passes is None else {"tf32": tf32_passes * flops}
    elem = 2.0 if tf32_passes is None else 4.0
    nbytes = elem * (B * H * W * cin + 9 * cin * cout + B * H * W * cout) + 4.0 * cout
    if prologue:
        ops["f32"] = 6.0 * B * H * W * cin
        nbytes += 2 * 4.0 * B * cin
    return bound(ops, nbytes)


def attention_bound(mode, B, H, Sq, L, D, Le=None, elem=2, skip_rows=0, tf32_passes=None, per_row=False) -> tuple:
    """The attention's bound from the key segments the kernel's segment
    loop visits (flash_interpolated_attention.cu: the own segment in self
    and fused modes, begin and end in outer modes, one lerped segment in
    inner modes; skip rows of fused modes visit their own segment only):
    4 * D flops per (query, key) pair (Q K^T and P V; the exps are not
    counted). Bytes: q and out, the own K/V where the mode reads it, and
    the K and V of both endpoints where they are passed apart (``Le``; one
    set per batch row with ``per_row``) or, in pure modes, are rows 0 and
    B-1 of K/V. ``tf32_passes`` = 3 reckons f32 operands at three TF32
    tensor-core passes (3xTF32); None means bf16."""
    has_own = mode in ("self", "fused_outer", "fused_inner")
    n_seg = {"self": 0, "fused_outer": 2, "pure_outer": 2, "fused_inner": 1, "pure_inner": 1}[mode]
    seg_len = Le if Le is not None else L
    keys = (B - skip_rows) * ((L if has_own else 0) + n_seg * seg_len) + skip_rows * L
    flops = 4.0 * H * Sq * D * keys
    nbytes = elem * (2.0 * B * H * Sq * D + (2.0 * B * H * L * D if has_own else 0.0))
    if n_seg and (Le is not None or not has_own):
        nbytes += elem * 4.0 * (B if per_row else 1) * H * seg_len * D  # K and V of both endpoints
    ops = {"bf16": flops} if tf32_passes is None else {"tf32": tf32_passes * flops}
    return bound(ops, nbytes)


def sdpa_backends(q, k, v, want, reps: int) -> dict:
    """F.scaled_dot_product_attention on (q, k, v) under each backend of
    ``torch.nn.attention.sdpa_kernel`` that accepts the input: {backend:
    (ms, max abs error against ``want``)}. A yardstick for the kernel
    (library_ms); the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                got = F.scaled_dot_product_attention(q, k, v)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                del got
                ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps)
        except RuntimeError:  # this backend does not take the input
            continue
        times[backend.name] = (ms, err)
    return times


def fastest(times: dict) -> tuple:
    """(name, ms) of the fastest entry of {name: (ms, ...)}, or (None, None)."""
    if not times:
        return None, None
    name = min(times, key=lambda n: times[n][0])
    return name, times[name][0]


def library_conv_ms(x, w, b, reps: int) -> dict:
    """cuDNN's F.conv2d on the same conv with NCHW and with channels_last
    operands: {layout: ms} (a yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    xc, wc = x.contiguous(memory_format=torch.channels_last), w.contiguous(memory_format=torch.channels_last)
    xn, wn = x.contiguous(), w.contiguous()
    return {"cudnn NCHW": cuda_ms(lambda: F.conv2d(xn, wn, b, padding=1), reps),
            "cudnn channels_last": cuda_ms(lambda: F.conv2d(xc, wc, b, padding=1), reps)}


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, by the name its launch count is reported under."""
    from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_gnsilu_f32, conv3x3_same, conv3x3_same_f32
    from aid_tpu_torch.ops.flash_attention import (
        flash_interpolated_attention,
        flash_interpolated_attention_f32,
        flash_self_attention_bf16,
        flash_self_attention_f32,
    )

    return {"flash_interpolated_attention": flash_interpolated_attention,
            "flash_interpolated_attention_f32": flash_interpolated_attention_f32,
            "flash_self_attention_f32": flash_self_attention_f32,
            "flash_self_attention_bf16": flash_self_attention_bf16,
            "conv3x3_same": conv3x3_same, "conv3x3_same_f32": conv3x3_same_f32, "conv3x3_gnsilu": conv3x3_gnsilu,
            "conv3x3_gnsilu_f32": conv3x3_gnsilu_f32}


def reset_counts() -> None:
    from aid_tpu_torch.ops.flash_attention import reset_launch_counts

    for fn in kernel_wrappers().values():
        fn.launches = 0
    reset_launch_counts()


def read_counts() -> dict:
    """Every wrapper's launches, and the D <= 160 attention kernels' by head
    dim under ``flash_interpolated_attention[D=...]`` (bf16) and
    ``flash_interpolated_attention_f32[D=...]``."""
    wrappers = kernel_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in ("flash_interpolated_attention", "flash_interpolated_attention_f32"):
        for d, n in wrappers[name].launches_by_head_dim.items():
            counts[f"{name}[D={d}]"] = n
    return counts


def check_path(path: str, counts: dict, needed) -> None:
    print(f"launches in the {path} path: {counts}", flush=True)
    for name in needed:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def frame_rel_l2(a, b) -> list:
    """Relative L2 of each frame (dim 0) of ``a`` against ``b``."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return ((a - b).norm(dim=1) / b.norm(dim=1)).tolist()


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


def phase_kernels(coef, sd_coef, fused_classes, sd21_classes):
    """Each kernel vs its plain version at the paths' shapes, timed beside
    its bound and, where one PyTorch call computes the same function, that
    call (library_ms). ``fused_classes`` / ``sd21_classes``: {(H, W, Cin,
    Cout): calls per forward} of the GN+SiLU conv in the SDXL and SD 2.1
    UNets. Returns {kernel name: record} for the kernels line, each record
    at the kernel's heaviest main-path shape."""
    import torch

    from aid_tpu_torch.models.layers import skip_mask
    from aid_tpu_torch.ops import conv
    from aid_tpu_torch.ops.conv import conv3x3_gnsilu, conv3x3_gnsilu_plain, conv3x3_same, conv3x3_same_plain
    from aid_tpu_torch.ops.flash_attention import (
        d512_launch,
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        flash_self_attention_bf16,
        flash_self_attention_f32,
        kernel_launch,
    )

    print("== phase 3: kernels vs plain versions, bounds and library calls", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    def yardsticks(bound_ms, bound_by, library):
        """One line of the bound and the library calls' times."""
        lib = ", ".join(f"{n} {t[0] if isinstance(t, tuple) else t:.3f} ms" for n, t in library.items()) or "—"
        return f"bound {bound_ms:.3f} ms ({bound_by}); library: {lib}"

    records = {}

    def attention(label, mode, c, H, Sq, L, D, reps, Le=None, dtype=torch.bfloat16):
        """One bf16 (or f32) attention case, B = len(c): (B, S, H*D)
        projections viewed as (B, H, S, D), as the model passes them; skip
        rows as the model marks them; optional shared (H, Le, D) endpoints.
        Timed through the wrapper (ms: the call the model makes, its host
        work included) and launched alone on operands kernel_launch prepared
        once (kernel_ms). In self mode SDPA computes the same function and is
        timed under each backend that takes the input. f32 is held to
        F32_ATTN_TOL and bounded at three TF32 passes. Returns a record."""
        B = c.shape[0]
        f32 = dtype == torch.float32
        tol = F32_ATTN_TOL if f32 else ATTN_TOL

        def heads(x):
            return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

        def make(*shape):  # f32 draws keep their full mantissa (bf16 ones would be exact in TF32)
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

        q = heads(make(B, Sq, H * D))
        k, v = heads(make(B, L, H * D)), heads(make(B, L, H * D))
        kw = {} if mode == "self" else {"skip_endpoints": skip_mask(c, B)}
        if Le is not None:  # shared (H, Le, D) endpoints; ("per_row", Le): (B, H, Le, D)
            shape = (B, H, Le[1], D) if isinstance(Le, tuple) else (H, Le, D)
            kw.update({n: make(*shape) for n in ("k_begin", "v_begin", "k_end", "v_end")})
        got = flash_interpolated_attention(q, k, v, c, mode, **kw)
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v, c, mode, **kw)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        rl2 = rel_l2(got, want)
        _, launch = kernel_launch(q, k, v, c, mode, **kw)  # operands checked and laid out once
        kernel_ms = cuda_ms(launch, reps)
        ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, c, mode, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, c, mode, **kw), max(1, reps // 5))
        skip_rows = int(kw["skip_endpoints"].sum()) if "skip_endpoints" in kw else 0
        per_row = isinstance(Le, tuple)
        bound_ms, bound_by = attention_bound(mode, B, H, Sq, L, D, Le[1] if per_row else Le, skip_rows=skip_rows,
                                             elem=4 if f32 else 2, tf32_passes=3 if f32 else None, per_row=per_row)
        library = sdpa_backends(q, k, v, want, reps) if mode == "self" else {}
        lib_err = (f"; library max_abs_err {', '.join(f'{n} {t[1]:.3e}' for n, t in library.items())}"
                   if f32 and library else "")
        ok = math.isfinite(err) and err <= tol * ref
        print(f"attention {'f32 ' if f32 else ''}{label:32s} B={B} H={H} D={D}: max_abs_err {err:.3e} (max|ref| "
              f"{ref:.3e}, tol {tol * ref:.3e}) rel_l2 {rl2:.3e}  kernel {ms:.4f} ms (launch alone {kernel_ms:.4f}, "
              f"{bound_ms / kernel_ms:.1%} of the bound)  "
              f"plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)}{lib_err}  {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"attention {label} (D={D}, {dtype}): kernel disagrees with the plain version")
        if f32 and D == 160 and mode != "self":
            # a planted fault the tolerance must see: the plain version with its
            # softmax scale 0.1% off
            fault = flash_interpolated_attention_plain(q, k, v, c, mode, scale=1.001 * D ** -0.5, **kw)
            ferr = (got.float() - fault.float()).abs().max().item()
            print(f"  planted fault (scale x 1.001): max_abs_err {ferr:.3e} against tol {tol * ref:.3e}  "
                  f"{'ok' if ferr > tol * ref else 'FAIL'}", flush=True)
            if not ferr > tol * ref:
                fail(f"attention {label} (D={D}, f32): the tolerance does not see a 0.1% scale fault ({ferr:.3e})")
        lib_name, lib_ms = fastest(library)
        return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms, "library": lib_name}

    def attention_record(cases, coefs, main_label, self_label, dtype=torch.bfloat16):
        """Run ``cases``; the record is the main (fused_outer) case's, with
        the self case's time, bound and fastest SDPA beside it. f32 records
        also carry every case (``shapes``: through the wrapper, launched
        alone, the bound and its share of the launch alone, the library)."""
        worst, shapes = 0.0, {}
        for label, mode, H, Sq, L, D, reps, Le in cases:
            r = attention(label, mode, coefs, H, Sq, L, D, reps, Le, dtype)
            worst = max(worst, r["max_abs_err"])
            shapes[f"{label} ({coefs.shape[0]},{H},{Sq},{D})"] = {
                **{k: r[k] for k in ("ms", "kernel_ms", "bound_ms", "library_ms")},
                "bound_share": r["bound_ms"] / r["kernel_ms"]}
            if label == main_label:
                main = r
            if label == self_label:
                self_case = r
        return {**main, "max_abs_err": worst, "library_ms": None, "library": None,
                "self_ms": self_case["ms"], "self_kernel_ms": self_case["kernel_ms"],
                "self_bound_ms": self_case["bound_ms"],
                "self_library_ms": self_case["library_ms"], "self_library": self_case["library"],
                **({"shapes": shapes} if dtype == torch.float32 else {})}

    # SDXL, D=64 (label, mode, H, Sq, Lkv, D, reps, Le): self/fused_outer
    # self-attention and the 77-token cross-attention at both SDXL attention
    # levels, then the other three modes at one small shape
    coef = coef.to(dev)
    B = coef.shape[0]  # the SDXL frames; the conv cases below use it too
    sdxl_cases = [
        ("self 4096", "self", 10, 4096, 4096, 64, 10, None),
        ("fused_outer 4096", "fused_outer", 10, 4096, 4096, 64, 5, None),
        ("self 1024", "self", 20, 1024, 1024, 64, 20, None),
        ("fused_outer 1024", "fused_outer", 20, 1024, 1024, 64, 20, None),
        ("cross self 4096x77", "self", 10, 4096, 77, 64, 20, None),
        ("cross fused_outer 4096x77", "fused_outer", 10, 4096, 77, 64, 20, None),
        ("cross self 1024x77", "self", 20, 1024, 77, 64, 20, None),
        ("cross fused_outer 1024x77", "fused_outer", 20, 1024, 77, 64, 20, None),
        ("pure_outer 256", "pure_outer", 10, 256, 256, 64, 20, None),
        ("pure_inner 256", "pure_inner", 10, 256, 256, 64, 20, None),
        ("fused_inner 256", "fused_inner", 10, 256, 256, 64, 20, None),
    ]
    records["flash_interpolated_attention"] = attention_record(sdxl_cases, coef, "fused_outer 4096", "self 4096")

    # SD1.5, 8 heads at D = 40 / 80 / 160 (widths 320 / 640 / 1280, 64^2 /
    # 32^2 / 16^2 tokens, 8^2 in the mid block), Beta(25, 25) coefficients
    sd_coef = sd_coef.to(dev)
    sd_cases = [
        ("self 4096", "self", 4096, 4096, 40, 10, None),
        ("fused_outer 4096", "fused_outer", 4096, 4096, 40, 5, None),
        ("self 1024", "self", 1024, 1024, 80, 20, None),
        ("fused_outer 1024", "fused_outer", 1024, 1024, 80, 20, None),
        ("self 256", "self", 256, 256, 160, 20, None),
        ("fused_outer 256", "fused_outer", 256, 256, 160, 20, None),
        ("self 64 (mid block)", "self", 64, 64, 160, 20, None),
        ("fused_outer 64 (mid block)", "fused_outer", 64, 64, 160, 20, None),
    ]
    for Sq, D in ((4096, 40), (1024, 80), (256, 160)):
        sd_cases += [(f"cross {m} {Sq}x77", m, Sq, 77, D, 20, None) for m in ("self", "fused_outer")]
    for Sq, D in ((4096, 40), (256, 160)):
        sd_cases += [(f"{m} {Sq}", m, Sq, Sq, D, 10, None) for m in ("pure_outer", "pure_inner", "fused_inner")]
    sd_cases.append(("fused_outer 4096, shared Le=333", "fused_outer", 4096, 4096, 40, 5, 333))
    records["flash_interpolated_attention(D=40/80/160)"] = attention_record(
        [(f"SD1.5 {label}", mode, 8, Sq, L, D, reps, Le) for label, mode, Sq, L, D, reps, Le in sd_cases],
        sd_coef, "SD1.5 fused_outer 4096", "SD1.5 self 4096")

    # SD 2.1 (phase 13), 5 / 10 / 20 / 20 heads at D = 64 over 96^2 / 48^2 /
    # 24^2 / 12^2 tokens: the new sequence lengths, 576 and 144 keys ragged
    # against the 128-key tile, 144 queries under one 192-row tile;
    # Beta(25, 25) coefficients (its 25-step sequence)
    sd21_cases = [
        ("SD2.1 self 9216", "self", 5, 9216, 9216, 64, 3, None),
        ("SD2.1 fused_outer 9216", "fused_outer", 5, 9216, 9216, 64, 2, None),
        ("SD2.1 cross fused_outer 9216x77", "fused_outer", 5, 9216, 77, 64, 10, None),
        ("SD2.1 fused_outer 2304", "fused_outer", 10, 2304, 2304, 64, 10, None),
        ("SD2.1 self 576", "self", 20, 576, 576, 64, 20, None),
        ("SD2.1 fused_outer 576", "fused_outer", 20, 576, 576, 64, 20, None),
        ("SD2.1 self 144", "self", 20, 144, 144, 64, 20, None),
        ("SD2.1 fused_outer 144", "fused_outer", 20, 144, 144, 64, 20, None),
    ]

    def with_sd21(record, sd21, keys=("ms", "kernel_ms", "plain_ms", "bound_ms", "self_ms", "self_kernel_ms",
                                      "self_bound_ms", "self_library_ms")):
        """``record`` with its worst error over the SD 2.1 cases too and the
        SD 2.1 main case's ``keys`` beside it (sd21_*)."""
        shapes = {**record["shapes"], **sd21["shapes"]} if "shapes" in record else None
        return {**record, "max_abs_err": max(record["max_abs_err"], sd21["max_abs_err"]),
                **{f"sd21_{k}": sd21[k] for k in keys}, **({"shapes": shapes} if shapes else {})}

    records["flash_interpolated_attention"] = with_sd21(
        records["flash_interpolated_attention"],
        attention_record(sd21_cases, sd_coef, "SD2.1 fused_outer 9216", "SD2.1 self 9216"))

    # the f32 instance at the f32 UNets' shapes (phases 11 and 12): SDXL's
    # D=64 self, fused_outer and 77-key cross calls at both attention levels
    # and the other modes at one shape; SD1.5's D=40/80/160, fewer reps
    f32_sdxl = [(label, mode, H, Sq, L, D, max(1, reps // 2), Le)
                for label, mode, H, Sq, L, D, reps, Le in sdxl_cases if "cross self 1024" not in label]
    records["flash_interpolated_attention_f32"] = with_sd21(
        attention_record(f32_sdxl, coef, "fused_outer 4096", "self 4096", torch.float32),
        attention_record([(label, mode, H, Sq, L, D, max(1, reps // 2), Le)
                          for label, mode, H, Sq, L, D, reps, Le in sd21_cases], sd_coef,
                         "SD2.1 fused_outer 9216", "SD2.1 self 9216", torch.float32))
    f32_sd = [(f"SD1.5 {label}", mode, 8, Sq, L, D, max(1, reps // 2), Le) for label, mode, Sq, L, D, reps, Le
              in sd_cases if not label.startswith(("pure", "fused_inner")) or Sq == 256]
    # D=160's own tile edges: endpoints of their own length, shared and per row
    f32_sd += [("SD1.5 fused_outer 256, shared Le=77", "fused_outer", 8, 256, 256, 160, 5, 77),
               ("SD1.5 pure_inner 64, per-row Le=33", "pure_inner", 8, 64, 64, 160, 5, ("per_row", 33))]
    records["flash_interpolated_attention_f32(D=40/80/160)"] = attention_record(
        f32_sd, sd_coef, "SD1.5 fused_outer 4096", "SD1.5 self 4096", torch.float32)

    def conv_case(label, x, w, b, factors=(), ring=None, reps=10, packed=False):
        """One conv class: the kernel through its wrapper (ms: the call the
        model makes, the layout kernel's pass over x included, the weight's
        tiling kept from the first call), launched alone on operands
        already laid out by conv.kernel_operands (kernel_ms), the layout
        kernel alone on NCHW x (layout_ms; against its plain version from
        NCHW and channels-last x, whose torch copy is timed too), the
        plain version, cuDNN with both layouts (the prologue-free conv
        only). f32 operands take the f32 kernel, F32_CONV_TOL and a bound at
        three TF32 passes; f32 with ``factors`` (gamma, beta) is the f32
        GN+SiLU conv, whose prologue is the layout pass's
        (aid_conv3x3_gnsilu_f32: layout_ms), then the f32 conv launch
        (kernel_ms). Returns (record, want)."""
        f32 = x.dtype == torch.float32
        entry = "aid_conv3x3_f32" if f32 else ("aid_conv3x3_gnsilu_bf16" if factors else "aid_conv3x3_bf16")
        wrapper = (lambda: conv3x3_gnsilu(x, w, b, *factors, 32)) if factors else (
            lambda: conv3x3_same(x, w, b, packed=packed))
        plain = (lambda: conv3x3_gnsilu_plain(x, w, b, *factors, 32)) if factors else (
            lambda: conv3x3_same_plain(x, w, b))
        got = wrapper()
        torch.cuda.synchronize()
        want = plain()
        diff = (got.float() - want.float()).abs()
        ref = want.float().abs().max().item()
        tol = (F32_CONV_TOL if f32 else GNSILU_TOL if factors else CONV_TOL) * ref
        if ring is None:
            errs = {"": diff.max().item()}
        else:
            errs = {"interior ": diff[:, :, ~ring].max().item(), "border ": diff[:, :, ring].max().item()}
        scale_shift = conv.gn_scale_shift(x, *factors, 32, 1e-5) if factors else ()
        ops = conv.kernel_operands(x, w, b, *scale_shift)
        prologue = scale_shift if f32 else ()  # the f32 layout pass applies the prologue
        blocked = conv.blocked_input_plain(x, *prologue)
        got_layouts = (ops[0], conv.blocked_input(x.contiguous(memory_format=torch.channels_last), *prologue))
        if prologue:  # fma and expf against torch's mul, add and silu: a few f32 ulps; the lo part
            # that follows is held to the kernel's own blocks (a value an ulp off may cross a tf32 step)
            layout_ok = all((g[0] - blocked[0]).abs().max().item() <= 1e-6 * blocked[0].abs().max().item()
                            and torch.equal(g[1], conv.tf32_rest(g[0])) for g in got_layouts)
        else:
            layout_ok = all(torch.equal(g, blocked) for g in got_layouts)
        if not layout_ok:
            fail(f"{label}: the conv's layout kernel disagrees with its plain version")
        del blocked, got_layouts
        kernel_ms = cuda_ms(lambda: conv.launch_kernel(entry, *ops), reps)
        layout_ms = cuda_ms(lambda: conv.blocked_input(x, *prologue), reps)
        layout_plain_ms = cuda_ms(lambda: conv.blocked_input_plain(x, *prologue), reps)
        ms = cuda_ms(wrapper, reps)
        plain_ms = cuda_ms(plain, reps)
        Bx, cin, H, W = x.shape
        bound_ms, bound_by = conv_bound(Bx, H, W, cin, w.shape[0], prologue=bool(factors),
                                        tf32_passes=3 if f32 else None)
        library = {} if factors else library_conv_ms(x, w, b, reps)
        ok = all(math.isfinite(e) and e <= tol for e in errs.values())
        print(f"{label}: max_abs_err {' '.join(f'{k}{e:.3e}' for k, e in errs.items())} (max|ref| {ref:.3e}, "
              f"tol {tol:.3e})  kernel {ms:.3f} ms (launch alone {kernel_ms:.3f}, layout {layout_ms:.3f}, torch's "
              f"layout copy {layout_plain_ms:.3f})  plain {plain_ms:.3f} ms  "
              f"{yardsticks(bound_ms, bound_by, library)}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{label}: kernel disagrees with the plain version")
        lib_name, lib_ms = fastest({n: (t,) for n, t in library.items()})
        return {"max_abs_err": max(errs.values()), "ms": ms, "kernel_ms": kernel_ms, "layout_ms": layout_ms,
                "layout_plain_ms": layout_plain_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms, "library": lib_name}, want

    worst = 0.0
    for cin, cout in ((960, 320), (640, 320), (640, 640)):
        x = randn(B, cin, 128, 128)
        w = randn(cout, cin, 3, 3) * (9 * cin) ** -0.5
        b = randn(cout)
        r, _ = conv_case(f"conv3x3 B={B} {cin}->{cout} @128x128", x, w, b)
        worst = max(worst, r["max_abs_err"])
        if cin == 960:
            main = r
        del x, w, b
    # SD 2.1's 96^2 classes: W = 96 is one full and one half-empty 64-column tile
    for cin, cout in ((960, 320), (640, 640)):
        x = randn(B, cin, 96, 96)
        w = randn(cout, cin, 3, 3) * (9 * cin) ** -0.5
        b = randn(cout)
        r, _ = conv_case(f"conv3x3 B={B} {cin}->{cout} @96x96 (SD2.1)", x, w, b)
        worst = max(worst, r["max_abs_err"])
        if cin == 960:
            sd21 = r
        del x, w, b
    conv_keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "library_ms")
    records["conv3x3_same"] = with_sd21({**main, "max_abs_err": worst}, sd21, conv_keys)

    # TPU kernel #4: conv3x3_same(packed=True), the same kernel instance
    x = randn(B, 640, 128, 128)
    w = randn(320, 640, 3, 3) * (9 * 640) ** -0.5
    b = randn(320)
    got = conv3x3_same(x, w, b, packed=True)
    torch.cuda.synchronize()
    if not torch.equal(got, conv3x3_same(x, w, b)):
        fail("conv3x3_same(packed=True) does not launch the prologue-free kernel")
    r, _ = conv_case(f"conv3x3 packed=True B={B} 640->320 @128x128", x, w, b, packed=True)
    records["conv3x3_same(packed=True)"] = r
    del x, w, b, got

    # the f32 conv at the f32 SDXL UNet's classes (phase 11), f32 draws at
    # full mantissa; cuDNN in f32 with TF32 off is the library call
    worst = 0.0
    for cin, cout, hw in ((960, 320, 128), (640, 320, 128), (640, 640, 128), (960, 320, 96), (640, 640, 96)):
        x = torch.randn((B, cin, hw, hw), generator=gen, device=dev)
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (9 * cin) ** -0.5
        b = torch.randn((cout,), generator=gen, device=dev)
        r, _ = conv_case(f"conv3x3 f32 B={B} {cin}->{cout} @{hw}x{hw}{' (SD2.1)' if hw == 96 else ''}", x, w, b,
                         reps=3)
        worst = max(worst, r["max_abs_err"])
        if (cin, hw) == (960, 128):
            main = r
            if not torch.equal(conv3x3_same(x, w, b, packed=True), conv3x3_same(x, w, b)):
                fail("f32 conv3x3_same(packed=True) does not launch the f32 kernel")
        elif (cin, hw) == (960, 96):
            sd21 = r
        del x, w, b
    records["conv3x3_same_f32"] = with_sd21({**main, "max_abs_err": worst}, sd21, conv_keys)

    # kernel A: the VAE mid-block attention in f32, one head over 16384
    # tokens (SDXL, one 1024px frame) and over 4096 tokens of 7 frames at
    # once (SD1.5, the batched 512px decode); SDPA under each backend that
    # takes f32 at D=512, with its error, since a backend may compute f32
    # through TF32
    worst = 0.0
    for n, S, reps in ((1, 16384, 3), (7, 4096, 5)):
        q, k, v = (torch.randn((n, 1, S, 512), generator=gen, device=dev) for _ in range(3))
        got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v)
        err, ref = (got - want).abs().max().item(), want.abs().max().item()
        ms = cuda_ms(lambda: flash_self_attention_f32(q, k, v), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v), reps)
        bound_ms, bound_by = attention_bound("self", n, 1, S, S, 512, elem=4, tf32_passes=3)
        cuda_core_ms = 4.0 * n * S * S * 512 / PEAK_OPS_PER_S["f32"] * 1e3  # the same flops in plain f32 FMA
        library = sdpa_backends(q, k, v, want, reps)
        ok = math.isfinite(err) and err <= F32_ATTN_TOL * ref
        print(f"attention f32 self ({n},1,{S},512): max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
              f"tol {F32_ATTN_TOL * ref:.3e}) rel_l2 {rel_l2(got, want):.3e}  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)} (3xTF32; "
              f"{cuda_core_ms:.3f} ms at the f32 CUDA-core rate); library max_abs_err "
              f"{', '.join(f'{b} {t[1]:.3e}' for b, t in library.items())}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"f32 D=512 attention ({n},1,{S},512): kernel disagrees with the plain version")
        worst = max(worst, err)
        if S == 16384:
            lib_name, lib_ms = fastest(library)
            main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "f32_cuda_core_bound_ms": cuda_core_ms, "library_ms": lib_ms, "library": lib_name,
                    "library_max_abs_err": library[lib_name][1] if lib_name else None}
        del q, k, v, got, want
    records["flash_self_attention_f32"] = {**main, "max_abs_err": worst}

    # the same attention in a bf16 VAE: one 1024px SDXL frame, SD1.5's
    # batched 512px decode (also a 512px tile or encode), and a ragged
    # sequence; timed through the wrapper (ms) and launched alone on
    # operands d512_launch prepared once (kernel_ms); SDPA under each
    # backend that takes bf16 at D=512
    worst = 0.0
    for n, S, reps in ((1, 16384, 5), (7, 4096, 5), (1, 4000, 10)):
        q, k, v = (randn(n, 1, S, 512) for _ in range(3))
        got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v)
        err, ref = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
        _, launch = d512_launch(q, k, v)
        kernel_ms = cuda_ms(launch, reps)
        ms = cuda_ms(lambda: flash_self_attention_bf16(q, k, v), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v), reps)
        bound_ms, bound_by = attention_bound("self", n, 1, S, S, 512)
        library = sdpa_backends(q, k, v, want, reps)
        ok = math.isfinite(err) and err <= BF16_D512_TOL * ref
        print(f"attention bf16 self ({n},1,{S},512): max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
              f"tol {BF16_D512_TOL * ref:.3e}) rel_l2 {rel_l2(got, want):.3e}  kernel {ms:.4f} ms (launch alone "
              f"{kernel_ms:.4f})  plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)}; library "
              f"max_abs_err {', '.join(f'{b} {t[1]:.3e}' for b, t in library.items())}  {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"bf16 D=512 attention ({n},1,{S},512): kernel disagrees with the plain version")
        worst = max(worst, err)
        if S == 16384:
            lib_name, lib_ms = fastest(library)
            main = {"ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms, "library": lib_name}
        elif S == 4096:
            sd15 = {"sd15_ms": ms, "sd15_kernel_ms": kernel_ms, "sd15_bound_ms": bound_ms,
                    "sd15_library_ms": fastest(library)[1]}
        del q, k, v, got, want, launch
    records["flash_self_attention_bf16"] = {**main, **sd15, "max_abs_err": worst}

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
        ring = torch.zeros(H, W, dtype=torch.bool, device=dev)
        ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
        r, want = conv_case(f"conv3x3_gnsilu B={B} {cin}->{cout} @{H}x{W} ({calls}/forward)", x, w, b,
                            (gamma, beta), ring, reps=5)
        worst = max(worst, r["max_abs_err"])
        total_ms += calls * r["ms"]
        total_plain += calls * r["plain_ms"]
        if (H, cin, cout) == (128, 960, 320):
            main = r
    print(f"conv3x3_gnsilu per fused UNet forward (B={B}, {sum(fused_classes.values())} calls): "
          f"kernel {total_ms:.2f} ms through the wrapper, plain chain {total_plain:.2f} ms", flush=True)
    # the border-ring check must see a halo that took silu(shift): the
    # planted fault on the last class moves the ring, not the interior
    ref = want.float().abs().max().item()
    fault = halo_fault_plain(x, w, b, gamma, beta, 32)
    fdiff = (fault.float() - want.float()).abs()
    f_ring, f_in = fdiff[:, :, ring].max().item(), fdiff[:, :, ~ring].max().item()
    print(f"conv3x3_gnsilu planted halo fault @{H}x{W}: border {f_ring:.3e}, interior {f_in:.3e} "
          f"(tol {GNSILU_TOL * ref:.3e})", flush=True)
    if not f_ring > GNSILU_TOL * ref:
        fail("the border-ring check does not see a halo fault")
    records["conv3x3_gnsilu"] = {**main, "max_abs_err": worst}
    bf16_main = main

    # TPU kernel #5 in f32: the prologue in the f32 layout pass, then the f32
    # conv kernel; at SDXL's (7,960,128,128) -> 320 beside the bf16 kernel
    # above, then at every class of SD 2.1's f32 UNet with the fused
    # configuration on (phase 13); f32 draws at full mantissa, off zero mean
    worst, total_ms, total_plain, sd21_ms = 0.0, 0.0, 0.0, {}
    for (H, W, cin, cout), calls in [((128, 128, 960, 320), 0)] + sorted(sd21_classes.items()):
        x = torch.randn((B, cin, H, W), generator=gen, device=dev) * 2.0 + 1.0
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (9 * cin) ** -0.5
        b = torch.randn((cout,), generator=gen, device=dev)
        gamma = 1.0 + 0.3 * torch.randn(cin, generator=gen, device=dev)
        beta = 0.5 * torch.randn(cin, generator=gen, device=dev)
        ring = torch.zeros(H, W, dtype=torch.bool, device=dev)
        ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
        where = f"({calls}/SD2.1 forward)" if calls else "(SDXL class)"
        r, want = conv_case(f"conv3x3_gnsilu f32 B={B} {cin}->{cout} @{H}x{W} {where}", x, w, b, (gamma, beta),
                            ring, reps=3)
        worst = max(worst, r["max_abs_err"])
        if calls:
            total_ms += calls * r["ms"]
            total_plain += calls * r["plain_ms"]
            sd21_ms[f"{H}x{W} {cin}->{cout}"] = r["ms"]
        else:
            main = r
            print(f"conv3x3_gnsilu at (7,960,128,128) -> 320: f32 {r['ms']:.3f} ms through the wrapper (bf16 "
                  f"{bf16_main['ms']:.3f}), launched alone {r['kernel_ms']:.3f} (bf16 {bf16_main['kernel_ms']:.3f})",
                  flush=True)
        if (H, W, cin, cout) == max(sd21_classes):
            # the ring check must see a halo that took silu(shift) in f32 too
            ref = want.abs().max().item()
            fdiff = (halo_fault_plain(x, w, b, gamma, beta, 32) - want).abs()
            f_ring = fdiff[:, :, ring].max().item()
            print(f"conv3x3_gnsilu f32 planted halo fault @{H}x{W}: border {f_ring:.3e}, interior "
                  f"{fdiff[:, :, ~ring].max().item():.3e} (tol {F32_CONV_TOL * ref:.3e})", flush=True)
            if not f_ring > F32_CONV_TOL * ref:
                fail("the f32 border-ring check does not see a halo fault")
        del x, w, b, want
    print(f"conv3x3_gnsilu f32 per SD2.1 fused UNet forward (B={B}, {sum(sd21_classes.values())} calls): kernel "
          f"{total_ms:.2f} ms through the wrapper, plain chain {total_plain:.2f} ms", flush=True)
    records["conv3x3_gnsilu_f32"] = {**main, "max_abs_err": worst, "sd21_forward_ms": total_ms,
                                     "sd21_forward_plain_ms": total_plain, "sd21_class_ms": sd21_ms}
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
                 None if added is None else {k: v[:1] for k, v in added.items()})
    finally:
        layers.conv3x3_gnsilu, layers._FUSED_GN_CONV = real, False
    if not seen:
        fail("the fused configuration routed no conv to conv3x3_gnsilu")
    return seen


def sd21_fused_conv_classes() -> dict:
    """fused_conv_classes of the SD 2.1 UNet, read off one 96^2 frame on the
    meta device (shapes only: no weights, no memory, nothing on the card):
    the classes phase 3 times the f32 GN+SiLU conv at, as phase 13's fused
    configuration routes them."""
    import torch

    from aid_tpu_torch.models.configs import SD21_UNET
    from aid_tpu_torch.models.unet import UNet2DCondition

    meta = torch.device("meta")
    unet = UNet2DCondition(SD21_UNET, device=meta, dtype=torch.bfloat16).eval()
    s = SD21_UNET.sample_size
    sample = torch.zeros((1, 4, s, s), device=meta, dtype=torch.bfloat16)
    ehs = torch.zeros((1, 77, SD21_UNET.cross_attention_dim), device=meta, dtype=torch.bfloat16)
    classes = fused_conv_classes(unet, sample, ehs, None)
    print(f"SD2.1 fused GN+SiLU conv classes (H, W, Cin, Cout): calls per forward {classes}", flush=True)
    return classes


def build_headline(frames: int = 7, latent: int = 128, seed: int = 0, dtype=None):
    """The headline program's pieces (bench.py::build_headline, ported), in
    bf16 unless ``dtype`` says otherwise."""
    import torch

    from aid_tpu_torch.models.configs import SDXL_UNET
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.ops.interp import generate_beta_schedule

    dev, dtype = torch.device("cuda"), dtype or torch.bfloat16
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


def run_denoise(unet, sample, ehs, uncond, added, coef, steps: int, warmup_steps=None, **modes):
    """The denoise of the headline program: (final latents, seconds), host
    clock around work that ends in a synchronize. ``modes``: the engine's
    cfg_mode / loop_mode; ``warmup_steps`` defaults to half the steps."""
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
        num_steps=steps, warmup_steps=steps // 2 if warmup_steps is None else warmup_steps, added_cond=added, **modes)
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


@contextlib.contextmanager
def uncond_rows_interpolated():
    """A planted fault of batched CFG: the uncond rows take the cond rows'
    endpoints (cond rows 0 / N-1) and none of them is skipped, so they
    interpolate like the cond rows instead of computing vanilla attention."""
    import torch

    from aid_tpu_torch.models import layers

    real_endpoints, real_skip = layers.per_row_endpoints, layers.skip_mask

    def endpoints(x, n):
        return x[0:1].expand_as(x), x[n - 1:n].expand_as(x)

    def skip(c, n_cond):
        return real_skip(c, n_cond) & (torch.arange(c.shape[0], device=c.device) < n_cond)

    layers.per_row_endpoints, layers.skip_mask = endpoints, skip
    try:
        yield
    finally:
        layers.per_row_endpoints, layers.skip_mask = real_endpoints, real_skip


def check_bound(label: str, sound: list, fault: list, tol: float, fault_label: str) -> None:
    """Print per-frame readings of a sound run and of a planted fault against
    the bound on their largest frame; fail unless the sound reading is under
    the bound and the fault's over it."""
    worst, worst_fault = max(sound), max(fault)
    ok = math.isfinite(worst) and worst <= tol
    print(f"{label}: largest per-frame rel_l2 {worst:.3e} (by frame {' '.join(f'{r:.3e}' for r in sound)}; "
          f"tol {tol:.1e}; planted fault {fault_label} {worst_fault:.3e}, by frame "
          f"{' '.join(f'{r:.3e}' for r in fault)})  {'ok' if ok else 'FAIL'}", flush=True)
    if not worst_fault > tol:
        fail(f"{label}: the bound {tol:.1e} does not separate the planted fault {fault_label} ({worst_fault:.3e})")
    if not ok:
        fail(f"{label}: over its bound")


def phase_engine(unet, sample, ehs, uncond, added, coef, card: str):
    """2 SDXL steps (1 fused_outer warmup, 1 vanilla) in batched CFG against
    sequential, and in the fused loop against split, from the same inputs,
    each with a planted fault; the batched and fused runs are paths of their
    own for the launch counts. Returns their counts."""
    import torch

    print("== phase 6: engine modes, 2 SDXL steps: batched CFG vs sequential, fused loop vs split", flush=True)
    steps, paths, outs = 2, [], {}
    for label, modes in (("sequential split", {}), ("batched CFG", dict(cfg_mode="batched")),
                         ("fused loop", dict(loop_mode="fused"))):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        outs[label], elapsed = run_denoise(unet, sample, ehs, uncond, added, coef, steps, **modes)
        counts = read_counts()
        print(f"{label}: {elapsed / steps:.3f} s/step (first steps included); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)
        if not torch.isfinite(outs[label]).all():
            fail(f"2-step {label} denoise is not finite")
        if modes:
            check_path(label, counts, ("flash_interpolated_attention", "conv3x3_same"))
            paths.append(counts)
    with uncond_rows_interpolated():
        fault_batched, _ = run_denoise(unet, sample, ehs, uncond, added, coef, steps, cfg_mode="batched")
    # the fused loop with force_vanilla never set: the late step keeps its endpoints
    fault_fused, _ = run_denoise(unet, sample, ehs, uncond, added, coef, steps, warmup_steps=steps, loop_mode="fused")
    split = outs["sequential split"]
    check_bound("batched CFG vs sequential", frame_rel_l2(outs["batched CFG"], split),
                frame_rel_l2(fault_batched, split), BATCHED_CFG_TOL, "uncond rows given the cond endpoints")
    check_bound("fused loop vs split", frame_rel_l2(outs["fused loop"], split), frame_rel_l2(fault_fused, split),
                FUSED_LOOP_TOL, "force_vanilla ignored on the late step")
    return paths


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

    print("== phase 7: fused GroupNorm+SiLU resnet prologue (layers._FUSED_GN_CONV = True)", flush=True)
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


def run_image_path(pipe, vae, call, steps: int, frames: int):
    """Drive one image-out entry point with the launch counts set to 0 just
    before it and read just after; time its stages (encode per prompt
    pair, denoise per step, decode per frame) with the host clock around
    synchronized calls, and keep the decoder's input. Returns (images,
    counts, stage times, decoder inputs, seconds in all, peak bytes)."""
    import torch

    from aid_tpu_torch.pipelines import engine

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
        images = call()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
    finally:
        engine.denoise_sequence = real_denoise
        del vae.decode, pipe.encode_prompt
    times = {"encode": stages["encode"], "s_per_step": stages["denoise"][0] / steps,
             "s_per_frame": sum(stages["decode"]) / frames}
    return images, counts, times, decoder_inputs, elapsed, torch.cuda.max_memory_allocated()


def check_images(label: str, images, shape, times, elapsed: float, peak: int, card: str) -> None:
    import numpy as np

    print(f"{label}: output {images.shape} {images.dtype}; {elapsed:.2f} s in all on {card}: encode "
          f"{' / '.join(f'{x:.3f}' for x in times['encode'])} s per prompt pair (prompt + negative), "
          f"denoise {times['s_per_step']:.3f} s/step, decode {times['s_per_frame']:.3f} s/frame; "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    if images.shape != shape or images.dtype != np.uint8:
        fail(f"{label} returned {images.shape} {images.dtype}, want {shape} uint8")
    inside = float(((images > 0) & (images < 255)).mean())
    print(f"share of output values strictly inside (0, 255): {inside:.4f}", flush=True)


@contextlib.contextmanager
def attention_unnormalised_fault():
    """A planted fault of the VAE's attention: the plain attention at head
    dim 512 without the softmax's division by the row sum, as a kernel
    whose epilogue left out its 1 / l would give."""
    import torch

    from aid_tpu_torch.ops import flash_attention

    real_plain = flash_attention.flash_interpolated_attention_plain

    def fault(q, k, v, *args, scale=None, **kwargs):
        if q.shape[-1] != 512:
            return real_plain(q, k, v, *args, scale=scale, **kwargs)
        logits = (q.float() @ k.float().transpose(-1, -2)) * (512 ** -0.5 if scale is None else scale)
        return (torch.exp(logits - logits.amax(-1, keepdim=True)) @ v.float()).to(q.dtype)

    flash_attention.flash_interpolated_attention_plain = fault
    try:
        yield
    finally:
        flash_attention.flash_interpolated_attention_plain = real_plain


def check_decoder(decode, z, images, frame: int, tol: float = VAE_TOL, label: str = "raw decoder output",
                  planted_fault=None) -> float:
    """One frame's raw decoder output through the kernels (timed, host clock
    around synchronized work) vs the plain versions (and, with
    ``planted_fault``, the plain versions with that fault, which must land
    over ``tol``); fails on disagreement or on a mostly saturated frame."""
    import torch

    from aid_tpu_torch.ops.routing import reference_ops

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = decode(z)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        with reference_ops():
            want = decode(z)
            if planted_fault is not None:
                with planted_fault():
                    fault = decode(z)
    frame_inside = float(((images[frame] > 0) & (images[frame] < 255)).mean())
    rel = rel_l2(got, want)
    ok = math.isfinite(rel) and rel <= tol and bool(torch.isfinite(got).all())
    fault_note = "" if planted_fault is None else f"; planted fault attention not normalised {rel_l2(fault, want):.3e}"
    print(f"{label}, frame {frame} {tuple(got.shape)} {str(got.dtype).replace('torch.', '')} in {elapsed:.3f} s: "
          f"rel_l2 kernels vs "
          f"plain {rel:.3e} (tol {tol:.0e}; TF32 off on both sides{fault_note}); its uint8 values strictly inside "
          f"(0, 255): {frame_inside:.4f}  {'ok' if ok else 'FAIL'}", flush=True)
    if frame_inside < 0.5:
        fail("the compared frame is mostly saturated: the comparison would not see the kernel")
    if planted_fault is not None and not rel_l2(fault, want) > tol:
        fail(f"{label}: the bound {tol:.0e} does not separate the planted fault")
    if not ok:
        fail(f"{label}: the output through the kernels disagrees with the plain versions")
    return rel


def phase_image(unet, steps: int, card: str):
    """InterpolationXLPipeline.interpolate at 1024px with the f32 VAE, then
    with the bf16 VAE: stage times, launch counts, peak memory, one frame's
    raw decoder output through the kernels vs the plain versions, and that
    frame's tiled bf16 decode. Returns the two paths' launch counts."""
    import numpy as np
    import torch

    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.configs import CLIP_VIT_L_TEXT, SDXL_TEXT_ENCODER_2, SDXL_VAE
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines import engine
    from aid_tpu_torch.pipelines.sdxl import InterpolationXLPipeline
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    print(f"== phase 8: image out, InterpolationXLPipeline.interpolate, 7 frames at 1024px, {steps} steps",
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

    def call():
        return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", size=7, num_inference_steps=steps)

    images, counts, times, decoder_inputs, elapsed, peak = run_image_path(pipe, vae, call, steps, 7)
    check_images("interpolate", images, (7, 1024, 1024, 3), times, elapsed, peak, card)
    check_path("image out", counts, ("flash_interpolated_attention", "flash_self_attention_f32", "conv3x3_same"))
    if counts["flash_self_attention_f32"] != 7:
        fail(f"the f32 attention kernel ran {counts['flash_self_attention_f32']} times, once per frame (7) expected")
    check_decoder(vae.decode, decoder_inputs[3], images, 3)  # frame by frame: input 3 is frame 3

    # the same call with the bf16 VAE: its mid-block attention is the bf16
    # D=512 kernel, once per frame
    pipe.enable_bf16_vae_decode()
    f32_images, f32_times = images, times
    images, counts_bf16, times, decoder_inputs, elapsed, peak = run_image_path(pipe, vae, call, steps, 7)
    check_images("interpolate, bf16 VAE", images, (7, 1024, 1024, 3), times, elapsed, peak, card)
    check_path("image out, bf16 VAE", counts_bf16,
               ("flash_interpolated_attention", "flash_self_attention_bf16", "conv3x3_same"))
    if counts_bf16["flash_self_attention_bf16"] != 7 or counts_bf16["flash_self_attention_f32"]:
        fail(f"the bf16 VAE ran the bf16 D=512 kernel {counts_bf16['flash_self_attention_bf16']} times and the f32 "
             f"one {counts_bf16['flash_self_attention_f32']} times; 7 and 0 expected")
    diff = np.abs(images.astype(np.int32) - f32_images.astype(np.int32))
    print(f"decode {f32_times['s_per_frame']:.3f} s/frame with the f32 VAE, {times['s_per_frame']:.3f} s/frame with "
          f"the bf16 VAE on {card}; bf16 frames against the f32 ones (information): mean |diff| {diff.mean():.3f}, "
          f"max {diff.max()} uint8 steps, {float((diff > 1).mean()):.4f} of values more than one step apart",
          flush=True)
    check_decoder(vae.decode, decoder_inputs[3], images, 3, BF16_VAE_TOL, "raw bf16 decoder output",
                  attention_unnormalised_fault)
    # one frame in 512px tiles (64-latent tiles, 4096-token attention each)
    reset_counts()
    check_decoder(lambda z: engine.tiled_decode(vae, z, tile_latent_size=64), decoder_inputs[3], images, 3,
                  BF16_VAE_TOL, "tiled bf16 decode (64-latent tiles)", attention_unnormalised_fault)
    print(f"tiled decode of one frame: {read_counts()['flash_self_attention_bf16']} bf16 D=512 launches (one per "
          f"tile)", flush=True)
    return [counts, counts_bf16]


def sd15_coef():
    """Beta(25, 25) coefficients of 7 frames (the 25-step SD1.5 sequence),
    endpoints forced, on the host."""
    import torch

    from aid_tpu_torch.ops.interp import generate_beta_schedule

    return torch.from_numpy(generate_beta_schedule(7, SD15_STEPS, SD15_STEPS, force_endpoints=True))


def build_sd15(seed: int = 0, cfg=None, device: str = "cuda", dtype=None):
    """The full-width SD1.5 UNet (``configs.SD15_UNET``, bf16 unless
    ``dtype`` says otherwise, N(0, 0.02) weights from a seeded CUDA
    generator, as bench.py's SD1.5 workloads). ``cfg``/``device`` exist for
    rehearsing the phases on the CPU."""
    import torch

    from aid_tpu_torch.models.configs import SD15_UNET
    from aid_tpu_torch.models.unet import UNet2DCondition

    dev = torch.device(device)
    unet = UNet2DCondition(cfg or SD15_UNET, device=dev, dtype=dtype or torch.bfloat16).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return unet


def swapped_endpoints(plain):
    """A planted fault: the plain attention ``plain`` with the begin and end
    endpoints exchanged."""
    def fault(q, k, v, coef=None, mode="self", k_begin=None, v_begin=None, k_end=None, v_end=None, **kwargs):
        if k_begin is None:
            k_begin, v_begin = k[0], v[0]
        if k_end is None:
            k_end, v_end = k[-1], v[-1]
        return plain(q, k, v, coef, mode, k_begin=k_end, v_begin=v_end, k_end=k_begin, v_end=v_begin, **kwargs)
    return fault


def phase_sd15_unet(unet, coef):
    """One full-width SD1.5 forward in fused_outer, 7 frames at 64^2
    latents, through the kernels and through the plain versions, with two
    faults planted through the plain versions (check_unet_vs_plain). Returns
    the forward's launch counts."""
    import torch

    from aid_tpu_torch.models.layers import AidContext, AidMode

    cfg, dev, frames = unet.config, coef.device, coef.shape[0]
    s = cfg.sample_size
    print(f"== phase 9: whole SD1.5 UNet forward, kernels vs plain (fused_outer, {frames} frames, {s}x{s} latents)",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    sample = torch.randn((frames, cfg.in_channels, s, s), generator=gen, device=dev).to(torch.bfloat16)
    ehs = torch.randn((frames, 77, cfg.cross_attention_dim), generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor(500, device=dev)
    counts = check_unet_vs_plain(f"unet SD1.5 fused_outer B={frames} {s}x{s}", lambda aid: unet(sample, t, ehs, aid),
                                 AidContext(coef=coef, mode=AidMode.from_name("fused_outer")), SD15_UNET_TOL)
    by_dim = {d: counts[f"flash_interpolated_attention[D={d}]"] for d in (40, 80, 160)}
    print(f"SD1.5 forward: attention launches by head dim {by_dim}", flush=True)
    if not min(by_dim.values()) > 0:
        fail(f"the SD1.5 forward did not reach the kernel at every head dim: {by_dim}")
    return counts


def check_unet_vs_plain(label: str, forward, aid, tol: float) -> dict:
    """One UNet forward ``forward(aid)`` through the kernels and through the
    plain versions, with two faults planted through the plain versions
    (fused_outer computed as self; begin and end endpoints exchanged): the
    LARGEST PER-FRAME relative L2 must lie under ``tol`` and both faults over
    it. Returns the forward's launch counts."""
    import torch

    from aid_tpu_torch.ops import flash_attention
    from aid_tpu_torch.ops.routing import reference_ops

    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = forward(aid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = read_counts()
        with reference_ops():
            want = forward(aid)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fault_self = forward(None)
            real_plain = flash_attention.flash_interpolated_attention_plain
            flash_attention.flash_interpolated_attention_plain = swapped_endpoints(real_plain)
            try:
                fault_swap = forward(aid)
            finally:
                flash_attention.flash_interpolated_attention_plain = real_plain
    if not torch.isfinite(got).all():
        fail(f"{label}: the kernel output is not finite")
    readings = {"kernels": got, "fused_outer->self": fault_self, "endpoints swapped": fault_swap}
    per_frame = {name: frame_rel_l2(x, want) for name, x in readings.items()}
    for name, x in readings.items():
        print(f"  {name:18s} rel_l2 whole {rel_l2(x, want):.3e}, by frame "
              f"{' '.join(f'{r:.3e}' for r in per_frame[name])}", flush=True)
    rel, f_self, f_swap = (max(per_frame[name]) for name in readings)
    ok = math.isfinite(rel) and rel <= tol
    print(f"{label}: largest per-frame rel_l2 kernels vs plain {rel:.3e} (tol {tol:.1e}; planted faults: "
          f"fused_outer->self {f_self:.3e}, endpoints swapped {f_swap:.3e}); forward "
          f"{t1 - t0:.3f} s with kernels (first call), {t2 - t1:.3f} s plain  {'ok' if ok else 'FAIL'}", flush=True)
    for name, f in (("fused_outer->self", f_self), ("endpoints swapped", f_swap)):
        if not f > tol:
            fail(f"{label}: the bound {tol:.1e} does not separate the planted fault {name} ({f:.3e})")
    if not ok:
        fail(f"{label}: the output through the kernels disagrees with the plain versions")
    return counts


def phase_sd15_image(unet, card: str, steps: int, text_cfg=None, vae_cfg=None):
    """The SD1.5 pipeline at 512px with DDIM, random f32 CLIP ViT-L,
    HashTokenizer and the SD VAE decode of all frames at once (the JAX
    default): ``interpolate`` (PAID guide prompt, 7 frames) in sequential
    and in batched CFG (s/step of each over three warm runs; their
    final latents against each other, with a planted fault),
    ``interpolate_single(0.5)`` (3 frames), ``interpolate`` again with the
    bf16 VAE, and ``vae.encode`` of those frames. Each call is its own path
    for the launch counts; returns their counts. ``text_cfg``/``vae_cfg``
    exist for rehearsing on the CPU."""
    import numpy as np
    import torch

    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.configs import CLIP_VIT_L_TEXT, SD_VAE
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.ops.routing import reference_ops
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    text_cfg, vae_cfg = text_cfg or CLIP_VIT_L_TEXT, vae_cfg or SD_VAE
    px = unet.config.sample_size * 2 ** (len(vae_cfg.block_out_channels) - 1)
    print(f"== phase 10: image out, SD1.5 InterpolationPipeline at {px}px, {steps} DDIM steps: interpolate (PAID, "
          f"7 frames) in sequential and batched CFG, interpolate_single(0.5) (3 frames), interpolate with the bf16 "
          f"VAE, vae.encode of its frames", flush=True)
    dev = next(unet.parameters()).device
    torch.manual_seed(9)  # the modules' default initialisations draw from it
    with torch.no_grad():
        text = CLIPTextModel(text_cfg, device=dev).eval()
        vae = AutoencoderKL(vae_cfg, device=dev).eval()
    pipe = InterpolationPipeline(unet=unet, vae=vae, text_encoder=text,
                                 tokenizer=HashTokenizer(text_cfg.vocab_size), scheduler=DDIMScheduler())
    gen = torch.Generator(device=dev).manual_seed(2)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)

    def interpolate(**kw):
        return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", guide_prompt="a guide prompt", size=7,
                                num_inference_steps=steps, **kw)

    def interpolate_single():
        return pipe.interpolate_single(0.5, latent_a, latent_b, "prompt A", "prompt B", num_inference_steps=steps)

    heads = ("flash_interpolated_attention[D=40]", "flash_interpolated_attention[D=80]",
             "flash_interpolated_attention[D=160]")
    paths = []

    def run_path(label, frames, call, vae_kernel="flash_self_attention_f32", tol=VAE_TOL, planted_fault=None):
        images, counts, times, decoder_inputs, elapsed, peak = run_image_path(pipe, vae, call, steps, frames)
        check_images(f"SD1.5 {label}", images, (frames, px, px, 3), times, elapsed, peak, card)
        check_path(f"SD1.5 {label}", counts, heads + (vae_kernel,))
        if counts[vae_kernel] != 1:
            fail(f"SD1.5 {label}: {counts[vae_kernel]} launches of {vae_kernel}, one batched decode (1) expected")
        # one decode of all frames: compare its least saturated frame
        inside = ((images > 0) & (images < 255)).reshape(frames, -1).mean(axis=1)
        frame = int(inside.argmax())
        check_decoder(vae.decode, decoder_inputs[0][frame:frame + 1], images, frame, tol,
                      "raw decoder output" if planted_fault is None else "raw bf16 decoder output", planted_fault)
        paths.append(counts)
        return images, times

    _, f32_times = run_path("interpolate", 7, interpolate)
    pipe.cfg_mode = "batched"
    run_path("interpolate, batched CFG", 7, interpolate)

    # s/step of both CFG modes over warm runs, in turns; the final latents
    # of the two modes against each other, and against a planted fault
    per_step, finals = {"sequential": [], "batched": []}, {}
    for mode in ("sequential", "batched", "batched", "sequential", "sequential", "batched"):
        pipe.cfg_mode = mode
        finals[mode], _, times, _, _, _ = run_image_path(pipe, vae, lambda: interpolate(output_type="latent"), steps, 7)
        per_step[mode].append(times["s_per_step"])
    for mode, t in per_step.items():
        print(f"SD1.5 interpolate, {mode} CFG: {len(t)} warm runs, best {min(t):.4f} s/step, p50 "
              f"{float(np.median(t)):.4f} s/step (all: {' '.join(f'{x:.4f}' for x in t)}) on {card}", flush=True)
    pipe.cfg_mode = "batched"
    with uncond_rows_interpolated():
        fault = interpolate(output_type="latent")
    pipe.cfg_mode = "sequential"
    check_bound("SD1.5 interpolate, batched CFG vs sequential (final latents)",
                frame_rel_l2(finals["batched"], finals["sequential"]), frame_rel_l2(fault, finals["sequential"]),
                SD15_CFG_TOL, "uncond rows given the cond endpoints")

    run_path("interpolate_single", 3, interpolate_single)

    # the bf16 VAE: one (7,1,4096,512) launch of the bf16 D=512 kernel in the
    # decode, then the encode of those frames (4096-token encoder attention)
    pipe.enable_bf16_vae_decode()
    images, times = run_path("interpolate, bf16 VAE", 7, interpolate, "flash_self_attention_bf16", BF16_VAE_TOL,
                             attention_unnormalised_fault)
    print(f"SD1.5 decode {f32_times['s_per_frame']:.4f} s/frame with the f32 VAE, {times['s_per_frame']:.4f} s/frame "
          f"with the bf16 VAE on {card}", flush=True)
    x = (torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).float() / 127.5 - 1.0).contiguous()
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = vae.encode(x)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        with reference_ops():
            want = vae.encode(x)
            with attention_unnormalised_fault():
                fault = vae.encode(x)
    print(f"SD1.5 vae.encode of 7 frames (bf16): {tuple(got.shape)} {got.dtype} in {elapsed:.3f} s on {card}",
          flush=True)
    check_path("SD1.5 encode", counts, ("flash_self_attention_bf16",))
    s = unet.config.sample_size
    if tuple(got.shape) != (7, vae_cfg.latent_channels, s, s) or not torch.isfinite(got).all():
        fail(f"vae.encode returned {tuple(got.shape)} or non-finite values")
    check_bound("SD1.5 vae.encode (bf16), kernels vs plain (posterior mean)", frame_rel_l2(got, want),
                frame_rel_l2(fault, want), BF16_VAE_TOL, "attention not normalised")
    paths.append(counts)
    return paths


def check_f32_only(path: str, counts: dict, needed) -> None:
    """check_path, and no launch of a bf16 kernel on an f32 path."""
    check_path(path, counts, needed)
    bf16 = {n: counts[n] for n in ("flash_interpolated_attention", "flash_self_attention_bf16", "conv3x3_same",
                                   "conv3x3_gnsilu")}
    if any(bf16.values()):
        fail(f"the f32 {path} path launched bf16 kernels: {bf16}")


def phase_f32_sdxl(card: str):
    """The SDXL UNet in f32 at full width and depth (N(0, 0.02) weights from
    a seeded CUDA generator), 7 frames at 128^2 latents, Beta(28, 28): one
    fused_outer forward, kernels vs plain, then a 2-step Euler denoise (1
    fused_outer warmup step, 1 vanilla). Returns the denoise's counts."""
    import torch

    from aid_tpu_torch.models.layers import AidContext, AidMode

    print("== phase 11: f32 SDXL UNet, full width and depth, 7 frames at 128x128: one fused_outer forward kernels "
          "vs plain, then 2 Euler steps (1 fused_outer warmup, 1 vanilla); TF32 off for cuBLAS and cuDNN",
          flush=True)
    unet, sample, ehs, uncond, added, coef = build_headline(dtype=torch.float32)
    t = torch.tensor(500.0, device=sample.device)
    counts = check_unet_vs_plain(f"f32 SDXL unet fused_outer B={sample.shape[0]} 128x128",
                                 lambda aid: unet(sample, t, ehs, aid, added),
                                 AidContext(coef=coef, mode=AidMode.from_name("fused_outer")), F32_UNET_TOL)
    check_f32_only("f32 SDXL forward", counts, ("flash_interpolated_attention_f32[D=64]", "conv3x3_same_f32"))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, elapsed = run_denoise(unet, sample, ehs, uncond, added, coef, 2)
    counts = read_counts()
    checksum = float(out.float().sum())
    print(f"f32 SDXL denoise: checksum {checksum!r}; output {tuple(out.shape)} {out.dtype}; {elapsed / 2:.3f} s/step "
          f"(2 steps, the first included); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}",
          flush=True)
    if tuple(out.shape) != tuple(sample.shape) or out.dtype != torch.float32 or not math.isfinite(checksum):
        fail(f"f32 SDXL denoise returned {tuple(out.shape)} {out.dtype}, checksum {checksum}")
    check_f32_only("f32 SDXL denoise", counts, ("flash_interpolated_attention_f32[D=64]", "conv3x3_same_f32"))
    return counts


def phase_f32_sd15(card: str, steps: int, unet=None, text_cfg=None, vae_cfg=None):
    """The SD1.5 UNet in f32 (D = 40/80/160), random f32 CLIP ViT-L and the
    f32 SD VAE: one fused_outer forward, kernels vs plain, then
    ``InterpolationPipeline.interpolate`` (PAID guide prompt, 7 frames,
    512px, DDIM) and three warm runs of its denoise for s/step. Returns the
    interpolate path's counts. ``unet``/``text_cfg``/``vae_cfg`` exist for
    rehearsing on the CPU."""
    import numpy as np
    import torch

    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.configs import CLIP_VIT_L_TEXT, SD_VAE
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    print(f"== phase 12: f32 SD1.5 UNet: one fused_outer forward kernels vs plain, then interpolate (PAID, 7 "
          f"frames, {steps} DDIM steps) with f32 CLIP and VAE; TF32 off for cuBLAS and cuDNN", flush=True)
    unet = unet or build_sd15(dtype=torch.float32)
    text_cfg, vae_cfg = text_cfg or CLIP_VIT_L_TEXT, vae_cfg or SD_VAE
    cfg, dev = unet.config, next(unet.parameters()).device
    s = cfg.sample_size
    px = s * 2 ** (len(vae_cfg.block_out_channels) - 1)
    gen = torch.Generator(device=dev).manual_seed(3)
    sample = torch.randn((7, cfg.in_channels, s, s), generator=gen, device=dev)
    ehs = torch.randn((7, 77, cfg.cross_attention_dim), generator=gen, device=dev)
    t = torch.tensor(500, device=dev)
    heads = tuple(f"flash_interpolated_attention_f32[D={d}]" for d in (40, 80, 160))
    counts = check_unet_vs_plain(f"f32 SD1.5 unet fused_outer B=7 {s}x{s}", lambda aid: unet(sample, t, ehs, aid),
                                 AidContext(coef=sd15_coef().to(dev), mode=AidMode.from_name("fused_outer")),
                                 F32_UNET_TOL)
    check_f32_only("f32 SD1.5 forward", counts, heads)

    torch.manual_seed(9)  # the modules' default initialisations draw from it
    with torch.no_grad():
        text = CLIPTextModel(text_cfg, device=dev).eval()
        vae = AutoencoderKL(vae_cfg, device=dev).eval()
    pipe = InterpolationPipeline(unet=unet, vae=vae, text_encoder=text,
                                 tokenizer=HashTokenizer(text_cfg.vocab_size), scheduler=DDIMScheduler())
    gen = torch.Generator(device=dev).manual_seed(2)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)

    def interpolate(**kw):
        return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", guide_prompt="a guide prompt", size=7,
                                num_inference_steps=steps, **kw)

    images, counts, times, _, elapsed, peak = run_image_path(pipe, vae, interpolate, steps, 7)
    check_images("f32 SD1.5 interpolate", images, (7, px, px, 3), times, elapsed, peak, card)
    check_f32_only("f32 SD1.5 interpolate", counts, heads + ("flash_self_attention_f32",))
    per_step = []
    for _ in range(3):
        _, _, warm, _, _, _ = run_image_path(pipe, vae, lambda: interpolate(output_type="latent"), steps, 7)
        per_step.append(warm["s_per_step"])
    print(f"f32 SD1.5 interpolate, sequential CFG: 3 warm runs, best {min(per_step):.4f} s/step, p50 "
          f"{float(np.median(per_step)):.4f} s/step (all: {' '.join(f'{x:.4f}' for x in per_step)}) on {card}",
          flush=True)
    return counts


# SD 2.1 at 768px as the JAX app runs it (aid_tpu/apps/gradio_app.py:39):
# UniPC, guidance 10, 25 steps, the loader's default dtype (bf16 UNet).
SD21_STEPS = 25
SD21_GUIDANCE = 10.0
# The SD 2.1 whole UNet in bf16 (phase 13), kernels vs plain, the LARGEST
# PER-FRAME relative L2 of the output, as SD15_UNET_TOL. On an H100 (these
# seeds; deterministic): sound 2.80-2.97e-3 in every frame; planted faults
# fused_outer computed as self 5.53e-2 at most, endpoints swapped 7.30e-3 at
# most (frame 1; frames 0, 3 and 6 do not move). SD 1.5's 4.5e-3 lies
# between: 1.5x the sound reading, 0.62x the smaller fault. Phase 13
# measures both faults in every run and fails if the bound does not
# separate either.
SD21_UNET_TOL = 4.5e-3


def sd21_diffusers_configs() -> dict:
    """config.json of each module of a diffusers SD 2.1 (768-v) directory,
    as published, and its scheduler_config.json (v-prediction DDIM,
    scaled_linear 0.00085-0.012, steps_offset 1, set_alpha_to_one false)."""
    from aid_tpu_torch.models.configs import OPENCLIP_VIT_H_TEXT as T, SD21_UNET as U, SD_VAE as V

    return {
        "unet": {"_class_name": "UNet2DConditionModel", "sample_size": U.sample_size, "in_channels": 4,
                 "out_channels": 4, "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
                 "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
                 "block_out_channels": list(U.block_out_channels), "layers_per_block": U.layers_per_block,
                 "attention_head_dim": list(U.num_attention_heads), "use_linear_projection": True,
                 "cross_attention_dim": U.cross_attention_dim, "norm_num_groups": 32, "flip_sin_to_cos": True,
                 "freq_shift": 0},
        "vae": {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3, "latent_channels": 4,
                "block_out_channels": list(V.block_out_channels), "layers_per_block": V.layers_per_block,
                "norm_num_groups": 32, "scaling_factor": V.scaling_factor, "sample_size": 768},
        "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": T.vocab_size,
                         "hidden_size": T.hidden_size, "intermediate_size": T.intermediate_size,
                         "num_hidden_layers": T.num_hidden_layers, "num_attention_heads": T.num_attention_heads,
                         "max_position_embeddings": 77, "hidden_act": "gelu", "bos_token_id": 0, "eos_token_id": 2,
                         "projection_dim": 512},
        "scheduler": {"_class_name": "DDIMScheduler", "prediction_type": "v_prediction",
                      "beta_schedule": "scaled_linear", "beta_start": 0.00085, "beta_end": 0.012,
                      "num_train_timesteps": 1000, "steps_offset": 1, "set_alpha_to_one": False,
                      "clip_sample": False},
    }


def write_sd21_checkpoint(root: str, seed: int = 0, device: str = "cuda", configs=None) -> int:
    """Write a full-width SD 2.1 diffusers directory under ``root``: each
    module's config.json, its weights ~ N(0, 0.02) from a seeded generator
    stored in f16 (as SD 2.1's published fp16 variant; ~2.6 GB), a
    byte-level tokenizer padding with "!", and the scheduler config.
    ``configs`` (sd21_diffusers_configs by default) and ``device`` let a
    test write a tiny copy on the CPU. Returns the bytes of weights written."""
    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.utils.safetensors import save_safetensors
    from aid_tpu_torch.utils.tokenizer import write_byte_level_tokenizer

    configs = configs or sd21_diffusers_configs()
    gen = torch.Generator(device=device).manual_seed(seed)
    modules = {"unet": (UNet2DCondition, loader.unet_config_from_diffusers, "diffusion_pytorch_model"),
               "vae": (AutoencoderKL, loader.vae_config_from_diffusers, "diffusion_pytorch_model"),
               "text_encoder": (CLIPTextModel, loader.clip_text_config_from_transformers, "model")}
    nbytes = 0
    for sub, cfg in configs.items():
        os.makedirs(os.path.join(root, sub))
        name = "scheduler_config.json" if sub == "scheduler" else "config.json"
        with open(os.path.join(root, sub, name), "w") as f:
            json.dump(cfg, f)
        if sub == "scheduler":
            continue
        cls, read, stem = modules[sub]
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in cls(read(cfg)).state_dict().items()}
        weights = {k: (torch.randn(shape, generator=gen, device=device) * 0.02).half() for k, shape in shapes.items()}
        save_safetensors(weights, os.path.join(root, sub, f"{stem}.fp16.safetensors"))
        nbytes += sum(w.numel() * w.element_size() for w in weights.values())
        del weights
    write_byte_level_tokenizer(os.path.join(root, "tokenizer"))
    return nbytes


def check_fused_vs_plain(label: str, forward, tol: float, counter: str) -> dict:
    """The fused GN+SiLU configuration (``layers._FUSED_GN_CONV``) of one
    UNet forward ``forward()`` through the kernels and through the plain
    versions, and with the planted halo fault (the plain GN+SiLU conv
    padding before its prologue): the largest per-frame relative L2 must lie
    under ``tol`` and the fault over it; ``counter`` must have launched.
    Returns the forward's launch counts."""
    import torch

    from aid_tpu_torch.models import layers
    from aid_tpu_torch.ops import conv
    from aid_tpu_torch.ops.routing import reference_ops

    real_plain = conv.conv3x3_gnsilu_plain
    try:
        layers._FUSED_GN_CONV = True
        with torch.no_grad():
            reset_counts()
            got = forward()
            torch.cuda.synchronize()
            counts = read_counts()
            with reference_ops():
                want = forward()
                conv.conv3x3_gnsilu_plain = halo_fault_plain
                fault = forward()
    finally:
        conv.conv3x3_gnsilu_plain = real_plain
        layers._FUSED_GN_CONV = False
    if not torch.isfinite(got).all():
        fail(f"{label}: the kernel output is not finite")
    print(f"{label}: {counts[counter]} {counter} launches", flush=True)
    if counts[counter] <= 0:
        fail(f"{label}: {counter} was not launched")
    check_bound(label, frame_rel_l2(got, want), frame_rel_l2(fault, want), tol, "halo not re-zeroed")
    return counts


def phase_sd21(card: str) -> list:
    """SD 2.1 at 768px through the port's loader, as the JAX app loads it:
    a full-width diffusers directory written from a seed into the checkout's
    git-ignored build/ (removed at the end), then
    ``load_interpolation_pipeline(dir, scheduler_name="unipc",
    guidance_scale=10.0)`` with no device and no dtype: every module on the
    card, the UNet in bf16, the VAE in f32 (force_upcast). In bf16: one
    fused_outer forward kernels vs plain (two planted faults), then
    ``interpolate`` (7 frames, SD21_STEPS UniPC steps, sequential CFG). In
    f32 (reloaded with ``dtype=torch.float32``): the forward check, the same
    with the fused GN+SiLU configuration (the f32 GN+SiLU conv) and its
    planted halo fault, then 2 UniPC steps. Returns the paths' launch
    counts."""
    import shutil
    import tempfile

    import torch

    from aid_tpu_torch.models import configs as C
    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.schedulers import UniPCScheduler

    steps = SD21_STEPS
    print(f"== phase 13: SD2.1 at 768px through the loader (load_interpolation_pipeline, UniPC, guidance "
          f"{SD21_GUIDANCE}): bf16 forward kernels vs plain, interpolate (7 frames, {steps} steps); f32 forward, "
          f"fused GN+SiLU forward, 2 steps", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="sd21-checkpoint-", dir=os.path.join(ROOT, "build"))
    paths = []
    try:
        t0 = time.perf_counter()
        nbytes = write_sd21_checkpoint(root)
        print(f"wrote a full-width SD2.1 diffusers directory ({nbytes / 2**30:.2f} GiB of f16 weights) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        def load(**kw):
            t0 = time.perf_counter()
            pipe = loader.load_interpolation_pipeline(root, scheduler_name="unipc", guidance_scale=SD21_GUIDANCE, **kw)
            torch.cuda.synchronize()
            args = ", ".join(f"{k}={v}" for k, v in kw.items()) or "no device, no dtype"
            print(f"load_interpolation_pipeline({args}) in {time.perf_counter() - t0:.2f} s", flush=True)
            return pipe

        pipe = load()
        placed = {name: ({p.device.type for p in m.parameters()}, {p.dtype for p in m.parameters()})
                  for name, m in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.text_encoder))}
        print(f"modules (devices, dtypes): {placed}; scheduler {type(pipe.scheduler).__name__} "
              f"({pipe.scheduler.config.prediction_type}); guidance {pipe.guidance_scale}", flush=True)
        want_dtypes = {"unet": torch.bfloat16, "vae": torch.float32, "text_encoder": torch.float32}
        if any(placed[n] != ({"cuda"}, {want_dtypes[n]}) for n in placed):
            fail(f"the loader placed the SD2.1 modules at {placed}; every module on the card, the UNet in bf16 and "
                 f"the VAE and text encoder in f32 expected")
        if not isinstance(pipe.scheduler, UniPCScheduler) or pipe.scheduler.config.prediction_type != "v_prediction":
            fail("the loader did not build UniPC with v-prediction")
        if pipe.unet.config != C.SD21_UNET:
            fail(f"the loaded UNet config {pipe.unet.config} is not configs.SD21_UNET")

        unet, cfg = pipe.unet, pipe.unet.config
        s, dev = cfg.sample_size, torch.device("cuda")
        coef = sd15_coef().to(dev)  # Beta(25, 25): the 25-step sequence's coefficients
        gen = torch.Generator(device=dev).manual_seed(5)
        sample = torch.randn((7, cfg.in_channels, s, s), generator=gen, device=dev)
        ehs = torch.randn((7, 77, cfg.cross_attention_dim), generator=gen, device=dev)
        t = torch.tensor(500, device=dev)
        aid = AidContext(coef=coef, mode=AidMode.from_name("fused_outer"))

        def forward(aid_ctx, m=unet, dtype=torch.bfloat16):
            return m(sample.to(dtype), t, ehs.to(dtype), aid_ctx)

        counts = check_unet_vs_plain(f"unet SD2.1 fused_outer B=7 {s}x{s} (bf16)", forward, aid, SD21_UNET_TOL)
        check_path("SD2.1 bf16 forward", counts, ("flash_interpolated_attention[D=64]", "conv3x3_same"))

        latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)

        def interpolate(**kw):
            return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", size=7, **kw)

        px = s * 2 ** (len(pipe.vae.config.block_out_channels) - 1)
        images, counts, times, decoder_inputs, elapsed, peak = run_image_path(
            pipe, pipe.vae, lambda: interpolate(num_inference_steps=steps), steps, 7)
        check_images(f"SD2.1 interpolate ({steps} UniPC steps)", images, (7, px, px, 3), times, elapsed, peak, card)
        checksum = float(decoder_inputs[0].float().sum())
        print(f"SD2.1 interpolate: final latents checksum {checksum!r}; launches of the bf16 attention at D=64 "
              f"{counts['flash_interpolated_attention[D=64]']}, of the conv kernel {counts['conv3x3_same']}",
              flush=True)
        if not math.isfinite(checksum):
            fail(f"SD2.1 interpolate: non-finite checksum {checksum}")
        check_path("SD2.1 interpolate", counts,
                   ("flash_interpolated_attention[D=64]", "conv3x3_same", "flash_self_attention_f32"))
        inside = ((images > 0) & (images < 255)).reshape(7, -1).mean(axis=1)
        frame = int(inside.argmax())
        check_decoder(pipe.vae.decode, decoder_inputs[0][frame:frame + 1], images, frame)
        paths.append(counts)
        del pipe, unet, images, decoder_inputs
        torch.cuda.empty_cache()

        pipe = load(dtype=torch.float32)
        unet = pipe.unet
        if {p.dtype for p in unet.parameters()} != {torch.float32}:
            fail("load_interpolation_pipeline(dtype=torch.float32) did not give an f32 UNet")

        def forward32(aid_ctx=aid):
            return forward(aid_ctx, unet, torch.float32)

        counts = check_unet_vs_plain(f"f32 SD2.1 unet fused_outer B=7 {s}x{s}", forward32, aid, F32_UNET_TOL)
        check_f32_only("f32 SD2.1 forward", counts, ("flash_interpolated_attention_f32[D=64]", "conv3x3_same_f32"))
        counts = check_fused_vs_plain(f"f32 SD2.1 unet, fused GN+SiLU, fused_outer B=7 {s}x{s}", forward32,
                                      F32_UNET_TOL, "conv3x3_gnsilu_f32")
        check_f32_only("f32 SD2.1 fused GN forward", counts,
                       ("flash_interpolated_attention_f32[D=64]", "conv3x3_same_f32", "conv3x3_gnsilu_f32"))
        paths.append(counts)

        final, counts, times, _, elapsed, peak = run_image_path(
            pipe, pipe.vae, lambda: interpolate(num_inference_steps=2, output_type="latent"), 2, 7)
        checksum = float(final.float().sum())
        print(f"f32 SD2.1 interpolate, 2 UniPC steps: latents {tuple(final.shape)} {final.dtype}, checksum "
              f"{checksum!r}; {times['s_per_step']:.3f} s/step (the first steps); encode "
              f"{' / '.join(f'{x:.3f}' for x in times['encode'])} s per prompt pair; peak memory "
              f"{peak / 2**30:.2f} GiB on {card}", flush=True)
        if tuple(final.shape) != (7, cfg.in_channels, s, s) or not math.isfinite(checksum):
            fail(f"f32 SD2.1 interpolate returned {tuple(final.shape)}, checksum {checksum}")
        check_f32_only("f32 SD2.1 interpolate", counts, ("flash_interpolated_attention_f32[D=64]", "conv3x3_same_f32"))
        paths.append(counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


# the keys every entry of the kernels line carries, in this order
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def phase_tiny_padded(card: str) -> None:
    """The tiny SD1.x-like UNet (``configs.TINY_UNET``: head dims 16 and 32,
    which no kernel instance takes) in f32, 7 frames at 8x8 latents with
    SD1.5's coefficients, N(0, 0.02) weights: one fused_outer forward
    through the kernels, every attention zero-padded to the D=40 instance,
    against the plain versions with the two planted faults
    (check_unet_vs_plain, F32_UNET_TOL). Fails unless the attention
    launches all land on D=40."""
    import torch

    from aid_tpu_torch.models.configs import TINY_UNET
    from aid_tpu_torch.models.layers import AidContext, AidMode

    print("== phase 14: padded head dims, the tiny f32 UNet (D=16 and 32 on the D=40 instance), kernels vs plain",
          flush=True)
    unet = build_sd15(seed=5, cfg=TINY_UNET, dtype=torch.float32)
    coef = sd15_coef().cuda()
    cfg, dev, frames = unet.config, coef.device, coef.shape[0]
    s = cfg.sample_size
    gen = torch.Generator(device=dev).manual_seed(3)
    sample = torch.randn((frames, cfg.in_channels, s, s), generator=gen, device=dev)
    ehs = torch.randn((frames, 77, cfg.cross_attention_dim), generator=gen, device=dev)
    t = torch.tensor(500, device=dev)
    counts = check_unet_vs_plain(f"tiny f32 unet fused_outer B={frames} {s}x{s} on {card}",
                                 lambda aid: unet(sample, t, ehs, aid),
                                 AidContext(coef=coef, mode=AidMode.from_name("fused_outer")), F32_UNET_TOL)
    by_dim = {d: counts[f"flash_interpolated_attention_f32[D={d}]"] for d in (40, 64, 80, 160)}
    print(f"tiny f32 UNet forward: f32 attention launches by instance head dim {by_dim} (bf16 attention "
          f"{counts['flash_interpolated_attention']})", flush=True)
    if not by_dim[40] > 0 or sum(by_dim.values()) != by_dim[40] or counts["flash_interpolated_attention"]:
        fail(f"the tiny UNet's padded head dims did not all reach the f32 D=40 instance: {by_dim}")


def kernels_line(kernels: dict, launches: dict) -> str:
    """The kernels' JSON record: one entry per kernel, with KERNEL_KEYS
    first, then what phase 3 measured besides (the conv's kernel_ms, the
    library call's name, the self case of the attention kernels, ...).
    ``kernels`` is phase 3's {name: record}, ``launches`` the counts summed
    over the paths."""
    flash_src = "aid_tpu_torch/csrc/flash_interpolated_attention.cu"
    conv_src = "aid_tpu_torch/csrc/conv3x3.cu"
    flash_f32_src = "aid_tpu_torch/csrc/flash_interpolated_attention_f32.cu"
    flash_replaces = ("aid_tpu/ops/flash_attention.py:101", {"also_replaces": "aid_tpu/ops/flash_attention.py:339"})
    conv_note = ("ms: through the wrapper, as the model calls it (w tiled once; x laid out by the layout kernel "
                 "aid_conv3x3_blocked_bf16 of the same source, which every launch runs first); kernel_ms: the "
                 "conv launch alone on operands laid out by aid_tpu_torch/ops/conv.py::kernel_operands; "
                 "layout_ms: the layout kernel alone, layout_plain_ms: torch's permuting copy")
    attn_note = ("ms: through the wrapper, as the model calls it; kernel_ms: the launch alone on operands "
                 "aid_tpu_torch/ops/flash_attention.py::kernel_launch prepared once")
    f32_wgmma = "wgmma 3xTF32 (raw hi), TMA, a split/transpose producer warpgroup"
    conv_f32_design = ("wgmma tf32 m64n160k8, both operands in shared memory, 3xTF32 (raw hi; the lo parts of x "
                       "from the layout pass, of w tiled once), one TMA window a K chunk for all nine taps, each "
                       "chunk's sum folded in f32")
    # name -> (source, TPU kernel replaced, the launch counts it is read from, extra fields)
    rows = {
        "flash_interpolated_attention": (
            flash_src, flash_replaces[0], ("flash_interpolated_attention[D=64]",),
            {**flash_replaces[1], "contract": "bf16, head dim 64, every mode (SDXL / SD2.x UNet); ms at "
                                              "fused_outer (7,10,4096,64), self_* at self (7,10,4096,64); "
                                              f"{attn_note}"}),
        "flash_interpolated_attention(D=40/80/160)": (
            flash_src, flash_replaces[0],
            tuple(f"flash_interpolated_attention[D={d}]" for d in (40, 80, 160)),
            {**flash_replaces[1], "contract": "bf16, head dims 40/80/160, every mode (SD1.x UNet); "
                                              "ms at fused_outer (7,8,4096,40), self_* at self (7,8,4096,40); "
                                              f"{attn_note}"}),
        "flash_self_attention_f32": (
            "aid_tpu_torch/csrc/flash_attention_f32_d512.cu", "aid_tpu/ops/flash_attention.py:101",
            ("flash_self_attention_f32",),
            {"contract": "f32, head dim 512, self (VAE mid block), 3xTF32; at (1,1,16384,512)"}),
        "flash_self_attention_bf16": (
            "aid_tpu_torch/csrc/flash_attention_bf16_d512.cu", flash_replaces[0], ("flash_self_attention_bf16",),
            {**flash_replaces[1], "design": "wgmma bf16 (Q K^T m64n32k16 from shared memory, P V m64n256k16 with "
                                            "P from registers, V through the transpose bit), TMA K and V rings "
                                            "filled by a producer warpgroup, D split across two consumer "
                                            "warpgroups that exchange partial scores, software-pipelined",
             "contract": "bf16, head dim 512, self (a bf16 VAE's mid block, encoder and "
                                              "decoder); ms at (1,1,16384,512), sd15_* at (7,1,4096,512); ms: "
                                              "through the wrapper, as the model calls it; kernel_ms: the launch "
                                              "alone on operands aid_tpu_torch/ops/flash_attention.py::d512_launch "
                                              "prepared once"}),
        "conv3x3_same": (conv_src, "aid_tpu/ops/conv.py:30", ("conv3x3_same",),
                         {"contract": f"bf16, (7,960,128,128) -> 320; {conv_note}"}),
        # the packed-K TPU kernel's port is the same (prologue-free) kernel
        # instance, so its launches are that instance's
        "conv3x3_same(packed=True)": (conv_src, "aid_tpu/ops/conv.py:47", ("conv3x3_same",),
                                      {"shares_kernel_with": "conv3x3_same",
                                       "contract": f"bf16, (7,640,128,128) -> 320; {conv_note}"}),
        "conv3x3_gnsilu": (conv_src, "aid_tpu/ops/conv.py:78", ("conv3x3_gnsilu",),
                           {"contract": f"bf16, (7,960,128,128) -> 320 with the GN+SiLU prologue; {conv_note}"}),
        "flash_interpolated_attention_f32": (
            flash_f32_src, flash_replaces[0], ("flash_interpolated_attention_f32[D=64]",),
            {**flash_replaces[1], "design": f32_wgmma,
             "contract": "f32, head dim 64, every mode (an f32 SDXL / SD2.x UNet), 3xTF32; "
                         "ms at fused_outer (7,10,4096,64), self_* at self (7,10,4096,64); "
                         f"{attn_note}"}),
        "flash_interpolated_attention_f32(D=40/80/160)": (
            flash_f32_src, flash_replaces[0],
            tuple(f"flash_interpolated_attention_f32[D={d}]" for d in (40, 80, 160)),
            {**flash_replaces[1], "design": f"{f32_wgmma}; at D=160 two consumer warpgroups of 80 columns "
                                            "each on the same 64 rows (Q hi and lo in registers), exchanging "
                                            "partial scores through shared memory once a 16-key tile, V^T under "
                                            "the 64-byte swizzle",
             "contract": "f32, head dims 40/80/160, every mode (an f32 SD1.x UNet), 3xTF32; "
                         "ms at fused_outer (7,8,4096,40), self_* at self (7,8,4096,40); "
                         f"{attn_note}"}),
        "conv3x3_same_f32": ("aid_tpu_torch/csrc/conv3x3_f32.cu", "aid_tpu/ops/conv.py:30", ("conv3x3_same_f32",),
                             {"also_replaces": "aid_tpu/ops/conv.py:47", "design": conv_f32_design,
                              "contract": "f32, (7,960,128,128) -> 320, 3xTF32; "
                                          + conv_note.replace("aid_conv3x3_blocked_bf16", "aid_conv3x3_blocked_f32")}),
        "conv3x3_gnsilu_f32": ("aid_tpu_torch/csrc/conv3x3_f32.cu", "aid_tpu/ops/conv.py:78", ("conv3x3_gnsilu_f32",),
                               {"design": f"{conv_f32_design}; the prologue in the layout pass",
                                "contract": "f32, (7,960,128,128) -> 320 with the GN+SiLU prologue, 3xTF32; ms: "
                                            "through the wrapper, as the model calls it (w tiled once; x laid out "
                                            "with the prologue applied by aid_conv3x3_gnsilu_f32 of the same "
                                            "source, which every launch runs first); kernel_ms: the conv launch "
                                            "alone on operands laid out by aid_tpu_torch/ops/conv.py::"
                                            "kernel_operands; layout_ms: the layout kernel with the prologue "
                                            "alone, layout_plain_ms: torch's prologue and permuting copy; "
                                            "sd21_*: the classes of SD 2.1's f32 UNet with the fused "
                                            "configuration, per forward"}),
    }
    record = []
    for name, (src, replaces, counters, extra) in rows.items():
        r = kernels[name]
        record.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": sum(launches[c] for c in counters), "max_abs_err": r["max_abs_err"],
                       "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "library_ms": r["library_ms"], **extra,
                       **{k: v for k, v in r.items() if k not in KERNEL_KEYS}})
    return json.dumps({"kernels": record})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="SDXL denoise steps of the main path and of the image-out path (half fused_outer warmup)")
    args = ap.parse_args(argv)
    try:
        import aid_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package aid_tpu_torch is not beside this script in {ROOT}: {e}")

    card = phase_device()
    import torch

    phase_build()
    sd21_classes = sd21_fused_conv_classes()
    unet, sample, ehs, uncond, added, coef = build_headline()
    fused_classes = fused_conv_classes(unet, sample, ehs, added)
    kernels = phase_kernels(coef, sd15_coef(), fused_classes, sd21_classes)
    phase_unet(unet, sample, ehs, added, coef)
    paths = [phase_main(unet, sample, ehs, uncond, added, coef, args.steps, card)]
    paths += phase_engine(unet, sample, ehs, uncond, added, coef, card)
    paths.append(phase_fused(unet, sample, ehs, uncond, added, coef, sum(fused_classes.values()), card))
    del sample, ehs, uncond, added, coef
    paths += phase_image(unet, args.steps, card)
    del unet
    torch.cuda.empty_cache()
    sd_unet = build_sd15()
    phase_sd15_unet(sd_unet, sd15_coef().cuda())
    paths += phase_sd15_image(sd_unet, card, SD15_STEPS)
    # the f32 UNets: free the bf16 one first (the f32 SDXL weights alone are 10.3 GB)
    del sd_unet
    torch.cuda.empty_cache()
    paths.append(phase_f32_sdxl(card))
    torch.cuda.empty_cache()
    paths.append(phase_f32_sd15(card, SD15_STEPS))
    torch.cuda.empty_cache()
    paths += phase_sd21(card)
    phase_tiny_padded(card)
    launches = {name: sum(p[name] for p in paths) for name in paths[0]}
    print(f"launches over the {len(paths)} paths: {launches}", flush=True)

    print(kernels_line(kernels, launches), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
