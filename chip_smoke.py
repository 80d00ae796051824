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
    16 and 32, which no kernel instance takes, padded to the D=40 instance;
  * SD 1.5 through the port's entry point with a safety checker: a
    full-width diffusers directory (SD 1.5's UNet, CLIP ViT-L text encoder,
    SD VAE, a DDIM config and a ``safety_checker/`` with the published
    ViT-L/14 configuration; f16 weights ~ N(0, 0.02) from a seed) loaded
    with ``load_interpolation_pipeline(dir)``; ``interpolate`` to seven
    512px frames over 25 DDIM steps with the checker on the decode;
  * PAID coefficient selection on that pipeline: the Beta-prior
    ``BetaPriorPipeline.generate_interpolation`` (exploration 16, selection
    7, batch_k 4 and 1) with a random CLIP ViT-B/32 scorer, and the Bayesian
    (alpha, beta) search (``bayesian_prior_selection``, size 3) with a
    random full-width VGG16 LPIPS;
  * IP-Adapter on the full-width SD1.5 UNet (bf16, 16 image tokens): an
    IP-Adapter-Plus at h94's ip-adapter-plus_sd15 widths and a standard
    4-token adapter (on a UNet with 4 tokens), N(0, 0.02) weights written
    as .safetensors files in the published layout and loaded with
    ``load_aid_ip_adapter(path)``, a random ViT-H/14 image encoder;
    ``interpolate_single(0.5)`` from two images through ``encode_image``,
    then in scale control;
  * what users load into a pipeline, at SD 2.1's full width: phase 13's
    seeded draw as one original LDM-layout ``.safetensors`` (OpenCLIP
    ViT-H tower of 24 resblocks) loaded with ``load_single_file_pipeline``
    and run through ``interpolate_single`` at 768px, 25 UniPC steps, against
    the diffusers directory of the same draw; the SDXL single-file layout at
    full width in memory; a LoRA merged into the UNet (``merge_lora``); a
    textual-inversion file; pre-computed prompt embeddings; latents
    exported as .npy / .pt and read back (``utils/parity.py``);
  * frame parallelism (``parallel.sharded_denoise_sequence``): the SDXL
    denoise above in an NCCL world of one; the full-width SD1.5 UNet's
    8-frame, 25-step DDIM sequence in a gloo world of two ranks on the one
    card, frame-sharded (dp=2) and tensor-parallel (tp=2, ``shard_params``);
  * the Gradio app's Generate function (``apps.gradio_app.build_app`` with
    a stub gradio module) on the SD 1.5 safety-checker pipeline: the
    gallery's 7-frame SD 1.5 example at 25 steps;
  * f16, as the upstream CUDA reference runs SD (``torch_dtype=
    torch.float16``): a full-width SD 1.5 directory (f16 N(0, 0.02)
    weights) loaded with ``load_interpolation_pipeline(dir, dtype=
    torch.float16)`` (UNet f16; text encoder and VAE f32, as the loader
    places them), ``interpolate`` (PAID, 7 frames, 512px, 25 DDIM steps) and
    ``interpolate_single(0.5)``; that directory's VAE loaded with
    ``load_vae(dir, dtype=torch.float16)`` decoding one frame (the f16
    D=512 attention); the SDXL UNet of the headline in f16 (a denoise and
    the fused GN+SiLU configuration). Every UNet and VAE kernel there is an
    f16 instance;
  * SD 1.x at D = 320: a full-width SD 1.5 directory whose list
    ``attention_head_dim`` [1, 2, 4, 4] both loaders read as head counts
    (320 channels a head at every level), loaded with
    ``load_interpolation_pipeline(dir)``; its UNet's forward in bf16, f32
    and f16 and ``interpolate`` (PAID, 7 frames, 512px, 10 DDIM steps), every
    attention on a D=512 kernel: the endpoint modes' new entries and the
    self ones;
  * SD 1.x with one head a level: the same directory with
    ``attention_head_dim`` [1, 1, 1, 1] (head dims 320 / 640 / 1280 /
    1280), loaded with ``load_interpolation_pipeline(dir)``; its UNet's
    forward in bf16, f32 and f16 and ``interpolate`` (PAID, 7 frames, 512px,
    10 DDIM steps), every attention at D = 640 / 1280 on a wide entry
    (``csrc/flash_attention_dwide.cu``), every one at D = 320 on a D=512
    kernel.

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
                 as the yardstick library_ms; the static-shift instances
                 (static_smax = 40: the D <= 160, mid-length, D=161-512,
                 D=512 self and wide ones) beside the exact route, at the
                 window's edges and against two planted faults (the clip
                 dropped, the shift left in a per-tile rescale), the wide
                 ones against a third (each split of the key stream
                 normalised by its own sum before the splits are added)
  4. whole UNet  one full-width SDXL forward in fused_outer through the
                 kernels and through the plain versions (test-only seam);
                 its logit window (as after every forward check below) must
                 lie in [-32, +70], where the model path's static shift is
                 the exact softmax
  5. denoise     the SDXL main path; launch counts, finite checksum, s/step,
                 peak memory
  6. engine      2 SDXL steps in batched CFG against sequential, and in the
                 fused loop against split, each with a planted fault
  7. fused GN    the fused-prologue configuration: a whole-UNet check with a
                 planted halo fault, then a 2-step denoise both ways
  8. image out   SDXL interpolate() at 1024px with the f32 VAE, then with
                 the bf16 VAE, each also with VAE tiling at 32-latent tiles
                 (1024-token attention the JAX wrapper keeps exact: the
                 exact D=512 kernels); stage times, launch counts, the raw decoder
                 output through the kernels vs the plain versions (f32 and
                 bf16, the bf16 one with a planted fault; the VAE's attention
                 on the D=512 static-shift instances under "auto", its logit
                 window read on one decode), one frame's tiled
                 decode (512px tiles) kernels vs plain; one more run with
                 the invisible watermark, its 48 bits read back from a frame
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
 15. SD1.5 safety the loader on a written SD1.5 directory with a
                 safety_checker/ (every module on the card; UNet bf16, the
                 rest f32); interpolate() at 512px, 25 DDIM steps, the
                 checker on the decode (its seconds per frame); thresholds
                 rigged to flag every frame, then none, through the decode
 16. selection   on phase 15's pipeline: the Beta-prior selection with
                 batch_k 4 and 1 (selection count, sorted coefficients in
                 [0, 1], finite decoder inputs; stage times: explore, CLIP
                 scoring, DP, in all; launches by head dim), _gen_batch's
                 middles against interpolate_single with a planted t fault,
                 the Bayesian search with LPIPS (its seconds per pair)
 17. IP-Adapter  the Plus adapter: one forward kernels vs plain with the IP
                 branch in fused_outer, pure_inner and scale control (two
                 planted faults each; the bf16 attention's launches by head
                 dim count the IP calls), interpolate_single(0.5) from two
                 images through encode_image (s/step), the same in scale
                 control; the standard 4-token adapter's forward check
 18. single file load_single_file_pipeline on an SD2.1 LDM file written from
                 phase 13's draw (load seconds with PhaseTimer): UNet, VAE and
                 23-layer text tower bit-equal to the directory load,
                 interpolate_single(0.5) latents bit-equal to the directory
                 pipeline's (s/step, peak memory, launches), the bare file's
                 warning and epsilon; the SDXL layout's round trip through
                 convert_ldm_checkpoint_xl at full width; merge_lora (every
                 merged weight bit-equal to W + cast(1.5 B A), the rest
                 shared) and the merged UNet's forward kernels vs plain with
                 two planted faults; a textual inversion, prompt_embeds_* and
                 exported latents, each run bit-equal
 19. frames      (a) right after phase 7: sharded_denoise_sequence on phase
                 5's program in an NCCL world of one, bit-equal to phase 5's
                 latents through the same launches, its all-gathers counted;
                 (c) right after phase 16: the app's generate on phase 15's
                 pipeline, seven 512px uint8 frames; (b) last: two gloo
                 ranks spawned on the one card, the SD1.5 sequence at dp=2
                 and at tp=2 against the unsharded run (largest per-frame
                 relative L2 under FRAMES_TOL, the planted faults local
                 endpoints and local skip rows over it), attention launches
                 by head dim on each rank
 20. f16         after phase 18: the f16 SD1.5 UNet's forward kernels vs
                 plain (two planted faults), interpolate() and
                 interpolate_single() through the loader's f16 pipeline
                 (s/step, launches by head dim), an f16 VAE's raw decoder
                 output kernels vs plain with a planted fault, the f16 SDXL
                 UNet's forward kernels vs plain, a denoise (s/step) and the
                 fused GN+SiLU forward with its halo fault; each path fails
                 if it launched a bf16 or f32 kernel (but the f32 VAE's
                 attention in the SD1.5 decodes). Phase 3 holds every f16
                 instance against its plain f16 version at the bf16 rows'
                 SDXL and SD1.5 shapes
 21. D=320       after phase 20: the SD1.x UNet with 320-wide heads through
                 the loader, a fused_outer forward kernels vs plain in bf16
                 (two planted faults: c and 1 - c swapped, the own segment
                 dropped), f32 and f16 (one each), a self-mode forward in
                 each dtype (planted fault: the last key tile unmasked),
                 interpolate() (PAID, 10 DDIM steps, s/step); every
                 attention launch at D = 320 on a D=161-512 entry, self mode
                 on its instance with no endpoint set (the f32 VAE's D=512
                 self launch aside). Phase 3 holds the D=161-512 entries
                 against their plain versions at its shapes, every mode, at
                 D = 384 and at D = 200, self mode at 448 and 504 too (f32
                 to 448), in bf16, f16 and f32, self mode timed beside the
                 D=512 self route padded to 512 and SDPA
 22. one head    after phase 21: the SD1.x UNet with one head a level through
                 the loader, a fused_outer forward kernels vs plain in bf16
                 (two planted faults: c and 1 - c swapped, the own segment
                 dropped), f32 (one output slice, and every slice, over its
                 own chunk of the scores) and f16 (the own segment
                 dropped), interpolate() (PAID, 10 DDIM steps, s/step);
                 every attention launch at D = 640 / 1280 on a wide entry,
                 every one at D = 320 on a D=161-512 entry, a forward's
                 counts those of the UNet's attention modules; under "auto"
                 the bf16 and f32 paths' endpoint-mode calls at D = 640 on
                 the wide static instance (the 1280-wide levels' own KV is
                 under FLASH_MIN_KV: exact), f16 on none, the bf16 forward's
                 logit window in [-32, +70]. Phase 3 holds the
                 wide entries against their plain versions in bf16, f16 and
                 f32, every mode, at its shapes, at (2,1,512,2048) and at a
                 ragged D = 520
The smoke prints its own wall time before the kernels line.
Phase 1 turns TF32 off for cuBLAS and cuDNN, so every plain f32 version and
library call computes in full f32, and cuBLAS's reduced-precision f16
reductions off, so every f16 GEMM (the plain versions' and the f16 paths')
reduces in f32.
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
# The f16 attention (phase 3; D <= 160 and D=512) against its plain f16
# version: the bf16 design's roundings of P and of the output at f16's 2^-11
# instead of bf16's 2^-8, eight times finer. A quarter of ATTN_TOL keeps twice
# that as margin; a wrong mask, scale, segment or element type is tens of
# percent.
F16_ATTN_TOL = ATTN_TOL / 4
# The f16 conv and GN+SiLU conv (phase 3) against cuDNN in f16 on the same
# operands (f32 accumulation on both sides): one output rounding at 2^-11 and
# summation order; a quarter of CONV_TOL for the same reason.
F16_CONV_TOL = CONV_TOL / 4

# The card's published dense peaks (NVIDIA H100 SXM data sheet, at its 700 W
# limit): tensor cores in bf16, f16 (the same rate) and TF32, f32 outside the
# tensor cores, HBM.
# bound_ms of a kernel is the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written once)
# over the memory rate. bf16 and TF32 products share the tensor cores, so
# their times add; f32 runs beside them on the CUDA cores, so where a call
# also does f32 work the slower of the two units sets it.
PEAK_OPS_PER_S = {"bf16": 989e12, "f16": 989e12, "tf32": 495e12, "f32": 67e12}
TENSOR_CORE_TYPES = ("bf16", "f16", "tf32")
HBM_BYTES_PER_S = 3.35e12

# The products of csrc/flash_attention_f32_d512.cu per flop of f32
# attention, by type: Q K^T runs two TF32 passes (hi hi, lo(Q) hi(K)) and a
# bf16 one (bf16(Q) bf16(lo(K))); P V runs one TF32 pass (hi hi) and one
# packed bf16 pass holding two products (lo(V) P and V lo(P)). The two
# products have equal flops, so 1.5 TF32 and 1.5 bf16 passes each.
F32_D512_PASSES = {"tf32_passes": 1.5, "bf16_passes": 1.5}


def bound(ops: dict, nbytes: float) -> tuple:
    """(least ms on the card, "operations" or "bytes") for ``ops`` {type:
    count} and ``nbytes`` of device-memory traffic."""
    t_tensor = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items() if kind in TENSOR_CORE_TYPES)
    t_ops = max([t_tensor] + [n / PEAK_OPS_PER_S[kind] for kind, n in ops.items() if kind not in TENSOR_CORE_TYPES])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def conv_bound(B, H, W, cin, cout, prologue=False, tf32_passes=None, kind="bf16") -> tuple:
    """The 3x3 conv's bound: 2 * 9 * Cin flops per output element on the
    tensor cores in ``kind`` (bf16 or f16, 2-byte operands), or with
    ``tf32_passes`` = 3 on f32 operands at three TF32 passes (3xTF32); x, w,
    bias (f32), out read or written once; the
    GN+SiLU prologue adds its (B, Cin) f32 scale and shift and ~6 f32
    operations per input element (fma, halving, tanh, fma)."""
    flops = 2.0 * B * H * W * cout * 9 * cin
    ops = {kind: flops} if tf32_passes is None else {"tf32": tf32_passes * flops}
    elem = 2.0 if tf32_passes is None else 4.0
    nbytes = elem * (B * H * W * cin + 9 * cin * cout + B * H * W * cout) + 4.0 * cout
    if prologue:
        ops["f32"] = 6.0 * B * H * W * cin
        nbytes += 2 * 4.0 * B * cin
    return bound(ops, nbytes)


def attention_bound(mode, B, H, Sq, L, D, Le=None, elem=2, skip_rows=0, tf32_passes=None, per_row=False,
                    bf16_passes=None, kind="bf16") -> tuple:
    """The attention's bound from the key segments the kernel's segment
    loop visits (flash_interpolated_attention.cu: the own segment in self
    and fused modes, begin and end in outer modes, one lerped segment in
    inner modes; skip rows of fused modes visit their own segment only):
    4 * D flops per (query, key) pair (Q K^T and P V; the exps are not
    counted). Bytes: q and out, the own K/V where the mode reads it, and
    the K and V of both endpoints where they are passed apart (``Le``; one
    set per batch row with ``per_row``) or, in pure modes, are rows 0 and
    B-1 of K/V. ``tf32_passes`` = 3 reckons f32 operands at three TF32
    tensor-core passes (3xTF32); with ``bf16_passes`` too, a split of
    TF32 and bf16 passes (``F32_D512_PASSES``); None means 2-byte operands
    on the tensor cores in ``kind`` (bf16 or f16)."""
    has_own = mode in ("self", "fused_outer", "fused_inner")
    n_seg = {"self": 0, "fused_outer": 2, "pure_outer": 2, "fused_inner": 1, "pure_inner": 1}[mode]
    seg_len = Le if Le is not None else L
    keys = (B - skip_rows) * ((L if has_own else 0) + n_seg * seg_len) + skip_rows * L
    flops = 4.0 * H * Sq * D * keys
    nbytes = elem * (2.0 * B * H * Sq * D + (2.0 * B * H * L * D if has_own else 0.0))
    if n_seg and (Le is not None or not has_own):
        nbytes += elem * 4.0 * (B if per_row else 1) * H * seg_len * D  # K and V of both endpoints
    if tf32_passes is None:
        ops = {kind: flops}
    else:
        ops = {"tf32": tf32_passes * flops, "bf16": (bf16_passes or 0) * flops}
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
    from aid_tpu_torch.ops import conv
    from aid_tpu_torch.ops import flash_attention as fa

    return {"flash_interpolated_attention": fa.flash_interpolated_attention,
            "flash_interpolated_attention_f32": fa.flash_interpolated_attention_f32,
            "flash_self_attention_f32": fa.flash_self_attention_f32,
            "flash_self_attention_bf16": fa.flash_self_attention_bf16,
            "conv3x3_same": conv.conv3x3_same, "conv3x3_same_f32": conv.conv3x3_same_f32,
            "conv3x3_gnsilu": conv.conv3x3_gnsilu, "conv3x3_gnsilu_f32": conv.conv3x3_gnsilu_f32,
            "flash_interpolated_attention_f16": fa.flash_interpolated_attention_f16,
            "flash_self_attention_f16": fa.flash_self_attention_f16,
            "conv3x3_same_f16": conv.conv3x3_same_f16, "conv3x3_gnsilu_f16": conv.conv3x3_gnsilu_f16}


def reset_counts() -> None:
    from aid_tpu_torch.ops.flash_attention import reset_launch_counts

    for fn in kernel_wrappers().values():
        fn.launches = 0
    reset_launch_counts()


def read_counts() -> dict:
    """Every wrapper's launches, and the D <= 160 attention kernels' by head
    dim under ``flash_interpolated_attention[D=...]`` (bf16),
    ``flash_interpolated_attention_f32[D=...]`` and
    ``flash_interpolated_attention_f16[D=...]``; of those, the short-stream
    kernel's (bf16 and f16) under ``...[onepass]`` in all and
    ``...[onepass D=...]`` by head dim, the mid-length stream kernel's
    under ``...[midstream]`` and ``...[midstream D=...]``, and the
    static-shift instances' (bf16 and f32) under ``...[static]`` /
    ``...[static D=...]`` (the streaming kernels'), ``...[static
    midstream]`` / ``...[static midstream D=...]``, ``...[static dmid]``
    / ``...[static dmid D=...]`` (the D=161-512 kernels', by the operands'
    head dim, the dims launched) and ``...[static dwide]`` / ``...[static
    dwide D=...]`` (the wide kernels', by the instance's padded head dim:
    640, 1024, 1280, 2048); the D=512 self wrappers' static launches under
    ``flash_self_attention_*[static]``."""
    wrappers = kernel_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in ("flash_interpolated_attention", "flash_interpolated_attention_f32",
                 "flash_interpolated_attention_f16"):
        for d, n in wrappers[name].launches_by_head_dim.items():
            counts[f"{name}[D={d}]"] = n
    for name in ("flash_interpolated_attention", "flash_interpolated_attention_f16"):
        for kind in ("onepass", "midstream"):
            by_dim = getattr(wrappers[name], f"launches_{kind}")
            counts[f"{name}[{kind}]"] = sum(by_dim.values())
            for d, n in by_dim.items():
                counts[f"{name}[{kind} D={d}]"] = n
    for name in ("flash_interpolated_attention", "flash_interpolated_attention_f32"):
        for kind, attr in (("static", "launches_static"), ("static midstream", "launches_static_midstream"),
                           ("static dmid", "launches_static_dmid"), ("static dwide", "launches_static_dwide")):
            by_dim = getattr(wrappers[name], attr)
            counts[f"{name}[{kind}]"] = sum(by_dim.values())
            for d, n in sorted(by_dim.items()):
                counts[f"{name}[{kind} D={d}]"] = n
    for name in ("flash_self_attention_f32", "flash_self_attention_bf16", "flash_self_attention_f16"):
        counts[f"{name}[static]"] = wrappers[name].launches_static
    return counts


def static_needed(dtype: str, classes) -> tuple:
    """The static-shift counters a path of ``dtype`` must show for its call
    classes [(kernel, head dim, mode)] under "auto" (kernel as
    ``static_route`` names it: "streaming", "midstream", "dmid", "d512" or
    "dwide", this one at its instance's padded head dim): each class's,
    unless the card measured it slower (``STATIC_SHIFT_SLOWER``: "auto"
    keeps it exact)."""
    from aid_tpu_torch.ops.flash_attention import STATIC_SHIFT_SLOWER

    name = {"bf16": "flash_interpolated_attention", "f32": "flash_interpolated_attention_f32"}[dtype]
    kinds = {"streaming": f"{name}[static]", "midstream": f"{name}[static midstream]",
             "dmid": f"{name}[static dmid]", "d512": f"flash_self_attention_{dtype}[static]",
             "dwide": f"{name}[static dwide]"}
    return tuple(sorted({kinds[kernel] for kernel, d, mode in classes
                         if (kernel, dtype, d, mode) not in STATIC_SHIFT_SLOWER}))


@contextlib.contextmanager
def logit_window(label: str):
    """Within: every dispatch_attention call reports its per-set row-max
    window (``LOGIT_WINDOW_RECORDER``); after: the whole run's window is
    printed and must lie inside STATIC_WINDOW, where the static shift is the
    exact softmax."""
    import importlib

    import torch

    attn = importlib.import_module("aid_tpu_torch.ops.attention")
    seen = []
    attn.LOGIT_WINDOW_RECORDER = lambda lo, hi: seen.append(torch.stack([lo.float(), hi.float()]))
    try:
        yield
    finally:
        attn.LOGIT_WINDOW_RECORDER = None
    if not seen:
        fail(f"{label}: no attention call reported a logit window")
    both = torch.stack(seen)
    lo, hi = both[:, 0].min().item(), both[:, 1].max().item()
    ok = STATIC_WINDOW[0] <= lo and hi <= STATIC_WINDOW[1]
    print(f"logit window of {label}: per-set row maxes in [{lo:.4f}, {hi:.4f}] over {len(seen)} attention calls "
          f"(the static shift is exact in [{STATIC_WINDOW[0]:g}, {STATIC_WINDOW[1]:g}])  {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{label}: attention logits outside the static shift's window")


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
    # the plain versions' f16 GEMMs reduce in f32, so the f16 yardstick is no
    # noisier than the kernels it holds (the f16 paths' own GEMMs too)
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
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


# The static-shift softmax's window (aid_tpu/ops/flash_attention.py:44-65):
# with C = 40 and the 30-nat clip, exp(min(s - C, 30)) is the exact softmax
# while every accumulator set's row max lies in [C - 72, C + 30]; below, the
# probabilities reach the e^-87 floor of bf16 (ex2.approx.ftz's too), above,
# the clip flattens the largest. Phase 4 and every forward check
# (check_unet_vs_plain) read their UNet's window (LOGIT_WINDOW_RECORDER) and
# fail outside it.
STATIC_WINDOW = (40.0 - 72.0, 40.0 + 30.0)


def window_inputs(dtype, hot: bool, B: int, H: int, S: int, D: int, gen) -> tuple:
    """(q, k, v, scale) for a static-shift instance at the window's edges
    (tests/test_flash_attention.py:250-281): cold, a dedicated column biases
    every logit to -25 at scale 1 (row maxes near -23, the exact softmax
    still); hot, scale 32 / sqrt(D) puts the logits at N(0, 32^2) (row maxes
    near +120 over thousands of keys: the clip flattens the largest, and the
    exact softmax is far off)."""
    import torch

    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=gen.device) for _ in range(3))
    if hot:
        return q.to(dtype), k.to(dtype), v.to(dtype), 32.0 / D ** 0.5
    qc = torch.cat([q[..., :-1] * 0.1, torch.ones_like(q[..., :1])], -1)
    kc = torch.cat([k[..., :-1], torch.full_like(k[..., :1], -25.0)], -1)
    return qc.to(dtype), kc.to(dtype), v.to(dtype), 1.0


def shift_in_rescale_fault(q, k, v, coef, mode: str, C: float, bk: int, clip: float = 30.0):
    """A planted fault of the static-shift instances: the plain static shift
    (self mode over the own keys, pure_inner over the endpoints lerped in f32
    and rounded as the wrapper lerps them) with the shift left in a per-tile
    rescale: O and l times e^-C before each ``bk``-key tile, as if the
    running max had moved by C every tile. Returns (B, H, Sq, D) f32."""
    import torch

    if mode == "pure_inner":
        c4 = coef.view(-1, 1, 1, 1)
        k = ((1 - c4) * k[0].float() + c4 * k[-1].float()).to(q.dtype)
        v = ((1 - c4) * v[0].float() + c4 * v[-1].float()).to(q.dtype)
    elif mode != "self":
        raise ValueError(f"the planted rescale fault takes self and pure_inner calls, not {mode}")
    B, H, Sq, D = q.shape
    scale, decay = D ** -0.5, math.exp(-C)
    qf = q.reshape(B * H, Sq, D).float()
    kf, vf = (x.expand(B, H, *x.shape[-2:]).reshape(B * H, -1, D) for x in (k, v))
    o = torch.zeros_like(qf)
    lsum = torch.zeros(B * H, Sq, 1, device=q.device)
    for t0 in range(0, kf.shape[1], bk):
        s = torch.matmul(qf, kf[:, t0:t0 + bk].float().transpose(-1, -2)) * scale
        p = torch.exp(torch.clamp_max(s - C, clip))
        o = o * decay + torch.matmul(p.to(q.dtype).float(), vf[:, t0:t0 + bk].float())
        lsum = lsum * decay + p.sum(-1, keepdim=True)
    return (o / lsum.clamp_min(1e-37)).reshape(B, H, Sq, D)


def split_normalised_fault(q, k, v, coef, mode: str, kw: dict, C: float, bk: int, splits: int,
                           clip: float = 30.0):
    """A planted fault of the wide kernels' static instance on a split call:
    the plain static shift over each split's part of the key stream (the
    own segment's ``bk``-key tiles, then each endpoint segment's, as the
    kernel splits them: split s takes tiles [s n / S, (s + 1) n / S), a
    skip row's cut at its own segment), each split's state normalised by
    its own sum before the splits are added, instead of O = sum O_s / sum
    l_s. Endpoints from ``kw`` (shared or per row) or the rows 0 and B - 1,
    the inner modes' lerped in f32 and rounded as the wrapper lerps them.
    Returns (B, H, Sq, D) f32."""
    import torch

    B, H, Sq, D = q.shape
    has_own = mode in ("self", "fused_outer", "fused_inner")
    outer, inner = mode in ("fused_outer", "pure_outer"), mode in ("fused_inner", "pure_inner")
    n_sets = 2 if outer else 1 if inner else 0

    def rows(x):  # (B, H, L, D): an endpoint shared over the rows is expanded
        return x.expand(B, *x.shape[-3:]) if x.dim() == 3 else x

    eps = []
    if n_sets:
        kb, vb = rows(kw.get("k_begin", k[0])), rows(kw.get("v_begin", v[0]))
        ke, ve = rows(kw.get("k_end", k[-1])), rows(kw.get("v_end", v[-1]))
        if inner:
            c4 = coef.view(-1, 1, 1, 1)
            kb = ((1 - c4) * kb.float() + c4 * ke.float()).to(q.dtype)
            vb = ((1 - c4) * vb.float() + c4 * ve.float()).to(q.dtype)
        eps = [(kb, vb), (ke, ve)][:n_sets]
    segs = ([(k, v)] if has_own else []) + eps
    n_tiles = [-(-x.shape[2] // bk) for x, _ in segs]
    n_own = n_tiles[0] if has_own else 0
    n_total = sum(n_tiles)
    skip = kw.get("skip_endpoints")
    scale = D ** -0.5
    out = torch.zeros(B, H, Sq, D, device=q.device)
    for b in range(B):
        skipped = bool(has_own and n_sets and skip is not None and skip[b])
        n_row = n_own if skipped else n_total
        kk = torch.cat([x[b] for x, _ in segs], 1).float()
        vv = torch.cat([y[b] for _, y in segs], 1).float()
        tile = torch.cat([t0 + torch.arange(x.shape[2], device=q.device) // bk
                          for (x, _), t0 in zip(segs, [sum(n_tiles[:i]) for i in range(len(segs))])])
        seg = torch.cat([torch.full((x.shape[2],), i, device=q.device) for i, (x, _) in enumerate(segs)])
        s = torch.matmul(q[b].float(), kk.transpose(-1, -2)) * scale
        p = torch.exp(torch.clamp_max(s - C, clip))
        first = 1 if has_own else 0  # the first endpoint segment's index
        if outer and not skipped:  # set 0: own + begin, set 1: own + end
            sets = [((seg < first) | (seg == first), 1 - coef[b]), ((seg < first) | (seg == first + 1), coef[b])]
        else:
            sets = [(seg >= 0, 1.0)]
        for member, wt in sets:
            acc = torch.zeros(H, Sq, D, device=q.device)
            for sp in range(splits):
                t0, t1 = sp * n_total // splits, min((sp + 1) * n_total // splits, n_row)
                m = member & (tile >= t0) & (tile < t1)
                ps = p * m
                o = torch.matmul(ps.to(q.dtype).float(), vv)
                acc += o / ps.sum(-1, keepdim=True).clamp_min(1e-37)
            out[b] += wt * acc
    return out


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
        D512,
        D512_BF16_TILES,
        F32_D512_TILES,
        KERNEL_F32_TILES,
        KERNEL_HEAD_DIMS,
        KERNEL_TILES,
        MIDSTREAM_TILES,
        STATIC_D512_ENTRIES,
        STATIC_DMID_ENTRIES,
        STATIC_DWIDE_ENTRIES,
        STATIC_SHIFT_C,
        d512_launch,
        dmid_columns,
        dmid_tiles,
        dwide_tiles,
        flash_interpolated_attention,
        flash_interpolated_attention_plain,
        flash_self_attention_bf16,
        flash_self_attention_f16,
        flash_self_attention_f32,
        kernel_launch,
        padded_head_dim,
        takes_d512_self,
        takes_midstream,
        takes_onepass,
    )

    print("== phase 3: kernels vs plain versions, bounds and library calls", flush=True)
    dev = torch.device("cuda")
    # the f16 rows draw from their own generator, so the bf16 and f32 rows
    # keep the inputs they had before the f16 rows came
    gen = main_gen = torch.Generator(device=dev).manual_seed(11)
    f16_gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def yardsticks(bound_ms, bound_by, library):
        """One line of the bound and the library calls' times."""
        lib = ", ".join(f"{n} {t[0] if isinstance(t, tuple) else t:.3f} ms" for n, t in library.items()) or "—"
        return f"bound {bound_ms:.3f} ms ({bound_by}); library: {lib}"

    records = {}

    def inner_sdpa(q, k, v, c, mode, kw, dtype, want, reps):
        """SDPA over [own; K_cross] (pure_inner: K_cross alone), K_cross
        lerped in f32 as the wrapper makes it: the inner modes' library call."""
        c4 = c.view(c.shape[0], 1, 1, 1)
        kb, vb = kw.get("k_begin", k[0]), kw.get("v_begin", v[0])
        ke, ve = kw.get("k_end", k[-1]), kw.get("v_end", v[-1])
        kc = ((1 - c4) * kb.float() + c4 * ke.float()).to(dtype)
        vc = ((1 - c4) * vb.float() + c4 * ve.float()).to(dtype)
        if mode == "fused_inner":
            kc, vc = torch.cat([k, kc], 2), torch.cat([v, vc], 2)
        return sdpa_backends(q, kc, vc, want, reps)

    def attention(label, mode, c, H, Sq, L, D, reps, Le=None, dtype=torch.bfloat16, parent=None, static=False):
        """One bf16 (or f16, or f32) attention case, B = len(c): (B, S, H*D)
        projections viewed as (B, H, S, D), as the model passes them; skip
        rows as the model marks them; optional shared (H, Le, D) endpoints.
        Timed through the wrapper (ms: the call the model makes, its host
        work included) and launched alone on operands kernel_launch prepared
        once (kernel_ms). In self mode SDPA computes the same function and is
        timed under each backend that takes the input. f32 is held to
        F32_ATTN_TOL and bounded at three TF32 passes, f16 to F16_ATTN_TOL
        and bounded at the f16 tensor-core rate. A head dim from 161 to 512
        takes the D=161-512 entry (in self mode up to the dtype's
        DMID_SELF_MAX, its self instance; f32 bounded at its passes,
        F32_D512_PASSES), timed in self mode beside the route before it, the
        D=512 self kernels on copies padded to 512 (d512_ms: the copies and
        the launch, as the wrapper made them; d512_kernel_ms: the launch
        alone on operands d512_launch prepared once), one past 512 the wide
        entry in every
        mode (f32 bounded at three TF32 passes). With ``parent`` ("onepass" or
        "midstream"), a call the route sends to the short-stream or the
        mid-length stream kernel (the route fails the phase if it does not) is
        timed beside the route before it, the D <= 160 streaming kernel
        (parent_ms: its host work and
        launch as the wrapper made them; parent_kernel_ms: the launch alone),
        and in the inner modes beside SDPA over [own; K_cross]. The wide
        entries are both bounded at the caller's
        D with the bound at the columns the kernel computes (D rounded up to
        the D=161-512 kernels' chunk, or the first of 640, 1024, 1280, 2048)
        beside it (bound_padded_ms), and in
        the inner modes timed beside SDPA over [own; K_cross] (pure: K_cross
        alone), the lerped endpoint made as the wrapper makes it. With
        ``static``, the call takes the static-shift instance (static_smax =
        STATIC_SHIFT_C; the route fails the phase if it does not) and is held
        to the plain version's static shift, timed beside the exact route
        (exact_ms: the wrapper with static_smax None; exact_kernel_ms: its
        launch alone), in turns. Returns a record."""
        B = c.shape[0]
        shift = STATIC_SHIFT_C if static else None
        f32, f16 = dtype == torch.float32, dtype == torch.float16
        tol = F32_ATTN_TOL if f32 else F16_ATTN_TOL if f16 else ATTN_TOL
        dwide = D > D512
        wide = dwide or (D > KERNEL_HEAD_DIMS[-1] and not takes_d512_self(D, mode, dtype))

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
        got = flash_interpolated_attention(q, k, v, c, mode, static_smax=shift, **kw)
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v, c, mode, static_smax=shift, **kw)
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        rl2 = rel_l2(got, want)
        _, launch = kernel_launch(q, k, v, c, mode, static_smax=shift, **kw)  # operands checked and laid out once
        if parent and not launch.operands[parent]:
            fail(f"attention {label} (D={D}, {dtype}): the route does not send it to the {parent} kernel")
        if static and launch.operands["static"] is None:
            fail(f"attention {label} (D={D}, {dtype}): no static-shift instance took it")
        kernel_ms = cuda_ms(launch, reps)
        ms = cuda_ms(lambda: flash_interpolated_attention(q, k, v, c, mode, static_smax=shift, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, c, mode, static_smax=shift, **kw),
                           max(1, reps // 5))
        skip_rows = int(kw["skip_endpoints"].sum()) if "skip_endpoints" in kw else 0
        per_row = isinstance(Le, tuple)
        passes = (F32_D512_PASSES if wide and not dwide else {"tf32_passes": 3}) if f32 else {}

        def bound_at(d):
            return attention_bound(mode, B, H, Sq, L, d, Le[1] if per_row else Le, skip_rows=skip_rows,
                                   elem=4 if f32 else 2, per_row=per_row, kind="f16" if f16 else "bf16", **passes)

        bound_ms, bound_by = bound_at(D)
        library = sdpa_backends(q, k, v, want, reps) if mode == "self" else {}
        d512 = {}
        if wide and not dwide and mode == "self":  # the route before: the D=512 self kernels, padded to 512
            _, d512_alone = d512_launch(q, k, v)
            d512 = {"d512_ms": cuda_ms(lambda: d512_launch(q, k, v)[1](), reps),
                    "d512_kernel_ms": cuda_ms(d512_alone, reps)}
            del d512_alone
        before = {}
        if parent:  # the route before, the D <= 160 streaming kernel, in turns with the new one (the least kept)
            _, old_alone = kernel_launch(q, k, v, c, mode, **{parent: False}, **kw)

            def old_call():
                kernel_launch(q, k, v, c, mode, **{parent: False}, **kw)[1]()

            before = {"parent_kernel_ms": cuda_ms(old_alone, reps), "parent_ms": cuda_ms(old_call, reps)}
            kernel_ms = min(kernel_ms, cuda_ms(launch, reps))
            ms = min(ms, cuda_ms(lambda: flash_interpolated_attention(q, k, v, c, mode, **kw), reps))
            before = {"parent_kernel_ms": min(before["parent_kernel_ms"], cuda_ms(old_alone, reps)),
                      "parent_ms": min(before["parent_ms"], cuda_ms(old_call, reps))}
            del old_alone
        if static:  # the exact route, in turns with the static instance (the least of two kept)
            _, exact_alone = kernel_launch(q, k, v, c, mode, **kw)

            def exact_call():
                flash_interpolated_attention(q, k, v, c, mode, **kw)

            before = {"exact_kernel_ms": cuda_ms(exact_alone, reps), "exact_ms": cuda_ms(exact_call, reps)}
            kernel_ms = min(kernel_ms, cuda_ms(launch, reps))
            ms = min(ms, cuda_ms(lambda: flash_interpolated_attention(q, k, v, c, mode, static_smax=shift, **kw), reps))
            before = {"exact_kernel_ms": min(before["exact_kernel_ms"], cuda_ms(exact_alone, reps)),
                      "exact_ms": min(before["exact_ms"], cuda_ms(exact_call, reps)),
                      "exact_entry": exact_alone.operands["entry"]}
            del exact_alone
        padded = ""
        if parent and mode in ("fused_inner", "pure_inner"):
            library = inner_sdpa(q, k, v, c, mode, kw, dtype, want, reps)
        if wide:
            Dk = dwide_tiles(D)[0] if dwide else dmid_columns(D, dtype)  # the columns the kernel computes
            padded_ms = bound_at(Dk)[0]
            padded = f"; bound at the padded D={Dk} {padded_ms:.3f} ms"
            if d512:
                padded += (f"; the D=512 self route padded to 512 {d512['d512_ms']:.4f} ms (launch alone "
                           f"{d512['d512_kernel_ms']:.4f})")
            if mode in ("fused_inner", "pure_inner"):
                library = inner_sdpa(q, k, v, c, mode, kw, dtype, want, reps)
        lib_err = (f"; library max_abs_err {', '.join(f'{n} {t[1]:.3e}' for n, t in library.items())}"
                   if f32 and library else "")
        ok = math.isfinite(err) and err <= tol * ref
        if before and parent:
            padded += (f"; the streaming kernel (the route before) {before['parent_ms']:.4f} ms (launch alone "
                       f"{before['parent_kernel_ms']:.4f})")
        if before and static:
            padded += (f"; {launch.operands['entry']} against the exact {before['exact_entry']} "
                       f"{before['exact_ms']:.4f} ms (launch alone {before['exact_kernel_ms']:.4f})")
        print(f"attention {'static ' if static else ''}{'f32 ' if f32 else 'f16 ' if f16 else ''}{label:32s} B={B} "
              f"H={H} D={D}: max_abs_err "
              f"{err:.3e} (max|ref| "
              f"{ref:.3e}, tol {tol * ref:.3e}) rel_l2 {rl2:.3e}  kernel {ms:.4f} ms (launch alone {kernel_ms:.4f}, "
              f"{bound_ms / kernel_ms:.1%} of the bound)  "
              f"plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)}{padded}{lib_err}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"attention {label} (D={D}, {dtype}): kernel disagrees with the plain version")
        if f32 and (D == 160 or wide) and mode != "self":
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
                "bound_by": bound_by, "library_ms": lib_ms, "library": lib_name,
                **({"bound_padded_ms": padded_ms} if wide else {}), **d512, **before,
                **({"want": want, "got": got, "inputs": (q, k, v, c, mode, kw)} if parent or static else {})}

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

    def d512_static(label, c, H, Sq, D, reps, dtype):
        """One self call of the D=512 self kernels' static-shift instance
        (B = len(c), (B, H, Sq, D), a head dim under 512 padded to it as the
        wrapper pads it): through the wrapper at static_smax = STATIC_SHIFT_C
        (ms) and launched alone on operands d512_launch prepared once
        (kernel_ms), in turns with the exact instance (exact_ms,
        exact_kernel_ms), held to the plain version's static shift (f32 to
        F32_ATTN_TOL, bf16 to BF16_D512_TOL), bounded at the caller's D (f32
        at its 1.5 TF32 + 1.5 bf16 passes), beside SDPA under each backend
        that takes the input. Returns a record, as attention's."""
        B, f32 = c.shape[0], dtype == torch.float32
        tol = F32_ATTN_TOL if f32 else BF16_D512_TOL
        wrapper = flash_self_attention_f32 if f32 else flash_self_attention_bf16
        q, k, v = (torch.randn((B, H, Sq, D), generator=gen, device=dev, dtype=torch.float32).to(dtype)
                   for _ in range(3))
        shift = STATIC_SHIFT_C
        got = wrapper(q, k, v, static_smax=shift)
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v, static_smax=shift)
        err, ref = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
        _, launch = d512_launch(q, k, v, static_smax=shift)
        _, exact_alone = d512_launch(q, k, v)
        if launch.operands["entry"] != STATIC_D512_ENTRIES[dtype]:
            fail(f"D=512 static {label} ({dtype}): the call took {launch.operands['entry']}")
        times = {"kernel_ms": [], "ms": [], "exact_kernel_ms": [], "exact_ms": []}
        for _ in range(2):  # in turns, the least of two kept
            times["kernel_ms"].append(cuda_ms(launch, reps))
            times["exact_kernel_ms"].append(cuda_ms(exact_alone, reps))
            times["ms"].append(cuda_ms(lambda: wrapper(q, k, v, static_smax=shift), reps))
            times["exact_ms"].append(cuda_ms(lambda: wrapper(q, k, v), reps))
        times = {n: min(t) for n, t in times.items()}
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v, static_smax=shift), max(1, reps // 5))
        passes = F32_D512_PASSES if f32 else {}
        bound_ms, bound_by = attention_bound("self", B, H, Sq, Sq, D, elem=4 if f32 else 2, **passes)
        library = sdpa_backends(q, k, v, want, reps)
        ok = math.isfinite(err) and err <= tol * ref
        print(f"attention static {'f32' if f32 else 'bf16'} D=512 self {label:26s} ({B},{H},{Sq},{D}): max_abs_err "
              f"{err:.3e} (max|ref| {ref:.3e}, tol {tol * ref:.3e}) rel_l2 {rel_l2(got, want):.3e}  kernel "
              f"{times['ms']:.4f} ms (launch alone {times['kernel_ms']:.4f}, {bound_ms / times['kernel_ms']:.1%} of the "
              f"bound)  plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)}; "
              f"{launch.operands['entry']} against the exact {exact_alone.operands['entry']} {times['exact_ms']:.4f} "
              f"ms (launch alone {times['exact_kernel_ms']:.4f})  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"D=512 static {label} ({dtype}): kernel disagrees with the plain version")
        lib_name, lib_ms = fastest(library)
        return {"max_abs_err": err, **times, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library": lib_name, "exact_entry": exact_alone.operands["entry"],
                "want": want, "got": got, "inputs": (q, k, v, c, "self", {})}

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

    # the f16 instance at the bf16 rows' SDXL and SD1.5 shapes (phase 20's
    # f16 UNets), half the reps
    gen = f16_gen
    records["flash_interpolated_attention_f16"] = attention_record(
        [(label, mode, H, Sq, L, D, max(1, reps // 2), Le) for label, mode, H, Sq, L, D, reps, Le in sdxl_cases],
        coef, "fused_outer 4096", "self 4096", torch.float16)
    records["flash_interpolated_attention_f16(D=40/80/160)"] = attention_record(
        [(f"SD1.5 {label}", mode, 8, Sq, L, D, max(1, reps // 2), Le) for label, mode, Sq, L, D, reps, Le in sd_cases],
        sd_coef, "SD1.5 fused_outer 4096", "SD1.5 self 4096", torch.float16)
    gen = main_gen

    # the short-stream kernel (csrc/flash_attention_onepass.cu) at every call
    # of the paths' shapes the route sends it, in bf16 and f16: the 77-key
    # text cross calls of SDXL (64^2 and 32^2 levels), SD 2.1 (96^2) and SD 1.5
    # (every level), the other modes at SDXL's 64^2 level, the short self
    # calls (SD 2.1's 12^2 level, SD 1.5's mid block) and the IP calls (16
    # and 4 tokens); each beside the route before it (the streaming kernel)
    # and, in self mode and the inner modes, SDPA; the record is the first
    # case's (self (7,10,4096,77), beside SDPA), every case under ``shapes``
    onepass_cases = [
        ("SDXL cross self 4096x77", "self", coef, 10, 4096, 77, 64, 20, None),
        ("SDXL cross fused_outer 4096x77", "fused_outer", coef, 10, 4096, 77, 64, 20, None),
        ("SDXL cross fused_outer 1024x77", "fused_outer", coef, 20, 1024, 77, 64, 20, None),
        ("SDXL cross self 1024x77", "self", coef, 20, 1024, 77, 64, 20, None),
        *[(f"SDXL cross {m} 4096x77", m, coef, 10, 4096, 77, 64, 20, None)
          for m in ("pure_outer", "fused_inner", "pure_inner")],
        *[(f"SD2.1 cross {m} 9216x77", m, sd_coef, 5, 9216, 77, 64, 10, None) for m in ("fused_outer", "self")],
        ("SD2.1 self 144", "self", sd_coef, 20, 144, 144, 64, 20, None),
        *[(f"SD1.5 cross {m} {Sq}x77", m, sd_coef, 8, Sq, 77, D, 20, None)
          for Sq, D in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for m in ("fused_outer", "self")],
        ("SD1.5 self 64 (mid block)", "self", sd_coef, 8, 64, 64, 160, 20, None),
        *[(f"SD1.5 IP {m} 4096x16", m, sd_coef, 8, 4096, 16, 40, 20, None)
          for m in ("fused_outer", "self", "pure_outer", "fused_inner", "pure_inner")],
        *[(f"SD1.5 IP fused_outer {Sq}x16", "fused_outer", sd_coef, 8, Sq, 16, D, 20, None)
          for Sq, D in ((1024, 80), (256, 160))],
        *[(f"SD1.5 IP {m} 4096x4", m, sd_coef, 8, 4096, 4, 40, 20, None) for m in ("fused_outer", "self")],
    ]
    for name, dtype in (("flash_interpolated_attention(onepass)", torch.bfloat16),
                        ("flash_interpolated_attention_f16(onepass)", torch.float16)):
        gen = f16_gen if dtype == torch.float16 else main_gen
        worst, shapes, main, fault_case = 0.0, {}, None, None
        for label, mode, c, H, Sq, L, D, reps, Le in onepass_cases:
            if not takes_onepass(padded_head_dim(D, mode, dtype), Sq, L, L if Le is None else Le, mode, dtype):
                continue  # the route keeps it on the streaming kernel (tools/attention_bench.py --onepass)
            r = attention(label, mode, c, H, Sq, L, D, reps if dtype == torch.bfloat16 else max(1, reps // 2), Le,
                          dtype, parent="onepass")
            got, want, inputs = r.pop("got"), r.pop("want"), r.pop("inputs")
            if fault_case is None and mode in ("fused_outer", "pure_outer"):
                fault_case = (label, got, want, inputs)
            del got, want
            worst = max(worst, r["max_abs_err"])
            shapes[f"{label} ({c.shape[0]},{H},{Sq},{D})"] = {
                **{k: r[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "library_ms", "library", "parent_ms",
                                     "parent_kernel_ms")}, "bound_share": r["bound_ms"] / r["kernel_ms"]}
            main = main or r
        # a planted fault the tolerance must see: the plain version with c and
        # 1 - c exchanged in the outer blend
        label, got, want, (q, k, v, c, mode, kw) = fault_case
        tol = F16_ATTN_TOL if dtype == torch.float16 else ATTN_TOL
        ref = want.float().abs().max().item()
        ferr = (got.float() - coef_swapped(flash_interpolated_attention_plain)(q, k, v, c, mode, **kw).float()
                ).abs().max().item()
        print(f"  planted fault on {label} (c and 1 - c exchanged): max_abs_err {ferr:.3e} against tol "
              f"{tol * ref:.3e}  {'ok' if ferr > tol * ref else 'FAIL'}", flush=True)
        if not ferr > tol * ref:
            fail(f"{name}: the tolerance does not see c and 1 - c exchanged on {label} ({ferr:.3e})")
        del fault_case, got, want, q, k, v
        records[name] = {**main, "max_abs_err": worst, "shapes": shapes}
    gen = main_gen

    # the mid-length stream kernel (csrc/flash_attention_midstream.cu) at every
    # call of the paths' shapes the route sends it, in bf16 and f16: SDXL's
    # 1024-token level, SD 2.1's 24^2 level and SD 1.5's 32^2 level at D = 80
    # in every mode, SD 2.1's 48^2 level in self and pure_inner mode (the
    # calls the route keeps on the streaming kernel, as SD 1.5's outer modes,
    # are skipped); each beside the route before it (the streaming kernel)
    # and, in self mode and the inner modes, SDPA; the record is the first
    # case's (SDXL self (7,20,1024,64), beside SDPA), every case under
    # ``shapes``
    modes = ("self", "fused_outer", "pure_outer", "fused_inner", "pure_inner")
    midstream_cases = [
        ("SDXL self 1024", "self", coef, 20, 1024, 1024, 64, 20, None),
        ("SDXL fused_outer 1024", "fused_outer", coef, 20, 1024, 1024, 64, 20, None),
        *[(f"SDXL {m} 1024", m, coef, 20, 1024, 1024, 64, 10, None)
          for m in ("pure_outer", "fused_inner", "pure_inner")],
        *[(f"SD2.1 {m} 576", m, sd_coef, 20, 576, 576, 64, 20 if m in ("self", "fused_outer") else 10, None)
          for m in modes],
        *[(f"SD2.1 {m} 2304", m, sd_coef, 10, 2304, 2304, 64, 10, None) for m in ("self", "pure_inner")],
        *[(f"SD1.5 {m} 1024", m, sd_coef, 8, 1024, 1024, 80, 20 if m == "self" else 10, None) for m in modes],
    ]
    t_mid = time.perf_counter()
    for name, dtype in (("flash_interpolated_attention(midstream)", torch.bfloat16),
                        ("flash_interpolated_attention_f16(midstream)", torch.float16)):
        gen = f16_gen if dtype == torch.float16 else main_gen
        worst, shapes, main, fault_case = 0.0, {}, None, None
        for label, mode, c, H, Sq, L, D, reps, Le in midstream_cases:
            if not takes_midstream(padded_head_dim(D, mode, dtype), Sq, L, L if Le is None else Le, mode, dtype):
                continue  # the route keeps it on the streaming kernel (tools/attention_bench.py --midstream)
            r = attention(label, mode, c, H, Sq, L, D, reps if dtype == torch.bfloat16 else max(1, reps // 2), Le,
                          dtype, parent="midstream")
            got, want, inputs = r.pop("got"), r.pop("want"), r.pop("inputs")
            if fault_case is None and mode in ("fused_outer", "pure_outer"):
                fault_case = (label, got, want, inputs)
            del got, want
            worst = max(worst, r["max_abs_err"])
            shapes[f"{label} ({c.shape[0]},{H},{Sq},{D})"] = {
                **{k: r[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "library_ms", "library", "parent_ms",
                                     "parent_kernel_ms")}, "bound_share": r["bound_ms"] / r["kernel_ms"]}
            main = main or r
        # a planted fault the tolerance must see: the plain version with c and
        # 1 - c exchanged in the outer blend
        label, got, want, (q, k, v, c, mode, kw) = fault_case
        tol = F16_ATTN_TOL if dtype == torch.float16 else ATTN_TOL
        ref = want.float().abs().max().item()
        ferr = (got.float() - coef_swapped(flash_interpolated_attention_plain)(q, k, v, c, mode, **kw).float()
                ).abs().max().item()
        print(f"  planted fault on {label} (c and 1 - c exchanged): max_abs_err {ferr:.3e} against tol "
              f"{tol * ref:.3e}  {'ok' if ferr > tol * ref else 'FAIL'}", flush=True)
        if not ferr > tol * ref:
            fail(f"{name}: the tolerance does not see c and 1 - c exchanged on {label} ({ferr:.3e})")
        del fault_case, got, want, q, k, v
        records[name] = {**main, "max_abs_err": worst, "shapes": shapes}
    gen = main_gen
    print(f"  the mid-length stream cases (bf16 and f16, each beside the streaming kernel and the plain version): "
          f"{time.perf_counter() - t_mid:.1f} s", flush=True)

    # the static-shift instances (static_smax = C = 40: what "auto" takes on
    # the model path where the JAX model path shifts) at the paths' shapes
    # the route sends each, each beside the exact route and the plain
    # version's static shift: the streaming kernels' (bf16 and f32; SD 1.5's
    # D = 160 calls stay exact on the path, own KV under 512, and are held
    # here all the same), the bf16 mid-length stream kernel's (the endpoint
    # modes at D = 64), the D=161-512 kernels' (bf16 and f32: phase 21's
    # D = 320 in every mode, and the self calls at 448 and 504 the route
    # sends them) and the D=512 self kernels' (f32 and bf16: the VAE's
    # 1024px frame, seven 512px frames, the tiled decode's ragged tile; f32's
    # self calls past 448, padded to 512) and the wide kernels' (bf16 and
    # f32: phase 22's D = 640 in every mode and its 77-key cross call, its
    # 1280-wide levels over 256 and 64 tokens, a ragged D = 520, self at
    # (2,1,512,2048); the key stream split at 64 tokens and in bf16's 2048,
    # f32 at an explicit shift past the 1024 its "auto" takes). Then, at one
    # shape each, the window's edges (row maxes near -23: the exact result;
    # far past +70: the clipped one) and two planted faults the tolerance
    # must see: the clip dropped (which is the exact softmax) on the hot
    # input, and the shift left in a per-tile rescale (O and l times e^-C
    # before each of the instance's own key tiles); on the wide kernels' first
    # split case a third, each split normalised by its own sum before the
    # splits are added
    t_static = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    one = torch.zeros(1, device=dev)  # a single-frame decode's batch of one
    two = torch.tensor([0.3, 0.6], device=dev)  # two rows, neither an endpoint (no skip row)
    modes5 = ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")
    static_sets = [
        ("flash_interpolated_attention(static)", torch.bfloat16, "streaming", [
            ("SDXL self 4096", "self", coef, 10, 4096, 4096, 64, 10),
            ("SDXL fused_outer 4096", "fused_outer", coef, 10, 4096, 4096, 64, 5),
            ("SD1.5 self 4096", "self", sd_coef, 8, 4096, 4096, 40, 10),
            ("SD1.5 fused_outer 4096", "fused_outer", sd_coef, 8, 4096, 4096, 40, 5),
            ("SD1.5 fused_outer 1024", "fused_outer", sd_coef, 8, 1024, 1024, 80, 20),
            ("SD1.5 fused_outer 256", "fused_outer", sd_coef, 8, 256, 256, 160, 20),
            ("SD2.1 self 9216", "self", sd_coef, 5, 9216, 9216, 64, 3),
            ("SD2.1 fused_outer 2304", "fused_outer", sd_coef, 10, 2304, 2304, 64, 10)]),
        ("flash_interpolated_attention(static midstream)", torch.bfloat16, "midstream", [
            ("SDXL fused_outer 1024", "fused_outer", coef, 20, 1024, 1024, 64, 20),
            *[(f"SDXL {m} 1024", m, coef, 20, 1024, 1024, 64, 10) for m in ("pure_outer", "fused_inner", "pure_inner")],
            ("SD2.1 fused_outer 576", "fused_outer", sd_coef, 20, 576, 576, 64, 20)]),
        ("flash_interpolated_attention_f32(static)", torch.float32, "streaming", [
            ("SDXL self 4096", "self", coef, 10, 4096, 4096, 64, 3),
            ("SDXL fused_outer 4096", "fused_outer", coef, 10, 4096, 4096, 64, 2),
            ("SDXL fused_outer 1024", "fused_outer", coef, 20, 1024, 1024, 64, 5),
            ("SD1.5 self 4096", "self", sd_coef, 8, 4096, 4096, 40, 3),
            ("SD1.5 fused_outer 4096", "fused_outer", sd_coef, 8, 4096, 4096, 40, 2),
            ("SD1.5 fused_outer 1024", "fused_outer", sd_coef, 8, 1024, 1024, 80, 5),
            ("SD1.5 fused_outer 256", "fused_outer", sd_coef, 8, 256, 256, 160, 10)]),
        ("flash_interpolated_attention(static dmid)", torch.bfloat16, "dmid", [
            *[(f"SD1.x D=320 {m} 4096", m, sd_coef, 1, 4096, 4096, 320, 5) for m in modes5],
            ("SD1.x D=320 fused_outer 1024", "fused_outer", sd_coef, 2, 1024, 1024, 320, 10),
            *[(f"self 1024 D={D}", "self", sd_coef, 2, 1024, 1024, D, 10) for D in (448, 504)]]),
        ("flash_interpolated_attention_f32(static dmid)", torch.float32, "dmid", [
            *[(f"SD1.x D=320 {m} 4096", m, sd_coef, 1, 4096, 4096, 320, 2) for m in modes5],
            ("SD1.x D=320 fused_outer 1024", "fused_outer", sd_coef, 2, 1024, 1024, 320, 5),
            ("self 1024 D=448", "self", sd_coef, 2, 1024, 1024, 448, 5)]),
        ("flash_interpolated_attention(static dwide)", torch.bfloat16, "dwide", [
            *[(f"SD1.x D=640 {m} 1024", m, sd_coef, 1, 1024, 1024, 640, 10) for m in modes5],
            ("SD1.x D=640 cross fused_outer 1024x77", "fused_outer", sd_coef, 1, 1024, 77, 640, 10),
            ("SD1.x D=1280 fused_outer 256", "fused_outer", sd_coef, 1, 256, 256, 1280, 20),
            ("SD1.x D=1280 fused_outer 64 (mid block)", "fused_outer", sd_coef, 1, 64, 64, 1280, 20),
            ("fused_outer 1024 D=520", "fused_outer", sd_coef, 1, 1024, 1024, 520, 10),
            ("self 512 D=2048", "self", two, 1, 512, 512, 2048, 10)]),
        ("flash_interpolated_attention_f32(static dwide)", torch.float32, "dwide", [
            *[(f"SD1.x D=640 {m} 1024", m, sd_coef, 1, 1024, 1024, 640, 3) for m in modes5],
            ("fused_outer 256 D=1024", "fused_outer", sd_coef, 1, 256, 256, 1024, 5),
            ("SD1.x D=1280 fused_outer 64 (mid block)", "fused_outer", sd_coef, 1, 64, 64, 1280, 10),
            ("self 512 D=2048", "self", two, 1, 512, 512, 2048, 3)]),
        ("flash_self_attention_f32(static)", torch.float32, "d512", [
            ("VAE 1024px frame", "self", one, 1, 16384, 16384, 512, 2),
            ("VAE 512px, 7 frames", "self", sd_coef, 1, 4096, 4096, 512, 3),
            ("VAE tiled decode's tile", "self", one, 1, 4000, 4000, 512, 5),
            ("self 1024 D=504 (padded)", "self", sd_coef, 2, 1024, 1024, 504, 5)]),
        ("flash_self_attention_bf16(static)", torch.bfloat16, "d512", [
            ("VAE 1024px frame", "self", one, 1, 16384, 16384, 512, 5),
            ("VAE 512px, 7 frames", "self", sd_coef, 1, 4096, 4096, 512, 5),
            ("VAE tiled decode's tile", "self", one, 1, 4000, 4000, 512, 10)]),
    ]
    for name, dtype, kind, cases in static_sets:
        tol = F32_ATTN_TOL if dtype == torch.float32 else ATTN_TOL
        worst, shapes, main, rescale_case, split_case = 0.0, {}, None, None, None
        for label, mode, c, H, Sq, L, D, reps in cases:
            if kind == "d512":
                r = d512_static(label, c, H, Sq, D, reps, dtype)
            else:
                r = attention(label, mode, c, H, Sq, L, D, reps, None, dtype, static=True)
            got, want, inputs = r.pop("got"), r.pop("want"), r.pop("inputs")
            if kind != "d512":
                ops = kernel_launch(*inputs[:5], static_smax=STATIC_SHIFT_C, **inputs[5])[1].operands
                entry = ops["entry"]
                routed = ("dmid" if entry == STATIC_DMID_ENTRIES[dtype] else
                          "dwide" if entry == STATIC_DWIDE_ENTRIES[dtype] else
                          "midstream" if "midstream" in entry else "streaming")
                if routed != kind:
                    fail(f"{name} {label}: the static call took {entry}, not the {kind} kernel's instance")
                if kind == "dwide" and split_case is None and ops["splits"] > 1:
                    split_case = (label, got, want, inputs, ops["splits"])
                del ops
            if rescale_case is None and mode in ("self", "pure_inner"):
                rescale_case = (label, got, want, inputs)
            del got, want
            worst = max(worst, r["max_abs_err"])
            shapes[f"{label} ({c.shape[0]},{H},{Sq},{D})"] = {
                **{k: r[k] for k in ("ms", "kernel_ms", "exact_ms", "exact_kernel_ms", "plain_ms", "bound_ms",
                                     "library_ms", "library")}, "bound_share": r["bound_ms"] / r["kernel_ms"],
                "static_over_exact_alone": r["kernel_ms"] / r["exact_kernel_ms"]}
            main = main or r
        # the shift left in a per-tile rescale: the plain static shift with O and l times e^-C before each of
        # the instance's own key tiles
        label, got, want, (q, k, v, c, mode, kw) = rescale_case
        ref = want.float().abs().max().item()
        Dp = padded_head_dim(q.shape[-1], mode, dtype)
        if kind == "d512":
            bk = (F32_D512_TILES if dtype == torch.float32 else D512_BF16_TILES)[1]
        elif kind == "dmid":
            bk = dmid_tiles(Dp, dtype, *q.shape[:3])["BK"]
        elif kind == "dwide":
            bk = dwide_tiles(Dp, dtype)[2]
        else:
            bk = (MIDSTREAM_TILES if kind == "midstream" else KERNEL_F32_TILES if dtype == torch.float32
                  else KERNEL_TILES)[Dp][0 if kind == "midstream" else 1]
        fault = shift_in_rescale_fault(q, k, v, c, mode, STATIC_SHIFT_C, bk)
        ferr = (got.float() - fault).abs().max().item()
        print(f"  planted fault on {label} (the shift left in a per-tile rescale, {bk}-key tiles): max_abs_err "
              f"{ferr:.3e} against tol {tol * ref:.3e}  {'ok' if ferr > tol * ref else 'FAIL'}", flush=True)
        if not ferr > tol * ref:
            fail(f"{name}: the tolerance does not see the shift left in the rescale on {label} ({ferr:.3e})")
        del rescale_case, got, want, fault
        if kind == "dwide":  # each split normalised by its own sum before the splits are added
            if split_case is None:
                fail(f"{name}: no case split the key stream, so the combine step went unchecked")
            label, got, want, (q, k, v, c, mode, kw), splits = split_case
            ref = want.float().abs().max().item()
            fault = split_normalised_fault(q, k, v, c, mode, kw, STATIC_SHIFT_C, dwide_tiles(q.shape[-1], dtype)[2],
                                           splits)
            ferr = (got.float() - fault).abs().max().item()
            print(f"  planted fault on {label} (each of {splits} splits normalised by its own sum before they are "
                  f"added): max_abs_err {ferr:.3e} against tol {tol * ref:.3e}  {'ok' if ferr > tol * ref else 'FAIL'}",
                  flush=True)
            if not ferr > tol * ref:
                fail(f"{name}: the tolerance does not see each split normalised alone on {label} ({ferr:.3e})")
            del split_case, got, want, fault
        # the window's edges at the first case's shape, and the clip dropped
        label, mode, c, H, Sq, L, D, _ = cases[0]
        window = {}
        for hot in (False, True):
            q, k, v, scale = window_inputs(dtype, hot, c.shape[0], H, Sq, D, gen)
            kw = {} if mode == "self" else {"skip_endpoints": skip_mask(c, c.shape[0])}
            if kind == "d512":
                out, launch = d512_launch(q, k, v, scale, static_smax=STATIC_SHIFT_C)
            else:
                out, launch = kernel_launch(q, k, v, c, mode, scale=scale, static_smax=STATIC_SHIFT_C, **kw)
            launch()
            clipped = flash_interpolated_attention_plain(q, k, v, c, mode, scale=scale, static_smax=STATIC_SHIFT_C,
                                                         **kw)
            exact = flash_interpolated_attention_plain(q, k, v, c, mode, scale=scale, **kw)  # = the clip dropped
            ref = clipped.float().abs().max().item()
            err = (out.float() - clipped.float()).abs().max().item()
            xerr = (out.float() - exact.float()).abs().max().item()
            ok = torch.isfinite(out).all().item() and err <= tol * ref and (xerr > tol * ref if hot else
                                                                             xerr <= tol * ref)
            edge = "far past the top (clipped)" if hot else "near the bottom"
            print(f"  {label} row maxes {edge}: max_abs_err {err:.3e} against the plain static shift, {xerr:.3e} "
                  f"against the exact softmax{' (the planted fault: the clip dropped)' if hot else ''}, tol "
                  f"{tol * ref:.3e}  {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} {label}: wrong at the window's edge ({edge})")
            window["clipped" if hot else "bottom"] = {"max_abs_err": err, "exact_err": xerr}
            del q, k, v, out, launch, clipped, exact
        records[name] = {**main, "max_abs_err": worst, "shapes": shapes, "window": window}
    gen = main_gen
    print(f"  the static-shift cases: {time.perf_counter() - t_static:.1f} s", flush=True)

    # the D=161-512 entries at phase 21's shapes (SD 1.x at 320-wide heads: 1
    # / 2 / 4 / 4 heads over 64^2 / 32^2 / 16^2 / 8^2 tokens, D = 320): every
    # endpoint mode and self mode at each level and the 77-key cross call in
    # fused_outer and self mode, and at D = 384 (bf16 / f16: D split across
    # warpgroups; f32: 16-key tiles) and the ragged D = 200 over 32^2 tokens,
    # self mode at 448 and 504 too (f32's last head dim on the self instance,
    # and bf16's and f16's last multiple of 8 on it: f32 takes 504 to the
    # D=512 self kernels, so phase 3 leaves it out), in bf16, f16 and f32;
    # the record is fused_outer (7,1,4096,320)'s, self_* self (7,1,4096,320)'s,
    # every case under ``shapes``
    wide_cases = [(f"SD1.x D=320 {m} {Sq}", m, H, Sq, Sq, 320, reps, None)
                  for H, Sq, reps in ((1, 4096, 3), (2, 1024, 10), (4, 256, 20), (4, 64, 20))
                  for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")]
    wide_cases += [(f"SD1.x D=320 cross {m} 4096x77", m, 1, 4096, 77, 320, 10, None) for m in ("fused_outer", "self")]
    wide_cases += [(f"D={D} {m} 1024", m, 2, 1024, 1024, D, 10, None) for D in (384, 200)
                   for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")]
    wide_cases += [(f"D={D} self 1024", "self", 2, 1024, 1024, D, 10, None) for D in (448, 504)]
    for name, dtype in (("flash_interpolated_attention(D=161-512)", torch.bfloat16),
                        ("flash_interpolated_attention_f16(D=161-512)", torch.float16),
                        ("flash_interpolated_attention_f32(D=161-512)", torch.float32)):
        gen = f16_gen if dtype == torch.float16 else main_gen
        worst, shapes = 0.0, {}
        for label, mode, H, Sq, L, D, reps, Le in wide_cases:
            if takes_d512_self(D, mode, dtype):  # not this entry's call
                continue
            r = attention(label, mode, sd_coef, H, Sq, L, D, reps if dtype != torch.float32 else max(1, reps // 2),
                          Le, dtype)
            worst = max(worst, r["max_abs_err"])
            shapes[f"{label} ({sd_coef.shape[0]},{H},{Sq},{D})"] = {
                **{k: r[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_padded_ms", "library_ms")},
                "bound_share": r["bound_ms"] / r["kernel_ms"],
                **{k: r[k] for k in ("library", "d512_ms", "d512_kernel_ms") if mode == "self"}}
            if label == "SD1.x D=320 fused_outer 4096":
                main = r
            if label == "SD1.x D=320 self 4096":
                self_case = r
        records[name] = {**main, "max_abs_err": worst, "shapes": shapes,
                         **{f"self_{k}": self_case[k] for k in ("ms", "kernel_ms", "bound_ms", "library_ms", "library",
                                                               "d512_ms", "d512_kernel_ms")}}
    gen = main_gen

    # the wide entries at phase 22's shapes (SD 1.x with one head a level:
    # D = 640 over 32^2 tokens, 1280 over 16^2 and 8^2, the 77-key cross call
    # at D = 640), at the widest head dim (2048, two frames with no skip row)
    # and at a ragged one (520), every mode, in bf16, f16 and f32; the record
    # is fused_outer (7,1,1024,640)'s, every case under ``shapes``
    two = torch.tensor([0.3, 0.6], device=dev)
    dwide_cases = [(f"SD1.x D={D} {m} {Sq}{'x77' if L == 77 else ''}", m, c, Sq, L, D, reps)
                   for Sq, L, D, c, reps in ((1024, 1024, 640, sd_coef, 3), (1024, 77, 640, sd_coef, 5),
                                             (256, 256, 1280, sd_coef, 5), (64, 64, 1280, sd_coef, 10),
                                             (512, 512, 2048, two, 3), (1024, 1024, 520, sd_coef, 3))
                   for m in ("fused_outer", "pure_outer", "fused_inner", "pure_inner", "self")]
    for name, dtype in (("flash_interpolated_attention(D=513-2048)", torch.bfloat16),
                        ("flash_interpolated_attention_f16(D=513-2048)", torch.float16),
                        ("flash_interpolated_attention_f32(D=513-2048)", torch.float32)):
        gen = f16_gen if dtype == torch.float16 else main_gen
        worst, shapes = 0.0, {}
        for label, mode, c, Sq, L, D, reps in dwide_cases:
            r = attention(label, mode, c, 1, Sq, L, D, reps if dtype != torch.float32 else max(1, reps // 2),
                          None, dtype)
            worst = max(worst, r["max_abs_err"])
            shapes[f"{label} ({c.shape[0]},1,{Sq},{D})"] = {
                **{k: r[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_padded_ms", "library_ms")},
                "bound_share": r["bound_ms"] / r["kernel_ms"], "library": r["library"]}
            if label == "SD1.x D=640 fused_outer 1024":
                main = r
        records[name] = {**main, "max_abs_err": worst, "shapes": shapes}
    gen = main_gen

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
        f32, f16 = x.dtype == torch.float32, x.dtype == torch.float16
        suffix = "f16" if f16 else "bf16"
        entry = "aid_conv3x3_f32" if f32 else (f"aid_conv3x3_gnsilu_{suffix}" if factors else f"aid_conv3x3_{suffix}")
        wrapper = (lambda: conv3x3_gnsilu(x, w, b, *factors, 32)) if factors else (
            lambda: conv3x3_same(x, w, b, packed=packed))
        plain = (lambda: conv3x3_gnsilu_plain(x, w, b, *factors, 32)) if factors else (
            lambda: conv3x3_same_plain(x, w, b))
        got = wrapper()
        torch.cuda.synchronize()
        want = plain()
        diff = (got.float() - want.float()).abs()
        ref = want.float().abs().max().item()
        tol = (F32_CONV_TOL if f32 else F16_CONV_TOL if f16 else GNSILU_TOL if factors else CONV_TOL) * ref
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
                                        tf32_passes=3 if f32 else None, kind=suffix)
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

    # the f16 instance at the SDXL classes (phase 20's f16 SDXL UNet), both packed flags
    worst, gen = 0.0, f16_gen
    for cin, cout in ((960, 320), (640, 320), (640, 640)):
        x = randn(B, cin, 128, 128, dtype=torch.float16)
        w = randn(cout, cin, 3, 3, dtype=torch.float16) * (9 * cin) ** -0.5
        b = randn(cout, dtype=torch.float16)
        r, _ = conv_case(f"conv3x3 f16 B={B} {cin}->{cout} @128x128", x, w, b, reps=5)
        worst = max(worst, r["max_abs_err"])
        if cin == 960:
            main = r
        if (cin, cout) == (640, 320):
            if not torch.equal(conv3x3_same(x, w, b, packed=True), conv3x3_same(x, w, b)):
                fail("f16 conv3x3_same(packed=True) does not launch the prologue-free f16 kernel")
            records["conv3x3_same_f16(packed=True)"], _ = conv_case(
                f"conv3x3 f16 packed=True B={B} 640->320 @128x128", x, w, b, reps=5, packed=True)
        del x, w, b
    records["conv3x3_same_f16"] = {**main, "max_abs_err": worst}
    gen = main_gen

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
    # tokens (SDXL, one 1024px frame), over 4096 tokens of 7 frames at once
    # (SD1.5, the batched 512px decode) and over the tiled decode's ragged
    # 4000-token tile; timed through the wrapper (ms) and launched alone on
    # operands d512_launch prepared once (kernel_ms); SDPA under each backend
    # that takes f32 at D=512, with its error, since a backend may compute
    # f32 through TF32
    worst = 0.0
    for n, S, reps in ((1, 16384, 3), (7, 4096, 5), (1, 4000, 10)):
        q, k, v = (torch.randn((n, 1, S, 512), generator=gen, device=dev) for _ in range(3))
        got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
        torch.cuda.synchronize()
        want = flash_interpolated_attention_plain(q, k, v)
        err, ref = (got - want).abs().max().item(), want.abs().max().item()
        _, launch = d512_launch(q, k, v)
        kernel_ms = cuda_ms(launch, reps)
        ms = cuda_ms(lambda: flash_self_attention_f32(q, k, v), reps)
        plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v), reps)
        bound_ms, bound_by = attention_bound("self", n, 1, S, S, 512, elem=4, **F32_D512_PASSES)
        three_tf32_ms, _ = attention_bound("self", n, 1, S, S, 512, elem=4, tf32_passes=3)
        cuda_core_ms = 4.0 * n * S * S * 512 / PEAK_OPS_PER_S["f32"] * 1e3  # the same flops in plain f32 FMA
        library = sdpa_backends(q, k, v, want, reps)
        ok = math.isfinite(err) and err <= F32_ATTN_TOL * ref
        print(f"attention f32 self ({n},1,{S},512): max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
              f"tol {F32_ATTN_TOL * ref:.3e}) rel_l2 {rel_l2(got, want):.3e}  kernel {ms:.3f} ms (launch alone "
              f"{kernel_ms:.3f}, {bound_ms / kernel_ms:.1%} of the bound, {three_tf32_ms / kernel_ms:.1%} of "
              f"3xTF32's {three_tf32_ms:.3f} ms)  plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)} "
              f"(the kernel's 1.5 TF32 + 1.5 bf16 passes; {cuda_core_ms:.3f} ms at the f32 CUDA-core rate); "
              f"library max_abs_err {', '.join(f'{b} {t[1]:.3e}' for b, t in library.items())}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"f32 D=512 attention ({n},1,{S},512): kernel disagrees with the plain version")
        worst = max(worst, err)
        if S == 16384:
            lib_name, lib_ms = fastest(library)
            main = {"ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bound_3xtf32_ms": three_tf32_ms, "f32_cuda_core_bound_ms": cuda_core_ms,
                    "library_ms": lib_ms, "library": lib_name,
                    "library_max_abs_err": library[lib_name][1] if lib_name else None}
        elif S == 4096:
            sd15 = {"sd15_ms": ms, "sd15_kernel_ms": kernel_ms, "sd15_plain_ms": plain_ms,
                    "sd15_bound_ms": bound_ms, "sd15_bound_3xtf32_ms": three_tf32_ms,
                    "sd15_library_ms": fastest(library)[1]}
        else:
            tile = {"tile_ms": ms, "tile_kernel_ms": kernel_ms, "tile_plain_ms": plain_ms, "tile_bound_ms": bound_ms,
                    "tile_library_ms": fastest(library)[1]}
        del q, k, v, got, want, launch
    records["flash_self_attention_f32"] = {**main, **sd15, **tile, "max_abs_err": worst}

    # the same attention in a bf16 VAE, and in an f16 VAE (phase 20): one
    # 1024px SDXL frame, SD1.5's batched 512px decode (also a 512px tile or
    # encode), and a ragged sequence; timed through the wrapper (ms) and
    # launched alone on operands d512_launch prepared once (kernel_ms); SDPA
    # under each backend that takes the dtype at D=512
    for name, dtype, tol, wrapper in (("bf16", torch.bfloat16, BF16_D512_TOL, flash_self_attention_bf16),
                                      ("f16", torch.float16, F16_ATTN_TOL, flash_self_attention_f16)):
        worst, gen = 0.0, f16_gen if dtype == torch.float16 else main_gen
        for n, S, reps in ((1, 16384, 5), (7, 4096, 5), (1, 4000, 10)):
            q, k, v = (randn(n, 1, S, 512, dtype=dtype) for _ in range(3))
            got = flash_interpolated_attention(q, k, v)  # routed by dtype and head dim, as the VAE calls it
            torch.cuda.synchronize()
            want = flash_interpolated_attention_plain(q, k, v)
            err, ref = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
            _, launch = d512_launch(q, k, v)
            kernel_ms = cuda_ms(launch, reps)
            ms = cuda_ms(lambda: wrapper(q, k, v), reps)
            plain_ms = cuda_ms(lambda: flash_interpolated_attention_plain(q, k, v), reps)
            bound_ms, bound_by = attention_bound("self", n, 1, S, S, 512, kind=name)
            library = sdpa_backends(q, k, v, want, reps)
            ok = math.isfinite(err) and err <= tol * ref
            print(f"attention {name} self ({n},1,{S},512): max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
                  f"tol {tol * ref:.3e}) rel_l2 {rel_l2(got, want):.3e}  kernel {ms:.4f} ms (launch alone "
                  f"{kernel_ms:.4f})  plain {plain_ms:.3f} ms  {yardsticks(bound_ms, bound_by, library)}; library "
                  f"max_abs_err {', '.join(f'{b} {t[1]:.3e}' for b, t in library.items())}  {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"{name} D=512 attention ({n},1,{S},512): kernel disagrees with the plain version")
            worst = max(worst, err)
            if S == 16384:
                lib_name, lib_ms = fastest(library)
                main = {"ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms, "library": lib_name}
            elif S == 4096:
                sd15 = {"sd15_ms": ms, "sd15_kernel_ms": kernel_ms, "sd15_bound_ms": bound_ms,
                        "sd15_library_ms": fastest(library)[1]}
            del q, k, v, got, want, launch
        records[f"flash_self_attention_{name}"] = {**main, **sd15, "max_abs_err": worst}
    gen = main_gen

    # kernel B at every (H, W, Cin, Cout) class the fused configuration routes
    # to it, in bf16 and in f16 (phase 20's fused f16 SDXL forward); inputs
    # off zero mean and gamma/beta off 1/0, so silu(shift) is far from 0 and
    # a halo that took it would show on the border ring
    for name, dtype, tol in (("conv3x3_gnsilu", torch.bfloat16, GNSILU_TOL),
                             ("conv3x3_gnsilu_f16", torch.float16, F16_CONV_TOL)):
        worst, total_ms, total_plain = 0.0, 0.0, 0.0
        gen = f16_gen if dtype == torch.float16 else main_gen
        for (H, W, cin, cout), calls in sorted(fused_classes.items()):
            x = (randn(B, cin, H, W).float() * 2.0 + 1.0).to(dtype)
            w = randn(cout, cin, 3, 3, dtype=dtype) * (9 * cin) ** -0.5
            b = randn(cout, dtype=dtype)
            gamma = 1.0 + 0.3 * torch.randn(cin, generator=gen, device=dev)
            beta = 0.5 * torch.randn(cin, generator=gen, device=dev)
            ring = torch.zeros(H, W, dtype=torch.bool, device=dev)
            ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
            label = f"{name} B={B} {cin}->{cout} @{H}x{W} ({calls}/forward)"
            r, want = conv_case(label, x, w, b, (gamma, beta), ring, reps=5 if dtype == torch.bfloat16 else 3)
            worst = max(worst, r["max_abs_err"])
            total_ms += calls * r["ms"]
            total_plain += calls * r["plain_ms"]
            if (H, cin, cout) == (128, 960, 320):
                main = r
        print(f"{name} per fused UNet forward (B={B}, {sum(fused_classes.values())} calls): "
              f"kernel {total_ms:.2f} ms through the wrapper, plain chain {total_plain:.2f} ms", flush=True)
        # the border-ring check must see a halo that took silu(shift): the
        # planted fault on the last class moves the ring, not the interior
        ref = want.float().abs().max().item()
        fault = halo_fault_plain(x, w, b, gamma, beta, 32)
        fdiff = (fault.float() - want.float()).abs()
        f_ring, f_in = fdiff[:, :, ring].max().item(), fdiff[:, :, ~ring].max().item()
        print(f"{name} planted halo fault @{H}x{W}: border {f_ring:.3e}, interior {f_in:.3e} "
              f"(tol {tol * ref:.3e})", flush=True)
        if not f_ring > tol * ref:
            fail(f"the {name} border-ring check does not see a halo fault")
        records[name] = {**main, "max_abs_err": worst}
        if dtype == torch.bfloat16:
            bf16_main = main
        del x, w, b, want, fault
    gen = main_gen

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
    with torch.no_grad(), logit_window(f"the SDXL UNet (bf16, fused_outer, B={sample.shape[0]} 128x128)"):
        unet(sample, t, ehs, aid, added)
        torch.cuda.synchronize()
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
    # the 77-key text cross calls on the short-stream kernel, the 1024-token
    # self calls on the mid-length stream kernel; under "auto" the 4096-token
    # self and fused_outer calls on the streaming kernel's static-shift
    # instance and the 1024-token fused_outer calls on the mid-length one's
    static = static_needed("bf16", [("streaming", 64, "self"), ("streaming", 64, "fused_outer"),
                                    ("midstream", 64, "fused_outer")])
    check_path("denoise", launches, ("flash_interpolated_attention", "flash_interpolated_attention[onepass]",
                                     "flash_interpolated_attention[midstream]", "conv3x3_same", *static))
    return launches, out


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


def timed(fn, stages: dict, stage: str):
    """``fn`` wrapped to append its seconds to ``stages[stage]``: host clock
    around the call, the card synchronized before and after."""
    import torch

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages.setdefault(stage, []).append(time.perf_counter() - t0)
        return out
    return run


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

    def decode_keep_input(z):
        decoder_inputs.append(z)
        return decode(z)

    real_denoise = engine.denoise_sequence
    pipe.encode_prompt = timed(pipe.encode_prompt, stages, "encode")
    vae.decode = timed(decode_keep_input, stages, "decode")
    engine.denoise_sequence = timed(real_denoise, stages, "denoise")
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


def tiled_vae_path(pipe, vae, call, steps: int, card: str, dtype: str) -> dict:
    """``call`` with the pipeline's VAE tiling on at 32-latent tiles
    (``enable_vae_tiling(32)``: 256px tiles, a 1024-token mid-block
    attention each, which the JAX wrapper keeps exact as a one-pass self
    call): the images, the VAE's attention on the exact D=512 kernel of
    ``dtype`` and none on its static-shift instance. Returns the path's
    counts."""
    pipe.enable_vae_tiling(32)
    try:
        images, counts, times, _, elapsed, peak = run_image_path(pipe, vae, call, steps, 7)
    finally:
        pipe.disable_vae_tiling()
    label = f"interpolate, {dtype} VAE in 32-latent tiles"
    check_images(label, images, (7, 1024, 1024, 3), times, elapsed, peak, card)
    name = f"flash_self_attention_{dtype}"
    check_path(f"image out, {dtype} VAE in 32-latent tiles", counts, ("flash_interpolated_attention", name,
                                                                     "conv3x3_same"))
    print(f"{label}: {counts[name]} D=512 launches, {counts[name + '[static]']} on the static-shift instance "
          f"(the 1024-token tiles stay exact under \"auto\")", flush=True)
    if counts[name + "[static]"]:
        fail(f"{label}: the 1024-token tiles took the static-shift instance; the JAX wrapper keeps them exact")
    return counts


def phase_image(unet, steps: int, card: str):
    """InterpolationXLPipeline.interpolate at 1024px with the f32 VAE, then
    with the bf16 VAE: stage times, launch counts (the VAE's attention on
    the D=512 static-shift instance of its dtype under "auto", unless
    STATIC_SHIFT_SLOWER keeps it exact), peak memory, one frame's raw
    decoder output through the kernels vs the plain versions (the f32 one's
    logit window read and held inside STATIC_WINDOW), that frame's tiled
    bf16 decode, and each VAE in 32-latent tiles (``tiled_vae_path``: the
    exact D=512 kernels). Returns the four paths' launch counts."""
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
    vae_static = static_needed("f32", [("d512", 512, "self")])  # the VAE's attention under "auto"
    check_path("image out", counts, ("flash_interpolated_attention", "flash_self_attention_f32", "conv3x3_same",
                                     *vae_static))
    if counts["flash_self_attention_f32"] != 7 or counts["flash_self_attention_f32[static]"] != 7 * len(vae_static):
        fail(f"the f32 attention kernel ran {counts['flash_self_attention_f32']} times "
             f"({counts['flash_self_attention_f32[static]']} on its static-shift instance), once per frame (7) "
             f"expected")
    check_decoder(vae.decode, decoder_inputs[3], images, 3)  # frame by frame: input 3 is frame 3
    with torch.no_grad(), logit_window("the f32 VAE decode of frame 3 (its mid-block attention, D=512)"):
        vae.decode(decoder_inputs[3])
    counts_tiled = tiled_vae_path(pipe, vae, call, steps, card, "f32")

    # the same call with the bf16 VAE: its mid-block attention is the bf16
    # D=512 kernel, once per frame
    pipe.enable_bf16_vae_decode()
    f32_images, f32_times = images, times
    images, counts_bf16, times, decoder_inputs, elapsed, peak = run_image_path(pipe, vae, call, steps, 7)
    check_images("interpolate, bf16 VAE", images, (7, 1024, 1024, 3), times, elapsed, peak, card)
    check_path("image out, bf16 VAE", counts_bf16,
               ("flash_interpolated_attention", "flash_self_attention_bf16", "conv3x3_same",
                *static_needed("bf16", [("d512", 512, "self")])))
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
    tiled = read_counts()
    print(f"tiled decode of one frame: {tiled['flash_self_attention_bf16']} bf16 D=512 launches (one per tile), "
          f"{tiled['flash_self_attention_bf16[static]']} of them on its static-shift instance", flush=True)
    counts_bf16_tiled = tiled_vae_path(pipe, vae, call, steps, card, "bf16")

    # the invisible watermark on one more run: every frame marked, the bits
    # read back from one of them
    from aid_tpu_torch.utils.watermark import WATERMARK_BITS, InvisibleWatermark

    pipe.watermarker = InvisibleWatermark()
    try:
        t0 = time.perf_counter()
        marked = call()
        elapsed = time.perf_counter() - t0
    finally:
        pipe.watermarker = None
    bits = InvisibleWatermark().decode(marked[3])
    ok = bits.tolist() == WATERMARK_BITS
    print(f"interpolate with the watermarker: {elapsed:.2f} s in all; {float((marked != images).mean()):.4f} of the "
          f"values differ from the unmarked run; frame 3's decoded bits {''.join(map(str, bits))} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the watermark read back from frame 3 is {bits.tolist()}, not the 48-bit message")
    return [counts, counts_tiled, counts_bf16, counts_bf16_tiled]


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


def check_unet_vs_plain(label: str, forward, aid, tol: float, faults=None) -> dict:
    """One UNet forward ``forward(aid)`` through the kernels and through the
    plain versions, with faults planted through the plain versions: the
    LARGEST PER-FRAME relative L2 must lie under ``tol`` and every fault's
    over it. ``faults``: name -> (the AidContext of the faulty forward, a
    function of the plain attention giving its faulty stand-in, or None);
    by default fused_outer computed as self, and the begin and end
    endpoints exchanged. Then one more forward reads the logit window of
    every attention call (logit_window). Returns the forward's launch
    counts."""
    import torch

    from aid_tpu_torch.ops import flash_attention
    from aid_tpu_torch.ops.routing import reference_ops

    if faults is None:
        faults = {"fused_outer->self": (None, None), "endpoints swapped": (aid, swapped_endpoints)}
    readings = {}
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        readings["kernels"] = forward(aid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = read_counts()
        with reference_ops():
            want = forward(aid)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for name, (fault_aid, plant) in faults.items():
                real_plain = flash_attention.flash_interpolated_attention_plain
                if plant is not None:
                    flash_attention.flash_interpolated_attention_plain = plant(real_plain)
                try:
                    readings[name] = forward(fault_aid)
                finally:
                    flash_attention.flash_interpolated_attention_plain = real_plain
    if not torch.isfinite(readings["kernels"]).all():
        fail(f"{label}: the kernel output is not finite")
    per_frame = {name: frame_rel_l2(x, want) for name, x in readings.items()}
    for name, x in readings.items():
        print(f"  {name:18s} rel_l2 whole {rel_l2(x, want):.3e}, by frame "
              f"{' '.join(f'{r:.3e}' for r in per_frame[name])}", flush=True)
    worst = {name: max(per_frame[name]) for name in readings}
    rel = worst["kernels"]
    ok = math.isfinite(rel) and rel <= tol
    planted = ", ".join(f"{name} {worst[name]:.3e}" for name in faults)
    print(f"{label}: largest per-frame rel_l2 kernels vs plain {rel:.3e} (tol {tol:.1e}; planted faults: "
          f"{planted}); forward {t1 - t0:.3f} s with kernels (first call), {t2 - t1:.3f} s plain  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    for name in faults:
        if not worst[name] > tol:
            fail(f"{label}: the bound {tol:.1e} does not separate the planted fault {name} ({worst[name]:.3e})")
    if not ok:
        fail(f"{label}: the output through the kernels disagrees with the plain versions")
    with torch.no_grad(), logit_window(label):  # one more forward, each call's row maxes read
        forward(aid)
        torch.cuda.synchronize()
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
             "flash_interpolated_attention[D=160]", "flash_interpolated_attention[onepass]",
             "flash_interpolated_attention[midstream]")
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


# each kernel's launch count by the dtype of the kernel
KERNELS_BY_DTYPE = {
    "bf16": ("flash_interpolated_attention", "flash_self_attention_bf16", "conv3x3_same", "conv3x3_gnsilu"),
    "f16": ("flash_interpolated_attention_f16", "flash_self_attention_f16", "conv3x3_same_f16", "conv3x3_gnsilu_f16"),
    "f32": ("flash_interpolated_attention_f32", "flash_self_attention_f32", "conv3x3_same_f32", "conv3x3_gnsilu_f32"),
}


def check_dtype_only(dtype: str, path: str, counts: dict, needed, allowed=()) -> None:
    """check_path, and no launch of a kernel of another dtype on a ``dtype``
    path except the counts named in ``allowed``."""
    check_path(path, counts, needed)
    other = {n: counts[n] for d, names in KERNELS_BY_DTYPE.items() if d != dtype for n in names if n not in allowed}
    if any(other.values()):
        fail(f"the {dtype} {path} path launched kernels of another dtype: {other}")


def check_f32_only(path: str, counts: dict, needed) -> None:
    """check_path, and no launch of a bf16 or f16 kernel on an f32 path."""
    check_dtype_only("f32", path, counts, needed)


def check_f16_only(path: str, counts: dict, needed, allowed=()) -> None:
    """check_path, and no launch of a bf16 or f32 kernel on an f16 path
    except the counts named in ``allowed`` (the f32 VAE's attention where the
    loader keeps the VAE in f32)."""
    check_dtype_only("f16", path, counts, needed, allowed)


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
    check_f32_only("f32 SDXL forward", counts, ("flash_interpolated_attention_f32[D=64]", "conv3x3_same_f32",
                                                *static_needed("f32", [("streaming", 64, "fused_outer")])))
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


def write_checkpoint(root: str, seed: int = 0, device: str = "cuda", configs=None) -> int:
    """Write a full-width SD diffusers directory under ``root`` (SD 2.1's
    unless ``configs`` says otherwise): each module's config.json, its
    weights ~ N(0, 0.02) from a seeded generator stored in f16 (as the
    published fp16 variants; ~2.6 GB for SD 2.1), a byte-level tokenizer
    padding with "!", and the scheduler config. ``configs``
    (sd21_diffusers_configs by default; sd15_diffusers_configs adds a
    ``safety_checker``) and ``device`` let a test write a tiny copy on the
    CPU. Returns the bytes of weights written."""
    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.safety import SafetyChecker
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.utils.safetensors import save_safetensors
    from aid_tpu_torch.utils.tokenizer import write_byte_level_tokenizer

    configs = configs or sd21_diffusers_configs()
    gen = torch.Generator(device=device).manual_seed(seed)
    modules = {"unet": (UNet2DCondition, loader.unet_config_from_diffusers, "diffusion_pytorch_model"),
               "vae": (AutoencoderKL, loader.vae_config_from_diffusers, "diffusion_pytorch_model"),
               "text_encoder": (CLIPTextModel, loader.clip_text_config_from_transformers, "model"),
               "safety_checker": (SafetyChecker, loader.clip_vision_config_from_transformers, "model")}
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
        nbytes = write_checkpoint(root)
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
        check_path("SD2.1 bf16 forward", counts, ("flash_interpolated_attention[D=64]", "conv3x3_same",
                                                  *static_needed("bf16", [("streaming", 64, "fused_outer"),
                                                                          ("midstream", 64, "fused_outer")])))

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
                   ("flash_interpolated_attention[D=64]", "flash_interpolated_attention[onepass]",
                    "flash_interpolated_attention[midstream]", "conv3x3_same", "flash_self_attention_f32"))
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


# Phase 16's check of the batched exploration: each middle frame of one
# (k + 2)-frame _gen_batch run against the middle of interpolate_single at
# the same t (uint8 frames as float, relative L2 per frame). The two runs
# differ only in their batch (4 rows against 3: other GEMM shapes in bf16).
# On an H100 (these seeds; deterministic): sound 7.5e-5 and 7.9e-5; the
# planted fault, t shifted by 0.05, 1.71e-3 (the random-weight model's
# frames move little with the start latent). 4e-4 lies between: 5x the
# sound reading, 0.23x the fault.
SELECT_BATCH_TOL = 4e-4
# Phase 16's depth: exploration 16 / selection 7 as bench.py's "dynamic
# selection" workload, at SD 1.5's 25 DDIM steps; the Bayesian search at
# size 3 with 25 steps and at most BAYES_ITERS GP iterations after its 3x3
# probe grid (its default is 15: cut to stay inside the smoke's time).
SELECT_EXPLORATION, SELECT_SIZE, BAYES_ITERS = 16, 7, 4


def sd15_diffusers_configs() -> dict:
    """config.json of each module of a diffusers SD 1.5 directory, as
    published (CLIP ViT-L text encoder with the legacy eos id 2, the SD VAE
    at 512px), a DDIM scheduler config (epsilon, scaled_linear 0.00085-0.012,
    steps_offset 1), and the safety checker's config with the values of
    CompVis's public stable-diffusion-safety-checker: a CLIP ViT-L/14 vision
    tower (hidden 1024, intermediate 4096, 24 layers, 16 heads, patch 14,
    image 224) under ``vision_config`` and projection_dim 768."""
    from aid_tpu_torch.models.configs import CLIP_VIT_L_TEXT as T, SD15_UNET as U, SD_VAE as V

    return {
        "unet": {"_class_name": "UNet2DConditionModel", "sample_size": U.sample_size, "in_channels": 4,
                 "out_channels": 4, "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
                 "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
                 "block_out_channels": list(U.block_out_channels), "layers_per_block": U.layers_per_block,
                 "attention_head_dim": U.num_attention_heads[0], "cross_attention_dim": U.cross_attention_dim,
                 "norm_num_groups": 32, "flip_sin_to_cos": True, "freq_shift": 0},
        "vae": {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3, "latent_channels": 4,
                "block_out_channels": list(V.block_out_channels), "layers_per_block": V.layers_per_block,
                "norm_num_groups": 32, "scaling_factor": V.scaling_factor, "sample_size": 512},
        "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": T.vocab_size,
                         "hidden_size": T.hidden_size, "intermediate_size": T.intermediate_size,
                         "num_hidden_layers": T.num_hidden_layers, "num_attention_heads": T.num_attention_heads,
                         "max_position_embeddings": 77, "hidden_act": "quick_gelu", "bos_token_id": 0,
                         "eos_token_id": 2, "projection_dim": 768},
        "safety_checker": {"_class_name": "StableDiffusionSafetyChecker", "architectures": ["StableDiffusionSafetyChecker"],
                           "projection_dim": 768,
                           "vision_config": {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
                                             "num_attention_heads": 16, "patch_size": 14, "image_size": 224,
                                             "hidden_act": "quick_gelu"}},
        "scheduler": {"_class_name": "DDIMScheduler", "prediction_type": "epsilon", "beta_schedule": "scaled_linear",
                      "beta_start": 0.00085, "beta_end": 0.012, "num_train_timesteps": 1000, "steps_offset": 1,
                      "set_alpha_to_one": False, "clip_sample": False},
    }


def phase_sd15_safety(card: str, device: str = "cuda", configs=None):
    """SD 1.5 with a safety checker through the loader: a full-width
    diffusers directory written from a seed into the checkout's git-ignored
    build/ (removed once loaded), ``load_interpolation_pipeline(dir)`` with
    no device and no dtype (every module on the card; UNet bf16, text
    encoder, VAE and checker f32), ``interpolate`` to seven 512px frames
    over SD15_STEPS DDIM steps with the checker on the decode, then the
    thresholds rigged both ways through the pipeline's decode: every frame
    black, then none. Returns the pipeline, its thresholds left at +10 (the
    checker runs, nothing is blacked out), and the path's launch counts.
    ``device``/``configs`` (sd15_diffusers_configs by default) exist for
    rehearsing on the CPU at a tiny size."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.safety import SafetyChecker
    from aid_tpu_torch.schedulers import DDIMScheduler

    steps = SD15_STEPS
    print(f"== phase 15: SD1.5 with a safety checker through the loader (load_interpolation_pipeline, DDIM): "
          f"interpolate (7 frames at 512px, {steps} steps) with the checker on the decode, thresholds rigged "
          f"both ways", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="sd15-checkpoint-", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        configs = configs or sd15_diffusers_configs()
        nbytes = write_checkpoint(root, seed=1, device=device, configs=configs)
        print(f"wrote a full-width SD1.5 diffusers directory with a safety_checker/ ({nbytes / 2**30:.2f} GiB of "
              f"f16 weights) in {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        pipe = loader.load_interpolation_pipeline(root, **({} if device == "cuda" else {"device": device}))
        torch.cuda.synchronize()
        print(f"load_interpolation_pipeline(dir) (no device, no dtype) in {time.perf_counter() - t0:.2f} s",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checker = pipe.safety_checker
    placed = {name: ({p.device.type for p in m.parameters()}, {p.dtype for p in m.parameters()})
              for name, m in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.text_encoder),
                              ("safety_checker", checker))}
    print(f"modules (devices, dtypes): {placed}; scheduler {type(pipe.scheduler).__name__}; guidance "
          f"{pipe.guidance_scale}", flush=True)
    want = {"unet": torch.bfloat16, "vae": torch.float32, "text_encoder": torch.float32,
            "safety_checker": torch.float32}
    if not isinstance(checker, SafetyChecker) or any(placed[n] != ({device}, {want[n]}) for n in placed):
        fail(f"the loader placed the SD1.5 modules at {placed}; every module on the card, the UNet in bf16, the "
             f"rest in f32 expected")
    if (pipe.unet.config != loader.unet_config_from_diffusers(configs["unet"])
            or not isinstance(pipe.scheduler, DDIMScheduler)):
        fail(f"the loaded UNet config {pipe.unet.config} is not the written one, or the scheduler is not DDIM")
    print(f"safety checker: CLIP vision {checker.config}, {checker.concept_embeds.shape[0]} concepts, "
          f"{checker.special_care_embeds.shape[0]} special", flush=True)

    runs = []
    checker.register_forward_hook(lambda m, i, o: runs.append(int(o.shape[0])))
    gen = torch.Generator(device=device).manual_seed(4)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)
    px = pipe.unet.config.sample_size * 2 ** (len(pipe.vae.config.block_out_channels) - 1)
    images, counts, times, decoder_inputs, elapsed, peak = run_image_path(
        pipe, pipe.vae, lambda: pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", size=7,
                                                 num_inference_steps=steps), steps, 7)
    check_images(f"SD1.5 interpolate with the safety checker ({steps} DDIM steps)", images, (7, px, px, 3), times,
                 elapsed, peak, card)
    check_path("SD1.5 with the safety checker", counts,
               ("flash_interpolated_attention[D=40]", "flash_interpolated_attention[D=80]",
                "flash_interpolated_attention[D=160]", "flash_self_attention_f32"))
    if runs != [7]:
        fail(f"the safety checker ran on {runs} frames; once on the 7 frames of the decode expected")
    black = [bool((im == 0).all()) for im in images]
    print(f"the written checker (N(0, 0.02) thresholds) blacked out {sum(black)} of 7 frames: {black}", flush=True)

    # the checker alone, timed on the decode's frames
    _, flags = pipe.run_safety(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        pipe.run_safety(images)
    torch.cuda.synchronize()
    print(f"safety checker: {(time.perf_counter() - t0) / reps / 7:.4f} s per frame (7 frames of {px}px, f32 CLIP "
          f"vision tower at {checker.config.image_size}px, resize included) on {card}; flags {flags.tolist()}",
          flush=True)

    # rigged both ways, through the pipeline's decode
    z = decoder_inputs[0] * pipe.vae.config.scaling_factor
    for thresh, want_black in ((-10.0, True), (10.0, False)):
        with torch.no_grad():
            checker.concept_embeds_weights.fill_(thresh)
            checker.special_care_embeds_weights.fill_(thresh)
        out = pipe._decode(z)
        got = [bool((im == 0).all()) for im in out]
        ok = got == [want_black] * 7
        print(f"thresholds rigged to {thresh:+.0f}: frames black {got}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the rigged safety checker ({thresh:+.0f}) left frames black {got}; {want_black} for all expected")
    if runs != [7] * (reps + 4):
        fail(f"the safety checker ran {len(runs)} times; once a decode or run_safety call ({reps + 4}) expected")
    return pipe, counts


def seeded_lpips(device, seed: int = 0):
    """Full-width VGG16 LPIPS with random weights from a seeded generator:
    He-normal convs (the features keep their scale through 13 layers),
    zero biases, non-negative heads as trained LPIPS heads are."""
    import torch

    from aid_tpu_torch.metrics.lpips import LPIPS

    model = LPIPS(device=device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("lin"):
                p.uniform_(0.0, 0.2, generator=gen)
            elif name.endswith("weight"):
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5, generator=gen)
            else:
                p.zero_()
    return model


def phase_selection(pipe, card: str, scorer_cfg=None):
    """PAID coefficient selection on phase 15's pipeline (bf16 UNet, f32 VAE,
    the safety checker on every decode, thresholds at +10): the Beta-prior
    ``generate_interpolation`` with a CLIP ViT-B/32 scorer (openai/
    clip-vit-base-patch32's published config, f32 N(0, 0.02) weights),
    exploration 16 and selection 7 with batch_k 4, then 1 (the scorer's
    weights initialised as transformers initialises CLIP: N(0, 0.02), norm
    scales 1, biases 0; with N(0, 0.02) norm scales its features barely
    differ between frames and the Beta fits degenerate); the batched
    exploration's middles against interpolate_single (with a planted t
    fault); the Bayesian (alpha, beta) search at size 3 with full-width
    VGG16 LPIPS. Stage times, launches by head dim. Returns the paths'
    launch counts. ``scorer_cfg`` exists for rehearsing on the CPU."""
    import numpy as np
    import torch

    from aid_tpu_torch.metrics.lpips import compute_lpips
    from aid_tpu_torch.models.clip import CLIPVisionModel
    from aid_tpu_torch.models.configs import CLIP_VIT_B32_VISION
    from aid_tpu_torch.prior.bayes import bayesian_prior_selection
    from aid_tpu_torch.prior import dp_solver
    from aid_tpu_torch.prior.beta import BetaPriorPipeline
    from aid_tpu_torch.prior.clip_scorer import make_clip_feature_fn

    steps = SD15_STEPS
    print(f"== phase 16: PAID selection on phase 15's pipeline: Beta prior (exploration {SELECT_EXPLORATION}, "
          f"selection {SELECT_SIZE}, batch_k 4 then 1, CLIP ViT-B/32 scorer), the batched exploration against "
          f"interpolate_single, Bayesian (alpha, beta) search with VGG16 LPIPS (size 3)", flush=True)
    print(f"depth: {steps} DDIM steps (not cut); Bayesian search at most {BAYES_ITERS} GP iterations after its 3x3 "
          f"grid (cut from 15), target_score 1.0 so that no probe ends it early", flush=True)
    dev = pipe.device
    vision = CLIPVisionModel(scorer_cfg or CLIP_VIT_B32_VISION, device=dev).eval()
    px = pipe.unet.config.sample_size * 2 ** (len(pipe.vae.config.block_out_channels) - 1)
    gen = torch.Generator(device=dev).manual_seed(11)
    norms = {f"{n}.weight" for n, m in vision.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    with torch.no_grad():
        for name, p in vision.named_parameters():
            if name in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    latent_a, latent_b = pipe._seeded_latent(21), pipe._seeded_latent(22)
    stages, decodes = {}, []
    real_decode = pipe.vae.decode

    def decode_checked(z):
        decodes.append(bool(torch.isfinite(z).all()))
        return real_decode(z)

    heads = ("flash_interpolated_attention[D=40]", "flash_interpolated_attention[D=80]",
             "flash_interpolated_attention[D=160]")
    paths = []
    pipe.vae.decode = decode_checked
    try:
        for batch_k in (4, 1):
            stages.clear(), decodes.clear()
            bp = BetaPriorPipeline(pipe, timed(make_clip_feature_fn(vision), stages, "clip"))
            bp._gen, bp._gen_batch = timed(bp._gen, stages, "explore"), timed(bp._gen_batch, stages, "explore")
            chosen = []
            real_select = bp.extract_uniform_points_plus

            def select(*args, _real=real_select):
                chosen[:] = _real(*args)
                return chosen

            bp.extract_uniform_points_plus = timed(select, stages, "dp")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            frames = bp.generate_interpolation("prompt A", "prompt B", latent_start=latent_a, latent_end=latent_b,
                                               num_inference_steps=steps, exploration_size=SELECT_EXPLORATION,
                                               interpolation_size=SELECT_SIZE, batch_k=batch_k)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            counts = read_counts()
            coefs = [bp.xs[i] for i in chosen]
            label = f"Beta-prior selection, batch_k {batch_k}"
            print(f"{label}: {total:.2f} s in all on {card}: explore {sum(stages['explore']):.2f} s in "
                  f"{len(stages['explore'])} runs, CLIP scoring {sum(stages['clip']):.3f} s in {len(stages['clip'])} "
                  f"calls, DP {sum(stages['dp']) * 1e3:.2f} ms, {len(decodes)} decodes; alpha {bp.alpha:.4f} beta "
                  f"{bp.beta_param:.4f}", flush=True)
            print(f"{label}: explored {len(bp.xs)} coefficients {[round(x, 4) for x in bp.xs]}; selected "
                  f"{chosen} -> {[round(c, 4) for c in coefs]}; adjacent CLIP distances "
                  f"{[float(f'{d:.3e}') for d in bp.ds]}; DP solver "
                  f"{'native ' + dp_solver.library_path().name if dp_solver.library_path().exists() else 'Python'}",
                  flush=True)
            print(f"{label}: launches of the bf16 attention by head dim "
                  f"{ {h.split('[')[1][:-1]: counts[h] for h in heads} }, of the f32 D=512 attention "
                  f"{counts['flash_self_attention_f32']}", flush=True)
            ok = (len(frames) == SELECT_SIZE and len(bp.xs) == SELECT_EXPLORATION and coefs == sorted(coefs)
                  and coefs[0] == 0.0 and coefs[-1] == 1.0 and all(0.0 <= c <= 1.0 for c in bp.xs)
                  and all(f.shape == (px, px, 3) and f.dtype == np.uint8 for f in frames) and all(decodes))
            if not ok:
                fail(f"{label}: {len(frames)} frames, {len(bp.xs)} explored, coefficients {coefs}, decoder inputs "
                     f"finite {all(decodes)}")
            check_path(label, counts, heads + ("flash_self_attention_f32",))
            if counts["flash_self_attention_f32"] != len(decodes):
                fail(f"{label}: {counts['flash_self_attention_f32']} f32 D=512 launches for {len(decodes)} decodes")
            paths.append(counts)
    finally:
        del pipe.vae.decode

    # the batched exploration: each middle against interpolate_single at its t
    bp = BetaPriorPipeline(pipe, None)
    kw = dict(prompt_start="prompt A", prompt_end="prompt B", latent_start=latent_a, latent_end=latent_b,
              num_inference_steps=steps)
    ts = [0.62, 0.31]
    middles = bp._gen_batch(ts, **kw)

    def rel(a, b):
        return float(np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b.astype(np.float64)))

    singles = [bp._gen(t, **kw)[1] for t in ts]
    sound = [rel(m, s) for m, s in zip(middles, singles)]
    fault = [rel(middles[0], bp._gen(ts[0] + 0.05, **kw)[1])]
    check_bound("_gen_batch middles vs interpolate_single at the same t (uint8 frames)", sound, fault,
                SELECT_BATCH_TOL, "t shifted by 0.05")

    # the Bayesian (alpha, beta) search
    lpips = seeded_lpips(dev)
    lpips_pair = []

    def lpips_fn(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = compute_lpips(images, lpips)
        torch.cuda.synchronize()
        lpips_pair.append((time.perf_counter() - t0) / (len(images) - 1))
        return d

    stages.clear()
    pipe.interpolate_save_gpu = timed(pipe.interpolate_save_gpu, stages, "objective")
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        # target_score 1.0 (equal distances) is out of reach, so the search
        # runs its grid and GP iterations instead of leaving at a probe
        a, b = bayesian_prior_selection(pipe, latent_a, latent_b, "prompt A", "prompt B", lpips_fn, size=3,
                                        num_inference_steps=steps, n_iter=BAYES_ITERS, target_score=1.0)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
    finally:
        del pipe.interpolate_save_gpu
    # the GP's search window keeps a minimum width of 0.1 (bayes.py's
    # GPOptimizer, as the JAX package's), so a suggestion may lie up to 0.1
    # past the box's upper edge
    p_max = float(steps) + 0.1
    print(f"Bayesian selection: (alpha, beta) = ({a:.4f}, {b:.4f}) in {total:.2f} s on {card}: "
          f"{len(stages.get('objective', []))} objective runs ({sum(stages.get('objective', [])):.2f} s), LPIPS "
          f"{len(lpips_pair)} calls, {float(np.median(lpips_pair)) * 1e3:.2f} ms per pair (median, {px}px, f32)",
          flush=True)
    if not (1.0 <= a <= p_max and 1.0 <= b <= p_max and lpips_pair):
        fail(f"Bayesian selection returned ({a}, {b}) outside [1, {p_max}] or ran no LPIPS")
    check_path("Bayesian selection", counts, heads + ("flash_self_attention_f32",))
    paths.append(counts)
    return paths


# The IP-Adapter UNet forwards of phase 17 (SD 1.5, bf16, 7 frames), kernels
# vs plain: the LARGEST PER-FRAME relative L2, as SD15_UNET_TOL, whose
# reasoning they share (each cross layer adds one IP attention call, ~0.3%
# from its plain version in bf16, like every other call). On an H100 (these
# seeds): sound 2.83-3.19e-3 in the four forwards; the planted faults: IP
# endpoints swapped 1.27e-2 / 2.36e-2 (Plus, fused_outer / pure_inner) and
# 9.80e-3 (4 tokens; the endpoint frames move, the interior ones by
# |1 - 2c| of it), ip_scale dropped (weight 1) 9.9e-2 to 1.2e-1; in scale control
# fused_outer computed as self 3.75e-2 and the coefficient weight dropped
# 2.26e-1. 4.5e-3 lies between: 1.4x the largest sound reading, 0.46x the
# smallest fault. Phase 17 measures every fault in every run.
IP_UNET_TOL = SD15_UNET_TOL
# The adapters of phase 17: the scale they are loaded with (h94's examples
# use 0.5-1.0), the Plus resampler at h94's ip-adapter-plus_sd15 widths
# (ViT-H/14 penultimate states of 1280, hidden 768, depth 4, 12 heads of 64,
# 16 queries); the standard adapter takes ViT-H/14's projected embeds (1024).
IP_SCALE = 0.5
IP_PLUS_WIDTHS = dict(embed_dim=1280, hidden_dim=768, depth=4, heads=12, num_queries=16)


def seed_adapter_module(module, gen):
    """Random weights as transformers and diffusers initialise theirs:
    weights (and the resampler's latents) N(0, 0.02) from ``gen``, biases
    0, LayerNorm scales 1. With N(0, 0.02) norm scales the image tokens
    would come out ~50x smaller than the text tokens, and the IP branch
    would sink under bf16's noise."""
    import torch

    norms = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return module.eval()


def write_ip_adapter(path: str, unet, image_proj, gen) -> dict:
    """An IP-Adapter checkpoint for ``unet`` in the published files' own
    layout and dtype (f16), one ``.safetensors`` file: ``image_proj.*``
    (``image_proj``'s state_dict) and ``ip_adapter.<idx>.to_{k,v}_ip.weight``
    at idx 1, 3, ... in the UNet's attention-processor order (down, up, mid
    last: 1..31 for SD 1.5), N(0, 0.02) from ``gen`` at each layer's width.
    Returns the tensors written."""
    import torch

    from aid_tpu_torch.models.params import unet_attention_order
    from aid_tpu_torch.utils.safetensors import save_safetensors

    tensors = {f"image_proj.{k}": v for k, v in image_proj.state_dict().items()}
    for i, name in enumerate(unet_attention_order(unet.config)):
        attn = unet.get_submodule(name)
        for proj in ("to_k_ip", "to_v_ip"):
            shape = getattr(attn, proj).weight.shape
            tensors[f"ip_adapter.{2 * i + 1}.{proj}.weight"] = torch.empty(
                shape, device=gen.device).normal_(0.0, 0.02, generator=gen)
    tensors = {k: v.detach().to("cpu", torch.float16).contiguous() for k, v in tensors.items()}
    save_safetensors(tensors, path)
    return tensors


def check_ip_loaded(label: str, pipe, written: dict, plus: bool) -> None:
    """The written file came back through ``load_aid_ip_adapter``: every
    ``ip_adapter`` weight in its UNet layer (in the UNet's dtype), the
    projection's state equal to ``image_proj`` (in f32), the kind detected."""
    import torch

    from aid_tpu_torch.models.ip_adapter import ImageProjection, Resampler
    from aid_tpu_torch.models.params import unet_attention_order

    params = dict(pipe.unet.named_parameters())
    order = unet_attention_order(pipe.unet.config)
    bad = []
    for key, w in written.items():
        group, rest = key.split(".", 1)
        if group == "ip_adapter":
            idx, proj, _ = rest.split(".")
            got = params[f"{order[(int(idx) - 1) // 2]}.{proj}.weight"]
            ok = torch.equal(got.cpu(), w.to(got.dtype))
        else:
            ok = torch.equal(pipe.ip_proj.state_dict()[rest].cpu(), w.float())
        if not ok:
            bad.append(key)
    kind = Resampler if plus else ImageProjection
    print(f"{label}: {len(written)} tensors loaded ({len(order)} cross-attention layers), projection "
          f"{type(pipe.ip_proj).__name__}, plus={pipe.ip_plus}", flush=True)
    if bad or pipe.ip_plus != plus or not isinstance(pipe.ip_proj, kind):
        fail(f"{label}: the file did not load back: {bad[:4]}, plus={pipe.ip_plus}, {type(pipe.ip_proj).__name__}")


def ip_swapped_endpoints(tokens: int):
    """A planted fault: the begin and end endpoints exchanged in the IP
    branch's calls only (the plain attention's calls over ``tokens`` keys)."""
    def plant(plain):
        swapped = swapped_endpoints(plain)

        def fault(q, k, v, *args, **kwargs):
            return (swapped if k.shape[-2] == tokens else plain)(q, k, v, *args, **kwargs)
        return fault
    return plant


def expected_attention_launches(unet, with_ip: bool) -> dict:
    """Attention calls of one forward by head dim: each transformer block's
    self- and cross-attention, and its IP call where ``with_ip``."""
    from aid_tpu_torch.models.layers import CrossAttention
    from aid_tpu_torch.ops.flash_attention import padded_head_dim

    want = {}
    for m in unet.modules():
        if isinstance(m, CrossAttention):
            d = padded_head_dim(m.head_dim)
            want[d] = want.get(d, 0) + 1 + int(with_ip and m.has_ip)
    return want


def phase_ip_adapter(card: str, unet_cfg=None, text_cfg=None, vae_cfg=None, vision_cfg=None, plus_widths=None,
                     device: str = "cuda") -> list:
    """IP-Adapter on the full-width SD 1.5 UNet (bf16, N(0, 0.02) weights)
    with 16 image tokens: a Plus adapter at h94's ip-adapter-plus_sd15
    widths written as one .safetensors file in the published layout and
    loaded with ``load_aid_ip_adapter(path)``, a random ViT-H/14
    ``CLIPVisionModel`` (f32) as its image encoder. (a) one forward, 7
    frames, kernels vs plain, with the IP branch in fused_outer, in
    pure_inner and in scale control, each with two planted faults; the
    bf16 attention's launches by head dim must count the IP calls; (b)
    ``interpolate_single(0.5)`` from two seeded random 224px images through
    ``encode_image`` (penultimate states), 25 DDIM steps, s/step; (c) the
    same in scale control, ``image_embeds_start=None``; (d) a standard
    4-token adapter (ImageProjection 1024 -> 4 x 768) on a UNet with 4 IP
    tokens: the forward check of (a) in fused_outer. The pipeline's text
    encoder (CLIP ViT-L) and VAE are random f32 modules as phase 10's.
    Returns the launch counts of (b) and (c). The other arguments exist for
    rehearsing on the CPU at a tiny size."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aid_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
    from aid_tpu_torch.models.configs import CLIP_VIT_H_VISION, CLIP_VIT_L_TEXT, SD15_UNET, SD_VAE
    from aid_tpu_torch.models.ip_adapter import ImageProjection, Resampler
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    steps = SD15_STEPS
    unet_cfg, text_cfg, vae_cfg = unet_cfg or SD15_UNET, text_cfg or CLIP_VIT_L_TEXT, vae_cfg or SD_VAE
    vision_cfg, plus_widths = vision_cfg or CLIP_VIT_H_VISION, plus_widths or IP_PLUS_WIDTHS
    nq = plus_widths["num_queries"]
    print(f"== phase 17: IP-Adapter on the SD1.5 UNet: a Plus adapter ({nq} tokens, resampler {plus_widths}) "
          f"and a standard one (4 tokens), written as .safetensors and loaded with load_aid_ip_adapter(path); "
          f"forwards kernels vs plain (fused_outer, pure_inner, scale_control IP), interpolate_single(0.5) "
          f"through encode_image ({steps} DDIM steps), scale control", flush=True)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(17)
    torch.manual_seed(9)  # the text encoder's and VAE's default initialisations draw from it
    with torch.no_grad():
        text = CLIPTextModel(text_cfg, device=dev).eval()
        vae = AutoencoderKL(vae_cfg, device=dev).eval()
        encoder = seed_adapter_module(CLIPVisionModel(vision_cfg, device=dev), gen)
    px = unet_cfg.sample_size * 2 ** (len(vae_cfg.block_out_channels) - 1)
    size = vision_cfg.image_size
    images = (torch.rand((9, size, size, 3), generator=gen, device=dev) * 255).to(torch.uint8).cpu().numpy()
    frames = 7
    coef = sd15_coef().to(dev)
    s = unet_cfg.sample_size
    sample = torch.randn((frames, unet_cfg.in_channels, s, s), generator=gen, device=dev).to(torch.bfloat16)
    ehs = torch.randn((frames, 77, unet_cfg.cross_attention_dim), generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor(500, device=dev)
    heads = tuple(f"flash_interpolated_attention[D={d}]" for d in (40, 80, 160)) + (
        "flash_interpolated_attention[onepass]",)

    def pipeline(tokens: int, hidden_dim: int):
        cfg = dataclasses.replace(unet_cfg, ip_num_tokens=tokens, ip_hidden_dim=hidden_dim)
        unet = build_sd15(seed=17 + tokens, cfg=cfg, device=device)
        return InterpolationPipeline(unet=unet, vae=vae, text_encoder=text,
                                     tokenizer=HashTokenizer(text_cfg.vocab_size), scheduler=DDIMScheduler())

    def check_forwards(pipe, label, ways):
        """The forward check of (a)/(d) in each IP way, on image tokens
        projected from 7 of the random images."""
        tokens = pipe._project_ip(pipe.encode_image(images[:frames]))
        T = tokens.shape[1]
        want = expected_attention_launches(pipe.unet, with_ip=True)
        for way in ways:
            if way == "scale_control":
                aid = AidContext(coef=coef, mode=AidMode.from_name("scale_control"), ip_hidden_states=tokens,
                                 ip_scale=IP_SCALE)
                faults = {"fused_outer->self": (dataclasses.replace(aid, mode=AidMode.vanilla(scale_control=True)),
                                                None),
                          "coef weight dropped": (dataclasses.replace(aid, mode=AidMode.vanilla(has_ip=True),
                                                                      ip_scale=1.0), None)}
            else:
                aid = AidContext(coef=coef, mode=AidMode.from_name(way, has_ip=True), ip_hidden_states=tokens,
                                 ip_scale=IP_SCALE)
                faults = {"IP endpoints swapped": (aid, ip_swapped_endpoints(T)),
                          "ip_scale dropped": (dataclasses.replace(aid, ip_scale=1.0), None)}
            counts = check_unet_vs_plain(f"{label} {way} B={frames} {s}x{s}, {T} IP tokens",
                                         lambda a: pipe.unet(sample, t, ehs, a), aid, IP_UNET_TOL, faults)
            got = {d: counts[f"flash_interpolated_attention[D={d}]"] for d in want}
            print(f"  attention launches by head dim {got}: self + text cross + IP calls {want}", flush=True)
            if got != want:
                fail(f"{label} {way}: bf16 attention launches by head dim {got}, want {want} (the IP calls included)")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ip-adapter-", dir=os.path.join(ROOT, "build"))
    try:
        # the Plus adapter
        pipe = pipeline(nq, plus_widths["embed_dim"])
        resampler = seed_adapter_module(Resampler(unet_cfg.cross_attention_dim, device=dev, **plus_widths), gen)
        path = os.path.join(root, "ip-adapter-plus_sd15.safetensors")
        written = write_ip_adapter(path, pipe.unet, resampler, gen)
        del resampler
        pipe.load_aid_ip_adapter(path, image_encoder=encoder, scale=IP_SCALE)
        check_ip_loaded("Plus adapter", pipe, written, plus=True)
        check_forwards(pipe, "unet SD1.5 + IP-Adapter-Plus", ("fused_outer", "pure_inner", "scale_control"))

        # (b) interpolate_single from two images, (c) the same in scale control
        latent_a, latent_b = pipe._seeded_latent(31), pipe._seeded_latent(32)
        paths = []
        for sc in (False, True):
            label = "interpolate_single(0.5) " + ("scale control, image_embeds_start=None" if sc else
                                                  "from two images")
            e0, e1 = (pipe.encode_image(images[7 + i:8 + i]) for i in range(2))
            if tuple(e1.shape) != (1, (size // vision_cfg.patch_size) ** 2 + 1, vision_cfg.hidden_size):
                fail(f"encode_image gave {tuple(e1.shape)}, not the penultimate hidden states")
            kw = dict(image_embeds_start=None if sc else e0, image_embeds_end=e1, num_inference_steps=steps,
                      early="scale_control" if sc else "fused_outer")
            walls = []
            for run in range(3):  # the first one checked and counted, then two warm ones timed
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                latents = pipe.interpolate_single(0.5, latent_a, latent_b, "prompt A", "prompt B",
                                                  output_type="latent", **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if run == 0:
                    counts = read_counts()
            frames_out = pipe._decode(latents)
            ok = (tuple(latents.shape) == (3, unet_cfg.in_channels, s, s) and bool(torch.isfinite(latents).all())
                  and frames_out.shape == (3, px, px, 3) and frames_out.dtype == np.uint8)
            print(f"{label}: {steps} steps, s/step {walls[0] / steps:.4f} (first), warm best "
                  f"{min(walls[1:]) / steps:.4f} of {[round(w / steps, 4) for w in walls[1:]]} on {card}; latents "
                  f"finite {bool(torch.isfinite(latents).all())}, frames {frames_out.shape} {frames_out.dtype}  "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{label}: latents {tuple(latents.shape)}, frames {frames_out.shape}")
            check_path(label, counts, heads)
            paths.append(counts)
        del pipe

        # (d) the standard 4-token adapter
        pipe = pipeline(4, vision_cfg.projection_dim)
        proj = seed_adapter_module(ImageProjection(vision_cfg.projection_dim, unet_cfg.cross_attention_dim, 4,
                                                   device=dev), gen)
        path = os.path.join(root, "ip-adapter_sd15.safetensors")
        written = write_ip_adapter(path, pipe.unet, proj, gen)
        pipe.load_aid_ip_adapter(path, image_encoder=encoder, scale=IP_SCALE)
        check_ip_loaded("standard adapter", pipe, written, plus=False)
        check_forwards(pipe, "unet SD1.5 + IP-Adapter", ("fused_outer",))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths

# ---------------------------------------------------------------------------
# phase 18: what users load into a pipeline (single files, LoRA, textual
# inversion, pre-computed embeddings, exported latents)
# ---------------------------------------------------------------------------

# The LoRA of phase 18 (c): rank 8, alpha 16, merged at scale 0.75, so each
# update is 1.5 * B @ A; factors N(0, 0.02) in f16, as published LoRAs ship.
LORA_RANK, LORA_ALPHA, LORA_SCALE = 8, 16.0, 0.75
# The textual-inversion placeholder of phase 18 (d), two vectors.
TI_TOKEN = "<aid-concept>"

# LDM <-> diffusers names, written here from the LDM layout itself so that
# phase 18's files do not come from the port's own map (models/params.py):
# a UNet resnet's sub-modules, and the VAE mid block's attention.
_LDM_RESNET = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
               "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_LDM_VAE_ATTENTION = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out"}


def ldm_unet_key(key: str, cfg) -> str:
    """A diffusers UNet key -> its name in an LDM checkpoint (under
    ``model.diffusion_model.``). LDM numbers each side's blocks flat:
    ``input_blocks.0`` is conv_in, then per level its resnets (sub-module 0)
    with their attentions (1) and the downsampler's slot (``op``);
    ``output_blocks`` per up block its resnets and attentions, the upsampler
    after them (sub-module 2 where the block has attention, else 1)."""
    import re

    per, lb = cfg.layers_per_block + 1, cfg.layers_per_block

    def resnet(rest):
        head, _, tail = rest.partition(".")
        return f"{_LDM_RESNET.get(head, head)}.{tail}"

    m = re.fullmatch(r"(time_embedding|add_embedding)\.linear_([12])\.(.+)", key)
    if m:
        stem = "time_embed" if m[1] == "time_embedding" else "label_emb.0"
        return f"{stem}.{2 * (int(m[2]) - 1)}.{m[3]}"
    for name, ldm in (("conv_in.", "input_blocks.0.0."), ("conv_norm_out.", "out.0."), ("conv_out.", "out.2.")):
        if key.startswith(name):
            return ldm + key[len(name):]
    m = re.fullmatch(r"down_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.+)", key)
    if m:
        i = 1 + int(m[1]) * per + int(m[3])
        return f"input_blocks.{i}.0.{resnet(m[4])}" if m[2] == "resnets" else f"input_blocks.{i}.1.{m[4]}"
    m = re.fullmatch(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.+)", key)
    if m:
        return f"input_blocks.{1 + int(m[1]) * per + lb}.0.op.{m[2]}"
    m = re.fullmatch(r"mid_block\.resnets\.([01])\.(.+)", key)
    if m:
        return f"middle_block.{2 * int(m[1])}.{resnet(m[2])}"
    if key.startswith("mid_block.attentions.0."):
        return "middle_block.1." + key[len("mid_block.attentions.0."):]
    m = re.fullmatch(r"up_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.+)", key)
    if m:
        i = int(m[1]) * per + int(m[3])
        return f"output_blocks.{i}.0.{resnet(m[4])}" if m[2] == "resnets" else f"output_blocks.{i}.1.{m[4]}"
    m = re.fullmatch(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.+)", key)
    if m:
        b = int(m[1])
        sub = 2 if cfg.cross_attention_levels[cfg.num_levels - 1 - b] else 1
        return f"output_blocks.{b * per + lb}.{sub}.conv.{m[2]}"
    raise KeyError(f"no LDM name for the UNet key {key}")


def ldm_vae_key(key: str, num_levels: int) -> str:
    """A diffusers VAE key -> its LDM name (under ``first_stage_model.``):
    ``mid.block_1/2``, ``mid.attn_1.{norm,q,k,v,proj_out}``, ``down.i`` and
    ``up.i`` with the decoder's levels numbered high-resolution first,
    ``nin_shortcut``, ``norm_out``."""
    import re

    side, _, rest = key.partition(".")
    rest = rest.replace("conv_shortcut", "nin_shortcut").replace("conv_norm_out", "norm_out")
    m = re.fullmatch(r"mid_block\.resnets\.([01])\.(.+)", rest)
    if m:
        return f"{side}.mid.block_{int(m[1]) + 1}.{m[2]}"
    m = re.fullmatch(r"mid_block\.attentions\.0\.(group_norm|to_q|to_k|to_v|to_out\.0)\.(.+)", rest)
    if m:
        return f"{side}.mid.attn_1.{_LDM_VAE_ATTENTION[m[1]]}.{m[2]}"
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(resnets|downsamplers|upsamplers)\.(\d+)\.(.+)", rest)
    if m:
        level = int(m[2]) if m[1] == "down" else num_levels - 1 - int(m[2])
        if m[3] == "resnets":
            return f"{side}.{m[1]}.{level}.block.{m[4]}.{m[5]}"
        return f"{side}.{m[1]}.{level}.{m[1]}sample.{m[5]}"
    return f"{side}.{rest}" if rest else key  # conv_in, conv_out, norm_out; the quant convs


def open_clip_text_state_dict(sd: dict) -> dict:
    """A transformers CLIPTextModel state dict -> OpenCLIP's text-tower
    names: ``transformer.resblocks.N`` with q/k/v packed into
    ``attn.in_proj_{weight,bias}``, ``positional_embedding``, ``ln_final``,
    and ``text_projection`` stored as the (width, proj) matrix OpenCLIP
    multiplies by."""
    import re

    import torch

    leaves = {"self_attn.out_proj": "attn.out_proj", "layer_norm1": "ln_1", "layer_norm2": "ln_2",
              "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}
    out, packed = {}, {}
    for k, v in sd.items():
        if k == "text_model.embeddings.token_embedding.weight":
            out["token_embedding.weight"] = v
        elif k == "text_model.embeddings.position_embedding.weight":
            out["positional_embedding"] = v
        elif k.startswith("text_model.final_layer_norm."):
            out["ln_final." + k.rsplit(".", 1)[1]] = v
        elif k == "text_projection.weight":
            out["text_projection"] = v.t()
        else:
            m = re.fullmatch(r"text_model\.encoder\.layers\.(\d+)\.(.+)\.(weight|bias)", k)
            qkv = re.fullmatch(r"self_attn\.([qkv])_proj", m[2])
            if qkv:
                packed.setdefault((m[1], m[3]), {})[qkv[1]] = v
            else:
                out[f"transformer.resblocks.{m[1]}.{leaves[m[2]]}.{m[3]}"] = v
    for (n, leaf), parts in packed.items():
        out[f"transformer.resblocks.{n}.attn.in_proj_{leaf}"] = torch.cat([parts["q"], parts["k"], parts["v"]])
    return out


def ldm_checkpoint(unet_sd: dict, vae_sd: dict, unet_cfg, vae_levels: int, towers: dict) -> dict:
    """One LDM-layout state dict: the UNet under ``model.diffusion_model.``,
    the VAE under ``first_stage_model.`` with its mid-block attention as
    1x1 convs, and each text tower's (already named) state dict under its
    prefix in ``towers``."""
    out = {"model.diffusion_model." + ldm_unet_key(k, unet_cfg): v for k, v in unet_sd.items()}
    for k, v in vae_sd.items():
        name = ldm_vae_key(k, vae_levels)
        out["first_stage_model." + name] = v.reshape(*v.shape, 1, 1) if ".mid.attn_1." in name and v.dim() == 2 else v
    for prefix, sd in towers.items():
        out.update({prefix + k: v for k, v in sd.items()})
    return out


def seeded_modules(modules: dict, gen) -> dict:
    """Every parameter of each module ~ N(0, 0.02) from ``gen``, drawn as
    build_headline draws (modules in the given order); their state dicts."""
    import torch

    with torch.no_grad():
        for m in modules.values():
            for p in m.parameters():
                p.normal_(0.0, 0.02, generator=gen)
    return {name: m.eval().state_dict() for name, m in modules.items()}


def check_sdxl_single_file_layout(device: str = "cuda", cfgs: dict = None) -> None:
    """Phase 18 (b): the SDXL single-file layout at full width, in memory.
    Phase 5's headline UNet (the same seeded bf16 draw), a CLIP ViT-L and an
    OpenCLIP bigG tower with its projection (f32) and an SDXL VAE (f32),
    N(0, 0.02) on the card, mapped to LDM names by this script's map (bigG
    in OpenCLIP naming: q/k/v packed, the projection transposed, a
    logit_scale; a model_ema entry besides) and back through
    ``convert_ldm_checkpoint_xl``: every key and tensor must come back, none
    dropped, none added."""
    import torch

    from aid_tpu_torch.models import configs as C
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.params import convert_ldm_checkpoint_xl
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL

    cfgs = cfgs or {"unet": C.SDXL_UNET, "vae": C.SDXL_VAE, "text": C.CLIP_VIT_L_TEXT,
                    "text_2": C.SDXL_TEXT_ENCODER_2}
    dev = torch.device(device)
    t0 = time.perf_counter()
    sds = seeded_modules({"unet": UNet2DCondition(cfgs["unet"], device=dev, dtype=torch.bfloat16),
                          "vae": AutoencoderKL(cfgs["vae"], device=dev),
                          "text": CLIPTextModel(cfgs["text"], device=dev),
                          "text_2": CLIPTextModel(cfgs["text_2"], device=dev)},
                         torch.Generator(device=dev).manual_seed(0))
    levels = len(cfgs["vae"].block_out_channels)
    ldm = ldm_checkpoint(sds["unet"], sds["vae"], cfgs["unet"], levels,
                         {"conditioner.embedders.0.transformer.": sds["text"],
                          "conditioner.embedders.1.model.": open_clip_text_state_dict(sds["text_2"])})
    ldm["conditioner.embedders.1.model.logit_scale"] = torch.tensor(4.6052, device=dev)
    ldm["model_ema.decay"] = torch.tensor(0.9999, device=dev)
    back = dict(zip(("unet", "vae", "text", "text_2"), convert_ldm_checkpoint_xl(
        ldm, layers_per_block=cfgs["unet"].layers_per_block, vae_levels=levels)))
    for name, want in sds.items():
        got = back[name]
        if got.keys() != want.keys():
            fail(f"SDXL single-file {name}: {len(set(want) - set(got))} keys dropped, {len(set(got) - set(want))} "
                 f"added, e.g. {sorted(set(want) ^ set(got))[:4]}")
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        if differ:
            fail(f"SDXL single-file {name}: {len(differ)} tensors differ after the round trip, e.g. {differ[:3]}")
    unet_keys = back["unet"]
    depth = 1 + max(int(k.split(".")[5]) for k in unet_keys if k.startswith("down_blocks.") and
                    ".transformer_blocks." in k)
    label_emb = sum(k.startswith("add_embedding.") for k in unet_keys)
    print(f"SDXL single-file layout in memory, {len(ldm)} LDM keys: unet {len(unet_keys)}, vae {len(back['vae'])}, "
          f"CLIP-L {len(back['text'])}, bigG {len(back['text_2'])} keys, every tensor back bit for bit, none "
          f"dropped or added (down-block transformer depth {depth}, {label_emb} label_emb keys) in "
          f"{time.perf_counter() - t0:.2f} s  ok", flush=True)


def single_file_lora(unet, gen) -> tuple:
    """Phase 18 (c)'s LoRA for ``unet``: rank LORA_RANK, alpha LORA_ALPHA,
    f16 factors ~ N(0, 0.02) from the host generator ``gen``. PEFT names
    (``unet.<module>.lora_A/B.weight`` and ``.alpha``) on every attn1 /
    attn2 to_q, to_k, to_v and to_out.0; kohya names
    (``lora_unet_<module with _>.lora_down/up.weight``, ``.alpha``) on every
    feed-forward's two Linears and, 4-D, on ``down_blocks.0.resnets.0.conv1``.
    Returns (the LoRA state dict, the target weight's name -> its (A, B))."""
    import torch

    r, alpha = LORA_RANK, torch.tensor(LORA_ALPHA)
    lora, targets = {}, {}

    def add(module, peft):
        w = unet.get_submodule(module).weight
        rest = tuple(w.shape[2:])
        A = (torch.randn((r, w.shape[1], *rest), generator=gen) * 0.02).half()
        B = (torch.randn((w.shape[0], r, *(1 for _ in rest)), generator=gen) * 0.02).half()
        targets[f"{module}.weight"] = (A, B)
        if peft:
            lora.update({f"unet.{module}.lora_A.weight": A, f"unet.{module}.lora_B.weight": B,
                         f"unet.{module}.alpha": alpha})
        else:
            stem = "lora_unet_" + module.replace(".", "_")
            lora.update({f"{stem}.lora_down.weight": A, f"{stem}.lora_up.weight": B, f"{stem}.alpha": alpha})

    for name, _ in unet.named_modules():
        if name.endswith((".attn1", ".attn2")):
            for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                add(f"{name}.{proj}", peft=True)
        elif name.endswith(".ff"):
            for proj in ("net.0.proj", "net.2"):
                add(f"{name}.{proj}", peft=False)
    add("down_blocks.0.resnets.0.conv1", peft=False)
    return lora, targets


def check_lora_merge(unet, lora: dict, targets: dict):
    """``merge_lora(unet, lora, LORA_SCALE)``: every target weight bit-equal
    to W + cast(LORA_SCALE * alpha / r * B @ A), the update computed on the
    host in f32 and cast to W's dtype, the sum in that dtype; every other
    tensor the caller's own (shared); the caller's UNet unchanged. Returns
    the merged UNet."""
    import numpy as np
    import torch

    from aid_tpu_torch.models.params import merge_lora

    before = {k: v.cpu().clone() for k, v in unet.state_dict().items()}
    t0 = time.perf_counter()
    merged = merge_lora(unet, lora, scale=LORA_SCALE)
    seconds = time.perf_counter() - t0
    base, got = unet.state_dict(), merged.state_dict()
    if got.keys() != base.keys():
        fail("merge_lora changed the UNet's keys")
    factor = LORA_SCALE * LORA_ALPHA / LORA_RANK
    wrong = []
    for k, (A, B) in targets.items():
        a, b = A.float().numpy(), B.float().numpy()
        delta = (b.reshape(b.shape[0], -1) @ a.reshape(a.shape[0], -1)) * np.float32(factor)
        want = before[k] + torch.from_numpy(delta.reshape(before[k].shape)).to(before[k].dtype)
        if not torch.equal(got[k].cpu(), want) or torch.equal(want, before[k]):
            wrong.append(k)
    shared = sum(got[k].data_ptr() == base[k].data_ptr() for k in base if k not in targets)
    untouched = all(torch.equal(v.cpu(), before[k]) for k, v in base.items())
    ok = not wrong and untouched and shared == len(base) - len(targets)
    print(f"merge_lora: {len(lora)} LoRA keys, {len(targets)} targets (PEFT attn1/attn2 q/k/v/out, kohya ff and one "
          f"4-D conv) in {seconds:.2f} s; {len(targets) - len(wrong)} of {len(targets)} bit-equal to W + "
          f"cast({factor} * B @ A); {shared} of {len(base) - len(targets)} other tensors shared; the caller's UNet "
          f"unchanged: {untouched}  {'ok' if ok else 'FAIL'}", flush=True)
    if wrong:
        fail(f"merge_lora: {len(wrong)} merged weights differ from W + cast(scale * alpha / r * B @ A), e.g. "
             f"{wrong[:3]}")
    if not ok:
        fail("merge_lora copied tensors it did not merge, or wrote the caller's UNet")
    return merged


def phase_single_file(card: str, configs=None, xl_cfgs=None, device: str = "cuda", steps: int = SD21_STEPS) -> list:
    """What users load into a pipeline, at SD 2.1's full width. (a) Phase
    13's seeded draw written once more as a diffusers directory and, from
    its files, as one LDM-layout .safetensors by this script's key map (the
    UNet under model.diffusion_model., the VAE under first_stage_model. with
    4-D mid-block attention convs, the ViT-H tower in OpenCLIP naming under
    cond_stage_model.model. with all 24 resblocks, a packed in_proj,
    text_projection and logit_scale); ``load_single_file_pipeline`` (timed
    with PhaseTimer) must give every UNet, VAE and (23-layer) text tensor
    bit-equal to the directory load, and ``interpolate_single(0.5)`` over
    ``steps`` UniPC steps the directory pipeline's latents bit for bit;
    loaded without ``prediction_type`` it must warn and give epsilon. (b)
    check_sdxl_single_file_layout. (c) a LoRA merged into (a)'s UNet
    (check_lora_merge), then one fused_outer forward of the merged UNet
    kernels vs plain with two planted faults. (d) a 2-vector A1111
    textual-inversion .pt loaded by path and its placeholder prompted;
    ``interpolate_single`` from ``prompt_embeds_*`` off ``encode_prompt``,
    and from the latents written as NCHW .npy and .pt and read back with
    ``load_reference_latents``: each bit-equal to (a)'s. The files go into
    the checkout's git-ignored build/ and are removed at the end. Returns
    the launch counts of (a)'s single-file run. The arguments exist for
    rehearsing on the CPU at a tiny size."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.utils.parity import load_reference_latents
    from aid_tpu_torch.utils.profiling import PhaseTimer
    from aid_tpu_torch.utils.safetensors import load_safetensors, save_safetensors

    print(f"== phase 18: SD2.1 at 768px from one LDM .safetensors (load_single_file_pipeline, UniPC, guidance "
          f"{SD21_GUIDANCE}) against the directory load of the same draw, interpolate_single ({steps} steps); the "
          f"SDXL layout in memory; a LoRA merged, forward kernels vs plain; textual inversion, prompt embeds, "
          f"exported latents", flush=True)
    configs = configs or sd21_diffusers_configs()
    dev = torch.device(device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="single-file-", dir=os.path.join(ROOT, "build"))
    paths = []
    try:
        # (a) the SD 2.1 single file
        directory, single = os.path.join(root, "sd21"), os.path.join(root, "single", "sd21-768-v.safetensors")
        t0 = time.perf_counter()
        write_checkpoint(directory, device=device, configs=configs)
        tower = open_clip_text_state_dict(load_safetensors(os.path.join(directory, "text_encoder")))
        gen = torch.Generator(device=dev).manual_seed(18)
        n = 1 + max(int(k.split(".")[2]) for k in tower if k.startswith("transformer.resblocks."))
        for k in [k for k in tower if k.startswith("transformer.resblocks.0.")]:  # the last resblock, dropped on load
            tower[k.replace(".0.", f".{n}.", 1)] = (torch.randn(tower[k].shape, generator=gen, device=dev) * 0.02).half()
        width = tower["ln_final.weight"].shape[0]
        tower["text_projection"] = (torch.randn((width, width), generator=gen, device=dev) * 0.02).half()
        tower["logit_scale"] = torch.tensor(4.6052)
        ldm = ldm_checkpoint(load_safetensors(os.path.join(directory, "unet")),
                             load_safetensors(os.path.join(directory, "vae")),
                             loader.unet_config_from_diffusers(configs["unet"]),
                             len(configs["vae"]["block_out_channels"]), {"cond_stage_model.model.": tower})
        os.makedirs(os.path.dirname(single))
        save_safetensors(ldm, single)
        print(f"wrote the SD2.1 diffusers directory and, from its files, one LDM single file ({len(ldm)} tensors, "
              f"{os.path.getsize(single) / 2**30:.2f} GiB, an OpenCLIP tower of {n + 1} resblocks) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del ldm, tower

        tokenizer = os.path.join(directory, "tokenizer")
        dir_pipe = loader.load_interpolation_pipeline(directory, scheduler_name="unipc", guidance_scale=SD21_GUIDANCE,
                                                      device=device)
        timer = PhaseTimer()
        with timer.phase("load_single_file_pipeline") as ph:
            pipe = loader.load_single_file_pipeline(single, tokenizer, scheduler_name="unipc",
                                                    prediction_type="v_prediction", guidance_scale=SD21_GUIDANCE,
                                                    device=device)
            ph.sync(pipe.unet.conv_out.weight)
        load_s = timer.totals["load_single_file_pipeline"]
        if type(pipe) is not type(dir_pipe) or pipe.scheduler != dir_pipe.scheduler:
            fail(f"the single-file pipeline is a {type(pipe).__name__} with {pipe.scheduler}, the directory's a "
                 f"{type(dir_pipe).__name__} with {dir_pipe.scheduler}")
        if (pipe.unet.config, pipe.tokenizer.pad_id, pipe.guidance_scale) != (
                dir_pipe.unet.config, dir_pipe.tokenizer.pad_id, dir_pipe.guidance_scale):
            fail("the single-file pipeline's UNet config, pad id or guidance differs from the directory's")
        text_cfg = pipe.text_encoder.config
        equal = {}
        for name in ("unet", "vae", "text_encoder"):
            got, want = getattr(pipe, name).state_dict(), getattr(dir_pipe, name).state_dict()
            if got.keys() != want.keys() or not all(
                    got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want):
                fail(f"the single-file {name} is not bit-equal to the directory load")
            equal[name] = len(want)
        if (text_cfg.num_hidden_layers, text_cfg.hidden_act) != (configs["text_encoder"]["num_hidden_layers"], "gelu"):
            fail(f"the single-file text tower is {text_cfg}")
        print(f"load_single_file_pipeline in {load_s:.2f} s on {card}: tensors bit-equal to the directory load "
              f"{equal}; the text tower {text_cfg.num_hidden_layers} layers (of {n + 1} resblocks); scheduler "
              f"{type(pipe.scheduler).__name__} ({pipe.scheduler.config.prediction_type}), pad id "
              f"{pipe.tokenizer.pad_id}  ok", flush=True)

        latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)

        def run(pipeline, a=latent_a, b=latent_b, prompt_start="prompt A", **extra):
            return pipeline.interpolate_single(0.5, a, b, prompt_start=prompt_start, prompt_end="prompt B",
                                               num_inference_steps=steps, output_type="latent", **extra)

        want = run(dir_pipe)
        got, counts, times, _, elapsed, peak = run_image_path(pipe, pipe.vae, lambda: run(pipe), steps, 3)
        same = bool(torch.isfinite(got).all()) and torch.equal(got, want)
        print(f"single-file interpolate_single(0.5), {steps} UniPC steps at "
              f"{pipe.unet.config.sample_size * pipe.vae_scale_factor}px: latents {tuple(got.shape)}, max |single - "
              f"directory| {(got.float() - want.float()).abs().max().item()!r}; {elapsed:.2f} s in all, "
              f"{times['s_per_step']:.4f} s/step, peak memory {peak / 2**30:.2f} GiB on {card}; launches of the bf16 "
              f"attention at D=64 {counts['flash_interpolated_attention[D=64]']}, of the conv kernel "
              f"{counts['conv3x3_same']}  {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            fail("the single-file pipeline's latents are not the directory pipeline's")
        check_path("single-file interpolate_single", counts, ("flash_interpolated_attention[D=64]", "conv3x3_same"))
        paths.append(counts)
        del dir_pipe
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bare = loader.load_single_file_pipeline(single, tokenizer, scheduler_name="unipc", device=device)
        warned = [str(w.message) for w in caught if "global_step" in str(w.message)]
        print(f"load_single_file_pipeline without prediction_type: {bare.scheduler.config.prediction_type}, warned "
              f"{warned[:1]}", flush=True)
        if bare.scheduler.config.prediction_type != "epsilon" or not warned:
            fail("a bare SD2.x single file must warn and default to epsilon")
        del bare
        if device == "cuda":
            torch.cuda.empty_cache()

        # (b) the SDXL layout
        check_sdxl_single_file_layout(device, xl_cfgs)
        if device == "cuda":
            torch.cuda.empty_cache()

        # (c) a LoRA on (a)'s UNet
        lora, targets = single_file_lora(pipe.unet, torch.Generator().manual_seed(19))
        merged = check_lora_merge(pipe.unet, lora, targets)
        cfg = merged.config
        s = cfg.sample_size
        fgen = torch.Generator(device=dev).manual_seed(5)
        sample = torch.randn((7, cfg.in_channels, s, s), generator=fgen, device=dev).to(merged.dtype)
        ehs = torch.randn((7, 77, cfg.cross_attention_dim), generator=fgen, device=dev).to(merged.dtype)
        t = torch.tensor(500, device=dev)
        aid = AidContext(coef=sd15_coef().to(dev), mode=AidMode.from_name("fused_outer"))
        counts = check_unet_vs_plain(f"unet SD2.1 + LoRA fused_outer B=7 {s}x{s} (bf16)",
                                     lambda aid_ctx: merged(sample, t, ehs, aid_ctx), aid, SD21_UNET_TOL)
        check_path("SD2.1 + LoRA forward", counts, ("flash_interpolated_attention[D=64]", "conv3x3_same"))
        del merged, sample, ehs

        # (d) textual inversion, the prompt-embeds shortcut, exported latents
        ti_path = os.path.join(root, "aid-concept.pt")
        vectors = torch.randn((2, text_cfg.hidden_size), generator=torch.Generator().manual_seed(20)) * 0.02
        torch.save({"string_to_param": {"*": vectors}, "name": TI_TOKEN, "step": 3000}, ti_path)
        vocab = text_cfg.vocab_size
        pipe.load_textual_inversion(ti_path)
        ids = set(np.asarray(pipe.tokenizer(f"a photo of {TI_TOKEN}")).ravel().tolist())
        table = pipe.text_encoder.text_model.embeddings.token_embedding.weight
        ti_latents = run(pipe, prompt_start=f"a photo of {TI_TOKEN}")
        ti_ok = (pipe.text_encoder.config.vocab_size == table.shape[0] == vocab + 2
                 and torch.equal(table[-2:].cpu(), vectors) and {vocab, vocab + 1} <= ids
                 and bool(torch.isfinite(ti_latents).all()))
        print(f"textual inversion {TI_TOKEN} (A1111 .pt, 2 vectors): vocab {vocab} -> "
              f"{pipe.text_encoder.config.vocab_size}, ids {vocab} and {vocab + 1} in the prompt's, interpolate_single "
              f"with the placeholder finite  {'ok' if ti_ok else 'FAIL'}", flush=True)
        if not ti_ok:
            fail("the textual-inversion embedding did not load into the text encoder and the tokenizer")
        emb_a, neg = pipe.encode_prompt("prompt A")
        emb_b, _ = pipe.encode_prompt("prompt B")
        via_embeds = pipe.interpolate_single(0.5, latent_a, latent_b, prompt_embeds_start=emb_a,
                                             prompt_embeds_end=emb_b, negative_prompt_embeds=neg,
                                             num_inference_steps=steps, output_type="latent")
        exported = {}
        for ext in ("npy", "pt"):
            files = [os.path.join(root, f"latent_{name}.{ext}") for name in ("start", "end")]
            for path, x in zip(files, (latent_a, latent_b)):
                if ext == "npy":
                    np.save(path, x.cpu().numpy())
                else:
                    torch.save(x.cpu(), path)
            a, b = (load_reference_latents(path, device=device) for path in files)
            exported[ext] = (a.device == latent_a.device and torch.equal(a, latent_a) and torch.equal(b, latent_b)
                             and torch.equal(run(pipe, a, b), got))
        ok = torch.equal(via_embeds, got) and all(exported.values())
        print(f"interpolate_single from prompt_embeds_* off encode_prompt: bit-equal to the prompts' "
              f"{torch.equal(via_embeds, got)}; from the latents written as NCHW .npy / .pt and read back with "
              f"load_reference_latents: bit-equal {exported}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("the prompt-embeds shortcut or the exported latents changed the latents")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


# ---------------------------------------------------------------------------
# phase 19: frame parallelism (parallel/mesh.py) and the app (apps/gradio_app.py)
# ---------------------------------------------------------------------------

# Phase 19 (b): the SD 1.5 sequence denoised by two frame shards against the
# unsharded run on the same card, the LARGEST PER-FRAME relative L2 of the
# final latents after 25 DDIM steps. Sharding changes every GEMM's and
# conv's batch (4 rows for 8), so bf16 rounding differs everywhere, as
# batched CFG's 2N rows do (SD15_CFG_TOL). On an H100 (these seeds; the same
# to the last digit in three runs): sound 2.239e-4 (interior 0/1
# coefficients 2.238e-4); planted faults local endpoints 3.156e-3 (2.697e-3
# in its smallest interior frame), local skip rows 6.538e-3 (frames 3-4
# only). 7e-4 lies between: 3.1x the sound reading, 0.22x the smaller fault.
FRAMES_TOL = 7e-4
# The same two ranks at tp=2 over FRAMES_TP_STEPS steps (gloo's all-reduce
# of the row-parallel outputs goes through the host, ~0.6 s a forward
# here): each row-parallel projection is summed from two bf16 halves, one
# more bf16 rounding than the unsharded GEMM. On an H100: sound 4.782e-4;
# each rank's heads through the other rank's to_out.0 columns 2.210e-2
# (5.364e-3 in its smallest frame). 1e-3 lies between: 2.1x the sound
# reading, 0.19x the fault's smallest frame. (A GEGLU up-projection split
# contiguously, the trap the CPU tests pin, reads only 5.128e-4 here: the
# random feed-forward barely moves the latents in 4 steps.)
FRAMES_TP_TOL = 1e-3
FRAMES_TP_STEPS = 4
# Phase 19 (b)'s interior coefficients at dp=2: frame 3 (shard 0's last
# row) at 1 and frame 4 (shard 1's first row) at 0, which skip rows taken by
# local row index would drop.
FRAMES_TRAP_COEF = (0.0, 0.25, 0.5, 1.0, 0.0, 0.5, 0.75, 1.0)
# Seconds the two ranks of phase 19 (b) may take: a collective one rank
# never joins hangs the other, and the phase then fails instead.
FRAMES_RANK_TIMEOUT = 300.0


def init_group(backend: str, world: int, rank: int, store_dir: str) -> None:
    """A process group through a FileStore under ``store_dir`` (no port to pick)."""
    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), world), rank=rank,
                            world_size=world)


@contextlib.contextmanager
def counted_all_gathers():
    """Count ``torch.distributed.all_gather`` calls inside (a one-item list)."""
    import torch.distributed as dist

    real, n = dist.all_gather, [0]

    def call(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    dist.all_gather = call
    try:
        yield n
    finally:
        dist.all_gather = real


def tp_heads_crossed(sharded, unet, rank: int, tp: int):
    """A planted fault of tensor parallelism: every row-parallel ``to_out.0``
    of ``sharded`` given the columns of the next rank's heads, so each rank
    projects its heads' outputs through another rank's weights."""
    import torch

    from aid_tpu_torch.models.layers import CrossAttention
    from aid_tpu_torch.parallel.mesh import RowParallelLinear

    whole = dict(unet.named_modules())
    for name, m in sharded.named_modules():
        if isinstance(m, CrossAttention) and isinstance(m.to_out[0], RowParallelLinear):
            w, n, other = whole[name].to_out[0].weight.detach(), m.to_out[0].weight.shape[1], (rank + 1) % tp
            m.to_out[0].weight = torch.nn.Parameter(w[:, other * n:(other + 1) * n].contiguous(), requires_grad=False)
    return sharded


@contextlib.contextmanager
def frames_fault(fault):
    """A planted fault of frame sharding: ``"local endpoints"`` (each shard's
    own rows 0 / B-1) or ``"local skip rows"`` (by local row index); any
    other fault is the caller's."""
    from aid_tpu_torch.models import layers

    if fault not in ("local endpoints", "local skip rows"):
        yield
        return
    if fault == "local endpoints":
        owner, name, fake = layers.FrameShard, "endpoints", lambda self, x: (x[0], x[-1])
    else:
        owner, name, fake = layers, "frame_skip_mask", lambda c, offset, total: layers.skip_mask(c, c.shape[0])
    real = getattr(owner, name)
    setattr(owner, name, fake)
    try:
        yield
    finally:
        setattr(owner, name, real)


def phase_frames_world_one(unet, sample, ehs, uncond, added, coef, steps: int, main_out, main_counts: dict,
                           card: str, backend: str = "nccl") -> dict:
    """``sharded_denoise_sequence`` on phase 5's program in a world of one:
    the gathered endpoints are copies of rows 0 and N-1, so the latents must
    equal phase 5's bit for bit, through the same launches. Returns the
    path's launch counts."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.parallel import make_mesh, sharded_denoise_sequence
    from aid_tpu_torch.schedulers.euler import EulerDiscreteScheduler

    print(f"== phase 19 (a): frame parallelism in a world of one ({backend}): sharded_denoise_sequence on phase 5's "
          f"SDXL program ({sample.shape[0]} frames, {steps} steps, {steps // 2} fused_outer)", flush=True)
    store = tempfile.mkdtemp(prefix="frames-store-")
    try:
        init_group(backend, 1, 0, store)
    except Exception as e:  # noqa: BLE001 - any failure to start ends the smoke
        fail(f"the {backend} process group of one did not start: {e!r}")
    try:
        mesh = make_mesh(dp=1, tp=1, devices=sample.device.type)
        scheduler = EulerDiscreteScheduler()
        state = scheduler.init(steps, device=sample.device)
        torch.cuda.reset_peak_memory_stats()
        outs, elapsed = [], []
        for _ in range(2):  # the first run includes the communicator's setup
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counted_all_gathers() as gathers:
                outs.append(sharded_denoise_sequence(
                    mesh, unet, scheduler, sample, ehs, uncond, coef, state, 5.0,
                    early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(), num_steps=steps,
                    warmup_steps=steps // 2, added_cond=added))
            torch.cuda.synchronize()
            elapsed.append(time.perf_counter() - t0)
            counts = read_counts()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    n_attn = sum(type(m).__name__ == "CrossAttention" for m in unet.modules())
    gap = max((out.float() - main_out.float()).abs().max().item() for out in outs)
    equal = all(torch.equal(out, main_out) for out in outs)
    print(f"{elapsed[0] / steps:.3f} s/step in the first run (the communicator's setup included), "
          f"{elapsed[1] / steps:.3f} in the second (phase 5: the first steps included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}; {gathers[0]} all-gathers a run "
          f"({4 * n_attn} a fused_outer forward: {n_attn} attention layers x k, v x first, last; 1 of the output)",
          flush=True)
    print(f"latents of both runs against phase 5's denoise_sequence: max |sharded - unsharded| {gap!r}, "
          f"bit-equal {equal}; "
          f"launches equal {counts == main_counts}  {'ok' if equal and counts == main_counts else 'FAIL'}", flush=True)
    if gathers[0] != 4 * n_attn * (steps // 2) + 1:
        fail(f"{gathers[0]} all-gathers; {4 * n_attn} per interpolating forward and one of the output expected")
    if not equal:
        fail(f"the world of one changed the latents (max gap {gap!r}): the gathered endpoints must carry the same "
             f"values into the same kernels")
    if counts != main_counts:
        fail(f"the world of one launched {counts}; phase 5 launched {main_counts}")
    check_path("frame-sharded denoise (world of one)", counts, ("flash_interpolated_attention", "conv3x3_same"))
    return counts


def frames_rank(rank: int, world: int, store_dir: str, spec: dict, out_dir: str) -> None:
    """One rank of phase 19 (b): the SD 1.5 UNet from the shared seed, then
    every run of ``spec`` through ``sharded_denoise_sequence`` (with
    ``shard_params`` on the TP mesh, and the crossed-heads fault's own copy);
    saves each run's latents, launch counts and seconds. Module-level, so
    spawned ranks import it; the ``__main__`` guard keeps them from running
    the smoke again."""
    import torch
    import torch.distributed as dist

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.parallel import make_mesh, shard_params, sharded_denoise_sequence
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler

    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    else:  # a rehearsal on the CPU: one thread a rank
        torch.set_num_threads(1)
    init_group("gloo", world, rank, store_dir)
    try:
        unet = build_sd15(cfg=spec["cfg"], device=device, dtype=spec["dtype"])
        meshes = {"dp": make_mesh(dp=world, tp=1, devices=device), "tp": make_mesh(dp=1, tp=world, devices=device)}
        sharded = {"dp": unet, "tp": shard_params(unet, meshes["tp"]),
                   "tp crossed": tp_heads_crossed(shard_params(unet, meshes["tp"]), unet, rank, world)}
        x = {k: v.to(device) for k, v in spec["inputs"].items()}
        scheduler = DDIMScheduler()
        results = {}
        for name, (mesh, coef, fault, steps) in spec["runs"].items():
            model = sharded["tp crossed" if fault == "heads crossed" else mesh]
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with frames_fault(fault):
                out = sharded_denoise_sequence(
                    meshes[mesh], model, scheduler, x["latents"], x["embs"], x["uncond"], x[coef],
                    scheduler.init(steps, device=device), 7.5, early=AidMode.from_name("fused_outer"),
                    late=AidMode.vanilla(), num_steps=steps, warmup_steps=steps // 2)
            if device == "cuda":
                torch.cuda.synchronize()
            results[name] = {"latents": out.cpu(), "counts": read_counts(), "seconds": time.perf_counter() - t0,
                             "peak": torch.cuda.max_memory_allocated() if device == "cuda" else 0}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple, timeout: float) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes; fail if one
    raises, dies or outlives ``timeout`` (then every rank is killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                fail(f"the {world} ranks did not finish in {timeout:.0f} s (a collective some rank never joined?)")
    except mp.ProcessRaisedException as e:
        fail(f"a rank raised: {e}")
    except mp.ProcessExitedException as e:
        fail(f"a rank died: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def phase_frames(card: str, device: str = "cuda", unet_cfg=None, steps: int = SD15_STEPS, frames: int = 8,
                 dtype=None) -> list:
    """Two gloo ranks on the one card (NCCL takes one rank a device): the
    full-width SD 1.5 UNet in bf16 from one seed on each rank, ``frames``
    frames at its 64^2 latents, ``steps`` DDIM steps with fused_outer for
    the first half, sequential CFG, at dp=2; then the same two ranks at
    tp=2 (8 heads, 4 a rank) over FRAMES_TP_STEPS steps. Each run against
    the unsharded run in this process, with planted faults over the bound:
    local endpoints, local skip rows on interior 0/1 coefficients, and (TP)
    each rank's heads through the other rank's to_out.0 columns. Returns the sound runs' launch
    counts, summed over the ranks. ``device``/``unet_cfg``/``dtype`` exist
    for rehearsing on the CPU."""
    import shutil
    import tempfile

    import torch

    from aid_tpu_torch.models.layers import AidMode
    from aid_tpu_torch.ops.interp import generate_beta_schedule
    from aid_tpu_torch.pipelines.engine import denoise_sequence
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler

    print(f"== phase 19 (b): frame parallelism in a world of two (gloo, two ranks on the one card): SD1.5, "
          f"{frames} frames, {steps} DDIM steps ({steps // 2} fused_outer), dp=2 then tp=2, against the "
          f"unsharded run", flush=True)
    t_phase = time.perf_counter()
    unet = build_sd15(cfg=unet_cfg, device=device, dtype=dtype)
    cfg, s = unet.config, unet.config.sample_size
    gen = torch.Generator(device=device).manual_seed(19)
    inputs = {"latents": torch.randn((frames, cfg.in_channels, s, s), generator=gen, device=device),
              "embs": torch.randn((frames, 77, cfg.cross_attention_dim), generator=gen, device=device),
              "uncond": torch.randn((frames, 77, cfg.cross_attention_dim), generator=gen, device=device),
              "beta": torch.from_numpy(generate_beta_schedule(frames, steps, steps, force_endpoints=True)).to(device),
              "trap": torch.tensor(FRAMES_TRAP_COEF, device=device)}
    tp_steps = min(steps, FRAMES_TP_STEPS)
    refs = {}
    for coef, n in (("beta", steps), ("trap", steps), ("beta", tp_steps)):
        scheduler = DDIMScheduler()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs[coef, n] = denoise_sequence(unet, scheduler, inputs["latents"], inputs["embs"], inputs["uncond"],
                                         inputs[coef], scheduler.init(n, device=device), 7.5,
                                         early=AidMode.from_name("fused_outer"), late=AidMode.vanilla(),
                                         num_steps=n, warmup_steps=n // 2).cpu()
        torch.cuda.synchronize()
        print(f"unsharded, {coef} coefficients, {n} steps: {time.perf_counter() - t0:.2f} s", flush=True)
    del unet
    if device == "cuda":
        torch.cuda.empty_cache()
    runs = {"dp=2": ("dp", "beta", None, steps), "dp=2 local endpoints": ("dp", "beta", "local endpoints", steps),
            "dp=2 interior 0/1": ("dp", "trap", None, steps),
            "dp=2 interior 0/1, local skip rows": ("dp", "trap", "local skip rows", steps),
            "tp=2": ("tp", "beta", None, tp_steps),
            "tp=2 heads crossed": ("tp", "beta", "heads crossed", tp_steps)}
    spec = {"device": device, "cfg": unet_cfg, "dtype": dtype, "runs": runs,
            "inputs": {k: v.cpu() for k, v in inputs.items()}}
    work = tempfile.mkdtemp(prefix="frames-ranks-")
    try:
        t0 = time.perf_counter()
        spawn_ranks(frames_rank, 2, (2, work, spec, work), FRAMES_RANK_TIMEOUT)
        spawned = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"two ranks: {spawned:.2f} s from spawn to exit; seconds per run by rank "
          f"{ {name: [round(r[name]['seconds'], 2) for r in ranks] for name in runs} }; peak memory by rank "
          f"{ {name: [round(r[name]['peak'] / 2**30, 2) for r in ranks] for name in runs} } GiB on {card}", flush=True)
    for name in runs:
        if not torch.equal(ranks[0][name]["latents"], ranks[1][name]["latents"]):
            fail(f"{name}: the two ranks returned different sequences")
    got = {name: ranks[0][name]["latents"] for name in runs}
    check_bound("dp=2 vs unsharded", frame_rel_l2(got["dp=2"], refs["beta", steps]),
                frame_rel_l2(got["dp=2 local endpoints"], refs["beta", steps]), FRAMES_TOL, "local endpoints")
    check_bound("dp=2 interior 0/1 coefficients vs unsharded",
                frame_rel_l2(got["dp=2 interior 0/1"], refs["trap", steps]),
                frame_rel_l2(got["dp=2 interior 0/1, local skip rows"], refs["trap", steps]), FRAMES_TOL,
                "local skip rows")
    check_bound(f"tp=2 vs unsharded ({tp_steps} steps)", frame_rel_l2(got["tp=2"], refs["beta", tp_steps]),
                frame_rel_l2(got["tp=2 heads crossed"], refs["beta", tp_steps]), FRAMES_TP_TOL,
                "to_out.0 columns of the other rank's heads")
    paths = []
    for name in ("dp=2", "dp=2 interior 0/1", "tp=2"):
        for rank, r in enumerate(ranks):
            by_dim = {d: r[name]["counts"].get(f"flash_interpolated_attention[D={d}]", 0) for d in (40, 80, 160)}
            print(f"{name}, rank {rank}: attention launches by head dim {by_dim}", flush=True)
            if not min(by_dim.values()) > 0:
                fail(f"{name}: rank {rank} did not launch the kernel at every head dim: {by_dim}")
        paths.append({k: sum(r[name]["counts"][k] for r in ranks) for k in ranks[0][name]["counts"]})
    print(f"phase 19 (b): {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


# Phase 20's whole-model bounds, the LARGEST PER-FRAME relative L2 of the
# output, kernels vs plain, both in f16. Every kernel differs from its plain
# f16 version by a few f16 roundings (2^-11), and the rest of the model is
# the same f16 code on both sides, so the sound readings sit about eight
# times under bf16's. On an NVIDIA H100 80GB HBM3 at 700 W (these seeds;
# deterministic), sound / smaller planted fault:
#   * the f16 SD1.5 UNet: 2.78e-4 in every frame / endpoints swapped 3.18e-3
#     (fused_outer computed as self 2.73e-2). 1e-3 lies between: 3.6x the
#     sound reading, 0.31x the fault;
#   * the f16 SDXL UNet: 3.19e-4 / endpoints swapped 8.85e-3 (self 4.48e-2).
#     1.5e-3: 4.7x, 0.17x;
#   * the same with the fused GN+SiLU configuration: 3.15e-4 / the halo not
#     re-zeroed 5.52e-3 (4.74e-3 in its smallest frame). 1e-3: 3.2x, 0.18x;
#   * the f16 VAE's raw decoder output of one 512px frame (only the D=512
#     attention differs; the convs are cuDNN f16 on both sides): 3.46e-4 /
#     the attention not normalised 4.1e-1. 2e-3: 5.8x the sound reading.
# Phase 20 measures every fault in every run and fails if its bound does not
# separate it.
F16_SD15_UNET_TOL = 1e-3
F16_UNET_TOL = 1.5e-3
F16_FUSED_UNET_TOL = 1e-3
F16_VAE_TOL = 2e-3


def phase_f16(card: str, steps: int) -> list:
    """Phase 20: the f16 path at full width, as the upstream CUDA reference
    runs SD (``torch_dtype=torch.float16``), every UNet and VAE kernel an f16
    one. (a) SD 1.5: a full-width diffusers directory written from a seed
    (f16 safetensors) into the git-ignored build/ and loaded with
    ``load_interpolation_pipeline(dir, dtype=torch.float16)`` (UNet f16,
    text encoder f32, VAE f32 by force_upcast), one fused_outer forward
    kernels vs plain with two planted faults, ``interpolate`` (PAID, 7
    frames, 512px, SD15_STEPS DDIM steps, guidance 7.5) and
    ``interpolate_single(0.5)``, s/step; (c) the same directory's VAE loaded
    with ``load_vae(dir, dtype=torch.float16)``: one 512px frame's raw
    decoder output kernels vs plain with a planted fault (the f16 D=512
    attention); (b) SDXL, ``build_headline(dtype=torch.float16)``: one
    fused_outer forward kernels vs plain with two planted faults, a denoise
    at ``steps`` (s/step), and one forward in the fused GN+SiLU
    configuration with its halo fault. No path launches a bf16 or f32 kernel
    but the f32 VAE's attention in (a)'s decodes. Returns the paths' counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.layers import AidContext, AidMode
    from aid_tpu_torch.schedulers import DDIMScheduler

    f16, dev = torch.float16, torch.device("cuda")
    print(f"== phase 20: f16 at full width: SD1.5 through load_interpolation_pipeline(dtype=torch.float16) (forward "
          f"kernels vs plain, interpolate 7 frames and interpolate_single, {SD15_STEPS} DDIM steps at 512px), an f16 "
          f"VAE decode, the f16 SDXL UNet (forward, {steps}-step denoise, fused GN+SiLU forward)", flush=True)
    paths = []
    heads = tuple(f"flash_interpolated_attention_f16[D={d}]" for d in (40, 80, 160)) + (
        "flash_interpolated_attention_f16[onepass]",)
    # the 1024-token self calls at D = 80 (a sequence's uncond passes and late
    # steps; the fused_outer forward's stay on row 1's kernel, the route's
    # measured limit) on the mid-length stream kernel
    midstream = ("flash_interpolated_attention_f16[midstream]",)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="sd15-f16-checkpoint-", dir=os.path.join(ROOT, "build"))
    try:
        configs = {k: v for k, v in sd15_diffusers_configs().items() if k != "safety_checker"}
        t0 = time.perf_counter()
        nbytes = write_checkpoint(root, seed=2, configs=configs)
        print(f"wrote a full-width SD1.5 diffusers directory ({nbytes / 2**30:.2f} GiB of f16 weights) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        pipe = loader.load_interpolation_pipeline(root, dtype=f16)
        vae16 = loader.load_vae(os.path.join(root, "vae"), dtype=f16)
        torch.cuda.synchronize()
        print(f"load_interpolation_pipeline(dir, dtype=torch.float16) and load_vae(dir/vae, dtype=torch.float16) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    placed = {name: ({p.device.type for p in m.parameters()}, {p.dtype for p in m.parameters()})
              for name, m in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.text_encoder),
                              ("f16 vae", vae16))}
    print(f"modules (devices, dtypes): {placed}; scheduler {type(pipe.scheduler).__name__}; guidance "
          f"{pipe.guidance_scale}", flush=True)
    want = {"unet": f16, "vae": torch.float32, "text_encoder": torch.float32, "f16 vae": f16}
    if any(placed[n] != ({"cuda"}, {want[n]}) for n in placed) or not isinstance(pipe.scheduler, DDIMScheduler):
        fail(f"the loader placed the f16 SD1.5 modules at {placed}; the UNet in f16, the text encoder and VAE in f32 "
             f"(force_upcast), load_vae(dtype=torch.float16) in f16, all on the card, and DDIM expected")

    # (a) the f16 SD1.5 UNet: one forward kernels vs plain, then the pipeline
    unet, cfg = pipe.unet, pipe.unet.config
    s = cfg.sample_size
    gen = torch.Generator(device=dev).manual_seed(3)
    sample = torch.randn((7, cfg.in_channels, s, s), generator=gen, device=dev).to(f16)
    ehs = torch.randn((7, 77, cfg.cross_attention_dim), generator=gen, device=dev).to(f16)
    t = torch.tensor(500, device=dev)
    counts = check_unet_vs_plain(f"f16 SD1.5 unet fused_outer B=7 {s}x{s}", lambda aid: unet(sample, t, ehs, aid),
                                 AidContext(coef=sd15_coef().to(dev), mode=AidMode.from_name("fused_outer")),
                                 F16_SD15_UNET_TOL)
    check_f16_only("f16 SD1.5 forward", counts, heads)
    paths.append(counts)
    del sample, ehs

    gen = torch.Generator(device=dev).manual_seed(4)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)
    px = s * 2 ** (len(pipe.vae.config.block_out_channels) - 1)

    def interpolate(**kw):
        return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", guide_prompt="a guide prompt", size=7,
                                num_inference_steps=SD15_STEPS, **kw)

    images, counts, times, decoder_inputs, elapsed, peak = run_image_path(pipe, pipe.vae, interpolate, SD15_STEPS, 7)
    check_images(f"f16 SD1.5 interpolate (PAID, {SD15_STEPS} DDIM steps, f32 VAE)", images, (7, px, px, 3), times,
                 elapsed, peak, card)
    check_f16_only("f16 SD1.5 interpolate", counts, heads + midstream + ("flash_self_attention_f32",),
                   allowed=("flash_self_attention_f32",))
    if counts["flash_self_attention_f32"] != 1:
        fail(f"f16 SD1.5 interpolate: {counts['flash_self_attention_f32']} launches of the f32 VAE's attention, one "
             f"batched decode (1) expected")
    print(f"f16 SD1.5 interpolate: launches by head dim "
          f"{ {d: counts[f'flash_interpolated_attention_f16[D={d}]'] for d in (40, 80, 160)} }", flush=True)
    paths.append(counts)
    per_step = []
    for _ in range(2):
        _, _, warm, _, _, _ = run_image_path(pipe, pipe.vae, lambda: interpolate(output_type="latent"), SD15_STEPS, 7)
        per_step.append(warm["s_per_step"])
    print(f"f16 SD1.5 interpolate, sequential CFG: first run {times['s_per_step']:.4f} s/step, 2 warm runs "
          f"{' '.join(f'{x:.4f}' for x in per_step)} s/step on {card}", flush=True)
    single, counts, times1, _, elapsed, peak = run_image_path(
        pipe, pipe.vae, lambda: pipe.interpolate_single(0.5, latent_a, latent_b, "prompt A", "prompt B",
                                                        num_inference_steps=SD15_STEPS), SD15_STEPS, 3)
    check_images("f16 SD1.5 interpolate_single(0.5)", single, (3, px, px, 3), times1, elapsed, peak, card)
    check_f16_only("f16 SD1.5 interpolate_single", counts, heads + midstream + ("flash_self_attention_f32",),
                   allowed=("flash_self_attention_f32",))
    paths.append(counts)

    # (c) the f16 VAE: the raw decoder output of the interpolate's least
    # saturated frame, kernels (the f16 D=512 attention) vs plain
    inside = ((images > 0) & (images < 255)).reshape(7, -1).mean(axis=1)
    frame = int(inside.argmax())
    z = decoder_inputs[0][frame:frame + 1].to(f16)
    reset_counts()
    check_decoder(vae16.decode, z, images, frame, F16_VAE_TOL, "raw f16 decoder output", attention_unnormalised_fault)
    counts = read_counts()
    check_f16_only("f16 VAE decode", counts, ("flash_self_attention_f16",))
    if counts["flash_self_attention_f16"] != 1:
        fail(f"f16 VAE decode: {counts['flash_self_attention_f16']} launches of the f16 D=512 attention, 1 expected")
    paths.append(counts)
    del pipe, unet, vae16, images, single, decoder_inputs, z
    torch.cuda.empty_cache()

    # (b) the f16 SDXL UNet: the headline program in f16
    unet, sample, ehs, uncond, added, coef = build_headline(dtype=f16)
    t = torch.tensor(500.0, device=dev)
    aid = AidContext(coef=coef, mode=AidMode.from_name("fused_outer"))

    def forward(aid_ctx=aid):
        return unet(sample, t, ehs, aid_ctx, added)

    needed = ("flash_interpolated_attention_f16[D=64]", "flash_interpolated_attention_f16[onepass]",
              "flash_interpolated_attention_f16[midstream]", "conv3x3_same_f16")
    counts = check_unet_vs_plain(f"f16 SDXL unet fused_outer B={sample.shape[0]} 128x128", forward, aid, F16_UNET_TOL)
    check_f16_only("f16 SDXL forward", counts, needed)
    paths.append(counts)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, elapsed = run_denoise(unet, sample, ehs, uncond, added, coef, steps)
    counts = read_counts()
    checksum = float(out.float().sum())
    print(f"f16 SDXL denoise: checksum {checksum!r}; output {tuple(out.shape)} {out.dtype}; {elapsed / steps:.3f} "
          f"s/step ({steps} steps, {steps // 2} fused_outer warmup, the first included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)
    if tuple(out.shape) != tuple(sample.shape) or out.dtype != f16 or not math.isfinite(checksum):
        fail(f"f16 SDXL denoise returned {tuple(out.shape)} {out.dtype}, checksum {checksum}")
    check_f16_only("f16 SDXL denoise", counts, needed)
    paths.append(counts)
    counts = check_fused_vs_plain(f"f16 SDXL unet, fused GN+SiLU, fused_outer B={sample.shape[0]} 128x128", forward,
                                  F16_FUSED_UNET_TOL, "conv3x3_gnsilu_f16")
    check_f16_only("f16 SDXL fused GN forward", counts, needed + ("conv3x3_gnsilu_f16",))
    paths.append(counts)
    return paths


# phase 21: SD 1.x at D = 320, the D=161-512 endpoint entries on a full-width
# UNet. No published UNet has heads wider than 160; SD 1.5's widths with the
# diffusers legacy attention_head_dim [1, 2, 4, 4] (read as head counts by
# both packages' loaders) put every level at 320 channels a head.
WIDE_HEADS = [1, 2, 4, 4]
WIDE_STEPS = 10


def sd15_wide_head_configs() -> dict:
    """sd15_diffusers_configs without the safety checker, the UNet's
    attention_head_dim the list WIDE_HEADS: 320-wide heads at every level."""
    configs = {k: v for k, v in sd15_diffusers_configs().items() if k != "safety_checker"}
    configs["unet"] = {**configs["unet"], "attention_head_dim": list(WIDE_HEADS)}
    return configs


def coef_swapped(plain):
    """A planted fault: the plain attention with c and 1 - c exchanged in the
    outer modes' combination."""
    from aid_tpu_torch.ops.attention import AttnMode

    def fault(q, k, v, coef=None, mode="self", **kwargs):
        if coef is not None and AttnMode(mode).is_outer:
            coef = 1 - coef
        return plain(q, k, v, coef, mode, **kwargs)
    return fault


def own_dropped(plain):
    """A planted fault: the plain attention with the fused modes' own
    segment dropped (computed as the pure modes)."""
    from aid_tpu_torch.ops.attention import AttnMode

    def fault(q, k, v, coef=None, mode="self", **kwargs):
        mode = {"fused_outer": "pure_outer", "fused_inner": "pure_inner"}.get(AttnMode(mode).value, mode)
        return plain(q, k, v, coef, mode, **kwargs)
    return fault


def key_tail_unmasked(plain):
    """A planted fault: the plain attention with self mode's last key tile
    unmasked: the keys past the own K/V's length, up to the next multiple
    of 64, read as zeros (a tile's fill past the tensor) and take part in
    the softmax."""
    import torch

    from aid_tpu_torch.ops.attention import AttnMode

    def fault(q, k, v, coef=None, mode="self", **kwargs):
        if AttnMode(mode) == AttnMode.SELF:
            pad = -k.shape[-2] % 64
            k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
        return plain(q, k, v, coef, mode, **kwargs)
    return fault


def check_wide_only(path: str, counts: dict, needed, allowed=()) -> None:
    """check_path, and no launch of an attention entry (D <= 160, D=512,
    the wide ones past 512, the self ones) other than ``needed`` and
    ``allowed``."""
    check_path(path, counts, needed)
    attention = [n for n in counts if "[D=" in n] + [n for names in KERNELS_BY_DTYPE.values() for n in names
                                                      if n.startswith("flash_self")]
    other = {n: counts[n] for n in attention if counts[n] and n not in needed and n not in allowed}
    if other:
        fail(f"the {path} path launched attention entries other than {tuple(needed) + tuple(allowed)}: {other}")


def check_static_dims(path: str, counts: dict, name: str, dims, wide_dims=()) -> None:
    """The static-shift launches of a path with head dims past 160: those of
    ``name`` (an interpolating wrapper) only on the D=161-512 kernels at
    ``dims`` and on the wide kernels at the instance head dims ``wide_dims``
    (no other dtype's, none on the D <= 160 ones' instances, none at another
    head dim: past 512 "auto" shifts only where the JAX wrapper does and the
    model path's FLASH_MIN_KV lets it)."""
    shifted = {n: c for n, c in counts.items() if c and "[static" in n and " D=" in n}
    allowed = {f"{name}[static dmid D={d}]" for d in dims} | {f"{name}[static dwide D={d}]" for d in wide_dims}
    other = {n: c for n, c in shifted.items() if n not in allowed}
    print(f"static-shift launches of the {path} path by head dim: {shifted}", flush=True)
    if other:
        fail(f"the {path} path launched static-shift instances other than {name}'s at D = {tuple(dims)} and the "
             f"wide ones at {tuple(wide_dims)}: {other}")


def phase_wide_heads(card: str, device: str = "cuda", configs=None, steps: int = WIDE_STEPS) -> list:
    """Phase 21: SD 1.x at D = 320. A full-width SD 1.5 diffusers directory
    with attention_head_dim WIDE_HEADS (f16 weights from a seed) written into
    the git-ignored build/ and loaded with ``load_interpolation_pipeline``
    (UNet bf16, text encoder and VAE f32) and its UNet again in f32 and f16
    with ``load_unet``. (a) one bf16 fused_outer forward, 7 frames at 64^2,
    kernels vs plain under SD15_UNET_TOL with two planted faults (c and 1 - c
    swapped, the own segment dropped), then ``interpolate`` (PAID, 7 frames,
    512px, ``steps`` DDIM steps, guidance 7.5), s/step; (b) one f32 and one
    f16 forward under F32_UNET_TOL / F16_SD15_UNET_TOL, each with a planted
    fault; (c) in each dtype one self-mode forward (no AidContext: every
    attention in self mode, as the uncond pass runs) under the same bound,
    with self mode's last key tile unmasked as its planted fault. Every
    attention launch at D = 320 lands on the D=161-512 entries (counted
    under D=512; self mode through their instance with no endpoint set),
    none on the D <= 160 kernels or the D=512 self ones; the one D=512 self
    launch is the f32 VAE's. Under "auto" the calls the JAX wrapper shifts
    (the 64^2 level's fused_outer and self calls; own KV under FLASH_MIN_KV
    and one-pass self calls stay exact) launch the D=161-512 kernels'
    static-shift instance in bf16 and f32 (``...[static dmid]``, unless
    STATIC_SHIFT_SLOWER keeps the class exact), none in f16. Returns the
    paths' counts. ``device``/``configs`` exist for rehearsing on the CPU."""
    import shutil
    import tempfile

    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.layers import AidContext, AidMode

    print(f"== phase 21: SD1.x at D=320 (SD1.5 widths, attention_head_dim {WIDE_HEADS}) through "
          f"load_interpolation_pipeline: forward kernels vs plain in bf16, f32 and f16, interpolate 7 frames at "
          f"512px, {steps} DDIM steps", flush=True)
    t_phase = time.perf_counter()
    configs = configs or sd15_wide_head_configs()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="sd15-d320-checkpoint-", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        nbytes = write_checkpoint(root, seed=21, device=device, configs=configs)
        print(f"wrote an SD1.5-width diffusers directory with 320-wide heads ({nbytes / 2**30:.2f} GiB of f16 "
              f"weights) in {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        pipe = loader.load_interpolation_pipeline(root, **({} if device == "cuda" else {"device": device}))
        unets = {dt: loader.load_unet(os.path.join(root, "unet"), dtype=dt, device=device)
                 for dt in (torch.float32, torch.float16)}
        torch.cuda.synchronize()
        print(f"load_interpolation_pipeline(dir) and load_unet(dir/unet) in f32 and f16 in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = pipe.unet.config
    heads = [c // h for c, h in zip(cfg.block_out_channels, cfg.num_attention_heads)]
    print(f"UNet: widths {cfg.block_out_channels}, heads {cfg.num_attention_heads}, head dims {heads}; UNet "
          f"{pipe.unet.dtype}, VAE {next(pipe.vae.parameters()).dtype}", flush=True)
    if (cfg != loader.unet_config_from_diffusers(configs["unet"]) or len(set(heads)) != 1 or heads[0] <= 160
            or pipe.unet.dtype != torch.bfloat16):
        fail(f"the loaded UNet config {cfg} is not the written one with one head dim past 160, or not bf16")

    paths = []
    dev = torch.device(device)
    s = cfg.sample_size
    gen = torch.Generator(device=dev).manual_seed(3)
    sample = torch.randn((7, cfg.in_channels, s, s), generator=gen, device=dev)
    ehs = torch.randn((7, 77, cfg.cross_attention_dim), generator=gen, device=dev)
    t = torch.tensor(500, device=dev)
    aid = AidContext(coef=sd15_coef().to(dev), mode=AidMode.from_name("fused_outer"))
    faults = {"c and 1-c swapped": (aid, coef_swapped), "own segment dropped": (aid, own_dropped)}
    for unet, tol, name, fault_names in (
            (pipe.unet, SD15_UNET_TOL, "flash_interpolated_attention", tuple(faults)),
            (unets[torch.float32], F32_UNET_TOL, "flash_interpolated_attention_f32", ("own segment dropped",)),
            (unets[torch.float16], F16_SD15_UNET_TOL, "flash_interpolated_attention_f16", ("own segment dropped",))):
        x, e = sample.to(unet.dtype), ehs.to(unet.dtype)
        dt = {torch.bfloat16: "bf16", torch.float32: "f32"}.get(unet.dtype)  # f16: no static instance
        counts = check_unet_vs_plain(f"{unet.dtype} SD1.x D=320 unet fused_outer B=7 {s}x{s}",
                                     lambda a: unet(x, t, e, a), aid, tol, {n: faults[n] for n in fault_names})
        check_wide_only(f"{unet.dtype} SD1.x D=320 forward", counts,
                        (f"{name}[D=512]", *(static_needed(dt, [("dmid", 320, "fused_outer")]) if dt else ())))
        check_static_dims(f"{unet.dtype} SD1.x D=320 forward", counts, name, (320,) if dt else ())
        paths.append(counts)
        counts = check_unet_vs_plain(f"{unet.dtype} SD1.x D=320 unet self B=7 {s}x{s}", lambda a: unet(x, t, e, a),
                                     None, tol, {"last key tile unmasked": (None, key_tail_unmasked)})
        check_wide_only(f"{unet.dtype} SD1.x D=320 self forward", counts,
                        (f"{name}[D=512]", *(static_needed(dt, [("dmid", 320, "self")]) if dt else ())))
        check_static_dims(f"{unet.dtype} SD1.x D=320 self forward", counts, name, (320,) if dt else ())
        paths.append(counts)
    del unets, unet, x, e, sample, ehs
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(4)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)
    px = s * 2 ** (len(pipe.vae.config.block_out_channels) - 1)

    def interpolate(**kw):
        return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", guide_prompt="a guide prompt", size=7,
                                num_inference_steps=steps, **kw)

    images, counts, times, _, elapsed, peak = run_image_path(pipe, pipe.vae, interpolate, steps, 7)
    check_images(f"SD1.x D=320 interpolate (PAID, {steps} DDIM steps, guidance {pipe.guidance_scale}, f32 VAE)",
                 images, (7, px, px, 3), times, elapsed, peak, card)
    check_wide_only("SD1.x D=320 interpolate", counts,
                    ("flash_interpolated_attention[D=512]",
                     *static_needed("bf16", [("dmid", 320, "fused_outer"), ("dmid", 320, "self")]),
                     *static_needed("f32", [("d512", 512, "self")])),
                    ("flash_self_attention_f32",))  # the f32 VAE's D=512 attention
    check_static_dims("SD1.x D=320 interpolate", counts, "flash_interpolated_attention", (320,))
    print(f"SD1.x D=320 interpolate: attention launches {({n: c for n, c in counts.items() if c and 'attention' in n})}",
          flush=True)
    paths.append(counts)
    _, _, warm, _, _, _ = run_image_path(pipe, pipe.vae, lambda: interpolate(output_type="latent"), steps, 7)
    print(f"SD1.x D=320 interpolate, sequential CFG: first run {times['s_per_step']:.4f} s/step, warm run "
          f"{warm['s_per_step']:.4f} s/step on {card}; phase 21 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


def stub_gradio():
    """A stand-in ``gradio`` module that builds nothing and keeps the
    functions wired to buttons (``clicks``): the card's machine has no
    gradio, and the app's logic is all in those functions."""
    import types

    g = types.ModuleType("gradio")
    g.clicks = []

    class Component:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def change(self, fn, inputs, outputs):
            pass

        def click(self, fn, inputs, outputs):
            g.clicks.append(fn)

    for name in ("Blocks", "Examples", "Markdown", "Dropdown", "Textbox", "Row", "Slider", "Number", "Checkbox",
                 "LinePlot", "Gallery", "Button"):
        setattr(g, name, type(name, (Component,), {}))
    g.update = lambda **kwargs: kwargs
    return g


def phase_app(pipe, card: str) -> dict:
    """The app's Generate function (``apps.gradio_app.build_app`` with a stub
    gradio) on phase 15's SD 1.5 pipeline: the gallery's 7-frame SD 1.5
    example at SD15_STEPS steps, seven 512px uint8 frames from one
    ``interpolate`` call. Returns the path's launch counts."""
    import numpy as np
    import torch

    from aid_tpu_torch.apps import gradio_app

    print(f"== phase 19 (c): the Gradio app's generate on phase 15's pipeline (stub gradio), the gallery's 7-frame "
          f"SD1.5 example at {SD15_STEPS} steps", flush=True)
    g, real = stub_gradio(), sys.modules.get("gradio")
    sys.modules["gradio"] = g
    try:
        gradio_app.build_app(lambda name: pipe)
    finally:
        if real is None:
            del sys.modules["gradio"]
        else:
            sys.modules["gradio"] = real
    if len(g.clicks) != 1:
        fail(f"build_app wired {len(g.clicks)} buttons; the Generate button expected")
    p1, p2, guide, neg, model, size, alpha, beta, warmup, guidance, _, early, late, seed, same = \
        gradio_app.get_examples()[1]
    px = pipe.unet.config.sample_size * 2 ** (len(pipe.vae.config.block_out_channels) - 1)

    def generate():
        frames = g.clicks[0](model, p1, p2, guide, neg, size, alpha, beta, warmup, guidance, SD15_STEPS, early,
                             late, seed, same)
        return np.stack([np.asarray(im) for im in frames])

    images, counts, times, decoder_inputs, elapsed, peak = run_image_path(pipe, pipe.vae, generate, SD15_STEPS, size)
    check_images(f"the app's generate ({model}, {size} frames, {early}/{late}, guide prompt)", images,
                 (size, px, px, 3), times, elapsed, peak, card)
    if not all(torch.isfinite(z).all() for z in decoder_inputs):
        fail("the app's generate decoded non-finite latents")
    check_path("the app's generate", counts, ("flash_interpolated_attention[D=40]",
                                              "flash_interpolated_attention[D=80]",
                                              "flash_interpolated_attention[D=160]"))
    return counts


# diffusers legacy attention_head_dim 1 at every level (read as a head count
# by both loaders): one head a level, 320 / 640 / 1280 / 1280 wide
ONE_HEAD = [1, 1, 1, 1]


def sd15_one_head_configs() -> dict:
    """sd15_wide_head_configs with attention_head_dim ONE_HEAD: heads past
    512 at every level but the first."""
    configs = sd15_wide_head_configs()
    configs["unet"] = {**configs["unet"], "attention_head_dim": list(ONE_HEAD)}
    return configs


def slice_own_chunk(plain, slices: int = 1):
    """A planted fault: the plain attention at head dims past 512 with the
    first ``slices`` output slices (the wide kernel's two consumer
    warpgroups' columns: warpgroup w holds the 64-column chunks w, w + 2,
    ...) each computed from the scores over its own columns alone (q and k
    cut to them, the scale kept): a warpgroup that skipped the exchange of
    partial scores."""
    import torch

    from aid_tpu_torch.ops.flash_attention import D512

    def fault(q, k, v, coef=None, mode="self", k_begin=None, v_begin=None, k_end=None, v_end=None, scale=None,
              **kwargs):
        eps = dict(k_begin=k_begin, v_begin=v_begin, k_end=k_end, v_end=v_end)
        out = plain(q, k, v, coef, mode, scale=scale, **eps, **kwargs)
        D = q.shape[-1]
        if D <= D512:
            return out
        out = out.clone()
        for w in range(slices):
            cols = torch.arange(D, device=q.device)
            cols = cols[(cols // 64) % 2 == w]
            cut = {n: None if x is None else x[..., cols] for n, x in eps.items()}
            out[..., cols] = plain(q[..., cols], k[..., cols], v[..., cols], coef, mode,
                                   scale=D ** -0.5 if scale is None else scale, **cut, **kwargs)
        return out
    return fault


def every_slice_own_chunk(plain):
    """slice_own_chunk over both warpgroups' slices: no partial score is exchanged."""
    return slice_own_chunk(plain, 2)


def phase_one_head_a_level(card: str, device: str = "cuda", configs=None, steps: int = WIDE_STEPS) -> list:
    """Phase 22: SD 1.x with one head a level. A full-width SD 1.5 diffusers
    directory with attention_head_dim ONE_HEAD (f16 weights from a seed)
    written into the git-ignored build/ and loaded with
    ``load_interpolation_pipeline`` (UNet bf16, text encoder and VAE f32) and
    its UNet again in f32 and f16 with ``load_unet``. Head dims 320 / 640 /
    1280: (a) one bf16 fused_outer forward, 7 frames at 64^2, kernels vs plain
    under SD15_UNET_TOL with two planted faults (c and 1 - c swapped, the own
    segment dropped; a slice of the output over its own chunk of the scores
    moves a bf16 forward no more than its roundings do), then
    ``interpolate`` (PAID, 7 frames, 512px, ``steps`` DDIM steps, guidance
    7.5), s/step; (b) one f32 forward under F32_UNET_TOL with one output
    slice over its own chunk and with every slice over its own (the
    exchange dropped), and one f16 forward under F16_SD15_UNET_TOL with the
    own segment dropped (the slice faults move an f16 forward no more than
    its roundings do). Every attention launch at D = 640 / 1280 lands on
    a wide entry, every one at D = 320 on a D=161-512 one, self mode too
    (counted under D=512; the one D=512 self launch is the f32 VAE's), none
    elsewhere (in a forward exactly
    the calls the UNet's attention modules make at each), none elsewhere.
    Under "auto" the static-shift launches are the D=161-512 kernels' at D
    = 320 and, in bf16 and f32, the wide kernels' at D = 640 (the endpoint
    modes' 1024-token calls the JAX wrapper shifts; required on the bf16 and
    f32 forwards and ``interpolate``); the D = 1280 calls stay exact (their
    own KV, 256 and 64 tokens, is under FLASH_MIN_KV, as the JAX model path
    keeps them on XLA), f16 launches none, and the bf16 forward's logit
    window (check_unet_vs_plain) lies in [-32, +70]. Returns the paths'
    counts.
    ``device``/``configs`` exist for rehearsing on the CPU."""
    import shutil
    import tempfile

    import torch

    from aid_tpu_torch.models import loader
    from aid_tpu_torch.models.layers import AidContext, AidMode, CrossAttention
    from aid_tpu_torch.ops.flash_attention import DWIDE, instance_head_dim, padded_head_dim

    print(f"== phase 22: SD1.x with one head a level (SD1.5 widths, attention_head_dim {ONE_HEAD}) through "
          f"load_interpolation_pipeline: forward kernels vs plain in bf16, f32 and f16, interpolate 7 frames at "
          f"512px, {steps} DDIM steps", flush=True)
    t_phase = time.perf_counter()
    configs = configs or sd15_one_head_configs()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="sd15-one-head-checkpoint-", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        nbytes = write_checkpoint(root, seed=22, device=device, configs=configs)
        print(f"wrote an SD1.5-width diffusers directory with one head a level ({nbytes / 2**30:.2f} GiB of f16 "
              f"weights) in {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        pipe = loader.load_interpolation_pipeline(root, **({} if device == "cuda" else {"device": device}))
        unets = {dt: loader.load_unet(os.path.join(root, "unet"), dtype=dt, device=device)
                 for dt in (torch.float32, torch.float16)}
        torch.cuda.synchronize()
        print(f"load_interpolation_pipeline(dir) and load_unet(dir/unet) in f32 and f16 in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = pipe.unet.config
    heads = [c // h for c, h in zip(cfg.block_out_channels, cfg.num_attention_heads)]
    print(f"UNet: widths {cfg.block_out_channels}, heads {cfg.num_attention_heads}, head dims {heads}; UNet "
          f"{pipe.unet.dtype}, VAE {next(pipe.vae.parameters()).dtype}", flush=True)
    if (cfg != loader.unet_config_from_diffusers(configs["unet"]) or set(cfg.num_attention_heads) != {1}
            or max(heads) <= 512 or pipe.unet.dtype != torch.bfloat16):
        fail(f"the loaded UNet config {cfg} is not the written one with one head a level past 512, or not bf16")
    # the calls a forward makes, by the instance that takes them: D = 320 the
    # D=161-512 entries, 640 and 1280 the wide ones
    want = {}
    for m in pipe.unet.modules():
        if isinstance(m, CrossAttention):
            d = instance_head_dim(padded_head_dim(m.head_dim))
            want[d] = want.get(d, 0) + 1
    print(f"attention calls a forward by instance head dim: {want}", flush=True)
    if set(want) != {512, DWIDE}:
        fail(f"the one-head UNet's attention calls {want} are not at D=512 and the wide entries")

    paths = []
    dev = torch.device(device)
    s = cfg.sample_size
    gen = torch.Generator(device=dev).manual_seed(5)
    sample = torch.randn((7, cfg.in_channels, s, s), generator=gen, device=dev)
    ehs = torch.randn((7, 77, cfg.cross_attention_dim), generator=gen, device=dev)
    t = torch.tensor(500, device=dev)
    aid = AidContext(coef=sd15_coef().to(dev), mode=AidMode.from_name("fused_outer"))
    faults = {"c and 1-c swapped": (aid, coef_swapped), "own segment dropped": (aid, own_dropped),
              "one slice over its own chunk": (aid, slice_own_chunk),
              "every slice over its own chunk": (aid, every_slice_own_chunk)}
    slices = ("one slice over its own chunk", "every slice over its own chunk")
    for unet, tol, name, fault_names in (
            (pipe.unet, SD15_UNET_TOL, "flash_interpolated_attention", ("c and 1-c swapped", "own segment dropped")),
            (unets[torch.float32], F32_UNET_TOL, "flash_interpolated_attention_f32", slices),
            (unets[torch.float16], F16_SD15_UNET_TOL, "flash_interpolated_attention_f16", ("own segment dropped",))):
        x, e = sample.to(unet.dtype), ehs.to(unet.dtype)
        counts = check_unet_vs_plain(f"{unet.dtype} SD1.x one head a level unet fused_outer B=7 {s}x{s}",
                                     lambda a: unet(x, t, e, a), aid, tol, {n: faults[n] for n in fault_names})
        # under "auto" the 1024-token fused_outer calls at D = 640 on the wide static instance (bf16 and f32)
        dt = {torch.bfloat16: "bf16", torch.float32: "f32"}.get(unet.dtype)  # f16: no static instance
        needed = (f"{name}[D=512]", f"{name}[D={DWIDE}]", *(static_needed(dt, [("dwide", 640, "fused_outer")])
                                                            if dt else ()))
        check_wide_only(f"{unet.dtype} SD1.x one-head forward", counts, needed)
        check_static_dims(f"{unet.dtype} SD1.x one-head forward", counts, name, (320,) if dt else (),
                          (640,) if dt else ())
        got = {d: counts[f"{name}[D={d}]"] for d in want}
        if got != want:
            fail(f"the {unet.dtype} one-head forward launched {got} attention entries by head dim, not {want}")
        paths.append(counts)
    del unets, unet, x, e, sample, ehs
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(6)
    latent_a, latent_b = pipe.generate_latent(gen), pipe.generate_latent(gen)
    px = s * 2 ** (len(pipe.vae.config.block_out_channels) - 1)

    def interpolate(**kw):
        return pipe.interpolate(latent_a, latent_b, "prompt A", "prompt B", guide_prompt="a guide prompt", size=7,
                                num_inference_steps=steps, **kw)

    images, counts, times, _, elapsed, peak = run_image_path(pipe, pipe.vae, interpolate, steps, 7)
    check_images(f"SD1.x one head a level interpolate (PAID, {steps} DDIM steps, guidance {pipe.guidance_scale}, "
                 "f32 VAE)", images, (7, px, px, 3), times, elapsed, peak, card)
    check_wide_only("SD1.x one-head interpolate", counts,
                    ("flash_interpolated_attention[D=512]", f"flash_interpolated_attention[D={DWIDE}]",
                     *static_needed("bf16", [("dwide", 640, "fused_outer")])),
                    ("flash_self_attention_f32",))  # the f32 VAE's D=512 attention
    check_static_dims("SD1.x one-head interpolate", counts, "flash_interpolated_attention", (320,), (640,))
    print(f"SD1.x one head a level interpolate: attention launches "
          f"{({n: c for n, c in counts.items() if c and 'attention' in n})}", flush=True)
    paths.append(counts)
    _, _, warm, _, _, _ = run_image_path(pipe, pipe.vae, lambda: interpolate(output_type="latent"), steps, 7)
    print(f"SD1.x one head a level interpolate, sequential CFG: first run {times['s_per_step']:.4f} s/step, warm "
          f"run {warm['s_per_step']:.4f} s/step on {card}; phase 22 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def kernels_line(kernels: dict, launches: dict, by_path=None) -> str:
    """The kernels' JSON record: one entry per kernel, with KERNEL_KEYS
    first, then what phase 3 measured besides (the conv's kernel_ms, the
    library call's name, the self case of the attention kernels, ...).
    ``kernels`` is phase 3's {name: record}, ``launches`` the counts summed
    over the paths, ``by_path`` each path's counts in order (the static
    entries list theirs)."""
    import torch

    from aid_tpu_torch.ops.flash_attention import (
        DMID_SELF_MAX,
        MIDSTREAM_MAX_STREAM,
        MIDSTREAM_MIN_QUERIES,
        MIDSTREAM_MODES,
        ONEPASS_STREAM_TILES,
    )

    flash_src = "aid_tpu_torch/csrc/flash_interpolated_attention.cu"
    onepass_src = "aid_tpu_torch/csrc/flash_attention_onepass.cu"
    midstream_src = "aid_tpu_torch/csrc/flash_attention_midstream.cu"
    conv_src = "aid_tpu_torch/csrc/conv3x3.cu"
    flash_f32_src = "aid_tpu_torch/csrc/flash_interpolated_attention_f32.cu"
    flash_replaces = ("aid_tpu/ops/flash_attention.py:101", {"also_replaces": "aid_tpu/ops/flash_attention.py:339"})
    conv_note = ("ms: through the wrapper, as the model calls it (w tiled once; x laid out by the layout kernel "
                 "aid_conv3x3_blocked_bf16 of the same source, which every launch runs first); kernel_ms: the "
                 "conv launch alone on operands laid out by aid_tpu_torch/ops/conv.py::kernel_operands; "
                 "layout_ms: the layout kernel alone, layout_plain_ms: torch's permuting copy")
    conv_note_f16 = conv_note.replace("aid_conv3x3_blocked_bf16", "aid_conv3x3_blocked_f16")
    attn_note = ("ms: through the wrapper, as the model calls it; kernel_ms: the launch alone on operands "
                 "aid_tpu_torch/ops/flash_attention.py::kernel_launch prepared once")
    d512_src = "aid_tpu_torch/csrc/flash_attention_bf16_d512.cu"
    dmid_src = "aid_tpu_torch/csrc/flash_attention_dmid.cu"
    segments = ("own / begin / end segments, each its own tensor map and length; the outer modes' own softmax state "
                "parked in a global f32 workspace the wrapper allocates per call at the caller's chunk count")
    dmid_design = ("wgmma on TMA tiles of the caller's tensors at the caller's D in 64-column chunks (no padded copy); "
                   "up to 5 chunks each consumer warpgroup owns 64 query rows over all of D (no score exchange), two "
                   "such warpgroups a block past one wave of 64-row blocks, taking turns on named barriers to issue "
                   "their products, 48- or 64-key tiles in K and V rings of two or three slots; 6 to 8 chunks two "
                   f"warpgroups split D and exchange partial scores (32-key tiles); over {segments}; self mode the "
                   "instance with no endpoint set (NSETS 0: the own segment alone, no park, no workspace)")
    dmid_note = ("ms at fused_outer (7,1,4096,320), self_* at self (7,1,4096,320), every case of phase 21's shapes, "
                 "D = 384 and 200 and self mode at 504 under shapes; bound_ms at the caller's D, bound_padded_ms at "
                 "the columns the kernel computes (D rounded up to its chunk); library_ms: SDPA in self mode and "
                 "over [own; K_cross] in the inner modes (none for the outer modes); d512_ms / d512_kernel_ms: self "
                 "mode on the D=512 self kernels with q, k and v padded to 512 (the route before the self "
                 f"instance), through the copies / the launch alone; {attn_note}")
    f32_wgmma = "wgmma 3xTF32 (raw hi), TMA, a split/transpose producer warpgroup"
    dwide_src = "aid_tpu_torch/csrc/flash_attention_dwide.cu"
    dwide_design = ("wgmma on the transposed products S^T = K Q^T and O^T = V^T P^T, the keys in M (128-key tiles as "
                    "two 64-key M blocks, each consumer warpgroup finishing one block's softmax, 32 or 16 query rows "
                    "in N; f32: 64-key tiles, 16 or 8 rows, 3xTF32 with K's and V^T's fragments from registers), Q "
                    "resident, K and V by TMA from one producer thread through a ring of key-tile x 128-column "
                    "slots, D split by 64-column chunks across two consumer warpgroups that exchange partial scores "
                    "once a tile, over own / begin / end segments of their own lengths; the outer modes' sets parked "
                    "in an f32 workspace the wrapper allocates per call; under one wave of blocks the key stream "
                    "split across blocks and merged by a combine kernel (flash_dwide_combine_kernel)")
    dwide_note = ("ms at fused_outer (7,1,1024,640), every case of phase 22's shapes, (2,1,512,2048) and D = 520 "
                  "under shapes; bound_ms at the caller's D, bound_padded_ms at the padded D the kernel computes "
                  "(640, 1024, 1280 or 2048); library_ms: SDPA in self mode and over [own; K_cross] in the inner "
                  f"modes (none for the outer modes); {attn_note}")
    onepass_design = ("the whole key stream of a (b, h) resident in shared memory, loaded once by TMA in 16-key "
                      "tiles (own, then each endpoint segment); blocks as many as the SMs hold, each looping over "
                      "a contiguous run of 64-row query tiles (one or two consumer warpgroups) through a ring of "
                      "three Q/O buffers (Q two tiles ahead, O out by TMA store); S = Q K^T one wgmma over the "
                      "whole stream, each segment's exact row max, the sets combined row by row into one weight a "
                      "segment folded into P, P V one accumulator")
    midstream_design = ("a persistent grid, one block an SM, walking one list of (head, batch row, query tile) "
                        "work items heaviest first (rows keeping their endpoints before skip rows, full tiles "
                        "before a (b, h)'s last) in a snake (block i at position i of even rounds, grid - 1 - i "
                        "of odd ones); 192-row items of three consumer "
                        "warpgroups at D = 64 (one whose rows are all past Sq only passes the stages on), 128-row "
                        "items of two at D = 80; a producer thread running "
                        "ahead across items through a ring of Q/O buffers (the output out by TMA store from the "
                        "item's Q buffer) and a K/V ring over own / begin / end segments; the online softmax on "
                        "wgmma per 64-row warpgroup; the outer modes' own state parked and swapped in shared memory")
    midstream_note = ("ms at self (7,20,1024,64), every routed case of the paths' shapes under shapes with "
                      "parent_ms / parent_kernel_ms (the same call on the D <= 160 streaming kernel, the route before, "
                      "through its host work / the launch alone); library_ms: SDPA in self mode and over "
                      f"[own; K_cross] in the inner modes; {attn_note}")
    onepass_note = ("ms at self (7,10,4096,77), every routed case of the paths' shapes under shapes with "
                    "parent_ms / parent_kernel_ms (the same call on the D <= 160 streaming kernel, the route before, "
                    "through its host work / the launch alone); library_ms: SDPA in self mode and over "
                    f"[own; K_cross] in the inner modes; {attn_note}")
    conv_f32_design = ("wgmma tf32 m64n160k8, both operands in shared memory, 3xTF32 (raw hi; the lo parts of x "
                       "from the layout pass, of w tiled once), one TMA window a K chunk for all nine taps, each "
                       "chunk's sum folded in f32")
    # name -> (source, TPU kernel replaced, the launch counts it is read from, extra fields)
    rows = {
        "flash_interpolated_attention": (
            flash_src, flash_replaces[0], ("flash_interpolated_attention[D=64]",
                                           "-flash_interpolated_attention[onepass D=64]",
                                           "-flash_interpolated_attention[midstream D=64]",
                                           "-flash_interpolated_attention[static D=64]",
                                           "-flash_interpolated_attention[static midstream D=64]"),
            {**flash_replaces[1], "contract": "bf16, head dim 64, every mode (SDXL / SD2.x UNet); ms at "
                                              "fused_outer (7,10,4096,64), self_* at self (7,10,4096,64); "
                                              f"{attn_note}"}),
        "flash_interpolated_attention(D=40/80/160)": (
            flash_src, flash_replaces[0],
            tuple(f"{sign}flash_interpolated_attention[{o}D={d}]" for d in (40, 80, 160)
                  for sign, o in (("", ""), ("-", "onepass "), ("-", "midstream "), ("-", "static "))),
            {**flash_replaces[1], "contract": "bf16, head dims 40/80/160, every mode (SD1.x UNet); "
                                              "ms at fused_outer (7,8,4096,40), self_* at self (7,8,4096,40); "
                                              f"{attn_note}"}),
        "flash_self_attention_f32": (
            "aid_tpu_torch/csrc/flash_attention_f32_d512.cu", "aid_tpu/ops/flash_attention.py:101",
            ("flash_self_attention_f32", "-flash_self_attention_f32[static]"),
            {"design": "wgmma (Q K^T m64n16: hi(Q) hi(K) and lo(Q) hi(K) in tf32 with Q's fragments from "
                       "registers, bf16(Q) bf16(lo(K)) with K's lo made in bf16; O^T = V^T P^T m64n64: hi*hi in "
                       "tf32, lo(V) P + V lo(P) in one packed bf16 pass), the Q tile resident, K and V by TMA "
                       "from a producer warpgroup, D split across two consumer warpgroups that exchange partial "
                       "scores",
             "contract": "f32, head dim 512, self (VAE mid block), three tensor-core passes a product; ms at "
                         "(1,1,16384,512), sd15_* at (7,1,4096,512), tile_* at (1,1,4000,512); ms: through the "
                         "wrapper, as the model calls it; kernel_ms: the launch alone on operands "
                         "aid_tpu_torch/ops/flash_attention.py::d512_launch prepared once"}),
        "flash_self_attention_bf16": (
            "aid_tpu_torch/csrc/flash_attention_bf16_d512.cu", flash_replaces[0],
            ("flash_self_attention_bf16", "-flash_self_attention_bf16[static]"),
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
            flash_f32_src, flash_replaces[0], ("flash_interpolated_attention_f32[D=64]",
                                               "-flash_interpolated_attention_f32[static D=64]"),
            {**flash_replaces[1], "design": f32_wgmma,
             "contract": "f32, head dim 64, every mode (an f32 SDXL / SD2.x UNet), 3xTF32; "
                         "ms at fused_outer (7,10,4096,64), self_* at self (7,10,4096,64); "
                         f"{attn_note}"}),
        "flash_interpolated_attention_f32(D=40/80/160)": (
            flash_f32_src, flash_replaces[0],
            tuple(f"{sign}flash_interpolated_attention_f32[{o}D={d}]" for d in (40, 80, 160)
                  for sign, o in (("", ""), ("-", "static "))),
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
        # the f16 instances of the bf16 designs (one source each, the element
        # type a template parameter): phase 20's paths
        "flash_interpolated_attention_f16": (
            flash_src, flash_replaces[0], ("flash_interpolated_attention_f16[D=64]",
                                           "-flash_interpolated_attention_f16[onepass D=64]",
                                           "-flash_interpolated_attention_f16[midstream D=64]"),
            {**flash_replaces[1], "entry": "aid_flash_attn_f16",
             "contract": "f16, head dim 64, every mode (an f16 SDXL / SD2.x UNet); ms at fused_outer "
                         f"(7,10,4096,64), self_* at self (7,10,4096,64); {attn_note}"}),
        "flash_interpolated_attention_f16(D=40/80/160)": (
            flash_src, flash_replaces[0], tuple(f"{sign}flash_interpolated_attention_f16[{o}D={d}]"
                                                for d in (40, 80, 160)
                                                for sign, o in (("", ""), ("-", "onepass "), ("-", "midstream "))),
            {**flash_replaces[1], "entry": "aid_flash_attn_f16",
             "contract": "f16, head dims 40/80/160, every mode (an f16 SD1.x UNet); ms at fused_outer "
                         f"(7,8,4096,40), self_* at self (7,8,4096,40); {attn_note}"}),
        "flash_self_attention_f16": (
            "aid_tpu_torch/csrc/flash_attention_bf16_d512.cu", flash_replaces[0], ("flash_self_attention_f16",),
            {**flash_replaces[1], "entry": "aid_flash_attn_f16_d512",
             "contract": "f16, head dim 512, self (an f16 VAE's mid block); ms at (1,1,16384,512), sd15_* at "
                         "(7,1,4096,512); ms: through the wrapper, as the model calls it; kernel_ms: the launch "
                         "alone on operands aid_tpu_torch/ops/flash_attention.py::d512_launch prepared once"}),
        "conv3x3_same_f16": (conv_src, "aid_tpu/ops/conv.py:30", ("conv3x3_same_f16",),
                             {"entry": "aid_conv3x3_f16", "contract": f"f16, (7,960,128,128) -> 320; {conv_note_f16}"}),
        "conv3x3_same_f16(packed=True)": (conv_src, "aid_tpu/ops/conv.py:47", ("conv3x3_same_f16",),
                                          {"shares_kernel_with": "conv3x3_same_f16", "entry": "aid_conv3x3_f16",
                                           "contract": f"f16, (7,640,128,128) -> 320; {conv_note_f16}"}),
        "conv3x3_gnsilu_f16": (conv_src, "aid_tpu/ops/conv.py:78", ("conv3x3_gnsilu_f16",),
                               {"entry": "aid_conv3x3_gnsilu_f16",
                                "contract": f"f16, (7,960,128,128) -> 320 with the GN+SiLU prologue; {conv_note_f16}"}),
        # the endpoint modes at head dims 161-512 (phase 21's SD 1.x UNet at
        # 320-wide heads), in the two D=161-512 sources
        "flash_interpolated_attention(D=161-512)": (
            dmid_src, flash_replaces[0], ("flash_interpolated_attention[D=512]",
                                          "-flash_interpolated_attention[static dmid]"),
            {**flash_replaces[1], "entry": "aid_flash_attn_bf16_dmid", "design": dmid_design,
             "contract": f"bf16, head dims 161-512 at the caller's D, the four endpoint modes, and self mode at "
                         f"161-{DMID_SELF_MAX[torch.bfloat16]} (its self instance, n_sets 0); {dmid_note}"}),
        "flash_interpolated_attention_f16(D=161-512)": (
            dmid_src, flash_replaces[0], ("flash_interpolated_attention_f16[D=512]",),
            {**flash_replaces[1], "entry": "aid_flash_attn_f16_dmid", "design": dmid_design,
             "contract": f"f16, head dims 161-512 at the caller's D, the four endpoint modes, and self mode at "
                         f"161-{DMID_SELF_MAX[torch.float16]} (its self instance, n_sets 0); {dmid_note}"}),
        "flash_interpolated_attention_f32(D=161-512)": (
            "aid_tpu_torch/csrc/flash_attention_dmid_f32.cu", flash_replaces[0],
            ("flash_interpolated_attention_f32[D=512]", "-flash_interpolated_attention_f32[static dmid]"),
            {**flash_replaces[1], "entry": "aid_flash_attn_f32_dmid",
             "design": "wgmma on TMA tiles of the caller's tensors at the caller's D in 32-column chunks, each product "
                       "in three tensor-core passes (1.5 TF32 + 1.5 bf16: K's lo and P V's small terms as bf16), O^T = "
                       "V^T P^T in 64-row M blocks, two consumer warpgroups sharing a tile's Q K^T chunks and M blocks "
                       "and exchanging partial scores, 32-key tiles up to D = 320 (16 above) beside the resident Q "
                       f"tile, over {segments}; self mode the instance with no endpoint set (NSETS 0)",
             "contract": f"f32, head dims 161-512 at the caller's D, the four endpoint modes, and self mode at "
                         f"161-{DMID_SELF_MAX[torch.float32]} (its self instance, n_sets 0); bound_ms at the caller's D "
                         "with 1.5 TF32 "
                         f"+ 1.5 bf16 passes; {dmid_note}"}),
        # every mode past head dim 512 (phase 22's SD 1.x UNet with one head a
        # level), one source, three element types
        **{f"flash_interpolated_attention{sfx}(D=513-2048)": (
            dwide_src, flash_replaces[0], (f"flash_interpolated_attention{sfx}[D=2048]",
                                           *((f"-flash_interpolated_attention{sfx}[static dwide]",) if ty != "f16"
                                             else ())),
            {**flash_replaces[1], "entry": f"aid_flash_attn_{ty}_dwide", "design": dwide_design,
             "contract": f"{ty}, head dims 513-2048, every mode{' (3xTF32)' if ty == 'f32' else ''}; {dwide_note}"})
           for sfx, ty in (("", "bf16"), ("_f16", "f16"), ("_f32", "f32"))},
        # the short key streams (77-key text cross-attention, the IP tokens,
        # short self calls) at D <= 160 in bf16 and f16, one source
        **{f"flash_interpolated_attention{sfx}(onepass)": (
            onepass_src, "aid_tpu/ops/flash_attention.py:339", (f"flash_interpolated_attention{sfx}[onepass]",),
            {"entry": f"aid_flash_attn_{ty}_onepass", "design": onepass_design,
             "contract": f"{ty}, head dims 40/64/80/160, every mode, streams of up to {ONEPASS_STREAM_TILES[-1]} "
                         f"16-key tiles that fit its shared memory; {onepass_note}"})
           for sfx, ty in (("", "bf16"), ("_f16", "f16"))},
        # the mid-length streams (past the short-stream kernel up to the JAX
        # wrapper's onepass_max: SDXL's 1024-token self and fused_outer calls,
        # SD 2.1's 576 and 2304, SD 1.5's 1024 at D = 80) in bf16 and f16, one source
        **{f"flash_interpolated_attention{sfx}(midstream)": (
            midstream_src, "aid_tpu/ops/flash_attention.py:339", (f"flash_interpolated_attention{sfx}[midstream]",),
            {"entry": f"aid_flash_attn_{ty}_midstream", "design": midstream_design,
             "contract": f"{ty}, head dims 64/80, every mode, streams past the short-stream kernel up to "
                         f"{MIDSTREAM_MAX_STREAM} keys (own keys and each endpoint segment's) with at least "
                         f"{MIDSTREAM_MIN_QUERIES} query rows a (b, h), in the modes measured faster at each head "
                         f"dim ({'; '.join(f'D = {d}: ' + '/'.join(sorted(m)) for d, m in MIDSTREAM_MODES.items())}); "
                         f"{midstream_note}"})
           for sfx, ty in (("", "bf16"), ("_f16", "f16"))},
    }
    # the static-shift instances (static_smax, C = 40): the static branches of both TPU kernels
    static_tail = ("exact_ms / exact_kernel_ms: the same call on the exact route, in turns; window: its edges at the "
                   "first case's shape (bottom: row maxes near -23 against the exact softmax; clipped: far past +70 "
                   "against the plain static shift, the exact softmax's distance being the planted fault 'the clip "
                   "dropped'); launches_by_path: the static launches of each path in order; every case under shapes")
    static_note = f"static_smax = 40; {attn_note}; {static_tail}"
    static_design = ("the exact instance's body built with AID_STATIC_SHIFT = 1 in a translation unit of its own: P = "
                     "2^min(s scale log2(e) - C log2(e), 30 log2(e)), no row max, no quad reduction, no rescale of O "
                     "and l; the outer modes' park kept; each row's sum guarded at 1e-37")
    static_replaces = ("aid_tpu/ops/flash_attention.py:210", {"also_replaces": "aid_tpu/ops/flash_attention.py:520"})
    f32_auto = " (3xTF32; under auto to 1024, the widest the JAX wrapper takes in f32)"
    rows.update({
        "flash_interpolated_attention(static)": (
            "aid_tpu_torch/csrc/flash_interpolated_attention_static.cu", static_replaces[0],
            ("flash_interpolated_attention[static]",),
            {**static_replaces[1], "entry": "aid_flash_attn_bf16_static", "design": static_design,
             "contract": f"bf16, head dims 40/64/80/160, every mode; ms at self (7,10,4096,64); {static_note}"}),
        "flash_interpolated_attention(static midstream)": (
            "aid_tpu_torch/csrc/flash_attention_midstream_static.cu", "aid_tpu/ops/flash_attention.py:520",
            ("flash_interpolated_attention[static midstream]",),
            {"entry": "aid_flash_attn_bf16_midstream_static", "design": f"{midstream_design}; {static_design}",
             "contract": f"bf16, head dim 64, the four endpoint modes (self stays exact), the mid-length stream "
                         f"kernel's calls; ms at fused_outer (7,20,1024,64); {static_note}"}),
        "flash_interpolated_attention_f32(static)": (
            "aid_tpu_torch/csrc/flash_interpolated_attention_f32_static.cu", static_replaces[0],
            ("flash_interpolated_attention_f32[static]",),
            {**static_replaces[1], "entry": "aid_flash_attn_f32_static", "design": f"{f32_wgmma}; {static_design}",
             "contract": f"f32, head dims 40/64/80/160, every mode, 3xTF32; ms at self (7,10,4096,64); "
                         f"{static_note}"}),
        # past head dim 160: the D=161-512 kernels' (phase 21's SD 1.x at 320-wide heads) and the D=512 self
        # kernels' (the VAE mid block) static instances
        "flash_interpolated_attention(static dmid)": (
            "aid_tpu_torch/csrc/flash_attention_dmid_static.cu", static_replaces[0],
            ("flash_interpolated_attention[static dmid]",),
            {**static_replaces[1], "entry": "aid_flash_attn_bf16_dmid_static",
             "design": f"{dmid_design}; {static_design} (the park keeps O and l, no max)",
             "contract": f"bf16, head dims 161-512 at the caller's D, the four endpoint modes and self mode at "
                         f"161-{DMID_SELF_MAX[torch.bfloat16]}; ms at fused_outer (7,1,4096,320); library_ms: SDPA "
                         f"in self mode (none for the endpoint modes); {static_note}"}),
        "flash_interpolated_attention_f32(static dmid)": (
            "aid_tpu_torch/csrc/flash_attention_dmid_f32_static.cu", static_replaces[0],
            ("flash_interpolated_attention_f32[static dmid]",),
            {**static_replaces[1], "entry": "aid_flash_attn_f32_dmid_static",
             "design": "the f32 D=161-512 design (3xTF32 as 1.5 TF32 + 1.5 bf16 passes, 32-column chunks, two "
                       f"warpgroups sharing a tile's work); {static_design} (each M block's tile product added "
                       "with no factor; the park keeps O and l, no max)",
             "contract": f"f32, head dims 161-512 at the caller's D, the four endpoint modes and self mode at "
                         f"161-{DMID_SELF_MAX[torch.float32]}; ms at fused_outer (7,1,4096,320); bound_ms at 1.5 "
                         f"TF32 + 1.5 bf16 passes; library_ms: SDPA in self mode (none for the endpoint modes); "
                         f"{static_note}"}),
        # past head dim 512: the wide kernels' static instances (phase 22's SD 1.x with one head a level)
        **{f"flash_interpolated_attention{sfx}(static dwide)": (
            "aid_tpu_torch/csrc/flash_attention_dwide_static.cu", static_replaces[0],
            (f"flash_interpolated_attention{sfx}[static dwide]",),
            {**static_replaces[1], "entry": f"aid_flash_attn_{ty}_dwide_static",
             "design": f"{dwide_design}; {static_design} (no column maxima: two named barriers a tile; each chunk's "
                       "P V added to O with no factor; the combine step O = sum O_s / sum l_s, with no max pass)",
             "contract": f"{ty}, head dims 513-2048, every mode{f32_auto if ty == 'f32' else ''}; ms at fused_outer "
                         "(7,1,1024,640); bound_ms at the caller's D; library_ms: SDPA in self mode (none for the "
                         "other modes); "
                         f"{static_note}"})
           for sfx, ty in (("", "bf16"), ("_f32", "f32"))},
        "flash_self_attention_f32(static)": (
            "aid_tpu_torch/csrc/flash_attention_f32_d512_static.cu", static_replaces[0],
            ("flash_self_attention_f32[static]",),
            {**static_replaces[1], "entry": "aid_flash_attn_f32_d512_static",
             "design": "the f32 D=512 design (wgmma, three tensor-core passes a product, D split across two "
                       f"consumer warpgroups); {static_design} (no rows' factors in shared memory; each 64-row "
                       "block of O^T's tile product still summed from zero and added in f32)",
             "contract": f"f32, head dim 512 (and self calls past {DMID_SELF_MAX[torch.float32]}, padded to 512), "
                         "self (the VAE mid block); ms at (1,1,16384,512), every case under shapes; ms: through the "
                         "wrapper at static_smax = 40; kernel_ms: the launch alone on operands "
                         "aid_tpu_torch/ops/flash_attention.py::d512_launch prepared once; bound_ms at 1.5 TF32 + "
                         f"1.5 bf16 passes; {static_tail}"}),
        "flash_self_attention_bf16(static)": (
            "aid_tpu_torch/csrc/flash_attention_bf16_d512_static.cu", static_replaces[0],
            ("flash_self_attention_bf16[static]",),
            {**static_replaces[1], "entry": "aid_flash_attn_bf16_d512_static",
             "design": "the bf16 D=512 design (wgmma, TMA K and V rings, D split across two consumer warpgroups, "
                       f"software-pipelined); {static_design} (no o *= alpha over each warpgroup's 256 columns)",
             "contract": "bf16, head dim 512, self (a bf16 VAE's mid block); ms at (1,1,16384,512), every case "
                         "under shapes; ms: through the wrapper at static_smax = 40; kernel_ms: the launch alone on "
                         "operands aid_tpu_torch/ops/flash_attention.py::d512_launch prepared once; "
                         f"{static_tail}"}),
    })
    record = []
    for name, (src, replaces, counters, extra) in rows.items():
        r = kernels[name]
        # a counter named "-..." is subtracted: the D <= 160 counts hold the short-stream kernel's launches too
        n = sum(-launches.get(c[1:], 0) if c.startswith("-") else launches[c] for c in counters)
        if by_path is not None and "(static" in name:
            extra = {**extra, "launches_by_path": [p.get(counters[0], 0) for p in by_path]}
        record.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": n, "max_abs_err": r["max_abs_err"],
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

    start = time.perf_counter()
    card = phase_device()
    import torch

    phase_build()
    sd21_classes = sd21_fused_conv_classes()
    unet, sample, ehs, uncond, added, coef = build_headline()
    fused_classes = fused_conv_classes(unet, sample, ehs, added)
    kernels = phase_kernels(coef, sd15_coef(), fused_classes, sd21_classes)
    phase_unet(unet, sample, ehs, added, coef)
    main_counts, main_out = phase_main(unet, sample, ehs, uncond, added, coef, args.steps, card)
    paths = [main_counts]
    paths += phase_engine(unet, sample, ehs, uncond, added, coef, card)
    paths.append(phase_fused(unet, sample, ehs, uncond, added, coef, sum(fused_classes.values()), card))
    # phase 19 (a) runs here, on phase 5's program and its result
    paths.append(phase_frames_world_one(unet, sample, ehs, uncond, added, coef, args.steps, main_out, main_counts,
                                        card))
    del sample, ehs, uncond, added, coef, main_out
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
    torch.cuda.empty_cache()
    pipe, counts = phase_sd15_safety(card)
    paths.append(counts)
    paths += phase_selection(pipe, card)
    paths.append(phase_app(pipe, card))  # phase 19 (c), on phase 15's pipeline
    del pipe
    torch.cuda.empty_cache()
    paths += phase_ip_adapter(card)
    torch.cuda.empty_cache()
    paths += phase_single_file(card)
    torch.cuda.empty_cache()
    paths += phase_f16(card, args.steps)
    torch.cuda.empty_cache()
    paths += phase_wide_heads(card)
    torch.cuda.empty_cache()
    paths += phase_one_head_a_level(card)
    torch.cuda.empty_cache()
    paths += phase_frames(card)  # phase 19 (b)
    # the union of the paths' counters (the D=161-512 static counts name the head dims each path launched)
    launches = {name: sum(p.get(name, 0) for p in paths) for name in dict.fromkeys(n for p in paths for n in p)}
    print(f"launches over the {len(paths)} paths: {launches}", flush=True)
    print(f"smoke wall time {time.perf_counter() - start:.1f} s (the limit is 1200 s)", flush=True)

    print(kernels_line(kernels, launches, paths), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
