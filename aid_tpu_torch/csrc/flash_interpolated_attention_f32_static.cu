// The static-shift instances of the f32 D <= 160 flash kernel, sm_90a:
// flash_interpolated_attention_f32.cu built with AID_STATIC_SHIFT = 1 (its
// header says what changes), every mode at head dims 40/64/80/160, entry
// aid_flash_attn_f32_static. They follow the static branches of the Pallas
// TPU kernels `_kernel` (aid_tpu/ops/flash_attention.py:210-256) and
// `_kernel_onepass` (:520-545). A translation unit of its own, so the build
// compiles it beside the exact instances, one nvcc each.
#define AID_STATIC_SHIFT 1
#include "flash_interpolated_attention_f32.cu"
