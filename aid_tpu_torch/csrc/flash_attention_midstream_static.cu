// The static-shift instances of the bf16 mid-length stream kernel, sm_90a:
// flash_attention_midstream.cu built with AID_STATIC_SHIFT = 1 (its header
// says what changes), D = 64 in the four endpoint modes, entry
// aid_flash_attn_bf16_midstream_static. They follow the static branch of the
// Pallas TPU kernel `_kernel_onepass` (aid_tpu/ops/flash_attention.py:520-545).
// A translation unit of its own, so the build compiles it beside the exact
// instances, one nvcc each.
#define AID_STATIC_SHIFT 1
#include "flash_attention_midstream.cu"
