// The static-shift instances of the f32 D=161-512 kernel, sm_90a:
// flash_attention_dmid_f32.cu built with AID_STATIC_SHIFT = 1 (its header says
// what changes), every endpoint mode and self mode, entry
// aid_flash_attn_f32_dmid_static. They follow the static branch of the Pallas
// TPU kernel `_kernel` (aid_tpu/ops/flash_attention.py:210-256). A translation
// unit of its own, so the build compiles it beside the exact instances, one
// nvcc each.
#define AID_STATIC_SHIFT 1
#include "flash_attention_dmid_f32.cu"
