// The static-shift instances of the wide kernels (head dims 513-2048), sm_90a:
// flash_attention_dwide.cu built with AID_STATIC_SHIFT = 1 (its header says
// what changes), bf16 and f32 (no f16 instance: exp(-40) is below f16's
// smallest subnormal), every endpoint mode and self mode, the key split's
// combine step static too, entries aid_flash_attn_bf16_dwide_static and
// aid_flash_attn_f32_dwide_static. They follow the static branch of the
// Pallas TPU kernel `_kernel` (aid_tpu/ops/flash_attention.py:210-256). A
// translation unit of its own, so the build compiles it beside the exact
// instances, one nvcc each.
#define AID_STATIC_SHIFT 1
#include "flash_attention_dwide.cu"
