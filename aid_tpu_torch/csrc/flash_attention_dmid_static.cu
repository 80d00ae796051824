// The static-shift instances of the bf16 D=161-512 kernel, sm_90a:
// flash_attention_dmid.cu built with AID_STATIC_SHIFT = 1 (its header says what
// changes), bf16 only, both layouts (the rows layout up to 5 chunks of 64
// columns, the split one past it), every endpoint mode and self mode, entry
// aid_flash_attn_bf16_dmid_static. They follow the static branch of the Pallas
// TPU kernel `_kernel` (aid_tpu/ops/flash_attention.py:210-256). A translation
// unit of its own, so the build compiles it beside the exact instances, one
// nvcc each.
#define AID_STATIC_SHIFT 1
#include "flash_attention_dmid.cu"
