// The static-shift instance of the bf16 D=512 self-attention kernel, sm_90a:
// flash_attention_bf16_d512.cu built with AID_STATIC_SHIFT = 1 (its header says
// what changes), bf16 only, entry aid_flash_attn_bf16_d512_static (the VAE mid
// block's attention in a bf16 VAE). It follows the static branch of the Pallas
// TPU kernel `_kernel` (aid_tpu/ops/flash_attention.py:210-256). A translation
// unit of its own, so the build compiles it beside the exact instances, one
// nvcc each.
#define AID_STATIC_SHIFT 1
#include "flash_attention_bf16_d512.cu"
