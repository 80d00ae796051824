// The two 16-bit element types of the bf16 designs (flash_interpolated_attention.cu,
// flash_attention_bf16_d512.cu, conv3x3.cu), each design a template over
// its element type T: __nv_bfloat16 or __half. Elem<T> gives the pair
// pack (two f32 values rounded to nearest, the low one first), its unpack,
// and the TMA data type; AID_WGMMA_16 emits a wgmma with T's type suffix
// (f32 accumulation in both). Included inside each source's anonymous
// namespace, after <cuda.h>, <cuda_bf16.h>, <cuda_fp16.h> and <stdint.h>.

template <class T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  }
};

// f16 goes to inf past 65504 and subnormal below 6.1e-5: every mask and
// running max stays on the f32 scores, and only softmax weights (in [0, 1])
// and finished outputs are rounded to it.
template <>
struct Elem<__half> {
  static constexpr bool kHalf = true;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<__half2*>(&w));
  }
};

// ASM(TY) with TY the wgmma type suffix of T, "bf16" or "f16": an asm
// template is a string literal, so each instance spells its own out.
#define AID_WGMMA_16(T, ASM)          \
  do {                                \
    if constexpr (Elem<T>::kHalf) {   \
      ASM("f16");                     \
    } else {                          \
      ASM("bf16");                    \
    }                                 \
  } while (0)
