// Shared by the f32 kernels (flash_attention_f32_d512.cu,
// flash_interpolated_attention_f32.cu, conv3x3_f32.cu): 16-byte cp.async
// copies with zero fill, and the 3xTF32 building blocks on
// mma.sync.m16n8k8.tf32 (a = hi + lo, hi*hi + hi*lo + lo*hi in f32).
// Included inside each source's anonymous namespace.

// 16-byte async copy global -> shared; copies zeros when !pred.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo: hi = tf32(a) rounded to nearest, lo = a - hi exactly (the
// tensor cores read lo's tf32 part, dropping its low 13 bits)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// c(16x8, f32) += a(16x8, tf32, row) * b(8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (rows g, g + 8) of the 8 columns at p, row pitch ld, split.
// The k order inside an 8-wide step is free as long as A and B agree:
// fragment k = t and t + 4 are columns 2t and 2t + 1, so each thread's pair
// is one 8-byte shared load.
__device__ __forceinline__ void load_a_split(const float* p, int ld, int g, int t, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  split_tf32(r0.x, hi[0], lo[0]);
  split_tf32(r1.x, hi[1], lo[1]);
  split_tf32(r0.y, hi[2], lo[2]);
  split_tf32(r1.y, hi[3], lo[3]);
}
