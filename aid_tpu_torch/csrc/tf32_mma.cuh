// Shared by the f32 kernels (flash_attention_f32_d512.cu,
// flash_interpolated_attention_f32.cu, conv3x3_f32.cu): 16-byte cp.async
// copies with zero fill, the 3xTF32 building blocks on
// mma.sync.m16n8k8.tf32 (a = hi + lo, hi*hi + hi*lo + lo*hi in f32), and
// those on wgmma.mma_async ... tf32 (k8): A from registers, B K-major in
// 128- or 64-byte-swizzled shared memory. Included inside each source's
// anonymous namespace.

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

// a - trunc(a): the part of an f32 operand that the tensor cores drop when
// they read it as tf32 (its low 13 mantissa bits), exact in f32. With the
// raw f32 value as the hi operand, hi*hi + hi*lo + lo*hi is 3xTF32.
__device__ __forceinline__ float tf32_rest(float a) {
  return a - __uint_as_float(__float_as_uint(a) & 0xFFFFE000u);
}

// wgmma descriptor of a K-major tile in 128-byte-swizzled shared memory:
// rows of 128 bytes (32 f32), 8-row groups 1024 bytes apart (SBO); a k8
// step of tf32 is 32 bytes, so steps move the start within a row
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// the same for a K-major tile of 64-byte rows (16 f32) under the 64-byte
// swizzle: 8-row groups 512 bytes apart; a k8 step moves the start 32 bytes
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving register reads (accumulators) or reuses
// (A operands, read asynchronously by wgmma) across the wait before it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// The A register fragment of wgmma m64nNk8 tf32 is mma.sync m16n8k8's per
// warp (warp w of the warpgroup holds rows 16w ..): a0..a3 at (row, k) =
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), g = lane / 4, t = lane % 4.
// The accumulator is m16n8's per n8 tile j: d[4j..4j+3] at (g, 8j + 2t),
// (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1).
// D(64 x 16, f32) (+)= A(64 x 8, tf32 registers) B(8 x 16, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 32, f32) (+)= A(64 x 8, tf32 registers) B(8 x 32, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 40, f32) (+)= A(64 x 8, tf32 registers) B(8 x 40, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[20], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) (+)= A(64 x 8, tf32 registers) B(8 x 64, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 80, f32) (+)= A(64 x 8, tf32 registers) B(8 x 80, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
