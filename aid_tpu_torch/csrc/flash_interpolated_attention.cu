// Flash interpolated attention for the AID family, bf16, head dims 40/64/80/160, sm_90a.
//
// Replaces the two Pallas TPU kernels behind
// aid_tpu/ops/flash_attention.py::flash_interpolated_attention
// (flash_attention.py:683-1061): the streaming online-softmax `_kernel`
// (flash_attention.py:101) and the whole-stream-resident `_kernel_onepass`
// (flash_attention.py:339). One kernel covers both: their split, the
// one-pass routing threshold, head grouping, `mxu_den`, `static_smax` and
// `pad_d` came from VMEM and Mosaic limits and have no counterpart here.
//
// What it computes (the JAX function's contract), per batch row b:
//   self         softmax(q k_b^T) v_b
//   fused_outer  (1-c_b) Attn(q, [k_b; K_begin]) + c_b Attn(q, [k_b; K_end])
//   pure_outer   (1-c_b) Attn(q, K_begin)        + c_b Attn(q, K_end)
//   fused_inner  Attn(q, [k_b; K_cross]),  K_cross = lerp(K_begin, K_end, c_b)
//   pure_inner   Attn(q, K_cross)
// The inner modes' K_cross/V_cross are lerped in f32 by the wrapper (as
// `pack_stream` does on the TPU) and arrive in the K_begin/V_begin slot.
// Endpoints are read in place through their own strides: a batch stride of
// 0 lets every row read one shared (H, Le, D) endpoint, so the B-fold
// broadcast never exists in memory. A row with skip != 0 drops its endpoint
// segments (fused modes), which makes it exactly vanilla attention.
//
// Head dims: 64 (SDXL, SD2.x), and 40, 80, 160 (SD1.x's 8 heads at widths
// 320, 640, 1280). The head dim D is a template parameter.
//
// What bounds it on the card: at the self-attention shapes (S = 1024..4096
// keys per segment) attention is compute-bound: 4*S*L*D flops against
// 2*(S+L)*D*2 bytes, well above the H100's ~295 flop/byte bf16 ridge. So the
// design keeps the tensor cores busy and the logits out of device memory:
//   * one thread block of 4 warps per (q-tile of 64 rows, head, batch row);
//     each warp owns 16 query rows, held in registers as mma A fragments;
//   * an inner loop over 64-key tiles of each KV segment (own, begin, end)
//     takes the place of the TPU's sequential kv grid axis; the tiles are
//     double-buffered in (dynamic) shared memory with cp.async, so the next
//     tile's loads overlap this tile's products;
//   * mma fragments come from shared memory by ldmatrix (`.trans` for V,
//     whose PV operand is the transpose of its row-major tile), from rows
//     padded by 8 elements (112, 144, 176 or 336 bytes) so the 8 row reads
//     of a matrix hit distinct banks;
//   * S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); the S accumulator layout is the A-operand layout of P, so
//     probabilities go from registers to the PV product without shared memory;
//   * online softmax in f32 (exp2 with log2(e) folded into the scale), the
//     probabilities cast to bf16 for the PV product;
//   * outer modes carry two accumulator sets. The own segment is common to
//     both, so it is computed ONCE into set A, which is then copied to set E
//     before the begin segment updates A and the end segment updates E, each
//     with its own running max;
//   * ragged segment tails are masked with -inf scores and zero-filled tiles
//     (q 4096 against 77 text keys, 77-token endpoints).
// What the head dims other than 64 need:
//   * D = 40 is not a multiple of the mma k step (16): Q K^T contracts over
//     48 columns. The Q fragments' columns 40..47 are zeros (never read from
//     global memory, where they would be the next head), and K's pad columns
//     in shared memory are zeroed once per block (uninitialised bits could be
//     NaN, and 0 * NaN is NaN). P V has 5 n8 tiles: ldmatrix.x4.trans loads
//     them in pairs, the fifth with an .x2. Stores write the 40 real columns.
//   * D = 160: two accumulator sets of 16x160 f32 (160 registers a thread)
//     beside 40 registers of Q fragments and 32 of scores would pass 255 and
//     spill. So two blocks share each q tile, each owning 80 of the output
//     columns: both compute the full Q K^T (the scores and the softmax are
//     the same in both), and each multiplies P by its half of V. That costs
//     a second Q K^T (1.25x the flops) and keeps every instance in registers;
//     at D = 160 the SD1.x sequences are 256 and 64 tokens, so the extra work
//     is small. Its K and V tiles take 64 KB, over the 48 KB a launch gets by
//     default: every instance uses dynamic shared memory and sets its limit.
// Not yet done (later work): wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// The kernel's shape at head dim D.
template <int D>
struct Cfg {
  static_assert(D % 8 == 0, "rows are copied in 16-byte chunks");
  static constexpr int kDK = (D + 15) / 16 * 16;      // Q K^T contraction, padded to the mma k step
  static constexpr int kKSteps = kDK / 16;
  static constexpr int kSplit = D > 128 ? 2 : 1;      // blocks sharing a q tile, one slice of output columns each
  static constexpr int kDV = D / kSplit;              // output (V) columns per block
  static constexpr int kNT = kDV / 8;                 // n8 output tiles per block
  static constexpr int kLdK = kDK + 8;                // padded smem row of K
  static constexpr int kLdV = (kDV + 15) / 16 * 16 + 8;  // padded smem row of V
  static constexpr int kChunksK = D / 8;              // 16-byte chunks of a K row in global memory
  static constexpr int kChunksV = kDV / 8;            // ... of the V columns a block reads
  static constexpr int kSmemBytes = 2 * kBK * (kLdK + kLdV) * 2;  // double-buffered K and V tiles
};

struct Strides {
  long long b, h, s;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  const __nv_bfloat16* ke;
  const __nv_bfloat16* ve;
  __nv_bfloat16* out;
  const float* coef;
  const int* skip;
  int B, H, Sq, Lk, Le;
  Strides sq, sk, sv, skb, svb, ske, sve, so;
  float scale_log2;  // softmax scale * log2(e)
};

template <int NT>
struct State {
  float o[NT][4];  // 16 rows x (8 NT) columns accumulator, mma C layout
  float m[2];      // running max of rows g and g+8 (log2 domain)
  float l[2];      // this thread's partial row sums; reduced over the quad at the end
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two matrices: lanes 0-15 give the row addresses (the others are ignored).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// 16-byte async copy global -> shared; copies zeros when !pred.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NT>
__device__ __forceinline__ void init_state(State<NT>& st) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  }
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// Copy `rows` x CHUNKS 16-byte chunks of a row-major segment into a smem
// tile with cp.async; consecutive threads take consecutive chunks of a row
// (coalesced). Rows at or past `len` are zero-filled.
template <int CHUNKS, int LD>
__device__ __forceinline__ void load_rows_async(const __nv_bfloat16* src, long long stride, int row0, int len,
                                                __nv_bfloat16 (*dst)[LD]) {
  constexpr int kTotal = kBK * CHUNKS;
#pragma unroll
  for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kTotal % kThreads == 0 || idx < kTotal) {
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      const int row = row0 + r;
      const bool ok = row < len;
      cp_async16(&dst[r][c * 8], ok ? src + row * stride + c * 8 : src, ok);
    }
  }
}

// Start staging keys [row0, row0 + kBK) of one (b, h) segment: all D
// columns of K, and the kDV columns of V this block multiplies (vp already
// points at the first of them).
template <int D>
__device__ __forceinline__ void load_tile_async(const __nv_bfloat16* kp, long long ks, const __nv_bfloat16* vp,
                                                long long vs, int row0, int len,
                                                __nv_bfloat16 (*Ks)[Cfg<D>::kLdK],
                                                __nv_bfloat16 (*Vs)[Cfg<D>::kLdV]) {
  load_rows_async<Cfg<D>::kChunksK, Cfg<D>::kLdK>(kp, ks, row0, len, Ks);
  load_rows_async<Cfg<D>::kChunksV, Cfg<D>::kLdV>(vp, vs, row0, len, Vs);
}

// One 64-key tile of online softmax for this warp's 16 query rows.
template <int D>
__device__ __forceinline__ void tile_update(State<Cfg<D>::kNT>& st, const uint32_t (&qa)[Cfg<D>::kKSteps][4],
                                            __nv_bfloat16 (*Ks)[Cfg<D>::kLdK], __nv_bfloat16 (*Vs)[Cfg<D>::kLdV],
                                            int valid, float scale_log2) {
  using C = Cfg<D>;
  const int lane = threadIdx.x & 31, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  // S = Q K^T: B operand (k = d, n = key) is K row-major; one ldmatrix.x4
  // gives b0, b1 of two adjacent 8-key n-tiles
#pragma unroll
  for (int kk = 0; kk < C::kKSteps; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, &Ks[p * 16 + (lane & 7) + ((lane >> 4) << 3)][kk * 16 + ((lane >> 3) & 1) * 8]);
      mma16816(s[2 * p], qa[kk], b[0], b[1]);
      mma16816(s[2 * p + 1], qa[kk], b[2], b[3]);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + t * 2 + (e & 1);
      s[j][e] = col < valid ? s[j][e] * scale_log2 : -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  // a row's 64 scores are spread over the 4 threads of a quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds at least one valid key, so the new max is finite
  const float mn0 = fmaxf(st.m[0], mx0), mn1 = fmaxf(st.m[1], mx1);
  const float al0 = exp2f(st.m[0] - mn0), al1 = exp2f(st.m[1] - mn1);
  st.m[0] = mn0;
  st.m[1] = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2f(s[j][0] - mn0);
    s[j][1] = exp2f(s[j][1] - mn0);
    s[j][2] = exp2f(s[j][2] - mn1);
    s[j][3] = exp2f(s[j][3] - mn1);
    ls0 += s[j][0] + s[j][1];
    ls1 += s[j][2] + s[j][3];
  }
  st.l[0] = st.l[0] * al0 + ls0;
  st.l[1] = st.l[1] * al1 + ls1;
#pragma unroll
  for (int j = 0; j < C::kNT; ++j) {
    st.o[j][0] *= al0;
    st.o[j][1] *= al0;
    st.o[j][2] *= al1;
    st.o[j][3] *= al1;
  }
  // O += P V: P's A fragments are the S accumulators of two adjacent
  // n-tiles; the B operand (k = key, n = d) is V's tile transposed, which
  // ldmatrix.trans reads from the row-major tile (two 8-wide d-tiles per x4,
  // and an x2 for an odd last one)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int p = 0; p < C::kNT / 2; ++p) {
      uint32_t b[4];
      ldsm_x4_trans(b, &Vs[kk * 16 + (lane & 15)][p * 16 + (lane >> 4) * 8]);
      mma16816(st.o[2 * p], pa, b[0], b[1]);
      mma16816(st.o[2 * p + 1], pa, b[2], b[3]);
    }
    if (C::kNT % 2) {
      uint32_t b[2];
      ldsm_x2_trans(b, &Vs[kk * 16 + (lane & 15)][(C::kNT - 1) * 8]);
      mma16816(st.o[C::kNT - 1], pa, b[0], b[1]);
    }
  }
}

// All tiles of one KV segment, double-buffered: tile i+1 loads while tile i computes.
template <int D>
__device__ __forceinline__ void run_segment(State<Cfg<D>::kNT>& st, const uint32_t (&qa)[Cfg<D>::kKSteps][4],
                                            const __nv_bfloat16* kp, long long ks, const __nv_bfloat16* vp,
                                            long long vs, int len, float scale_log2,
                                            __nv_bfloat16 (*Ks)[kBK][Cfg<D>::kLdK],
                                            __nv_bfloat16 (*Vs)[kBK][Cfg<D>::kLdV]) {
  const int ntiles = (len + kBK - 1) / kBK;
  __syncthreads();  // the buffers' previous users are done
  load_tile_async<D>(kp, ks, vp, vs, 0, len, Ks[0], Vs[0]);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_tile_async<D>(kp, ks, vp, vs, (i + 1) * kBK, len, Ks[(i + 1) & 1], Vs[(i + 1) & 1]);
    cp_async_commit();  // possibly empty: keeps the group count in step
    cp_async_wait<1>();  // tile i has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    tile_update<D>(st, qa, Ks[i & 1], Vs[i & 1], min(kBK, len - i * kBK), scale_log2);
    __syncthreads();  // buffer i & 1 is free for the prefetch of tile i + 2
  }
}

template <int NT>
__device__ __forceinline__ void row_sums(const State<NT>& st, float& l0, float& l1) {
  l0 = st.l[0];
  l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}

// HAS_OWN: the row's own K/V segment leads the stream (self and fused modes).
// NSETS: 0 = no endpoint segment (self), 1 = one cross segment (inner),
// 2 = begin and end segments with two accumulator sets (outer).
template <int D, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int NT = C::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16 (*)[kBK][C::kLdK]>(smem);
  auto Vs = reinterpret_cast<__nv_bfloat16 (*)[kBK][C::kLdV]>(smem + 2 * kBK * C::kLdK * sizeof(__nv_bfloat16));

  const int b = blockIdx.z, h = blockIdx.y;
  const int dv0 = (blockIdx.x % C::kSplit) * C::kDV;  // this block's first output column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (blockIdx.x / C::kSplit) * kBQ + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  if (C::kDK != D) {
    // K's pad columns [D, kDK) in both buffers: the loaders never write them
    for (int r = threadIdx.x; r < 2 * kBK; r += kThreads) {
#pragma unroll
      for (int c = D; c < C::kDK; c += 8) *reinterpret_cast<uint4*>(&Ks[r / kBK][r % kBK][c]) = make_uint4(0, 0, 0, 0);
    }
    // (run_segment's first __syncthreads orders these stores before any read)
  }

  // Q A fragments for the k-steps of d, straight from global memory; the
  // pad columns of the last k-step (d >= D) are zeros
  uint32_t qa[C::kKSteps][4];
  {
    const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
    const bool ok0 = r0 < p.Sq, ok1 = r0 + 8 < p.Sq;
    const __nv_bfloat16* q0 = qb + (long long)r0 * p.sq.s;
    const __nv_bfloat16* q1 = qb + (long long)(r0 + 8) * p.sq.s;
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
      const int d = kk * 16 + t * 2;
      const bool hi = kk * 16 + 8 < D;  // columns d + 8 are real
      qa[kk][0] = ok0 ? ld32(q0 + d) : 0u;
      qa[kk][1] = ok1 ? ld32(q1 + d) : 0u;
      qa[kk][2] = ok0 && hi ? ld32(q0 + d + 8) : 0u;
      qa[kk][3] = ok1 && hi ? ld32(q1 + d + 8) : 0u;
    }
  }

  State<NT> a;
  init_state(a);
  if (HAS_OWN) {
    run_segment<D>(a, qa, p.k + b * p.sk.b + h * p.sk.h, p.sk.s, p.v + b * p.sv.b + h * p.sv.h + dv0, p.sv.s,
                   p.Lk, p.scale_log2, Ks, Vs);
  }
  // skip rows drop the endpoint segments; pure modes never skip (the
  // wrapper passes zeros), their stream has no own segment to fall back on
  const bool skip = NSETS > 0 && p.skip[b] != 0;

  float l0, l1;
  float out[NT][4];
  if (NSETS == 2 && !skip) {
    State<NT> e = a;  // the own segment is common to both sets
    run_segment<D>(a, qa, p.kb + b * p.skb.b + h * p.skb.h, p.skb.s, p.vb + b * p.svb.b + h * p.svb.h + dv0,
                   p.svb.s, p.Le, p.scale_log2, Ks, Vs);
    run_segment<D>(e, qa, p.ke + b * p.ske.b + h * p.ske.h, p.ske.s, p.ve + b * p.sve.b + h * p.sve.h + dv0,
                   p.sve.s, p.Le, p.scale_log2, Ks, Vs);
    const float c = p.coef[b];
    float e0, e1;
    row_sums(a, l0, l1);
    row_sums(e, e0, e1);
    const float wa0 = (1.f - c) / l0, wa1 = (1.f - c) / l1, we0 = c / e0, we1 = c / e1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      out[j][0] = a.o[j][0] * wa0 + e.o[j][0] * we0;
      out[j][1] = a.o[j][1] * wa0 + e.o[j][1] * we0;
      out[j][2] = a.o[j][2] * wa1 + e.o[j][2] * we1;
      out[j][3] = a.o[j][3] * wa1 + e.o[j][3] * we1;
    }
  } else {
    if (NSETS == 1 && !skip) {
      run_segment<D>(a, qa, p.kb + b * p.skb.b + h * p.skb.h, p.skb.s, p.vb + b * p.svb.b + h * p.svb.h + dv0,
                     p.svb.s, p.Le, p.scale_log2, Ks, Vs);
    }
    row_sums(a, l0, l1);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      out[j][0] = a.o[j][0] * i0;
      out[j][1] = a.o[j][1] * i0;
      out[j][2] = a.o[j][2] * i1;
      out[j][3] = a.o[j][3] * i1;
    }
  }

  __nv_bfloat16* ob = p.out + b * p.so.b + h * p.so.h + dv0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = j * 8 + t * 2;
    if (r0 < p.Sq) {
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * p.so.s + d) = pack_bf16(out[j][0], out[j][1]);
    }
    if (r0 + 8 < p.Sq) {
      *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + 8) * p.so.s + d) = pack_bf16(out[j][2], out[j][3]);
    }
  }
}

template <int D, bool HAS_OWN, int NSETS>
int launch(const Params& p, cudaStream_t s) {
  using C = Cfg<D>;
  const void* fn = reinterpret_cast<const void*>(&flash_kernel<D, HAS_OWN, NSETS>);
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((p.Sq + kBQ - 1) / kBQ) * C::kSplit, p.H, p.B);
  flash_kernel<D, HAS_OWN, NSETS><<<grid, kThreads, C::kSmemBytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const Params& p, int has_own, int n_sets, cudaStream_t s) {
  if (has_own && n_sets == 0) return launch<D, true, 0>(p, s);
  if (has_own && n_sets == 1) return launch<D, true, 1>(p, s);
  if (has_own && n_sets == 2) return launch<D, true, 2>(p, s);
  if (!has_own && n_sets == 1) return launch<D, false, 1>(p, s);
  if (!has_own && n_sets == 2) return launch<D, false, 2>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dims: [B, H, Sq, Lk, Le, D, then (b, h, s) element strides of
//        q, k, v, k_begin, v_begin, k_end, v_end, out]  (30 values)
// D must be 40, 64, 80 or 160. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                   const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                   const long long* dims, float scale, int has_own, int n_sets, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.kb = static_cast<const __nv_bfloat16*>(kb);
  p.vb = static_cast<const __nv_bfloat16*>(vb);
  p.ke = static_cast<const __nv_bfloat16*>(ke);
  p.ve = static_cast<const __nv_bfloat16*>(ve);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const int*>(skip);
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  Strides* st[8] = {&p.sq, &p.sk, &p.sv, &p.skb, &p.svb, &p.ske, &p.sve, &p.so};
  for (int i = 0; i < 8; ++i) {
    st[i]->b = dims[6 + 3 * i];
    st[i]->h = dims[7 + 3 * i];
    st[i]->s = dims[8 + 3 * i];
  }
  p.scale_log2 = scale * 1.4426950408889634f;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 40: return launch_mode<40>(p, has_own, n_sets, s);
    case 64: return launch_mode<64>(p, has_own, n_sets, s);
    case 80: return launch_mode<80>(p, has_own, n_sets, s);
    case 160: return launch_mode<160>(p, has_own, n_sets, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
