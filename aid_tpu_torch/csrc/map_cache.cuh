// Shared by the attention sources that encode a tensor map a call
// (flash_interpolated_attention_f32.cu, flash_attention_dmid.cu,
// flash_attention_dmid_f32.cu): cuTensorMapEncodeTiled behind a
// direct-mapped cache. A map is a pure function of what it encodes (the
// tensor's address, extents, strides, element type and box), so one made for
// the same key is the same map, and calls at the same shapes on the same
// buffers (every step of a denoise loop, through the caching allocator) skip
// the encoding, a few microseconds of host time a map. Included inside each
// source's anonymous namespace, after tma_sm90.cuh, <string.h> and <mutex>.

struct MapKey {
  const void* ptr;
  long long dims[4], bytes[3];
  int type, box0, rows;
};

constexpr int kMapCacheSlots = 1024;
struct MapCache {
  std::mutex mu;
  MapKey key[kMapCacheSlots];
  CUtensorMap map[kMapCacheSlots];
  bool used[kMapCacheSlots];
};

// A (D, H, S, B) map of `type` elements over ptr at element strides (b, h,
// s) of `esize` bytes each, boxes of box0 elements by `rows` rows, 128-byte
// swizzle, zeros out of bounds (past D and past S). A batch stride of 0 (one
// tensor shared by every row) becomes a batch extent of 1.
inline bool encode_map_cached(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int D, int H,
                              int S, int B, const long long* strides, int box0, int rows) {
  static MapCache cache;  // one a source
  const long long sb = strides[0], sh = strides[1], ss = strides[2];
  MapKey k;
  memset(&k, 0, sizeof(k));  // padding too: keys compare as bytes
  k.ptr = ptr;
  k.dims[0] = D;
  k.dims[1] = H;
  k.dims[2] = S;
  k.dims[3] = sb == 0 ? 1 : B;
  k.bytes[0] = sh * esize;
  k.bytes[1] = ss * esize;
  k.bytes[2] = (sb == 0 ? ss * S + sh * H : sb) * esize;
  k.type = (int)type;
  k.box0 = box0;
  k.rows = rows;
  uint64_t hash = 1469598103934665603ull;  // FNV-1a over the key's bytes
  for (size_t i = 0; i < sizeof(k); ++i) hash = (hash ^ reinterpret_cast<const unsigned char*>(&k)[i]) * 1099511628211ull;
  const int slot = (int)(hash % kMapCacheSlots);
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.used[slot] && memcmp(&cache.key[slot], &k, sizeof(k)) == 0) {
    *map = cache.map[slot];
    return true;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)k.dims[0], (cuuint64_t)k.dims[1], (cuuint64_t)k.dims[2], (cuuint64_t)k.dims[3]};
  const cuuint64_t bytes[3] = {(cuuint64_t)k.bytes[0], (cuuint64_t)k.bytes[1], (cuuint64_t)k.bytes[2]};
  const cuuint32_t box[4] = {(cuuint32_t)box0, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  if (encode_tiled()(map, type, 4, const_cast<void*>(ptr), dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  cache.key[slot] = k;
  cache.map[slot] = *map;
  cache.used[slot] = true;
  return true;
}
