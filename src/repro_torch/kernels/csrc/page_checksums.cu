// Per-page checksums of the live store: a Fletcher pair in uint32
// wraparound arithmetic over each listed page's native-domain lanes.
//
// page_checksums replaces no Pallas kernel: the reference computes the
// same reduction in jnp inside a shard_map (src/repro/core/pifs.py:1394,
// _build_checksum_plan.block), and its numpy twin is
// repro/core/integrity.py:page_checksum_host.  Definition, per page p of
// N = page_size * D lanes (the page's rows, row-major, reinterpreted as
// unsigned: an int8 code as its uint8 byte, a float32 value as its IEEE
// bits) and the page's carried scale bits sc:
//     s1 = (sum_i lane_i           + sc)           mod 2^32
//     s2 = (sum_i lane_i * (i + 1) + sc * (N + 1)) mod 2^32
// A hot page (page_to_shard == -1) is read from the float32 hot tier at
// slot * page_size; a cold page from its shard's slice of the cold tier.
// A negative page id is a pad and gets (0, 0); an id at or past the page
// count reads the last page, as the reference's gather clamps it.
//
// Native uint32 multiply and add wrap for free, and sums mod 2^32 do not
// depend on the order they are taken in, so any split of a page over
// lanes and any reduction tree gives the host twin's value bit for bit.
//
// Bound: bytes -- each listed page read once (4 KiB at the default page
// size), 16 bytes out per page.  Design: one warp per page (four per
// block), each lane 16 bytes per load (float4 of lanes, or 16 codes) when
// every page start is 16-byte aligned (vec == 1), else one lane per load;
// per-lane partial sums, a shuffle reduction, lane 0 writes.  One launch
// covers any number of pages.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kHotShard = -1;
constexpr int kPagesPerBlock = 4;   // warps per block, one page each

__device__ __forceinline__ void add_lane(uint32_t lane, uint32_t pos,
                                         uint32_t& s1, uint32_t& s2) {
  s1 += lane;
  s2 += lane * pos;                  // pos = i + 1, wraps mod 2^32
}

// float32 lanes (their bit patterns) of a contiguous page of n lanes
template <bool VEC>
__device__ __forceinline__ void fold_f32(const float* __restrict__ p, int n,
                                         int lane, uint32_t& s1,
                                         uint32_t& s2) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(p);
  if constexpr (VEC) {
#pragma unroll 4
    for (int i = lane * 4; i < n; i += 32 * 4) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(u + i));
      add_lane(t.x, i + 1, s1, s2);
      add_lane(t.y, i + 2, s1, s2);
      add_lane(t.z, i + 3, s1, s2);
      add_lane(t.w, i + 4, s1, s2);
    }
  } else {
    for (int i = lane; i < n; i += 32) add_lane(__ldg(u + i), i + 1, s1, s2);
  }
}

// int8 codes as uint8 lanes of a contiguous page of n lanes
template <bool VEC>
__device__ __forceinline__ void fold_u8(const int8_t* __restrict__ p, int n,
                                        int lane, uint32_t& s1,
                                        uint32_t& s2) {
  const uint8_t* u = reinterpret_cast<const uint8_t*>(p);
  if constexpr (VEC) {
#pragma unroll 2
    for (int i = lane * 16; i < n; i += 32 * 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(u + i));
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        add_lane((w[k / 4] >> (8 * (k % 4))) & 0xFFu, i + k + 1, s1, s2);
    }
  } else {
    for (int i = lane; i < n; i += 32) add_lane(__ldg(u + i), i + 1, s1, s2);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kPagesPerBlock)
page_checksums_kernel(const T* __restrict__ cold,
                      const float* __restrict__ hot,
                      const float* __restrict__ scales,
                      const int32_t* __restrict__ p2s,
                      const int32_t* __restrict__ p2slot,
                      const int32_t* __restrict__ pages,
                      int64_t* __restrict__ out, int K, int P, int ps, int D,
                      int64_t rows_per_shard) {
  const int lane = threadIdx.x % 32;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kPagesPerBlock + threadIdx.x / 32;
  if (k >= K) return;
  int32_t page = pages[k];
  if (page < 0) {                               // a pad
    if (lane == 0) out[2 * k] = out[2 * k + 1] = 0;
    return;
  }
  page = min(page, P - 1);
  const int32_t shard = p2s[page];
  const int64_t first = static_cast<int64_t>(p2slot[page]) * ps;
  const int n = ps * D;
  uint32_t s1 = 0, s2 = 0;
  if (shard == kHotShard) {
    fold_f32<VEC>(hot + first * D, n, lane, s1, s2);
  } else {
    const T* src = cold + (shard * rows_per_shard + first) * D;
    if constexpr (sizeof(T) == 4)
      fold_f32<VEC>(reinterpret_cast<const float*>(src), n, lane, s1, s2);
    else
      fold_u8<VEC>(reinterpret_cast<const int8_t*>(src), n, lane, s1, s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, off);
    s2 += __shfl_xor_sync(0xFFFFFFFFu, s2, off);
  }
  if (lane == 0) {
    const uint32_t sc = __float_as_uint(scales[page]);
    s1 += sc;
    s2 += sc * static_cast<uint32_t>(n + 1);
    out[2 * k] = static_cast<int64_t>(s1);
    out[2 * k + 1] = static_cast<int64_t>(s2);
  }
}

template <typename T, bool VEC>
static void launch(const void* cold, const float* hot, const float* scales,
                   const int32_t* p2s, const int32_t* p2slot,
                   const int32_t* pages, int64_t* out, int K, int P, int ps,
                   int D, int64_t rows_per_shard, cudaStream_t stream) {
  const int grid = (K + kPagesPerBlock - 1) / kPagesPerBlock;
  page_checksums_kernel<T, VEC><<<grid, 32 * kPagesPerBlock, 0, stream>>>(
      static_cast<const T*>(cold), hot, scales, p2s, p2slot, pages, out, K,
      P, ps, D, rows_per_shard);
}

// cold (n_shards * rows_per_shard, D) float32 or int8 codes (itemsize 4 /
// 1), hot (hot_rows, D) float32, scales / p2s / p2slot (P,) float32 /
// int32 / int32, pages (K,) int32 (-1 for a pad), out (K, 2) int64: each
// page's [s1, s2], values in [0, 2^32).  vec 1 needs every page start and
// the page length 16-byte aligned in both tiers (the wrapper checks);
// vec 0 takes any shape.
extern "C" int page_checksums(const void* cold, int itemsize,
                              const void* hot, const void* scales,
                              const void* p2s, const void* p2slot,
                              const void* pages, void* out, int K, int P,
                              int ps, int D, int vec, int64_t rows_per_shard,
                              void* stream) {
  if (K <= 0) return static_cast<int>(cudaSuccess);
  if (P <= 0 || ps <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto sc = static_cast<const float*>(scales);
  auto sh = static_cast<const int32_t*>(p2s);
  auto sl = static_cast<const int32_t*>(p2slot);
  auto pg = static_cast<const int32_t*>(pages);
  auto o = static_cast<int64_t*>(out);
#define FOLD(T, VEC) \
  launch<T, VEC>(cold, h, sc, sh, sl, pg, o, K, P, ps, D, rows_per_shard, s)
  if (itemsize == 4 && vec) FOLD(float, true);
  else if (itemsize == 4) FOLD(float, false);
  else if (itemsize == 1 && vec) FOLD(int8_t, true);
  else if (itemsize == 1) FOLD(int8_t, false);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef FOLD
  return static_cast<int>(cudaGetLastError());
}
