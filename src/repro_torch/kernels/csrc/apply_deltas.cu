// Streaming embedding updates: fold a batch of per-row deltas into the
// live tables, in place, both tiers in one launch.
//
// apply_deltas replaces no Pallas kernel: the reference computes the same
// update in jnp inside a shard_map (src/repro/core/pifs.py:1232,
// _build_update_plan.block).  It is a kernel of its own because its
// bitwise contract needs an explicit fused multiply-add: XLA on the CPU
// contracts the int8 read-modify-write
//     quantize_rows(dequantize_rows(q, scale) + delta, scale)
// into round(fma(q, scale, delta) / scale), and a multiply then an add
// gives another int8 code about once in 2e6 elements, a drift that an
// update stream never undoes.  The plain version (kernels/ref.py:
// apply_deltas_ref) emulates the same fma on any device.
//
// Per unique row r of the batch (a negative r is a pad and writes nothing):
//   page = r / ps, local = page_to_slot[page] * ps + r % ps;
//   hot page (page_to_shard == -1):  hot[local] += delta;
//   cold page on shard s, float32:   cold[s * rows_per_shard + local] += delta;
//   cold page on shard s, int8:      v = fmaf(float(q), scale, delta),
//     q' = clamp(rint(v / scale), -127, 127) if scale > 0, else q is kept
//     (the reference's zero-scale guard); rint rounds half to even, as
//     jnp.round.
// Rows are unique (the caller coalesces them), so no two warps write one
// row.
//
// Bound: bytes -- each row read and written once, plus its delta and two
// page-table entries; at serving's capacity of 256 rows that is well under
// a microsecond of HBM time, so a launch costs its latency.  Design: one
// warp per row, lanes over D in 16-byte chunks (float4 of deltas and
// float32 rows, char4 of codes) when D % 4 == 0 and the tensors are
// aligned (vec == 4), else one element per lane (vec == 1).
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kHotShard = -1;
constexpr int kRowsPerBlock = 4;   // warps per block, one row each

template <int VEC>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void add_row(float* __restrict__ dst,
                                        const float* __restrict__ d, int D,
                                        int lane) {
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float x[VEC], y[VEC];
    load_f<VEC>(dst + c, x);
    load_f<VEC>(d + c, y);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = __fadd_rn(x[k], y[k]);
    store_f<VEC>(dst + c, x);
  }
}

__device__ __forceinline__ int8_t requant(int8_t q, float s, float d) {
  const float v = __fmaf_rn(static_cast<float>(q), s, d);
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

template <int VEC>
__device__ __forceinline__ void requant_row(int8_t* __restrict__ dst,
                                            const float* __restrict__ d,
                                            float s, int D, int lane) {
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float y[VEC];
    load_f<VEC>(d + c, y);
    if constexpr (VEC == 4) {
      char4 q = *reinterpret_cast<const char4*>(dst + c);
      q.x = requant(q.x, s, y[0]);
      q.y = requant(q.y, s, y[1]);
      q.z = requant(q.z, s, y[2]);
      q.w = requant(q.w, s, y[3]);
      *reinterpret_cast<char4*>(dst + c) = q;
    } else {
      dst[c] = requant(dst[c], s, y[0]);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
apply_deltas_kernel(T* __restrict__ cold, float* __restrict__ hot,
                    const float* __restrict__ scales,
                    const int32_t* __restrict__ p2s,
                    const int32_t* __restrict__ p2slot,
                    const int32_t* __restrict__ rows,
                    const float* __restrict__ deltas, int U, int D, int ps,
                    int64_t rows_per_shard, int64_t n_rows) {
  const int lane = threadIdx.x % 32;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (u >= U) return;
  const int32_t r = rows[u];
  if (r < 0 || r >= n_rows) return;            // a pad writes nothing
  const int32_t page = r / ps;
  const int32_t shard = p2s[page];
  const int64_t local = static_cast<int64_t>(p2slot[page]) * ps + r % ps;
  const float* d = deltas + u * D;
  if (shard == kHotShard) {
    add_row<VEC>(hot + local * D, d, D, lane);
    return;
  }
  T* dst = cold + (static_cast<int64_t>(shard) * rows_per_shard + local) * D;
  if constexpr (sizeof(T) == 4) {
    add_row<VEC>(dst, d, D, lane);
  } else {
    const float s = scales[page];
    if (!(s > 0.0f)) return;                     // zero-scale guard
    requant_row<VEC>(dst, d, s, D, lane);
  }
}

template <typename T, int VEC>
static void launch(void* cold, float* hot, const float* scales,
                   const int32_t* p2s, const int32_t* p2slot,
                   const int32_t* rows, const float* deltas, int U, int D,
                   int ps, int64_t rows_per_shard, int64_t n_rows,
                   cudaStream_t stream) {
  const int grid = (U + kRowsPerBlock - 1) / kRowsPerBlock;
  apply_deltas_kernel<T, VEC><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<T*>(cold), hot, scales, p2s, p2slot, rows, deltas, U, D,
      ps, rows_per_shard, n_rows);
}

// cold (n_shards * rows_per_shard, D) float32 or int8 codes (itemsize 4 /
// 1), hot (hot_rows, D) float32, both updated in place; scales, p2s,
// p2slot (num_pages,) float32 / int32 / int32; rows (U,) int32, -1 for a
// pad; deltas (U, D) float32; n_rows = num_pages * ps (a row at or past it
// is skipped: the wrapper's caller raises on one first).  vec 4 needs
// D % 4 == 0 and 16-byte aligned float rows (4-byte aligned code rows);
// vec 1 takes any D.
extern "C" int apply_deltas(void* cold, int itemsize, void* hot,
                            const void* scales, const void* p2s,
                            const void* p2slot, const void* rows,
                            const void* deltas, int U, int D, int vec,
                            int ps, int64_t rows_per_shard, int64_t n_rows,
                            void* stream) {
  if (U <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0 || ps <= 0 || (vec == 4 && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<float*>(hot);
  auto sc = static_cast<const float*>(scales);
  auto sh = static_cast<const int32_t*>(p2s);
  auto sl = static_cast<const int32_t*>(p2slot);
  auto r = static_cast<const int32_t*>(rows);
  auto d = static_cast<const float*>(deltas);
#define APPLY(T, VEC) \
  launch<T, VEC>(cold, h, sc, sh, sl, r, d, U, D, ps, rows_per_shard, n_rows, s)
  if (itemsize == 4 && vec == 4) APPLY(float, 4);
  else if (itemsize == 4 && vec == 1) APPLY(float, 1);
  else if (itemsize == 1 && vec == 4) APPLY(int8_t, 4);
  else if (itemsize == 1 && vec == 1) APPLY(int8_t, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef APPLY
  return static_cast<int>(cudaGetLastError());
}
