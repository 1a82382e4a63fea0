// Shared device helpers: vectorized row loads and stores and the
// fixed-order SLS accumulate step used by masked_sls.cu and
// fused_front_end.cu.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

// Load VEC consecutive row elements as float.  VEC * sizeof(T) == 16 uses
// 16-byte vector loads (the caller guarantees 16-byte alignment of the row
// chunk), 4 int8 codes one 4-byte load; VEC == 1 is the scalar path for any
// other D.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* v) {
  if constexpr (sizeof(T) == 4 && VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else if constexpr (sizeof(T) == 1 && VEC == 16) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* b = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = static_cast<float>(b[k]);
  } else if constexpr (sizeof(T) == 1 && VEC == 4) {
    const char4 t = __ldg(reinterpret_cast<const char4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = static_cast<float>(__ldg(p + k));
  }
}

// Store VEC consecutive floats: 16-byte vector stores when VEC % 4 == 0
// (the caller guarantees 16-byte alignment), else scalar.
template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// One pooling entry of the fixed l-order accumulate:
//   row = float(q) * scale   (rounded on its own; int8 only)
//   acc = fmaf(f, row, acc)  with f = owned * w
// __fmul_rn keeps the dequant product out of any contraction, so the split
// kernel and the fused kernel see identical operands.
template <int VEC>
__device__ __forceinline__ void accumulate(float* acc, float f, float* v,
                                           const float* scale) {
  if (scale != nullptr) {
    const float s = *scale;
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(v[k], s);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fmaf_rn(f, v[k], acc[k]);
}

// The row of a V-row table that row id r names: r clamped into [-V, V - 1],
// then taken mod V (an id in [-V, 0) wraps once, one below -V names row 0,
// one past the end row V - 1).  Every kernel that takes row ids reads
// them through it, as the plain versions do (kernels/ref.py: clamp_rows):
// no id reads outside its table, and the sentinel INT32_MAX of a dedup
// plan names row V - 1.
__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t V) {
  r = r < -V ? -V : (r > V - 1 ? V - 1 : r);
  return r < 0 ? r + V : r;
}

// The per-entry factor f = owned * w (owned in {0, 1}); the same product
// the reference forms, so f is bitwise the reference's.
__device__ __forceinline__ float entry_factor(bool own, const float* w,
                                              int64_t e) {
  float f = own ? 1.0f : 0.0f;
  if (w != nullptr) f = __fmul_rn(f, __ldg(w + e));
  return f;
}

// Threads per bag: the smallest power of two >= min(chunks, 32).
inline int team_size(int chunks) {
  int team = 1;
  while (team < chunks && team < 32) team *= 2;
  return team;
}
