// Masked partial SparseLengthSum (plain SLS with a null mask).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sls.py:_sls_call
// (masked_sls_pallas and sls_pallas).  out[n] = sum_l f[n,l] * row[n,l] in
// the fixed order l = 0..L-1, with f = owned * w and row = table[idx] (int8:
// float(q) * scale).  A non-owned entry reads row 0 with f = 0.
//
// Bound: bytes.  Each pooling entry gathers one D-wide row from device
// memory and does 2 flops per element on it.  Design: a team of threads
// owns one bag, each thread owns a 16-byte chunk of D (float4, or 16 int8
// codes) and keeps its accumulator in registers, so a row read is one
// coalesced 16-byte load per thread and the pooled row is written once.
#include "common.cuh"

template <typename T, int VEC>
__global__ void masked_sls_kernel(const T* __restrict__ table, int D,
                                  const int32_t* __restrict__ idx,
                                  const uint8_t* __restrict__ owned,
                                  const float* __restrict__ w,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, int N, int L,
                                  int team) {
  const int chunks = D / VEC;
  const int teams = blockDim.x / team;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * teams + threadIdx.x / team;
  if (bag >= N) return;
  const int lane = threadIdx.x % team;
  const int64_t e0 = bag * L;
  for (int c = lane; c < chunks; c += team) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int64_t e = e0 + l;
      const bool own = owned == nullptr || owned[e] != 0;
      const float f = entry_factor(owned != nullptr, own, w, e);
      const int64_t r = own ? static_cast<int64_t>(__ldg(idx + e)) : 0;
      float v[VEC];
      load_row<T, VEC>(table + r * D + c * VEC, v);
      accumulate<VEC>(acc, f, v, scales == nullptr ? nullptr : scales + e);
    }
    float* o = out + bag * D + c * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = acc[k];
  }
}

template <typename T, int VEC>
static int launch(const void* table, int D, const int32_t* idx,
                  const uint8_t* owned, const float* w, const float* scales,
                  float* out, int N, int L, cudaStream_t stream) {
  const int threads = 128;
  const int team = team_size(D / VEC);
  const int teams = threads / team;
  const int blocks = (N + teams - 1) / teams;
  if (blocks > 0) {
    masked_sls_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(table), D, idx, owned, w, scales, out, N, L,
        team);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: (V, D) float32 (itemsize 4) or int8 codes (itemsize 1);
// idx (N, L) int32; owned (N, L) bool or null; w, scales (N, L) float32 or
// null; out (N, D) float32.  vec16 != 0 selects 16-byte loads (the caller
// checked D * itemsize % 16 == 0 and 16-byte aligned pointers).
extern "C" int masked_sls(const void* table, int itemsize, int D, int vec16,
                          const void* idx, const void* owned, const void* w,
                          const void* scales, void* out, int N, int L,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(idx);
  auto m = static_cast<const uint8_t*>(owned);
  auto wf = static_cast<const float*>(w);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
  if (itemsize == 4) {
    return vec16 ? launch<float, 4>(table, D, i, m, wf, sc, o, N, L, s)
                 : launch<float, 1>(table, D, i, m, wf, sc, o, N, L, s);
  }
  if (itemsize == 1) {
    return vec16 ? launch<int8_t, 16>(table, D, i, m, wf, sc, o, N, L, s)
                 : launch<int8_t, 1>(table, D, i, m, wf, sc, o, N, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
