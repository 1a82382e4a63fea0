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
//
// masked_sls_dedup (below) replaces src/repro/kernels/sls.py:
// masked_sls_dedup_pallas: each unique owned row is gathered and
// dequantized once (dedup_stage.cuh), then this kernel's accumulate, with
// DEDUP set, reads row[n,l] = staging[slots[n,l]] and no per-entry scale.
// Same operands, same fmaf order: bitwise equal to masked_sls for every
// weight.  Bound: bytes, each distinct row read once; the staging round
// trip (U * D * 4 bytes written, then read per entry) stays in L2 while it
// fits the 50 MB.
#include "common.cuh"
#include "dedup_stage.cuh"

template <typename T, int VEC, bool DEDUP>
__global__ void masked_sls_kernel(const T* __restrict__ table, int D,
                                  const int32_t* __restrict__ idx,
                                  const uint8_t* __restrict__ owned,
                                  const float* __restrict__ w,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, int N, int L,
                                  int team,
                                  const float* __restrict__ staging) {
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
      float v[VEC];
      if constexpr (DEDUP) {
        // idx holds staging slots; a non-owned entry reads its (finite)
        // sentinel slot with f = 0
        const int64_t u = __ldg(idx + e);
        load_row<float, VEC>(staging + u * D + c * VEC, v);
        accumulate<VEC>(acc, f, v, nullptr);
      } else {
        const int64_t r = own ? static_cast<int64_t>(__ldg(idx + e)) : 0;
        load_row<T, VEC>(table + r * D + c * VEC, v);
        accumulate<VEC>(acc, f, v, scales == nullptr ? nullptr : scales + e);
      }
    }
    float* o = out + bag * D + c * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = acc[k];
  }
}

template <typename T, int VEC, bool DEDUP = false>
static int launch(const void* table, int D, const int32_t* idx,
                  const uint8_t* owned, const float* w, const float* scales,
                  float* out, int N, int L, cudaStream_t stream,
                  const float* staging = nullptr) {
  const int threads = 128;
  const int team = team_size(D / VEC);
  const int teams = threads / team;
  const int blocks = (N + teams - 1) / teams;
  if (blocks > 0) {
    masked_sls_kernel<T, VEC, DEDUP><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(table), D, idx, owned, w, scales, out, N, L,
        team, staging);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage, then accumulate through the slots, on one stream.  VEC is the
// float32 staging chunk (see dedup_stage.cuh); T only types the table.
template <typename T, int VEC>
static int launch_dedup(const void* table, int64_t V, int D,
                        const int32_t* uniq, const int32_t* n_slots,
                        const float* uscales, float* staging, int U,
                        const int32_t* slots, const uint8_t* owned,
                        const float* w, float* out, int N, int L,
                        cudaStream_t stream) {
  launch_stage<T, VEC>(static_cast<const T*>(table), V, D, uniq, n_slots,
                       uscales, staging, U, stream);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch<float, VEC, true>(table, D, slots, owned, w, nullptr, out,
                                  N, L, stream, staging);
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

// table (V, D) float32 or int8 codes; uniq (U,) int32 row per staging slot
// (sentinel-padded); n_slots (1,) int32 on the card; uscales (U,) float32
// or null (int8 only); staging (U, D) float32 scratch; slots (N, L) int32;
// owned (N, L) bool; w (N, L) float32 or null; out (N, D) float32.
extern "C" int masked_sls_dedup(const void* table, int itemsize, int64_t V,
                                int D, int vec16, const void* uniq,
                                const void* n_slots, const void* uscales,
                                void* staging, int U, const void* slots,
                                const void* owned, const void* w, void* out,
                                int N, int L, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto uq = static_cast<const int32_t*>(uniq);
  auto n = static_cast<const int32_t*>(n_slots);
  auto us = static_cast<const float*>(uscales);
  auto st = static_cast<float*>(staging);
  auto sl = static_cast<const int32_t*>(slots);
  auto m = static_cast<const uint8_t*>(owned);
  auto wf = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  if (itemsize == 4) {
    return vec16 ? launch_dedup<float, 4>(table, V, D, uq, n, us, st, U, sl,
                                          m, wf, o, N, L, s)
                 : launch_dedup<float, 1>(table, V, D, uq, n, us, st, U, sl,
                                          m, wf, o, N, L, s);
  }
  if (itemsize == 1) {
    return vec16 ? launch_dedup<int8_t, 4>(table, V, D, uq, n, us, st, U,
                                           sl, m, wf, o, N, L, s)
                 : launch_dedup<int8_t, 1>(table, V, D, uq, n, us, st, U,
                                           sl, m, wf, o, N, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
