// Phase 1 of the gather-once (dedup) kernels: stage each unique row once.
//
// Replaces the staging prologue of the Pallas TPU kernels
// src/repro/kernels/sls.py:_make_sls_dedup_kernel and, per tier,
// _make_fused_front_end_kernel(dedup=True).  There the first grid step
// fills a VMEM staging buffer that every later step reads, which relies on
// the TPU running the grid in order.  CUDA blocks run in no order and
// cannot share memory across a launch, so staging is its own launch on
// the same stream, into a (U, D) float32 buffer in device memory; the
// accumulate launch that follows reads it (from L2 while U * D * 4 bytes
// fit there).
//
// staging[u] = float(table[min(uniq[u], V - 1)]) * scale[u]   for
// u < max(n_slots, 1), with n_slots read on the card (no host round trip).
// The dequant product is rounded on its own (__fmul_rn), as the per-entry
// kernels round it, so staged rows equal the rows those kernels gather.
// Slot 0 is always filled: the accumulate may read it even when nothing
// is owned, and the buffer comes uninitialized from the allocator.
//
// The partial pool stages both tiers in one launch
// (dedup_stage_tiers_kernel): the cold plan's live slots, then the hot
// plan's, each row computed as above.
//
// Staging is float32 whatever the table's type, so the stage, and the
// accumulate that reads it, work in float4 chunks (VEC = 4; 1 for a D that
// is not a multiple of 4): a warp's loads and stores then cover whole
// contiguous rows.  int8's 16-code chunks would make each thread write and
// read 64 bytes at a 64-byte stride across the warp; measured, that ran the
// int8 dedup kernels 2.5-3.6x slower than the per-entry kernel at batch
// 2048 (PERF.md).
#pragma once
#include <algorithm>

#include "common.cuh"

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

// One team of threads per unique row, one 16-byte chunk per thread, over a
// grid-stride loop bounded by the live slot count.
template <typename T, int VEC>
__global__ void dedup_stage_kernel(const T* __restrict__ table, int64_t V,
                                   int D, const int32_t* __restrict__ uniq,
                                   const int32_t* __restrict__ n_slots,
                                   const float* __restrict__ uscales,
                                   float* __restrict__ staging, int U,
                                   int team) {
  const int n = max(min(__ldg(n_slots), U), 1);
  const int chunks = D / VEC;
  const int teams = blockDim.x / team;
  const int lane = threadIdx.x % team;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * teams +
                   threadIdx.x / team;
       u < n; u += static_cast<int64_t>(gridDim.x) * teams) {
    const int64_t r = min(static_cast<int64_t>(__ldg(uniq + u)), V - 1);
    for (int c = lane; c < chunks; c += team) {
      float v[VEC];
      load_row<T, VEC>(table + r * D + c * VEC, v);
      if (uscales != nullptr) {
        const float s = __ldg(uscales + u);
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(v[k], s);
      }
      store_row<VEC>(staging + u * D + c * VEC, v);
    }
  }
}

// Launch the stage on `stream`: enough blocks for U rows, at most
// `max_blocks` (the loop strides over the rest; blocks past n_slots exit).
template <typename T, int VEC>
static void launch_stage(const T* table, int64_t V, int D,
                         const int32_t* uniq, const int32_t* n_slots,
                         const float* uscales, float* staging, int U,
                         cudaStream_t stream) {
  const int threads = 128;
  const int team = team_size(D / VEC);
  const int teams = threads / team;
  const int max_blocks = 132 * 16;
  const int blocks = std::max(1, std::min((U + teams - 1) / teams,
                                          max_blocks));
  dedup_stage_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      table, V, D, uniq, n_slots, uscales, staging, U, team);
}

// Both tiers of one call in one launch (the partial pool's): slot
// t < nc + nh, with nc, nh the plans' live slot counts read on the card (at
// least 1 each: slot 0 of each staging is always filled); t < nc stages
// cold slot t (type T, with its scale), the rest hot slot t - nc.  Each
// staged row is the one dedup_stage_kernel writes, by the same loop.
template <typename T, int VEC>
__global__ void dedup_stage_tiers_kernel(
    const T* __restrict__ cold, int64_t Vc,
    const int32_t* __restrict__ cuniq, const int32_t* __restrict__ cn,
    const float* __restrict__ cscales, float* __restrict__ cstage, int Uc,
    const float* __restrict__ hot, int64_t Vh,
    const int32_t* __restrict__ huniq, const int32_t* __restrict__ hn,
    float* __restrict__ hstage, int Uh, int D, int team) {
  const int64_t nc = max(min(__ldg(cn), Uc), 1);
  const int64_t n = nc + max(min(__ldg(hn), Uh), 1);
  const int chunks = D / VEC;
  const int teams = blockDim.x / team;
  const int lane = threadIdx.x % team;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * teams +
                   threadIdx.x / team;
       t < n; t += static_cast<int64_t>(gridDim.x) * teams) {
    const bool is_cold = t < nc;
    const int64_t u = is_cold ? t : t - nc;
    const int64_t r =
        is_cold ? min(static_cast<int64_t>(__ldg(cuniq + u)), Vc - 1)
                : min(static_cast<int64_t>(__ldg(huniq + u)), Vh - 1);
    for (int c = lane; c < chunks; c += team) {
      float v[VEC];
      if (is_cold) {
        load_row<T, VEC>(cold + r * D + c * VEC, v);
        if (cscales != nullptr) {
          const float s = __ldg(cscales + u);
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(v[k], s);
        }
        store_row<VEC>(cstage + u * D + c * VEC, v);
      } else {
        load_row<float, VEC>(hot + r * D + c * VEC, v);
        store_row<VEC>(hstage + u * D + c * VEC, v);
      }
    }
  }
}

template <typename T, int VEC>
static void launch_stage_tiers(const T* cold, int64_t Vc,
                               const int32_t* cuniq, const int32_t* cn,
                               const float* cscales, float* cstage, int Uc,
                               const float* hot, int64_t Vh,
                               const int32_t* huniq, const int32_t* hn,
                               float* hstage, int Uh, int D,
                               cudaStream_t stream) {
  const int threads = 128;
  const int team = team_size(D / VEC);
  const int teams = threads / team;
  const int max_blocks = 132 * 16;
  const int64_t U = static_cast<int64_t>(Uc) + Uh;
  const int blocks = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>((U + teams - 1) / teams,
                                             max_blocks)));
  dedup_stage_tiers_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      cold, Vc, cuniq, cn, cscales, cstage, Uc, hot, Vh, huniq, hn, hstage,
      Uh, D, team);
}
