// Phase 1 of the gather-once partial pool: stage each unique row once.
//
// Replaces the staging prologue of the Pallas TPU kernel
// src/repro/kernels/sls.py:fused_partial_pool_dedup_pallas
// (_make_fused_front_end_kernel, emit="tiles", dedup=True).  There the
// first grid step fills a VMEM staging buffer that every later step reads,
// which relies on the TPU running the grid in order.  CUDA blocks run in
// no order and cannot share memory across a launch, so staging is its own
// launch on the same stream, into (U, D) float32 buffers in device memory;
// the partial pool that follows reads them (from L2 while they fit).
// The gather-once SLS and fused front end no longer stage: they read each
// row through the plan (gather_once.cuh).
//
// staging[u] = float(table[clamp_row(uniq[u], V)]) * scale[u]   for
// u < max(n_slots, 1), with n_slots read on the card (no host round trip).
// The dequant product is rounded on its own (__fmul_rn), as the per-entry
// kernels round it, so staged rows equal the rows those kernels gather.
// Slot 0 is always filled: the accumulate may read it even when nothing
// is owned, and the buffer comes uninitialized from the allocator.
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

// Both tiers of one call in one launch (the partial pool's): slot
// t < nc + nh, with nc, nh the plans' live slot counts read on the card (at
// least 1 each: slot 0 of each staging is always filled); t < nc stages
// cold slot t (type T, with its scale), the rest hot slot t - nc, one team
// of threads per staged row and one 16-byte chunk per thread, over a
// grid-stride loop bounded by the live slot counts.
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
    const int64_t r = is_cold ? clamp_row(__ldg(cuniq + u), Vc)
                              : clamp_row(__ldg(huniq + u), Vh);
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
