// Fused DLRM front end: two-tier masked SLS -> features -> interaction.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sls.py:
// fused_front_end_pallas (_make_fused_front_end_kernel, emit="interact",
// dedup=False).  The TPU grid (B/BB, G, L tiles) revisits one output block
// in order; blocks on a GPU run in no order, so here one CTA owns a batch
// tile of BB samples and loops over the G bags and the L entries itself.
// BB is small (one bag per team of threads) so that many gathers are in
// flight across the card.
//
// Bound: bytes (the row gather, as in masked_sls.cu).  Design: per bag, the
// cold and hot accumulators live in separate registers and run the same
// fixed l-order fmaf steps as masked_sls.cu; cold + hot is written once into
// a shared-memory (BB, F, D) feature tile with x in row 0, and the tile is
// reduced by interact_tile, the device function dot_interaction.cu uses.
// The pooled features never reach device memory, and the result equals
// split (masked_sls per tier -> add -> dot_interaction) bit for bit.
//
// fused_front_end_dedup (below) replaces src/repro/kernels/sls.py:
// fused_front_end_dedup_pallas (the same body with dedup=True): each tier's
// unique rows are staged once (dedup_stage.cuh; cold with its scales, hot
// without), then this kernel, with DEDUP set, reads cstage[cslots[e]] and
// hstage[hslots[e]] in place of the per-entry gathers.  Same operands and
// order, so it equals fused_front_end, and split, bit for bit.
//
// fused_partial_pool and fused_partial_pool_dedup (below) replace
// src/repro/kernels/sls.py:fused_partial_pool_pallas and
// fused_partial_pool_dedup_pallas (emit="tiles"): the same pooling loop
// with EMIT_TILES set, stopped before the interaction.  Each bag's cold and
// hot accumulators go to device memory as two (B, F, D) tiles, part_c (row 0
// zero) and part_h (row 0 = x); fused_resume (dot_interaction.cu) adds
// them and interacts.  Tensor parallelism runs in one launch: grid row
// blockIdx.y is cold shard s, which pools the entries it owns from its
// slice of the cold tier into part_c[s]; the replicated hot tier (and x)
// is pooled by shard 0 alone, so x is counted once.  Bound: bytes (the
// gather, as above, plus the tiles written).  The dedup variant stages
// all shards' unique cold rows with one plan (their rows are disjoint)
// and the hot rows with another, then reads them through per-shard slots.
#include <algorithm>

#include "common.cuh"
#include "dedup_stage.cuh"
#include "interaction.cuh"

template <typename T, int VEC, bool DEDUP, bool EMIT_TILES>
__global__ void fused_front_end_kernel(
    const T* __restrict__ cold, const float* __restrict__ hot,
    const float* __restrict__ x, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ owned, const uint8_t* __restrict__ is_hot,
    const float* __restrict__ w, const float* __restrict__ scales,
    float* __restrict__ out, int B, int G, int L, int D, int P, int BB,
    int team, const int32_t* __restrict__ hslots,
    const float* __restrict__ cstage, const float* __restrict__ hstage,
    int64_t cold_stride, float* __restrict__ part_c,
    float* __restrict__ part_h) {
  extern __shared__ float tile[];
  const int F = G + 1;
  const int lds = D + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BB;
  const int nb = static_cast<int>(min(static_cast<int64_t>(BB), B - b0));
  // shard blockIdx.y (EMIT_TILES only): its ownership mask and its cold
  // tier (its slots, with DEDUP); the hot tier is replicated and pooled by
  // shard 0 alone.  Without EMIT_TILES both fold to constants, so the
  // fused kernel's code is the one-shard code.
  const int sh = EMIT_TILES ? static_cast<int>(blockIdx.y) : 0;
  const int64_t n_e = static_cast<int64_t>(B) * G * L;
  const bool with_hot = !EMIT_TILES || sh == 0;
  owned += sh * n_e;
  if constexpr (DEDUP) {
    rows += sh * n_e;
  } else {
    cold += sh * cold_stride * D;
  }

  // feature row 0 of each sample: x (EMIT_TILES: zeros in part_c, x in
  // part_h)
  for (int e = threadIdx.x; e < nb * D; e += blockDim.x) {
    const int s = e / D;
    const int d = e - s * D;
    if constexpr (EMIT_TILES) {
      part_c[((sh * B + b0 + s) * F) * D + d] = 0.0f;
      if (with_hot) part_h[((b0 + s) * F) * D + d] = __ldg(x + b0 * D + e);
    } else {
      tile[s * F * lds + d] = __ldg(x + b0 * D + e);
    }
  }

  // rows 1..G: pooled bags, cold and hot accumulated apart
  const int chunks = D / VEC;
  const int teams = blockDim.x / team;
  const int lane = threadIdx.x % team;
  for (int bag = threadIdx.x / team; bag < nb * G; bag += teams) {
    const int s = bag / G;
    const int g = bag - s * G;
    const int64_t e0 = ((b0 + s) * G + g) * L;
    for (int c = lane; c < chunks; c += team) {
      float acc_c[VEC], acc_h[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc_c[k] = acc_h[k] = 0.0f;
      for (int l = 0; l < L; ++l) {
        const int64_t e = e0 + l;
        const bool own = owned[e] != 0;
        const bool hit = with_hot && is_hot[e] != 0;
        const float fc = entry_factor(true, own, w, e);
        const float fh = entry_factor(true, hit, w, e);
        float vc[VEC], vh[VEC];
        if constexpr (DEDUP) {
          // rows holds the cold staging slots; out-of-tier entries read
          // their tier's (finite) sentinel slot with f = 0
          const int64_t uc = __ldg(rows + e);
          load_row<float, VEC>(cstage + uc * D + c * VEC, vc);
          if (with_hot) {
            const int64_t uh = __ldg(hslots + e);
            load_row<float, VEC>(hstage + uh * D + c * VEC, vh);
          }
          accumulate<VEC>(acc_c, fc, vc, nullptr);
        } else {
          const int64_t r = __ldg(rows + e);
          load_row<T, VEC>(cold + (own ? r : 0) * D + c * VEC, vc);
          if (with_hot)
            load_row<float, VEC>(hot + (hit ? r : 0) * D + c * VEC, vh);
          accumulate<VEC>(acc_c, fc, vc,
                          scales == nullptr ? nullptr : scales + e);
        }
        if (with_hot) accumulate<VEC>(acc_h, fh, vh, nullptr);
      }
      if constexpr (EMIT_TILES) {
        const int64_t row = (b0 + s) * F + g + 1;
        store_row<VEC>(part_c + (sh * B * F + row) * D + c * VEC, acc_c);
        if (with_hot) store_row<VEC>(part_h + row * D + c * VEC, acc_h);
      } else {
        float* dst = tile + (s * F + g + 1) * lds;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          dst[c * VEC + k] = __fadd_rn(acc_c[k], acc_h[k]);
      }
    }
  }
  if constexpr (!EMIT_TILES) {
    __syncthreads();
    interact_tile(tile, nb, F, D, lds, P, 0, out + b0 * P);
  }
}

// EMIT_TILES: S > 1 runs one grid row (blockIdx.y) per cold-tier shard;
// cold_stride is the rows of one shard's slice.  Without EMIT_TILES, S == 1.
template <typename T, int VEC, bool DEDUP = false, bool EMIT_TILES = false>
static int launch(const void* cold, const float* hot, const float* x,
                  const int32_t* rows, const uint8_t* owned,
                  const uint8_t* is_hot, const float* w, const float* scales,
                  float* out, int B, int G, int L, int D, int P, int max_bb,
                  cudaStream_t stream, const int32_t* hslots = nullptr,
                  const float* cstage = nullptr,
                  const float* hstage = nullptr, int S = 1,
                  int64_t cold_stride = 0, float* part_c = nullptr,
                  float* part_h = nullptr) {
  const int threads = 256;
  const int team = team_size(D / VEC);
  // A team walks its bags' entries one gather after another, so the
  // kernel is bound by gather latency unless many teams are in flight:
  // give each team one bag (BB * G <= teams), up to the caller's cap.
  const int BB = std::max(1, std::min(max_bb, (threads / team) / G));
  const size_t smem =
      EMIT_TILES ? 0
                 : static_cast<size_t>(BB) * (G + 1) * (D + 1) * sizeof(float);
  // above 48 KB a block gets dynamic shared memory only after this opt-in;
  // without it the launch is refused
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_front_end_kernel<T, VEC, DEDUP, EMIT_TILES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + BB - 1) / BB;
  if (blocks > 0) {
    fused_front_end_kernel<T, VEC, DEDUP, EMIT_TILES>
        <<<dim3(blocks, S), threads, smem, stream>>>(
            static_cast<const T*>(cold), hot, x, rows, owned, is_hot, w,
            scales, out, B, G, L, D, P, BB, team, hslots, cstage, hstage,
            cold_stride, part_c, part_h);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage each tier's unique rows, then the fused kernel through the slots,
// on one stream.  VEC is the float32 staging chunk (see dedup_stage.cuh);
// T only types the cold table.  Uc, Uh: the tiers' plan capacities.
template <typename T, int VEC, bool EMIT_TILES = false>
static int launch_dedup(const void* cold, int64_t Vc, const float* hot,
                        int64_t Vh, const float* x, const int32_t* cuniq,
                        const int32_t* cn, const float* cscales,
                        const int32_t* huniq, const int32_t* hn,
                        float* cstage, float* hstage, int Uc, int Uh,
                        const int32_t* cslots, const int32_t* hslots,
                        const uint8_t* owned, const uint8_t* is_hot,
                        const float* w, float* out, int B, int G, int L,
                        int D, int P, int max_bb, cudaStream_t stream,
                        int S = 1, float* part_c = nullptr,
                        float* part_h = nullptr) {
  launch_stage<T, VEC>(static_cast<const T*>(cold), Vc, D, cuniq, cn,
                       cscales, cstage, Uc, stream);
  launch_stage<float, VEC>(hot, Vh, D, huniq, hn, nullptr, hstage, Uh,
                           stream);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch<float, VEC, true, EMIT_TILES>(
      cold, hot, x, cslots, owned, is_hot, w, nullptr, out, B, G, L, D, P,
      max_bb, stream, hslots, cstage, hstage, S, 0, part_c, part_h);
}

// cold (Vc, D) float32 or int8 (itemsize 4 / 1); hot (Vh, D) float32;
// x (B, D) float32; rows (B, G, L) int32; owned, is_hot (B, G, L) bool;
// w, scales (B, G, L) float32 or null; out (B, P) float32, P = G(G+1)/2.
// max_bb caps the samples per CTA (the caller keeps max_bb (G+1)(D+1) 4 B
// within shared memory).
extern "C" int fused_front_end(const void* cold, int itemsize, int vec16,
                               const void* hot, const void* x,
                               const void* rows, const void* owned,
                               const void* is_hot, const void* w,
                               const void* scales, void* out, int B, int G,
                               int L, int D, int max_bb, void* stream) {
  const int P = G * (G + 1) / 2;
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto xf = static_cast<const float*>(x);
  auto r = static_cast<const int32_t*>(rows);
  auto m = static_cast<const uint8_t*>(owned);
  auto hm = static_cast<const uint8_t*>(is_hot);
  auto wf = static_cast<const float*>(w);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
  if (itemsize == 4) {
    return vec16 ? launch<float, 4>(cold, h, xf, r, m, hm, wf, sc, o, B, G,
                                    L, D, P, max_bb, s)
                 : launch<float, 1>(cold, h, xf, r, m, hm, wf, sc, o, B, G,
                                    L, D, P, max_bb, s);
  }
  if (itemsize == 1) {
    return vec16 ? launch<int8_t, 16>(cold, h, xf, r, m, hm, wf, sc, o, B,
                                      G, L, D, P, max_bb, s)
                 : launch<int8_t, 1>(cold, h, xf, r, m, hm, wf, sc, o, B, G,
                                     L, D, P, max_bb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// cold (Vc, D) float32 or int8; hot (Vh, D) float32; x (B, D) float32;
// c_/h_uniq (U,) int32, c_/h_n (1,) int32 on the card, c_scales (U,)
// float32 or null (int8 only): one dedup plan per tier; c_/h_stage (U, D)
// float32 scratch; c_/h_slots, owned, is_hot (B, G, L); w (B, G, L) or
// null; out (B, P) float32.  max_bb as for fused_front_end.
extern "C" int fused_front_end_dedup(
    const void* cold, int itemsize, int64_t Vc, int vec16, const void* hot,
    int64_t Vh, const void* x, const void* c_uniq, const void* c_n,
    const void* c_scales, const void* h_uniq, const void* h_n,
    void* c_stage, void* h_stage, int U, const void* c_slots,
    const void* h_slots, const void* owned, const void* is_hot,
    const void* w, void* out, int B, int G, int L, int D, int max_bb,
    void* stream) {
  const int P = G * (G + 1) / 2;
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto xf = static_cast<const float*>(x);
  auto cu = static_cast<const int32_t*>(c_uniq);
  auto cn = static_cast<const int32_t*>(c_n);
  auto cs = static_cast<const float*>(c_scales);
  auto hu = static_cast<const int32_t*>(h_uniq);
  auto hn = static_cast<const int32_t*>(h_n);
  auto cst = static_cast<float*>(c_stage);
  auto hst = static_cast<float*>(h_stage);
  auto csl = static_cast<const int32_t*>(c_slots);
  auto hsl = static_cast<const int32_t*>(h_slots);
  auto m = static_cast<const uint8_t*>(owned);
  auto hm = static_cast<const uint8_t*>(is_hot);
  auto wf = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  if (itemsize == 4) {
    return vec16
        ? launch_dedup<float, 4>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                 cst, hst, U, U, csl, hsl, m, hm, wf, o, B,
                                 G, L, D, P, max_bb, s)
        : launch_dedup<float, 1>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                 cst, hst, U, U, csl, hsl, m, hm, wf, o, B,
                                 G, L, D, P, max_bb, s);
  }
  if (itemsize == 1) {
    return vec16
        ? launch_dedup<int8_t, 4>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                  cst, hst, U, U, csl, hsl, m, hm, wf, o, B,
                                  G, L, D, P, max_bb, s)
        : launch_dedup<int8_t, 1>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                  cst, hst, U, U, csl, hsl, m, hm, wf, o, B,
                                  G, L, D, P, max_bb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partial pool: the fused kernel with EMIT_TILES, one grid row per shard.
// cold (S * cold_stride, D) float32 or int8, shard s's slice at row
// s * cold_stride; hot (Vh, D) float32; x (B, D) float32; rows, is_hot
// (B, G, L) int32 / bool, rows local to a slice; owned (S, B, G, L) bool;
// w, scales (B, G, L) float32 or null; part_c (S, B, G + 1, D) and
// part_h (B, G + 1, D) float32.  max_bb as for fused_front_end.
extern "C" int fused_partial_pool(const void* cold, int itemsize, int vec16,
                                  int64_t cold_stride, int S,
                                  const void* hot, const void* x,
                                  const void* rows, const void* owned,
                                  const void* is_hot, const void* w,
                                  const void* scales, void* part_c,
                                  void* part_h, int B, int G, int L, int D,
                                  int max_bb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto xf = static_cast<const float*>(x);
  auto r = static_cast<const int32_t*>(rows);
  auto m = static_cast<const uint8_t*>(owned);
  auto hm = static_cast<const uint8_t*>(is_hot);
  auto wf = static_cast<const float*>(w);
  auto sc = static_cast<const float*>(scales);
  auto pc = static_cast<float*>(part_c);
  auto ph = static_cast<float*>(part_h);
  if (itemsize == 4) {
    return vec16
        ? launch<float, 4, false, true>(cold, h, xf, r, m, hm, wf, sc,
                                        nullptr, B, G, L, D, 0, max_bb, s,
                                        nullptr, nullptr, nullptr, S,
                                        cold_stride, pc, ph)
        : launch<float, 1, false, true>(cold, h, xf, r, m, hm, wf, sc,
                                        nullptr, B, G, L, D, 0, max_bb, s,
                                        nullptr, nullptr, nullptr, S,
                                        cold_stride, pc, ph);
  }
  if (itemsize == 1) {
    return vec16
        ? launch<int8_t, 16, false, true>(cold, h, xf, r, m, hm, wf, sc,
                                          nullptr, B, G, L, D, 0, max_bb, s,
                                          nullptr, nullptr, nullptr, S,
                                          cold_stride, pc, ph)
        : launch<int8_t, 1, false, true>(cold, h, xf, r, m, hm, wf, sc,
                                         nullptr, B, G, L, D, 0, max_bb, s,
                                         nullptr, nullptr, nullptr, S,
                                         cold_stride, pc, ph);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gather-once partial pool: one cold plan over all S shards (c_uniq
// (Uc,) rows of the whole cold tier (Vc, D), c_slots and owned
// (S, B, G, L)), one hot plan (h_uniq (Uh,), h_slots (B, G, L)); the
// stagings (Uc, D) and (Uh, D) float32 scratch; then the partial pool
// with DEDUP through the slots.  Outputs as fused_partial_pool.
extern "C" int fused_partial_pool_dedup(
    const void* cold, int itemsize, int64_t Vc, int vec16, int S,
    const void* hot, int64_t Vh, const void* x, const void* c_uniq,
    const void* c_n, const void* c_scales, const void* h_uniq,
    const void* h_n, void* c_stage, void* h_stage, int Uc, int Uh,
    const void* c_slots, const void* h_slots, const void* owned,
    const void* is_hot, const void* w, void* part_c, void* part_h, int B,
    int G, int L, int D, int max_bb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto xf = static_cast<const float*>(x);
  auto cu = static_cast<const int32_t*>(c_uniq);
  auto cn = static_cast<const int32_t*>(c_n);
  auto cs = static_cast<const float*>(c_scales);
  auto hu = static_cast<const int32_t*>(h_uniq);
  auto hn = static_cast<const int32_t*>(h_n);
  auto cst = static_cast<float*>(c_stage);
  auto hst = static_cast<float*>(h_stage);
  auto csl = static_cast<const int32_t*>(c_slots);
  auto hsl = static_cast<const int32_t*>(h_slots);
  auto m = static_cast<const uint8_t*>(owned);
  auto hm = static_cast<const uint8_t*>(is_hot);
  auto wf = static_cast<const float*>(w);
  auto pc = static_cast<float*>(part_c);
  auto ph = static_cast<float*>(part_h);
  if (itemsize == 4) {
    return vec16
        ? launch_dedup<float, 4, true>(cold, Vc, h, Vh, xf, cu, cn, cs, hu,
                                       hn, cst, hst, Uc, Uh, csl, hsl, m, hm,
                                       wf, nullptr, B, G, L, D, 0, max_bb, s,
                                       S, pc, ph)
        : launch_dedup<float, 1, true>(cold, Vc, h, Vh, xf, cu, cn, cs, hu,
                                       hn, cst, hst, Uc, Uh, csl, hsl, m, hm,
                                       wf, nullptr, B, G, L, D, 0, max_bb, s,
                                       S, pc, ph);
  }
  if (itemsize == 1) {
    return vec16
        ? launch_dedup<int8_t, 4, true>(cold, Vc, h, Vh, xf, cu, cn, cs, hu,
                                        hn, cst, hst, Uc, Uh, csl, hsl, m,
                                        hm, wf, nullptr, B, G, L, D, 0,
                                        max_bb, s, S, pc, ph)
        : launch_dedup<int8_t, 1, true>(cold, Vc, h, Vh, xf, cu, cn, cs, hu,
                                        hn, cst, hst, Uc, Uh, csl, hsl, m,
                                        hm, wf, nullptr, B, G, L, D, 0,
                                        max_bb, s, S, pc, ph);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
