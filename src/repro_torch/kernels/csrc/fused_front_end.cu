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
#include <algorithm>

#include "common.cuh"
#include "dedup_stage.cuh"
#include "interaction.cuh"

template <typename T, int VEC, bool DEDUP>
__global__ void fused_front_end_kernel(
    const T* __restrict__ cold, const float* __restrict__ hot,
    const float* __restrict__ x, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ owned, const uint8_t* __restrict__ is_hot,
    const float* __restrict__ w, const float* __restrict__ scales,
    float* __restrict__ out, int B, int G, int L, int D, int P, int BB,
    int team, const int32_t* __restrict__ hslots,
    const float* __restrict__ cstage, const float* __restrict__ hstage) {
  extern __shared__ float tile[];
  const int F = G + 1;
  const int lds = D + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BB;
  const int nb = static_cast<int>(min(static_cast<int64_t>(BB), B - b0));

  // feature row 0 of each sample: the bottom-MLP output x
  for (int e = threadIdx.x; e < nb * D; e += blockDim.x) {
    const int s = e / D;
    tile[s * F * lds + (e - s * D)] = __ldg(x + b0 * D + e);
  }

  // rows 1..G: pooled bags, cold and hot accumulated apart
  const int chunks = D / VEC;
  const int teams = blockDim.x / team;
  const int lane = threadIdx.x % team;
  for (int bag = threadIdx.x / team; bag < nb * G; bag += teams) {
    const int s = bag / G;
    const int g = bag - s * G;
    const int64_t e0 = ((b0 + s) * G + g) * L;
    float* dst = tile + (s * F + g + 1) * lds;
    for (int c = lane; c < chunks; c += team) {
      float acc_c[VEC], acc_h[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc_c[k] = acc_h[k] = 0.0f;
      for (int l = 0; l < L; ++l) {
        const int64_t e = e0 + l;
        const bool own = owned[e] != 0;
        const bool hit = is_hot[e] != 0;
        const float fc = entry_factor(true, own, w, e);
        const float fh = entry_factor(true, hit, w, e);
        float vc[VEC], vh[VEC];
        if constexpr (DEDUP) {
          // rows holds the cold staging slots; out-of-tier entries read
          // their tier's (finite) sentinel slot with f = 0
          const int64_t uc = __ldg(rows + e);
          const int64_t uh = __ldg(hslots + e);
          load_row<float, VEC>(cstage + uc * D + c * VEC, vc);
          load_row<float, VEC>(hstage + uh * D + c * VEC, vh);
          accumulate<VEC>(acc_c, fc, vc, nullptr);
        } else {
          const int64_t r = __ldg(rows + e);
          load_row<T, VEC>(cold + (own ? r : 0) * D + c * VEC, vc);
          load_row<float, VEC>(hot + (hit ? r : 0) * D + c * VEC, vh);
          accumulate<VEC>(acc_c, fc, vc,
                          scales == nullptr ? nullptr : scales + e);
        }
        accumulate<VEC>(acc_h, fh, vh, nullptr);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        dst[c * VEC + k] = __fadd_rn(acc_c[k], acc_h[k]);
    }
  }
  __syncthreads();
  interact_tile(tile, nb, F, D, lds, P, 0, out + b0 * P);
}

template <typename T, int VEC, bool DEDUP = false>
static int launch(const void* cold, const float* hot, const float* x,
                  const int32_t* rows, const uint8_t* owned,
                  const uint8_t* is_hot, const float* w, const float* scales,
                  float* out, int B, int G, int L, int D, int P, int max_bb,
                  cudaStream_t stream, const int32_t* hslots = nullptr,
                  const float* cstage = nullptr,
                  const float* hstage = nullptr) {
  const int threads = 256;
  const int team = team_size(D / VEC);
  // A team walks its bags' entries one gather after another, so the
  // kernel is bound by gather latency unless many teams are in flight:
  // give each team one bag (BB * G <= teams), up to the caller's cap.
  const int BB = std::max(1, std::min(max_bb, (threads / team) / G));
  const size_t smem =
      static_cast<size_t>(BB) * (G + 1) * (D + 1) * sizeof(float);
  // above 48 KB a block gets dynamic shared memory only after this opt-in;
  // without it the launch is refused
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_front_end_kernel<T, VEC, DEDUP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + BB - 1) / BB;
  if (blocks > 0) {
    fused_front_end_kernel<T, VEC, DEDUP><<<blocks, threads, smem, stream>>>(
        static_cast<const T*>(cold), hot, x, rows, owned, is_hot, w, scales,
        out, B, G, L, D, P, BB, team, hslots, cstage, hstage);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage each tier's unique rows, then the fused kernel through the slots,
// on one stream.  VEC is the float32 staging chunk (see dedup_stage.cuh);
// T only types the cold table.
template <typename T, int VEC>
static int launch_dedup(const void* cold, int64_t Vc, const float* hot,
                        int64_t Vh, const float* x, const int32_t* cuniq,
                        const int32_t* cn, const float* cscales,
                        const int32_t* huniq, const int32_t* hn,
                        float* cstage, float* hstage, int U,
                        const int32_t* cslots, const int32_t* hslots,
                        const uint8_t* owned, const uint8_t* is_hot,
                        const float* w, float* out, int B, int G, int L,
                        int D, int P, int max_bb, cudaStream_t stream) {
  launch_stage<T, VEC>(static_cast<const T*>(cold), Vc, D, cuniq, cn,
                       cscales, cstage, U, stream);
  launch_stage<float, VEC>(hot, Vh, D, huniq, hn, nullptr, hstage, U,
                           stream);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch<float, VEC, true>(cold, hot, x, cslots, owned, is_hot, w,
                                  nullptr, out, B, G, L, D, P, max_bb,
                                  stream, hslots, cstage, hstage);
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
                                 cst, hst, U, csl, hsl, m, hm, wf, o, B, G,
                                 L, D, P, max_bb, s)
        : launch_dedup<float, 1>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                 cst, hst, U, csl, hsl, m, hm, wf, o, B, G,
                                 L, D, P, max_bb, s);
  }
  if (itemsize == 1) {
    return vec16
        ? launch_dedup<int8_t, 4>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                  cst, hst, U, csl, hsl, m, hm, wf, o, B, G,
                                  L, D, P, max_bb, s)
        : launch_dedup<int8_t, 1>(cold, Vc, h, Vh, xf, cu, cn, cs, hu, hn,
                                  cst, hst, U, csl, hsl, m, hm, wf, o, B, G,
                                  L, D, P, max_bb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
