// Fused DLRM front end: two-tier masked SLS -> features -> interaction,
// per entry and gather-once.
//
// fused_front_end replaces the Pallas TPU kernel src/repro/kernels/sls.py:
// fused_front_end_pallas (_make_fused_front_end_kernel, emit="interact",
// dedup=False); fused_front_end_dedup replaces :623
// fused_front_end_dedup_pallas (its pallas_call at :683), the same with
// each tier's rows read through its dedup plan -- cold c_unique[c_slots[e]]
// with its scale, hot h_unique[h_slots[e]] -- and no staging buffer
// (gather_once.cuh).  Every row id is read through clamp_row (common.cuh)
// against its own tier's rows, Vc or Vh.  The TPU grid (B/BB, G, L tiles)
// revisits one output
// block in order; blocks on a GPU run in no order, so here one CTA owns a
// batch tile of BB samples and loops over the G bags and the L entries
// itself.
//
// Bound: bytes (each tier's distinct rows once, plus x and the triangle);
// in practice latency, each bag's chain metadata -> row (through a plan:
// metadata -> slot's row id -> row).  Design, one walk for both
// (front_end_walk, the row sources template parameters): a team of threads
// per bag takes its entries in runs, both tiers' metadata in one round
// trip into shared memory, each tier's kept entries compacted in l order
// (an entry is cold or hot, so each tier loads only its own rows), then U
// rows in flight per lane: with a float32 cold tier one list of both
// tiers' kept entries (cold, then hot), U = 4, or 8 below 16 bags per SM;
// with an int8 cold tier two lists of U / 2 = 2 rows each (its rows stay
// raw int4 chunks, the hot rows are floats).  The cold and hot
// accumulators run the fixed l-order fmaf steps of masked_sls.cu apart,
// and cold + hot (__fadd_rn) is written once into a shared-memory
// (BB, F, D) feature tile with x in row 0, which interact_tile -- the
// device function dot_interaction.cu uses -- reduces.  The pooled
// features never reach device memory, and the result equals split
// (masked_sls per tier -> add -> dot_interaction) bit for bit.  One CTA per
// tile of BB samples, a CTA per sample at small batch (sls.py:
// front_end_shape).  Spreading a tile's bags over a cluster of CTAs that
// pool into the first one's shared memory (so that batch 32 runs on 128
// SMs, not 32) was measured slower at every batch (PERF.md): at batch 32
// each bag's chain of loads is the time, not the SMs.
//
// fused_partial_pool and fused_partial_pool_dedup (below) replace
// src/repro/kernels/sls.py:fused_partial_pool_pallas and
// fused_partial_pool_dedup_pallas (emit="tiles"): the pooling stopped
// before the interaction, in a kernel of its own (partial_pool_kernel).
// Each bag's cold and hot accumulators go to device memory as (B, F, D)
// tiles, part_c[s] per cold shard (row 0 zero) and part_h (row 0 = x);
// fused_resume (dot_interaction.cu) adds them and interacts.  A row id is
// read through clamp_row against its shard's slice (cold_stride rows: the
// reference pools each shard on its own local table) or the hot tier's
// Vh rows, so an id past a slice's end reads that slice's last row, never
// the next slice's.  The gather-once plan holds rows of the whole cold
// tier (slice offsets added by the caller): its stage clamps against Vc.
//
// Bound: bytes (the gather, plus the S + 1 tiles written); in practice
// latency, the chain of dependent metadata -> row round trips that each
// warp walks.  Design: one walk over each bag's entries for all shards, so
// a full card walks each entry once, not once per shard.
// - One team of threads per bag (a lane per 16-byte chunk of D; int8 reads
//   4-code chunks here), blocks of 64 threads, so that a small batch still
//   spreads over the SMs.
// - The team takes its bag's entries in runs of `team`: lane j loads entry
//   j's metadata (its owner mask over this grid row's shards, weight,
//   scale, rows or slots) into shared memory, one round trip per run, not
//   one per entry; then every lane gathers its chunk of the cold and hot
//   rows of 4 entries at a time and accumulates them in l order.
// - A shard that owns the entry accumulates its row into its own
//   accumulator acc_c[s] in registers (the shard-group size NSH is a
//   template parameter: 1, 2, 4 or 8; more shards take one grid row per
//   group of 8, the hot tier and x in group 0 alone).  The hot
//   accumulator takes every entry, f = hit * w.
// - Below 16 bags per SM (the wrapper's shard_group) each shard takes a
//   grid row of its own instead: a small batch leaves the card idle, and a
//   warp's chain of loads is then the time.
// A shard that does not own an entry skips it, where the plain versions
// add fmaf(0, v, acc) (f = owned * w = +-0): on finite
// rows the two agree, because f * v is +-0, acc + +-0 == acc, and an
// accumulator that starts at +0 turns to -0 only by underflow, which ==
// comparisons treat as +0.  So the tiles equal the plain version's, and
// partial pool -> resume equals split (chip_smoke.py checks it with
// +-1e30 rows under every masked entry).
//
// The gather-once variant stages both tiers' unique rows in one launch
// (dedup_stage.cuh, dedup_stage_tiers_kernel: the cold plan's live slots,
// then the hot plan's), then this kernel reads them through the first
// owner's cold slot and the hot slot: two launches per call.
#include "common.cuh"
#include "dedup_stage.cuh"
#include "gather_once.cuh"
#include "interaction.cuh"

constexpr int FE_THREADS = 256;   // threads per CTA, at most

// Registers per thread for 4 CTAs of FE_THREADS per SM, or 2 where a lane
// holds 8 rows in flight or int8's 16-code chunks (16 floats of the hot
// tier per row).
template <int VEC, int U>
constexpr int fe_min_blocks() {
  return VEC >= 16 || U >= 8 ? 2 : 4;
}

// The walk of both fused front ends: one CTA per feature tile of BB
// samples (blockIdx.x); its teams walk the tile's BB * G bags, one bag per
// team at a time, each run's metadata of both tiers in one round trip
// (cold rows and scales from csrc, hot rows from hsrc), and write each
// pooled row cold + hot into the tile; then x as row 0 and interact_tile.
// A lane holds U rows in flight.  With a float32 cold tier both tiers'
// kept entries share one list (the cold ones in l order, then the hot
// ones), so the U rows are whichever the bag has, mostly cold; an int8
// cold tier keeps two lists of U / 2 (its rows stay raw int4 chunks, the
// hot rows are floats).  Registers capped for 4 CTAs per SM at U = 4 (2 at
// U = 8 or int8's 16-code chunks): more CTAs per SM overlap one tile's
// interaction with other tiles' loads (PERF.md).
template <typename T, int VEC, int U, class ColdSrc, class HotSrc>
__device__ __forceinline__ void front_end_walk(
    const T* __restrict__ cold, const float* __restrict__ hot,
    const float* __restrict__ x, const ColdSrc& csrc, const HotSrc& hsrc,
    const uint8_t* __restrict__ owned, const uint8_t* __restrict__ is_hot,
    const float* __restrict__ w, float* __restrict__ out, int B, int G,
    int L, int D, int P, int BB, int team, float* tile, PlanEntry* meta) {
  constexpr bool kScaled = sizeof(T) == 1;   // int8 cold rows
  const int F = G + 1;
  const int lds = D + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * BB;
  const int nb = static_cast<int>(min(static_cast<int64_t>(BB), B - b0));
  // feature row 0 of each sample: x
  for (int e = threadIdx.x; e < nb * D; e += blockDim.x) {
    const int s = e / D;
    const int d = e - s * D;
    tile[s * F * lds + d] = __ldg(x + b0 * D + e);
  }
  const int teams = blockDim.x / team;
  const int lane = threadIdx.x % team;
  const int chunks = D / VEC;
  // a team's 2 * team entries of metadata: cold then hot
  PlanEntry* tm = meta + 2 * (threadIdx.x - lane);
  // the same trip counts for every lane of a warp (team_compact)
  for (int q0 = 0; q0 < nb * G; q0 += teams) {
    const int q = q0 + static_cast<int>(threadIdx.x) / team;
    const bool valid = q < nb * G;
    const int s = q / G;
    const int g = q - s * G;
    const int64_t e0 = ((b0 + s) * G + g) * L;
    for (int c0 = 0; c0 < chunks; c0 += team) {
      const int c = c0 + lane;
      const bool active = valid && c < chunks;
      float acc_c[VEC], acc_h[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc_c[k] = acc_h[k] = 0.0f;
      for (int l0 = 0; l0 < L; l0 += team) {
        const int n = min(team, L - l0);
        const bool mine = valid && lane < n;
        const int64_t e = e0 + l0 + lane;
        const float f = mine ? entry_factor(true, w, e) : 0.0f;
        __syncwarp();
        PlanEntry pc, ph;
        const bool kc = plan_load<kScaled>(mine, e, f, owned, csrc, D, &pc);
        const bool kh = plan_load<false>(mine, e, f, is_hot, hsrc, D, &ph);
        if constexpr (!kScaled) {
          // one list: kept cold entries at [0, mc), hot at [mc, mc + mh)
          int pc_pos, ph_pos;
          const int mc = team_compact(kc, lane, team, &pc_pos);
          const int mh = team_compact(kh, lane, team, &ph_pos);
          if (kc) tm[pc_pos] = pc;
          if (kh) tm[mc + ph_pos] = ph;
          __syncwarp();
          if (!active) continue;
          const int m = mc + mh;
          for (int j0 = 0; j0 < m; j0 += U) {
            RowChunk<float, VEC> r[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (j0 + u < m)
                r[u].load((j0 + u < mc ? cold : hot) + tm[j0 + u].off +
                          c * VEC);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (j0 + u < m) {
                float v[VEC];
                r[u].to_float(v);
                if (j0 + u < mc)
                  accumulate<VEC>(acc_c, tm[j0 + u].f, v, nullptr);
                else
                  accumulate<VEC>(acc_h, tm[j0 + u].f, v, nullptr);
              }
            }
          }
        } else {
          constexpr int UT = U / 2;          // rows in flight per tier
          const int mc = plan_keep(kc, pc, lane, team, tm);
          const int mh = plan_keep(kh, ph, lane, team, tm + team);
          __syncwarp();
          if (!active) continue;
          for (int j0 = 0; j0 < max(mc, mh); j0 += UT) {
            RowChunk<T, VEC> rc[UT];
            RowChunk<float, VEC> rh[UT];
            gather_kept<T, VEC, UT>(cold, tm, j0, mc, c, rc);
            gather_kept<float, VEC, UT>(hot, tm + team, j0, mh, c, rh);
            add_kept<T, VEC, UT, kScaled>(tm, j0, mc, rc, acc_c);
            add_kept<float, VEC, UT, false>(tm + team, j0, mh, rh, acc_h);
          }
        }
      }
      if (active) {
        float* dst = tile + (s * F + g + 1) * lds + c * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k) dst[k] = __fadd_rn(acc_c[k], acc_h[k]);
      }
    }
  }
  __syncthreads();
  interact_tile(tile, nb, F, D, lds, P, 0, out + b0 * P);
}

// The per-entry fused front end: entry e's row is rows[e] in either tier.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(FE_THREADS, fe_min_blocks<VEC, U>())
    fused_front_end_kernel(
        const T* __restrict__ cold, int64_t Vc, const float* __restrict__ hot,
        int64_t Vh, const float* __restrict__ x,
        const int32_t* __restrict__ rows, const uint8_t* __restrict__ owned,
        const uint8_t* __restrict__ is_hot, const float* __restrict__ w,
        const float* __restrict__ scales, float* __restrict__ out, int B,
        int G, int L, int D, int P, int BB, int team) {
  extern __shared__ float tile[];
  __shared__ PlanEntry meta[2 * FE_THREADS];
  front_end_walk<T, VEC, U>(cold, hot, x, PerEntry{rows, scales, Vc},
                            PerEntry{rows, nullptr, Vh}, owned, is_hot, w,
                            out, B, G, L, D, P, BB, team, tile, meta);
}

// The gather-once fused front end: each tier's rows through its plan.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(FE_THREADS, fe_min_blocks<VEC, U>())
    fused_front_end_dedup_kernel(
        const T* __restrict__ cold, int64_t Vc, const float* __restrict__ hot,
        int64_t Vh, const float* __restrict__ x,
        const int32_t* __restrict__ cuniq, const float* __restrict__ cscales,
        const int32_t* __restrict__ huniq, const int32_t* __restrict__ cslots,
        const int32_t* __restrict__ hslots, const uint8_t* __restrict__ owned,
        const uint8_t* __restrict__ is_hot, const float* __restrict__ w,
        float* __restrict__ out, int B, int G, int L, int D, int P, int BB,
        int team) {
  extern __shared__ float tile[];
  __shared__ PlanEntry meta[2 * FE_THREADS];
  front_end_walk<T, VEC, U>(
      cold, hot, x, ThroughPlan{cslots, cuniq, cscales, Vc},
      ThroughPlan{hslots, huniq, nullptr, Vh}, owned, is_hot, w, out, B, G,
      L, D, P, BB, team, tile, meta);
}

// Check the wrapper's shape (threads a multiple of 32 and of the team, at
// most FE_THREADS; BB >= 1) and opt the kernel into the tile's dynamic
// shared memory: the static metadata (2 * FE_THREADS PlanEntry) counts
// against the 48 KB a block gets without the opt-in.  Returns the tile's
// bytes, or -1 with *err set.
template <typename K>
static int64_t front_end_smem(K kernel, int G, int D, int vec, int BB,
                              int threads, int* err) {
  const int team = team_size(D / vec);
  *err = 0;
  if (threads % 32 != 0 || threads > FE_THREADS || threads % team || BB < 1) {
    *err = static_cast<int>(cudaErrorInvalidValue);
    return -1;
  }
  const size_t smem =
      static_cast<size_t>(BB) * (G + 1) * (D + 1) * sizeof(float);
  if (smem + 2 * FE_THREADS * sizeof(PlanEntry) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      *err = static_cast<int>(e);
      return -1;
    }
  }
  return static_cast<int64_t>(smem);
}

// One CTA per tile of BB samples, the kernel at U = inflight rows in flight
// per lane: k4, or k8 (given for a float32 cold tier only).
template <typename K, typename... Args>
static int launch_tiles(K k4, K k8, int inflight, int B, int G, int D,
                        int vec, int BB, int threads, cudaStream_t stream,
                        Args... args) {
  if (inflight != 4 && (inflight != 8 || k8 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const K kernel = inflight == 8 ? k8 : k4;
  int err;
  const int64_t smem = front_end_smem(kernel, G, D, vec, BB, threads, &err);
  if (smem < 0) return err;
  kernel<<<(B + BB - 1) / BB, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int launch_front_end(const void* cold, int64_t Vc, const float* hot,
                            int64_t Vh, const float* x, const int32_t* rows,
                            const uint8_t* owned, const uint8_t* is_hot,
                            const float* w, const float* scales, float* out,
                            int B, int G, int L, int D, int BB, int threads,
                            int inflight, cudaStream_t stream) {
  decltype(&fused_front_end_kernel<T, VEC, 4>) k8 = nullptr;
  if constexpr (sizeof(T) == 4) k8 = fused_front_end_kernel<T, VEC, 8>;
  return launch_tiles(fused_front_end_kernel<T, VEC, 4>, k8, inflight, B, G,
                      D, VEC, BB, threads, stream,
                      static_cast<const T*>(cold), Vc, hot, Vh, x, rows,
                      owned, is_hot, w, scales, out, B, G, L, D,
                      G * (G + 1) / 2, BB, team_size(D / VEC));
}

template <typename T, int VEC>
static int launch_front_end_dedup(
    const T* cold, int64_t Vc, const float* hot, int64_t Vh, const float* x,
    const int32_t* cuniq, const float* cscales, const int32_t* huniq,
    const int32_t* cslots, const int32_t* hslots, const uint8_t* owned,
    const uint8_t* is_hot, const float* w, float* out, int B, int G, int L,
    int D, int BB, int threads, int inflight, cudaStream_t stream) {
  decltype(&fused_front_end_dedup_kernel<T, VEC, 4>) k8 = nullptr;
  if constexpr (sizeof(T) == 4) k8 = fused_front_end_dedup_kernel<T, VEC, 8>;
  return launch_tiles(fused_front_end_dedup_kernel<T, VEC, 4>, k8, inflight,
                      B, G, D, VEC, BB, threads, stream, cold, Vc, hot, Vh,
                      x, cuniq, cscales, huniq, cslots, hslots, owned, is_hot,
                      w, out, B, G, L, D, G * (G + 1) / 2, BB,
                      team_size(D / VEC));
}

// One entry of a team's current run, as the partial pool's row phase reads
// it: the element offsets of the rows to gather (cold: the first owner's
// row in its slice or, with DEDUP, its staging slot; hot: hit ? row : 0,
// or the hot slot), the factors fc = 1 * w (owned) and fh = hit * w, the
// dequant scale and the owners among this grid row's shards (bit q: shard
// s0 + q).  32 bytes, read as two 16-byte shared loads.
struct __align__(16) PoolEntry {
  int64_t cold;
  int64_t hot;
  float fc;
  float fh;
  float scale;
  uint32_t owners;
};

constexpr int POOL_THREADS = 64;   // partial-pool block size
constexpr int POOL_U = 4;          // entries whose rows are in flight at once

// The partial pool: NSH shards of grid row blockIdx.y's group (shards
// s0 = blockIdx.y * NSH .. s0 + ns - 1) in one walk over each bag's
// entries.  owned (S, B, G, L); rows (B, G, L) row ids local to a slice
// (clamp_row: against cold_stride in the cold tier, Vh in the hot), or
// with DEDUP the cold slots (S, B, G, L); cold's shard s slice at row
// s * cold_stride (without DEDUP); scales (int8 only, without DEDUP).  One
// team of threads per bag, a few bags per block (small blocks, so that a
// small batch still spreads over the SMs).  The team takes its bag's
// entries in runs of `team`: lane j reads entry j's metadata into shared
// memory (one round trip per run, not one per entry), then every lane
// gathers its chunk of the rows of U entries at a time and accumulates
// them in l order.  See the header for why skipping a non-owned entry
// keeps the tiles bitwise.
template <typename T, int VEC, bool DEDUP, int NSH>
__global__ void __launch_bounds__(POOL_THREADS) partial_pool_kernel(
    const T* __restrict__ cold, const float* __restrict__ hot,
    const float* __restrict__ x, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ owned, const uint8_t* __restrict__ is_hot,
    const float* __restrict__ w, const float* __restrict__ scales, int B,
    int G, int L, int D, int S, int team,
    const int32_t* __restrict__ hslots, const float* __restrict__ cstage,
    const float* __restrict__ hstage, int64_t cold_stride, int64_t Vh,
    float* __restrict__ part_c, float* __restrict__ part_h) {
  __shared__ PoolEntry meta[POOL_THREADS];
  // 16-float chunks: one entry in flight, so that the registers hold more
  // bags (the int8 16-code path runs at one or two shards)
  constexpr int U = VEC >= 16 ? 1 : POOL_U;
  constexpr bool kScaled = !DEDUP && sizeof(T) == 1;  // int8 rows
  const int F = G + 1;
  const int s0 = static_cast<int>(blockIdx.y) * NSH;
  const int ns = min(NSH, S - s0);
  const bool with_hot = blockIdx.y == 0;
  const int64_t n_e = static_cast<int64_t>(B) * G * L;
  const int64_t tile_c = static_cast<int64_t>(B) * F * D;  // one part_c[s]
  const int chunks = D / VEC;
  const int lane = threadIdx.x % team;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / team) +
      threadIdx.x / team;
  // Every loop bound below is the same for all lanes of a warp (a team
  // lies inside one warp), so the __syncwarp()s are reached by all.
  const bool valid = bag < static_cast<int64_t>(B) * G;
  const int64_t b = bag / G;
  const int g = static_cast<int>(bag - b * G);
  const int64_t e0 = bag * L;
  PoolEntry* tm = meta + (threadIdx.x / team) * team;
  for (int c0 = 0; c0 < chunks; c0 += team) {
    const int c = c0 + lane;
    const bool active = valid && c < chunks;
    // feature row 0 of sample b, by the team of bag g = 0: zeros in
    // part_c, x in part_h, written in the first metadata phase so that x's
    // round trip overlaps the metadata's
    const bool row0 = active && g == 0;
    float acc_c[NSH][VEC], acc_h[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc_h[k] = 0.0f;
#pragma unroll
      for (int q = 0; q < NSH; ++q) acc_c[q][k] = 0.0f;
    }
    for (int l0 = 0; l0 < L; l0 += team) {
      const int n = min(team, L - l0);
      __syncwarp();
      float xv[VEC];
      if (l0 == 0 && row0 && with_hot) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xv[k] = __ldg(x + b * D + c * VEC + k);
      }
      if (valid && lane < n) {
        const int64_t e = e0 + l0 + lane;
        uint32_t m = 0;
#pragma unroll
        for (int q = 0; q < NSH; ++q)
          if (q < ns && owned[(s0 + q) * n_e + e] != 0) m |= 1u << q;
        const bool hit = with_hot && is_hot[e] != 0;
        const int first = m ? __ffs(m) - 1 : 0;
        PoolEntry p;
        p.owners = m;
        p.fc = entry_factor(true, w, e);
        p.fh = entry_factor(hit, w, e);
        p.scale = kScaled ? __ldg(scales + e) : 1.0f;
        if constexpr (DEDUP) {
          // the first owner's slot; slot 0 (always staged) for nobody
          const int64_t u = m ? __ldg(rows + (s0 + first) * n_e + e) : 0;
          p.cold = u * D;
          p.hot = with_hot ? __ldg(hslots + e) * static_cast<int64_t>(D) : 0;
        } else {
          // nobody: row 0 of the group's first slice, read and not used
          const int32_t r = __ldg(rows + e);
          p.cold = ((s0 + first) * cold_stride +
                    (m ? clamp_row(r, cold_stride) : 0)) * D;
          p.hot = (hit ? clamp_row(r, Vh) : 0) * D;
        }
        tm[lane] = p;
      }
      if (l0 == 0 && row0) {
        float zero[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) zero[k] = 0.0f;
        const int64_t row = b * F * D + c * VEC;
#pragma unroll
        for (int q = 0; q < NSH; ++q)
          if (q < ns) store_row<VEC>(part_c + (s0 + q) * tile_c + row, zero);
        if (with_hot) store_row<VEC>(part_h + row, xv);
      }
      __syncwarp();
      if (!active) continue;
      for (int j0 = 0; j0 < n; j0 += U) {
        // gather the first owner's cold row and the hot row, U entries in
        // flight
        float vc[U][VEC], vh[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u < n) {
            const PoolEntry p = tm[j0 + u];
            if constexpr (DEDUP)
              load_row<float, VEC>(cstage + p.cold + c * VEC, vc[u]);
            else
              load_row<T, VEC>(cold + p.cold + c * VEC, vc[u]);
            if (with_hot)
              load_row<float, VEC>((DEDUP ? hstage : hot) + p.hot + c * VEC,
                                   vh[u]);
          }
        }
        // accumulate in l order: each owner's accumulator, then the hot
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u < n) {
            const PoolEntry p = tm[j0 + u];
            uint32_t m = p.owners;
            while (m) {
              const int q = __ffs(m) - 1;
              if (m != p.owners) {
                // a further owner (masks need not be disjoint): its row
                const int64_t e = e0 + l0 + j0 + u;
                if constexpr (DEDUP) {
                  const int64_t slot = __ldg(rows + (s0 + q) * n_e + e);
                  load_row<float, VEC>(cstage + slot * D + c * VEC, vc[u]);
                } else {
                  const int64_t r = clamp_row(__ldg(rows + e), cold_stride);
                  load_row<T, VEC>(
                      cold + ((s0 + q) * cold_stride + r) * D + c * VEC,
                      vc[u]);
                }
              }
              float v[VEC];
#pragma unroll
              for (int k = 0; k < VEC; ++k)
                v[k] = kScaled ? __fmul_rn(vc[u][k], p.scale) : vc[u][k];
              if constexpr (NSH == 1) {
                accumulate<VEC>(acc_c[0], p.fc, v, nullptr);
              } else {
#pragma unroll
                for (int r = 0; r < NSH; ++r)
                  if (r == q) accumulate<VEC>(acc_c[r], p.fc, v, nullptr);
              }
              m &= m - 1;
            }
            if (with_hot) accumulate<VEC>(acc_h, p.fh, vh[u], nullptr);
          }
        }
      }
    }
    if (active) {
      const int64_t row = (b * F + g + 1) * D + c * VEC;
#pragma unroll
      for (int q = 0; q < NSH; ++q)
        if (q < ns) store_row<VEC>(part_c + (s0 + q) * tile_c + row, acc_c[q]);
      if (with_hot) store_row<VEC>(part_h + row, acc_h);
    }
  }
}

// The partial pool's launch: POOL_THREADS / team bags per block, one grid
// row per group of nsh shards.  nsh (1, 2, 4 or 8) is the wrapper's choice
// (sls.py: shard_group).  With DEDUP, rows holds the cold slots and cold
// is unused.
template <typename T, int VEC, bool DEDUP>
static int launch_partial(const void* cold, const float* hot, const float* x,
                          const int32_t* rows, const uint8_t* owned,
                          const uint8_t* is_hot, const float* w,
                          const float* scales, int B, int G, int L, int D,
                          int S, int nsh, int64_t cold_stride, int64_t Vh,
                          cudaStream_t stream, const int32_t* hslots,
                          const float* cstage, const float* hstage,
                          float* part_c, float* part_h) {
  const int team = team_size(D / VEC);
  const int64_t bags = static_cast<int64_t>(B) * G;
  const int per_block = POOL_THREADS / team;
  const dim3 grid(static_cast<unsigned>((bags + per_block - 1) / per_block),
                  (S + nsh - 1) / nsh);
  if (grid.x == 0) return static_cast<int>(cudaGetLastError());
  auto c = static_cast<const T*>(cold);
#define PARTIAL_POOL(N)                                                     \
  partial_pool_kernel<T, VEC, DEDUP, N><<<grid, POOL_THREADS, 0, stream>>>(\
      c, hot, x, rows, owned, is_hot, w, scales, B, G, L, D, S, team,       \
      hslots, cstage, hstage, cold_stride, Vh, part_c, part_h)
  switch (nsh) {
    case 1: PARTIAL_POOL(1); break;
    case 2: PARTIAL_POOL(2); break;
    case 4: PARTIAL_POOL(4); break;
    case 8: PARTIAL_POOL(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PARTIAL_POOL
  return static_cast<int>(cudaGetLastError());
}

// cold (Vc, D) float32 or int8 (itemsize 4 / 1); hot (Vh, D) float32;
// x (B, D) float32; rows (B, G, L) int32 row ids of either tier; owned,
// is_hot (B, G, L) bool; w (B, G, L) float32 or null; scales (B, G, L)
// float32, given exactly for an int8 cold tier; out (B, P) float32,
// P = G(G+1)/2.  vec: row elements per lane (1; 4, a 16-byte float32 chunk
// or 4 int8 codes; 16 int8 codes), BB samples per CTA, threads per CTA
// and inflight rows in flight per lane (4, or 8 with a float32 cold tier)
// -- the wrapper's choice (sls.py: front_end_shape).
extern "C" int fused_front_end(const void* cold, int itemsize, int64_t Vc,
                               int vec, const void* hot, int64_t Vh,
                               const void* x, const void* rows,
                               const void* owned, const void* is_hot,
                               const void* w, const void* scales, void* out,
                               int B, int G, int L, int D, int BB,
                               int threads, int inflight, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto xf = static_cast<const float*>(x);
  auto r = static_cast<const int32_t*>(rows);
  auto m = static_cast<const uint8_t*>(owned);
  auto hm = static_cast<const uint8_t*>(is_hot);
  auto wf = static_cast<const float*>(w);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
#define FE(T, VEC)                                                          \
  launch_front_end<T, VEC>(cold, Vc, h, Vh, xf, r, m, hm, wf, sc, o, B, G, L, \
                           D, BB, threads, inflight, s)
  if (itemsize == 4 && vec == 4) return FE(float, 4);
  if (itemsize == 4 && vec == 1) return FE(float, 1);
  if (itemsize == 1 && vec == 16) return FE(int8_t, 16);
  if (itemsize == 1 && vec == 4) return FE(int8_t, 4);
  if (itemsize == 1 && vec == 1) return FE(int8_t, 1);
#undef FE
  return static_cast<int>(cudaErrorInvalidValue);
}

// cold (Vc, D) float32 or int8 (itemsize 4 / 1); hot (Vh, D) float32;
// x (B, D) float32; c_/h_uniq (U,) int32 row per slot (one dedup plan per
// tier), c_scales (U,) float32, given exactly for an int8 cold tier;
// c_/h_slots, owned, is_hot (B, G, L); w (B, G, L) or null; out (B, P)
// float32.  vec, BB, threads and inflight as for fused_front_end.
extern "C" int fused_front_end_dedup(
    const void* cold, int itemsize, int64_t Vc, int vec, const void* hot,
    int64_t Vh, const void* x, const void* c_uniq, const void* c_scales,
    const void* h_uniq, const void* c_slots, const void* h_slots,
    const void* owned, const void* is_hot, const void* w, void* out, int B,
    int G, int L, int D, int BB, int threads, int inflight, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto h = static_cast<const float*>(hot);
  auto xf = static_cast<const float*>(x);
  auto cu = static_cast<const int32_t*>(c_uniq);
  auto cs = static_cast<const float*>(c_scales);
  auto hu = static_cast<const int32_t*>(h_uniq);
  auto csl = static_cast<const int32_t*>(c_slots);
  auto hsl = static_cast<const int32_t*>(h_slots);
  auto m = static_cast<const uint8_t*>(owned);
  auto hm = static_cast<const uint8_t*>(is_hot);
  auto wf = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
#define FE_DEDUP(T, VEC)                                                    \
  launch_front_end_dedup<T, VEC>(static_cast<const T*>(cold), Vc, h, Vh, xf, \
                                 cu, cs, hu, csl, hsl, m, hm, wf, o, B, G, L, \
                                 D, BB, threads, inflight, s)
  if (itemsize == 4 && vec == 4) return FE_DEDUP(float, 4);
  if (itemsize == 4 && vec == 1) return FE_DEDUP(float, 1);
  if (itemsize == 1 && vec == 16) return FE_DEDUP(int8_t, 16);
  if (itemsize == 1 && vec == 4) return FE_DEDUP(int8_t, 4);
  if (itemsize == 1 && vec == 1) return FE_DEDUP(int8_t, 1);
#undef FE_DEDUP
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partial pool, one walk for all shards of a group.  cold
// (S * cold_stride, D) float32 or int8, shard s's slice at row
// s * cold_stride; hot (Vh, D) float32; x (B, D) float32; rows, is_hot
// (B, G, L) int32 / bool, row ids local to a slice; owned (S, B, G, L) bool;
// w (B, G, L) float32 or null; scales (B, G, L) float32, given exactly
// for an int8 cold tier; part_c (S, B, G + 1, D) and part_h
// (B, G + 1, D) float32.  vec: row elements per lane (1; 4, a
// 16-byte float32 chunk or 4 int8 codes; 16 int8 codes), nsh: shards per
// grid row (1, 2, 4 or 8) -- both the wrapper's choice (sls.py: pool_vec,
// shard_group).
extern "C" int fused_partial_pool(const void* cold, int itemsize, int vec,
                                  int64_t cold_stride, int S, int nsh,
                                  const void* hot, int64_t Vh, const void* x,
                                  const void* rows, const void* owned,
                                  const void* is_hot, const void* w,
                                  const void* scales, void* part_c,
                                  void* part_h, int B, int G, int L, int D,
                                  void* stream) {
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
#define PARTIAL(T, V)                                                       \
  launch_partial<T, V, false>(cold, h, xf, r, m, hm, wf, sc, B, G, L, D, S, \
                              nsh, cold_stride, Vh, s, nullptr, nullptr,    \
                              nullptr, pc, ph)
  if (itemsize == 4 && vec == 4) return PARTIAL(float, 4);
  if (itemsize == 4 && vec == 1) return PARTIAL(float, 1);
  if (itemsize == 1 && vec == 16) return PARTIAL(int8_t, 16);
  if (itemsize == 1 && vec == 4) return PARTIAL(int8_t, 4);
  if (itemsize == 1 && vec == 1) return PARTIAL(int8_t, 1);
#undef PARTIAL
  return static_cast<int>(cudaErrorInvalidValue);
}

// Stage both tiers in one launch, then the partial pool through the slots:
// two launches on one stream.  VEC is the float32 staging chunk; T only
// types the cold table.
template <typename T, int VEC>
static int launch_partial_dedup(
    const void* cold, int64_t Vc, const float* hot, int64_t Vh,
    const float* x, const int32_t* cuniq, const int32_t* cn,
    const float* cscales, const int32_t* huniq, const int32_t* hn,
    float* cstage, float* hstage, int Uc, int Uh, const int32_t* cslots,
    const int32_t* hslots, const uint8_t* owned, const uint8_t* is_hot,
    const float* w, float* part_c, float* part_h, int B, int G, int L, int D,
    int S, int nsh, cudaStream_t stream) {
  launch_stage_tiers<T, VEC>(static_cast<const T*>(cold), Vc, cuniq, cn,
                             cscales, cstage, Uc, hot, Vh, huniq, hn, hstage,
                             Uh, D, stream);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_partial<float, VEC, true>(
      nullptr, hot, x, cslots, owned, is_hot, w, nullptr, B, G, L, D, S, nsh,
      0, Vh, stream, hslots, cstage, hstage, part_c, part_h);
}

// The gather-once partial pool: one cold plan over all S shards (c_uniq
// (Uc,) rows of the whole cold tier (Vc, D), c_slots and owned
// (S, B, G, L)), one hot plan (h_uniq (Uh,), h_slots (B, G, L)); the
// stagings (Uc, D) and (Uh, D) float32 scratch, filled by one stage
// launch; then the partial pool with DEDUP through the slots.  Outputs
// and nsh as fused_partial_pool.
extern "C" int fused_partial_pool_dedup(
    const void* cold, int itemsize, int64_t Vc, int vec16, int S, int nsh,
    const void* hot, int64_t Vh, const void* x, const void* c_uniq,
    const void* c_n, const void* c_scales, const void* h_uniq,
    const void* h_n, void* c_stage, void* h_stage, int Uc, int Uh,
    const void* c_slots, const void* h_slots, const void* owned,
    const void* is_hot, const void* w, void* part_c, void* part_h, int B,
    int G, int L, int D, void* stream) {
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
        ? launch_partial_dedup<float, 4>(cold, Vc, h, Vh, xf, cu, cn, cs, hu,
                                         hn, cst, hst, Uc, Uh, csl, hsl, m,
                                         hm, wf, pc, ph, B, G, L, D, S, nsh, s)
        : launch_partial_dedup<float, 1>(cold, Vc, h, Vh, xf, cu, cn, cs, hu,
                                         hn, cst, hst, Uc, Uh, csl, hsl, m,
                                         hm, wf, pc, ph, B, G, L, D, S, nsh, s);
  }
  if (itemsize == 1) {
    return vec16
        ? launch_partial_dedup<int8_t, 4>(cold, Vc, h, Vh, xf, cu, cn, cs,
                                          hu, hn, cst, hst, Uc, Uh, csl, hsl,
                                          m, hm, wf, pc, ph, B, G, L, D, S,
                                          nsh, s)
        : launch_partial_dedup<int8_t, 1>(cold, Vc, h, Vh, xf, cu, cn, cs,
                                          hu, hn, cst, hst, Uc, Uh, csl, hsl,
                                          m, hm, wf, pc, ph, B, G, L, D, S,
                                          nsh, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
