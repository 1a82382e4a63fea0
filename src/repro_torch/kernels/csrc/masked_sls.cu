// Masked partial SparseLengthSum (plain SLS with a null mask), per entry
// and gather-once.
//
// masked_sls replaces the Pallas TPU kernel src/repro/kernels/sls.py:
// _sls_call (masked_sls_pallas and sls_pallas).  out[n] = sum_l f[n,l] *
// row[n,l] in the fixed order l = 0..L-1, with f = owned * w and
// row = table[clamp_row(idx, V)] (int8: float(q) * scale, rounded on its
// own; clamp_row, common.cuh: any id reads a row of the table); a
// non-owned entry adds nothing (the plain version adds 0 * row 0, the same
// on finite rows: gather_once.cuh).
//
// masked_sls_dedup replaces src/repro/kernels/sls.py:254
// masked_sls_dedup_pallas (its pallas_call at :304): the same sum, each
// owned entry's row read through the dedup plan, row =
// table[clamp_row(unique_rows[slots[e]], V)] (int8: times the slot's
// scale), with no
// staging buffer (gather_once.cuh).  Same operands, same fmaf order:
// bitwise equal to masked_sls for every weight on finite rows.
//
// Bound: bytes, each distinct row once (duplicates hit in L2); in
// practice latency, the chain metadata -> row (through the plan:
// metadata -> slot's row id -> row) that each bag walks.  Design, one walk
// for both (sls_walk, the row source a template parameter): a team of
// threads per bag takes its entries in runs, one round trip of metadata
// per run into shared memory, the owned entries compacted in l order by a
// warp ballot (a masked entry costs no row load: the hot-tier call of the
// split path keeps ~5 % of its entries), then U rows in flight per lane
// (8 below 16 bags per SM, where each bag's chain is the time, else 4,
// which leaves the registers for more warps; int8's 16-code chunks only
// at 4); blocks of at most 64
// threads, so that batch 32 (256 bags) spreads over the SMs; int8 in 4- or
// 16-code chunks, a 16-code chunk held raw until its add.  The launch
// shape is the wrapper's (sls.py: sls_shape).
#include "common.cuh"
#include "gather_once.cuh"

constexpr int SLS_THREADS = 64;   // threads per block, at most

// One team of threads per bag (bag = block * (threads / team) + thread /
// team), reading each owned entry's row from the source, U rows in flight;
// owned null keeps every entry.
template <typename T, int VEC, int U, class Src>
__device__ __forceinline__ void sls_walk(const T* __restrict__ table, int D,
                                         const Src& src,
                                         const uint8_t* __restrict__ owned,
                                         const float* __restrict__ w,
                                         float* __restrict__ out, int N,
                                         int L, int team, PlanEntry* meta) {
  constexpr bool kScaled = sizeof(T) == 1;   // int8 rows
  const int chunks = D / VEC;
  const int lane = threadIdx.x % team;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / team) +
      threadIdx.x / team;
  const bool valid = bag < N;
  const int64_t e0 = bag * L;
  PlanEntry* tm = meta + (threadIdx.x - lane);
  for (int c0 = 0; c0 < chunks; c0 += team) {
    const int c = c0 + lane;
    const bool active = valid && c < chunks;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int l0 = 0; l0 < L; l0 += team) {
      const int n = min(team, L - l0);
      const bool mine = valid && lane < n;
      const int64_t e = e0 + l0 + lane;
      __syncwarp();
      PlanEntry p;
      const bool keep = plan_load<kScaled>(
          mine, e, mine ? entry_factor(true, w, e) : 0.0f, owned, src,
          D, &p);
      const int m = plan_keep(keep, p, lane, team, tm);
      __syncwarp();
      if (!active) continue;
      for (int j0 = 0; j0 < m; j0 += U) {
        RowChunk<T, VEC> r[U];
        gather_kept<T, VEC, U>(table, tm, j0, m, c, r);
        add_kept<T, VEC, U, kScaled>(tm, j0, m, r, acc);
      }
    }
    if (active) store_row<VEC>(out + bag * D + c * VEC, acc);
  }
}

template <typename T, int VEC, int U>
__global__ void __launch_bounds__(SLS_THREADS) masked_sls_kernel(
    const T* __restrict__ table, int64_t V, int D,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ owned,
    const float* __restrict__ w, const float* __restrict__ scales,
    float* __restrict__ out, int N, int L, int team) {
  __shared__ PlanEntry meta[SLS_THREADS];
  sls_walk<T, VEC, U>(table, D, PerEntry{idx, scales, V}, owned, w, out, N,
                      L, team, meta);
}

template <typename T, int VEC, int U>
__global__ void __launch_bounds__(SLS_THREADS) masked_sls_dedup_kernel(
    const T* __restrict__ table, int64_t V, int D,
    const int32_t* __restrict__ uniq, const float* __restrict__ uscales,
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ owned,
    const float* __restrict__ w, float* __restrict__ out, int N, int L,
    int team) {
  __shared__ PlanEntry meta[SLS_THREADS];
  sls_walk<T, VEC, U>(table, D, ThroughPlan{slots, uniq, uscales, V}, owned,
                      w, out, N, L, team, meta);
}

// The launch shape the wrapper chose: threads a multiple of 32 and of the
// team, at most SLS_THREADS; inflight 4, or 8 below int8's 16-code chunks
// (sls_shape takes 16-code chunks only where it keeps 4 rows in flight).
static bool sls_shape_ok(int D, int vec, int inflight, int threads) {
  const int team = team_size(D / vec);
  return threads % 32 == 0 && threads <= SLS_THREADS && threads % team == 0
         && (inflight == 4 || (inflight == 8 && vec < 16));
}

static dim3 sls_grid(int N, int D, int vec, int threads) {
  const int per_block = threads / team_size(D / vec);
  return dim3(static_cast<unsigned>((N + per_block - 1) / per_block));
}

template <typename T, int VEC>
static void launch_sls(const void* table, int64_t V, int D, int inflight,
                       const int32_t* idx, const uint8_t* owned,
                       const float* w, const float* scales, float* out, int N,
                       int L, int threads, cudaStream_t stream) {
  const int team = team_size(D / VEC);
  const dim3 grid = sls_grid(N, D, VEC, threads);
  auto t = static_cast<const T*>(table);
  if constexpr (VEC < 16) {
    if (inflight == 8) {
      masked_sls_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(
          t, V, D, idx, owned, w, scales, out, N, L, team);
      return;
    }
  }
  masked_sls_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(
      t, V, D, idx, owned, w, scales, out, N, L, team);
}

// table: (V, D) float32 (itemsize 4) or int8 codes (itemsize 1);
// idx (N, L) int32 row ids (clamp_row); owned (N, L) bool or null (every
// entry); w (N, L) float32 or null; scales (N, L) float32, given exactly
// for an int8 table; out (N, D) float32.  vec: row elements per lane (1;
// 4, a 16-byte float32 chunk or 4 int8 codes; 16 int8 codes), inflight:
// rows in flight per lane (4, or 8 where vec < 16), threads: a multiple of
// 32 and of the team, at most SLS_THREADS -- the wrapper's choice (sls.py:
// sls_shape).
extern "C" int masked_sls(const void* table, int itemsize, int64_t V, int D,
                          int vec, int inflight, const void* idx,
                          const void* owned, const void* w,
                          const void* scales, void* out, int N, int L,
                          int threads, void* stream) {
  if (!sls_shape_ok(D, vec, inflight, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(idx);
  auto m = static_cast<const uint8_t*>(owned);
  auto wf = static_cast<const float*>(w);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
#define SLS(T, VEC) \
  launch_sls<T, VEC>(table, V, D, inflight, i, m, wf, sc, o, N, L, threads, \
                     s)
  if (itemsize == 4 && vec == 4) SLS(float, 4);
  else if (itemsize == 4 && vec == 1) SLS(float, 1);
  else if (itemsize == 1 && vec == 16) SLS(int8_t, 16);
  else if (itemsize == 1 && vec == 4) SLS(int8_t, 4);
  else if (itemsize == 1 && vec == 1) SLS(int8_t, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef SLS
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static void launch_sls_dedup(const void* table, int64_t V, int D, int inflight,
                             const int32_t* uniq, const float* uscales,
                             const int32_t* slots, const uint8_t* owned,
                             const float* w, float* out, int N, int L,
                             int threads, cudaStream_t stream) {
  const int team = team_size(D / VEC);
  const dim3 grid = sls_grid(N, D, VEC, threads);
  auto t = static_cast<const T*>(table);
  if constexpr (VEC < 16) {
    if (inflight == 8) {
      masked_sls_dedup_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(
          t, V, D, uniq, uscales, slots, owned, w, out, N, L, team);
      return;
    }
  }
  masked_sls_dedup_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(
      t, V, D, uniq, uscales, slots, owned, w, out, N, L, team);
}

// table (V, D) float32 or int8 codes (itemsize 4 / 1); uniq (U,) int32 row
// per slot (sentinel-padded); uscales (U,) float32, given exactly for an
// int8 table; slots, owned (N, L) int32 / bool; w (N, L) float32 or null;
// out (N, D) float32.  vec, inflight and threads as for masked_sls.
extern "C" int masked_sls_dedup(const void* table, int itemsize, int64_t V,
                                int D, int vec, int inflight,
                                const void* uniq, const void* uscales,
                                const void* slots, const void* owned,
                                const void* w, void* out, int N, int L,
                                int threads, void* stream) {
  if (!sls_shape_ok(D, vec, inflight, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto uq = static_cast<const int32_t*>(uniq);
  auto us = static_cast<const float*>(uscales);
  auto sl = static_cast<const int32_t*>(slots);
  auto m = static_cast<const uint8_t*>(owned);
  auto wf = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
#define SLS_DEDUP(T, VEC)                                                   \
  launch_sls_dedup<T, VEC>(table, V, D, inflight, uq, us, sl, m, wf, o, N, L, \
                           threads, s)
  if (itemsize == 4 && vec == 4) SLS_DEDUP(float, 4);
  else if (itemsize == 4 && vec == 1) SLS_DEDUP(float, 1);
  else if (itemsize == 1 && vec == 16) SLS_DEDUP(int8_t, 16);
  else if (itemsize == 1 && vec == 4) SLS_DEDUP(int8_t, 4);
  else if (itemsize == 1 && vec == 1) SLS_DEDUP(int8_t, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef SLS_DEDUP
  return static_cast<int>(cudaGetLastError());
}
