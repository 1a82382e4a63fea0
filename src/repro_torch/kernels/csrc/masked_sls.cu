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
// masked_sls_dedup (below) replaces src/repro/kernels/sls.py:254
// masked_sls_dedup_pallas (its pallas_call at :304), a kernel of its own
// (masked_sls_dedup_kernel): one launch that reads each entry's row through
// the dedup plan, row = table[unique_rows[slots[e]]] (int8: times the
// slot's scale), with no staging buffer (gather_once.cuh).  Bound: bytes,
// each distinct row once (duplicates share a slot's address and hit in
// L2); in practice latency, the chain metadata -> slot's row id -> row that
// each bag walks.  Design: a team per bag takes its entries in runs, one
// round trip of metadata per run into shared memory, the owned entries
// compacted in l order, then U rows in flight per lane (8 below 16 bags
// per SM, where each bag's chain is the time, else 4, which leaves the
// registers for more warps); blocks of at most 64 threads, so that batch
// 32 (256 bags) spreads over the SMs; int8 in 4- or 16-code chunks
// (pool_vec).  The launch shape is the wrapper's (sls.py:
// sls_dedup_shape).
// Same operands, same fmaf order: bitwise equal to masked_sls for every
// weight on finite rows.
#include "common.cuh"
#include "gather_once.cuh"

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
      float v[VEC];
      const int64_t r = own ? static_cast<int64_t>(__ldg(idx + e)) : 0;
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

constexpr int SLS_DEDUP_THREADS = 64;   // masked_sls_dedup block, at most

// The gather-once SLS: one team of threads per bag (bag = block * (threads
// / team) + thread / team), reading each owned entry's row through its
// slot, U rows in flight; see gather_once.cuh.
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(SLS_DEDUP_THREADS) masked_sls_dedup_kernel(
    const T* __restrict__ table, int64_t V, int D,
    const int32_t* __restrict__ uniq, const float* __restrict__ uscales,
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ owned,
    const float* __restrict__ w, float* __restrict__ out, int N, int L,
    int team) {
  __shared__ PlanEntry meta[SLS_DEDUP_THREADS];
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
          mine, e, mine ? entry_factor(true, true, w, e) : 0.0f, owned,
          slots, uniq, uscales, V, D, &p);
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

template <typename T, int VEC>
static void launch_sls_dedup(const void* table, int64_t V, int D, int inflight,
                             const int32_t* uniq, const float* uscales,
                             const int32_t* slots, const uint8_t* owned,
                             const float* w, float* out, int N, int L,
                             int threads, int team, cudaStream_t stream) {
  const int per_block = threads / team;
  const dim3 grid(static_cast<unsigned>((N + per_block - 1) / per_block));
  auto t = static_cast<const T*>(table);
  if (inflight == 8)
    masked_sls_dedup_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(
        t, V, D, uniq, uscales, slots, owned, w, out, N, L, team);
  else
    masked_sls_dedup_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(
        t, V, D, uniq, uscales, slots, owned, w, out, N, L, team);
}

// table (V, D) float32 or int8 codes (itemsize 4 / 1); uniq (U,) int32 row
// per slot (sentinel-padded); uscales (U,) float32, given exactly for an
// int8 table; slots, owned (N, L) int32 / bool; w (N, L) float32 or null;
// out (N, D) float32.  vec: row elements per lane (1; 4, a 16-byte float32
// chunk or 4 int8 codes; 16 int8 codes), inflight: rows in flight per lane
// (4 or 8), threads: a multiple of 32 and of the team, at most
// SLS_DEDUP_THREADS -- the wrapper's choice (sls.py: sls_dedup_shape).
extern "C" int masked_sls_dedup(const void* table, int itemsize, int64_t V,
                                int D, int vec, int inflight,
                                const void* uniq, const void* uscales,
                                const void* slots, const void* owned,
                                const void* w, void* out, int N, int L,
                                int threads, void* stream) {
  const int team = team_size(D / vec);
  if (threads % 32 != 0 || threads > SLS_DEDUP_THREADS || threads % team ||
      (inflight != 4 && inflight != 8))
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
                           threads, team, s)
  if (itemsize == 4 && vec == 4) SLS_DEDUP(float, 4);
  else if (itemsize == 4 && vec == 1) SLS_DEDUP(float, 1);
  else if (itemsize == 1 && vec == 16) SLS_DEDUP(int8_t, 16);
  else if (itemsize == 1 && vec == 4) SLS_DEDUP(int8_t, 4);
  else if (itemsize == 1 && vec == 1) SLS_DEDUP(int8_t, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef SLS_DEDUP
  return static_cast<int>(cudaGetLastError());
}
