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
//
// ragged_sls replaces no Pallas kernel: the reference pools bags of one
// length L.  It pools T tables whose bags differ in length (MLPerf
// DLRM-DCNv2: 1 to 100 ids) from one (N, C) batch, table t's bag in the
// columns [c_t, c_{t+1}) of the T + 1 edges, into (N, T, D) in one launch:
// out[n, t] = sum over l in [c_t, c_{t+1}) of f[n,l] * row[n,l], in that
// order, with masked_sls's operands, fmaf order and row rule, so it equals
// the plain version (ref.ragged_sls_ref) bit for bit.  Bound as
// masked_sls.  Balance: a team walks k_t = max(1, team / L_t) bags of one
// table as one stream of entries (a run of metadata may span bags; the
// sum is stored at each bag's end), so a run of single-id bags fills the
// team as a long bag does; the grid takes the tables longest bags first,
// so the long walks start first and the short ones fill the tail.
// Element offsets are 64-bit.
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

// ------------------------------------------------------------------ ragged
constexpr int RAGGED_MAX_TABLES = 128;

// The launch's work list, passed by value: the tables in the order of
// their blocks (longest bags first), the bags each team of a table walks,
// each table's first block and the column edges c_t.
struct RaggedPlan {
  int n_tables;
  int table[RAGGED_MAX_TABLES];          // group g -> table t
  int bags[RAGGED_MAX_TABLES];           // group g: bags per team, k_t
  int block0[RAGGED_MAX_TABLES + 1];     // group g's first block; the end
  int64_t edge[RAGGED_MAX_TABLES + 1];   // column edges c_0 .. c_T
};

// A team walks bags [first, first + nb) of table t as one stream of
// entries s = q * L + l (bag q, entry l), a run of `team` entries at a
// time: the run's kept entries land in tm in stream order with their bag
// in tq; each bag's sum is stored when the stream passes its end (a bag
// with no kept entry stores zeros).
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(SLS_THREADS) ragged_sls_kernel(
    const T* __restrict__ table, int64_t V, int D,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ owned,
    const float* __restrict__ w, const float* __restrict__ scales,
    float* __restrict__ out, int N, int64_t C, int team,
    const RaggedPlan plan) {
  constexpr bool kScaled = sizeof(T) == 1;   // int8 rows
  __shared__ PlanEntry meta[SLS_THREADS];
  __shared__ int bag_of[SLS_THREADS];
  int g = 0;                                 // the last group that starts
  int hi = plan.n_tables - 1;                // at or before this block
  while (g < hi) {
    const int mid = (g + hi + 1) / 2;
    if (plan.block0[mid] <= static_cast<int>(blockIdx.x)) g = mid;
    else hi = mid - 1;
  }
  const int t = plan.table[g];
  const int64_t c0 = plan.edge[t];
  const int L = static_cast<int>(plan.edge[t + 1] - c0);
  const int k = plan.bags[g];
  const int lane = threadIdx.x % team;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x - plan.block0[g]) *
           (blockDim.x / team) + threadIdx.x / team) * k;
  const int nb = static_cast<int>(
      first < N ? (N - first < k ? N - first : k) : 0);
  const int n = nb * L;                      // this team's entries
  const int stream_end = k * L;              // the same for the whole block
  const int chunks = D / VEC;
  PlanEntry* tm = meta + (threadIdx.x - lane);
  int* tq = bag_of + (threadIdx.x - lane);
  const int64_t bag_stride = static_cast<int64_t>(plan.n_tables) * D;
  float* dst = out + first * bag_stride + static_cast<int64_t>(t) * D;
  for (int cg = 0; cg < chunks; cg += team) {
    const int c = cg + lane;
    const bool active = nb > 0 && c < chunks;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    int cur = 0;                             // the bag acc holds
    for (int s0 = 0; s0 < stream_end; s0 += team) {
      const int s = s0 + lane;
      const bool mine = s < n;
      const int q = mine ? s / L : 0;
      const int64_t e = (first + q) * C + c0 + (s - q * L);
      __syncwarp();
      PlanEntry p;
      const bool keep = plan_load<kScaled>(
          mine, e, mine ? entry_factor(true, w, e) : 0.0f, owned,
          PerEntry{idx, scales, V}, D, &p);
      int pos;
      const int m = team_compact(keep, lane, team, &pos);
      if (keep) {
        tm[pos] = p;
        tq[pos] = q;
      }
      __syncwarp();
      if (!active) continue;
      for (int j0 = 0; j0 < m; j0 += U) {
        RowChunk<T, VEC> r[U];
        gather_kept<T, VEC, U>(table, tm, j0, m, c, r);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u < m) {
            for (const int qb = tq[j0 + u]; cur < qb; ++cur) {
              store_row<VEC>(dst + cur * bag_stride + c * VEC, acc);
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
            }
            float v[VEC];
            r[u].to_float(v);
            accumulate<VEC>(acc, tm[j0 + u].f, v,
                            kScaled ? &tm[j0 + u].scale : nullptr);
          }
        }
      }
    }
    if (!active) continue;
    for (; cur < nb; ++cur) {
      store_row<VEC>(dst + cur * bag_stride + c * VEC, acc);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    }
  }
}

// The work list for N items of T tables (edges c_0..c_T, host memory) and
// blocks of `teams` teams of `team` threads; returns the blocks, or -1 on
// edges that do not rise from 0, or too many tables or blocks.
static int64_t ragged_plan(const int64_t* edges, int T, int N, int teams,
                           int team, RaggedPlan* plan) {
  if (T < 1 || T > RAGGED_MAX_TABLES || edges[0] != 0) return -1;
  plan->n_tables = T;
  for (int t = 0; t <= T; ++t) {
    if (t > 0 && edges[t] < edges[t - 1]) return -1;
    plan->edge[t] = edges[t];
  }
  for (int g = 0; g < T; ++g) {              // insertion sort, stable:
    plan->table[g] = g;                      // longest bags first
    for (int h = g; h > 0; --h) {
      const int a = plan->table[h - 1], b = plan->table[h];
      if (edges[b + 1] - edges[b] <= edges[a + 1] - edges[a]) break;
      plan->table[h - 1] = b;
      plan->table[h] = a;
    }
  }
  int64_t blocks = 0;
  for (int g = 0; g < T; ++g) {
    const int t = plan->table[g];
    const int64_t L = edges[t + 1] - edges[t];
    const int k = L >= team ? 1 : (L > 0 ? static_cast<int>(team / L) : team);
    const int64_t per = static_cast<int64_t>(teams) * k;
    plan->bags[g] = k;
    plan->block0[g] = static_cast<int>(blocks);
    blocks += (N + per - 1) / per;
    if (blocks > 0x7fffffff) return -1;
  }
  plan->block0[T] = static_cast<int>(blocks);
  return blocks;
}

template <typename T, int VEC>
static void launch_ragged(const void* table, int64_t V, int D, int inflight,
                          const int32_t* idx, const uint8_t* owned,
                          const float* w, const float* scales, float* out,
                          int N, int64_t C, int threads, int64_t blocks,
                          const RaggedPlan& plan, cudaStream_t stream) {
  const int team = team_size(D / VEC);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto t = static_cast<const T*>(table);
  if constexpr (VEC < 16) {
    if (inflight == 8) {
      ragged_sls_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(
          t, V, D, idx, owned, w, scales, out, N, C, team, plan);
      return;
    }
  }
  ragged_sls_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(
      t, V, D, idx, owned, w, scales, out, N, C, team, plan);
}

// table (V, D) float32 or int8 codes (itemsize 4 / 1); idx (N, C) int32
// row ids (clamp_row); owned (N, C) bool or null (every entry); w (N, C)
// float32 or null; scales (N, C) float32, given exactly for an int8 table;
// out (N, T, D) float32; edges: the T + 1 column edges, in host memory,
// c_0 = 0 and c_T = C.  vec, inflight and threads as for masked_sls.
extern "C" int ragged_sls(const void* table, int itemsize, int64_t V, int D,
                          int vec, int inflight, const void* idx,
                          const void* owned, const void* w,
                          const void* scales, void* out, int N, int T,
                          const int64_t* edges, int threads, void* stream) {
  if (!sls_shape_ok(D, vec, inflight, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  RaggedPlan plan;
  const int team = team_size(D / vec);
  const int64_t blocks = ragged_plan(edges, T, N, threads / team, team,
                                     &plan);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const int64_t C = edges[T];
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(idx);
  auto m = static_cast<const uint8_t*>(owned);
  auto wf = static_cast<const float*>(w);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
#define RAGGED(T_, VEC)                                                     \
  launch_ragged<T_, VEC>(table, V, D, inflight, i, m, wf, sc, o, N, C,      \
                         threads, blocks, plan, s)
  if (itemsize == 4 && vec == 4) RAGGED(float, 4);
  else if (itemsize == 4 && vec == 1) RAGGED(float, 1);
  else if (itemsize == 1 && vec == 16) RAGGED(int8_t, 16);
  else if (itemsize == 1 && vec == 4) RAGGED(int8_t, 4);
  else if (itemsize == 1 && vec == 1) RAGGED(int8_t, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef RAGGED
  return static_cast<int>(cudaGetLastError());
}
