// The walk of a team of threads over its bags' entries, shared by the
// per-entry kernels masked_sls (masked_sls.cu) and fused_front_end
// (fused_front_end.cu) and their gather-once variants masked_sls_dedup and
// fused_front_end_dedup.  They differ only in where entry e's row and
// scale come from (the row source):
//   PerEntry     row clamp_row(idx[e], V), scale scales[e];
//   ThroughPlan  row clamp_row(unique_rows[slots[e]], V), scale
//                unique_scales[slots[e]] -- the gather-once kernels.
// (clamp_row, common.cuh: any id reads a row of the table, as in the plain
// versions.)
// On the TPU the gather-once kernels first copy each unique row into VMEM
// and then accumulate from there.  On Hopper the 50 MB L2 already plays
// that part: duplicates of a row share one slot of the plan, hence one
// address, and every gather after the first hits in L2.  So these kernels
// keep the plan and drop the staging: the accumulate sees the operands of
// the per-entry kernels, in the same order: one launch, no float32
// staging round trip through device memory.
//
// A team of threads walks one bag (a lane per 16-byte chunk of D), taking
// its entries in runs of `team`: in one round trip lane j reads entry j's
// mask, weight, row and scale (through the plan: its slot, then the
// slot's row and scale); the team keeps the owned entries, compacted in l
// order, in shared memory (plan_load, plan_keep); then every lane gathers
// its chunk of the rows of several kept entries at a time (gather_kept)
// and accumulates them in l order (add_kept).  A non-owned entry is
// skipped where the plain versions (and the JAX reference) add
// fmaf(+-0, v, acc) -- f = owned * w = +-0 times row 0, or the plan's
// sentinel row: on finite rows the two agree (f * v is +-0 and
// acc + +-0 == acc; an accumulator that starts at +0 turns to -0 only by
// underflow, which == comparisons treat as +0), so the result equals the
// plain version's bit for bit.  On a non-finite row under a masked entry
// the plain versions give NaN (0 * inf) and the kernels do not read it.
#pragma once
#include "common.cuh"

// A lane's chunk of one row, loaded now and read as floats later
// (to_float): a lane keeps several rows in flight.  Loaded as load_row
// loads it, as floats -- except int8's 16-code chunk, which stays raw (one
// int4, a quarter of the registers of its floats) until it is read.
template <typename T, int VEC>
struct RowChunk {
  float q[VEC];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    load_row<T, VEC>(p, q);
  }
  __device__ __forceinline__ void to_float(float* v) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = q[k];
  }
};

template <>
struct RowChunk<int8_t, 16> {
  int4 q;
  __device__ __forceinline__ void load(const int8_t* __restrict__ p) {
    q = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ void to_float(float* v) const {
    const int8_t* b = reinterpret_cast<const int8_t*>(&q);
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = static_cast<float>(b[k]);
  }
};

// A kept entry of a team's current run: the element offset of its row, its
// factor f = owned * w (= w: only owned entries are kept) and its dequant
// scale (1 where the table is float32).
struct __align__(16) PlanEntry {
  int64_t off;
  float f;
  float scale;
};

// The team's lanes whose `keep` is set, in lane order: returns how many and
// sets *pos to the number of kept lanes before this one.  Every lane of the
// warp calls it (a team lies inside one warp, blocks are whole warps and
// every loop around a call has the same trip count for the whole warp).
__device__ __forceinline__ int team_compact(bool keep, int lane, int team,
                                            int* pos) {
  const unsigned ball = __ballot_sync(0xffffffffu, keep);
  const unsigned mine =
      team == 32 ? ball
                 : (ball >> ((threadIdx.x & 31) - lane)) & ((1u << team) - 1u);
  *pos = __popc(mine & ((1u << lane) - 1u));
  return __popc(mine);
}

// Row sources: entry e's row of the table and its dequant scale.  SCALED:
// an int8 table, whose rows carry a scale (1 otherwise).
struct PerEntry {
  const int32_t* idx;      // (N, L) row ids
  const float* scales;     // (N, L), given when SCALED
  int64_t V;               // table rows: clamp_row's range
  template <bool SCALED>
  __device__ __forceinline__ int64_t row(int64_t e, float* scale) const {
    *scale = SCALED ? __ldg(scales + e) : 1.0f;
    return clamp_row(__ldg(idx + e), V);
  }
};

struct ThroughPlan {
  const int32_t* slots;    // (N, L) slot per entry
  const int32_t* uniq;     // row per slot, sentinel-padded
  const float* uscales;    // scale per slot, given when SCALED
  int64_t V;               // table rows: clamp_row's range
  template <bool SCALED>
  __device__ __forceinline__ int64_t row(int64_t e, float* scale) const {
    const int32_t u = __ldg(slots + e);
    *scale = SCALED ? __ldg(uscales + u) : 1.0f;
    return clamp_row(__ldg(uniq + u), V);
  }
};

// One run of one tier, in two steps so that a caller with two tiers has
// both tiers' loads in flight before either ballot.  plan_load: lane j
// (mine: j < the run's length, on a valid bag) reads entry e's mask (none:
// every entry kept) and its row and scale from the source into *p;
// returns whether the entry is kept.  plan_keep: the kept entries land in
// tm[0, m) in l order; returns m.  f is the entry's factor w (or 1).
template <bool SCALED, class Src>
__device__ __forceinline__ bool plan_load(bool mine, int64_t e, float f,
                                          const uint8_t* __restrict__ mask,
                                          const Src& src, int D,
                                          PlanEntry* p) {
  bool keep = false;
  if (mine) {
    keep = mask == nullptr || __ldg(mask + e) != 0;
    p->off = src.template row<SCALED>(e, &p->scale) * D;
    p->f = f;
  }
  return keep;
}

__device__ __forceinline__ int plan_keep(bool keep, const PlanEntry& p,
                                         int lane, int team, PlanEntry* tm) {
  int pos;
  const int m = team_compact(keep, lane, team, &pos);
  if (keep) tm[pos] = p;
  return m;
}

// Kept entries [j0, j0 + U) of tm (those below m): gather_kept loads their
// rows' chunk c, all in flight (RowChunk: int8's 16-code chunks stay
// raw); add_kept then reads and adds them in l order.  A caller with two
// tiers gathers both before it adds either.
template <typename T, int VEC, int U>
__device__ __forceinline__ void gather_kept(const T* __restrict__ table,
                                            const PlanEntry* tm, int j0,
                                            int m, int c,
                                            RowChunk<T, VEC>* r) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (j0 + u < m) r[u].load(table + tm[j0 + u].off + c * VEC);
}

template <typename T, int VEC, int U, bool SCALED>
__device__ __forceinline__ void add_kept(const PlanEntry* tm, int j0, int m,
                                         const RowChunk<T, VEC>* r,
                                         float* acc) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (j0 + u < m) {
      float v[VEC];
      r[u].to_float(v);
      accumulate<VEC>(acc, tm[j0 + u].f, v,
                      SCALED ? &tm[j0 + u].scale : nullptr);
    }
  }
}
