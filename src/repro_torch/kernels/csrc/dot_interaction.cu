// DLRM pairwise-dot interaction with the triangle pack fused in, and the
// resume of the partial-pool path: one kernel template serves both.
//
// dot_interaction replaces the Pallas TPU kernel
// src/repro/kernels/interaction.py: dot_interaction_pallas.  out[b] =
// packed lower triangle of X_b X_b^T for X_b = feats[b] (F x D), strict or
// with the diagonal (self_inter); the (B, F, F) product never reaches
// memory.
//
// fused_resume replaces src/repro/kernels/sls.py: fused_resume_pallas: the
// interaction on the partial-pool tiles (fused_front_end.cu,
// partial_pool_kernel).  Its tile is ((c_0 + c_1) + ...) + h, one rounded
// add per term: the S shards' cold tiles in shard order (the one-card
// stand-in of the psum over the tp axis), then the hot tile, the split
// path's operand order.  dot_interaction is the same kernel with no cold
// terms: its tile is feats itself.
//
// Every dot is z = fmaf(x_i[d], x_j[d], z) for d = 0..D-1 from z = 0,
// interact_tile's arithmetic (interaction.cuh, shared with
// fused_front_end.cu), so fused == split and partial pool -> resume ==
// split bit for bit at any shard count.
//
// Bound: bytes.  (S + 1) tiles of B*F*D floats in (one for
// dot_interaction), B*P out, 2*D flops per output: about 2 flops per byte
// at F = 9, far below the card's float32 balance.  Design, sized to the
// bytes and not to the pairs:
// - a block of 128 or 256 threads (the wrapper's tile_shape) owns NS
//   samples, whose tiles are each one contiguous run of NS*F*D floats;
// - the run reaches shared memory at a row stride of lds = 4 * (the least
//   odd number > D / 4) floats: rows stay 16-byte aligned, and since
//   lds / 4 is odd, the 8 rows a quarter-warp's float4 reads touch at one d
//   fall in 8 distinct 4-bank groups unless two of them are equal mod 8;
// - both read their runs as float4 through registers, U elements per
//   thread at a time with all their loads in flight before the first add
//   or store: the resume U = 2 of S + 1 terms each, S a template parameter
//   (1, 2, 4, 8; a loop in groups of 8 for any other S), dot_interaction
//   (no cold terms) U = 4;
// - any D that is not a multiple of 4, or a tile that is not 16-byte
//   aligned, takes a scalar path in the same kernel (interact_tile);
// - each thread then reduces whole dots: one pair per thread in the
//   resume and at one sample per block, else K = 4 pairs (i, j..j+3) of
//   one row, reading x_i once per 4 d for all four chains: shared-memory
//   reads, not the loads, bound the dot phase.
// No tensor cores: Hopper's take float32 only as TF32, which the numerics
// contract (TF32 off) and the bitwise fused == split gate rule out.
#include "interaction.cuh"

template <int VEC>
struct VecT;
template <>
struct VecT<4> {
  using type = float4;
};
template <>
struct VecT<1> {
  using type = float;
};

__device__ __forceinline__ float4 ldg_v(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_v(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// The SC + 1 terms of element e: t[0..SC-1] the cold tiles in shard order,
// t[SC] the hot tile (the only one when SC == 0).
template <int SC, typename V>
__device__ __forceinline__ void load_terms(const V* __restrict__ c,
                                           const V* __restrict__ h,
                                           int64_t shard, int64_t e, V* t) {
#pragma unroll
  for (int s = 0; s < SC; ++s) t[s] = ldg_v(c + s * shard + e);
  t[SC] = ldg_v(h + e);
}

template <int SC, typename V>
__device__ __forceinline__ V sum_terms(const V* t) {
  if constexpr (SC == 0) {
    return t[0];
  } else {
    V v = t[0];
#pragma unroll
    for (int s = 1; s < SC; ++s) v = add_rn(v, t[s]);
    return add_rn(v, t[SC]);
  }
}

// Any other S: the cold terms in groups of up to 8 loads in flight.
template <typename V>
__device__ __forceinline__ V tile_sum_any(const V* __restrict__ c,
                                          const V* __restrict__ h,
                                          int64_t shard, int S, int64_t e) {
  V v = ldg_v(c + e);
  const V hv = ldg_v(h + e);
  for (int s0 = 1; s0 < S; s0 += 8) {
    V t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (s0 + k < S) t[k] = ldg_v(c + (s0 + k) * shard + e);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (s0 + k < S) v = add_rn(v, t[k]);
  }
  return add_rn(v, hv);
}

// Stage the block's tile, n elements of VEC floats (rv to a row), summed
// over its terms, into shared memory at row stride lds.  SC >= 0: the
// shard count (0: no cold terms); SC < 0: S at run time.  Each thread
// takes U elements a blockDim apart per round, all loads before the adds.
template <int SC, int VEC, int U>
__device__ __forceinline__ void stage_tile(const float* __restrict__ part_c,
                                           const float* __restrict__ part_h,
                                           int64_t shard, int S, int n,
                                           int rv, int lds, float* tile) {
  using V = typename VecT<VEC>::type;
  const V* c = reinterpret_cast<const V*>(part_c);
  const V* h = reinterpret_cast<const V*>(part_h);
  const int step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * step) {
    V v[U];
    if constexpr (SC >= 0) {
      V t[U][SC + 1];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e0 + u * step < n) load_terms<SC>(c, h, shard, e0 + u * step,
                                              t[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e0 + u * step < n) v[u] = sum_terms<SC>(t[u]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e0 + u * step < n) v[u] = tile_sum_any(c, h, shard, S,
                                                   e0 + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * step;
      if (e < n) {
        const int row = e / rv;
        *reinterpret_cast<V*>(tile + row * lds + (e - row * rv) * VEC) =
            v[u];
      }
    }
  }
}

// Items of one sample's triangle: row i (from 1, or 0 with the diagonal)
// holds len_i = i + self_inter pairs, cut into ceil(len_i / K) items of
// up to K consecutive j.
__host__ __device__ __forceinline__ int tri_items(int F, int self_inter,
                                                  int K) {
  int q = 0;
  for (int i = self_inter ? 0 : 1; i < F; ++i)
    q += (i + self_inter + K - 1) / K;
  return q;
}

// The dots of interact_tile on float4 rows: item w = (sample s, row i,
// first column j0) computes the cnt <= K dots (i, j0..j0+cnt-1), reading
// x_i once per 4 d for all of them; each chain is the fmaf sequence over
// d = 0..D-1 from 0.  Q = tri_items(F, self_inter, K).
template <int K>
__device__ __forceinline__ void interact_tile_vec4(const float* tile,
                                                   int n_samples, int F,
                                                   int D, int lds, int P,
                                                   int self_inter, int Q,
                                                   float* __restrict__ out) {
  const int D4 = D / 4;
  const int lds4 = lds / 4;
  for (int w = threadIdx.x; w < n_samples * Q; w += blockDim.x) {
    const int s = w / Q;
    int q = w - s * Q;
    int i = self_inter ? 0 : 1;
    int off = 0;              // packed index of (i, 0)
    for (;;) {
      const int g = (i + self_inter + K - 1) / K;
      if (q < g) break;
      q -= g;
      off += i + self_inter;
      ++i;
    }
    const int j0 = q * K;
    const int cnt = min(K, i + self_inter - j0);
    const float4* xi =
        reinterpret_cast<const float4*>(tile + (s * F + i) * lds);
    const float4* xj =
        reinterpret_cast<const float4*>(tile + (s * F + j0) * lds);
    float z[K];
#pragma unroll
    for (int k = 0; k < K; ++k) z[k] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D4; ++d) {
      const float4 a = xi[d];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < cnt) {
          const float4 b = xj[k * lds4 + d];
          z[k] = __fmaf_rn(a.x, b.x, z[k]);
          z[k] = __fmaf_rn(a.y, b.y, z[k]);
          z[k] = __fmaf_rn(a.z, b.z, z[k]);
          z[k] = __fmaf_rn(a.w, b.w, z[k]);
        }
      }
    }
    float* o = out + s * P + off + j0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < cnt) o[k] = z[k];
  }
}

// SC: the shard count S when it is 1, 2, 4 or 8, 0 for no cold terms
// (dot_interaction), -1 for S at run time.  VEC: 4 (float4; D % 4 == 0,
// 16-byte aligned tiles) or 1 (scalar).  U: elements per thread in flight.
// K: pairs per item in the dot phase (VEC == 4).
template <int SC, int VEC, int U, int K>
__global__ void tile_interaction_kernel(const float* __restrict__ part_c,
                                        const float* __restrict__ part_h,
                                        float* __restrict__ out, int B, int F,
                                        int D, int P, int S, int NS, int lds,
                                        int self_inter, int Q) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * NS;
  const int ns = static_cast<int>(min(static_cast<int64_t>(NS), B - b0));
  const int64_t run = b0 * F * D;     // floats before this block's run
  const int64_t shard = static_cast<int64_t>(B) * F * D / VEC;
  stage_tile<SC, VEC, U>(SC == 0 ? nullptr : part_c + run, part_h + run,
                         shard, S, ns * F * D / VEC, D / VEC, lds, tile);
  __syncthreads();
  if constexpr (VEC == 4) {
    interact_tile_vec4<K>(tile, ns, F, D, lds, P, self_inter, Q,
                          out + b0 * P);
  } else {
    interact_tile(tile, ns, F, D, lds, P, self_inter, out + b0 * P);
  }
}

template <int SC, int VEC, int U, int K>
static int launch_tile(const float* part_c, const float* part_h, float* out,
                       int B, int F, int D, int P, int S, int NS,
                       int threads, int lds, int self_inter,
                       cudaStream_t stream) {
  auto kernel = tile_interaction_kernel<SC, VEC, U, K>;
  const size_t smem = static_cast<size_t>(NS) * F * lds * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + NS - 1) / NS;
  const int Q = VEC == 4 ? tri_items(F, self_inter, K) : P;
  if (blocks > 0) {
    kernel<<<blocks, threads, smem, stream>>>(part_c, part_h, out, B, F, D, P,
                                              S, NS, lds, self_inter, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

static bool bad_shape(int D, int NS, int threads, int lds, int vec4) {
  return NS < 1 || threads < 32 || threads % 32 != 0 || lds < D ||
         (vec4 && (D % 4 != 0 || lds % 4 != 0));
}

// feats (B, F, D) float32 -> out (B, P) float32, P = F(F-1)/2, or
// F(F+1)/2 with self_inter.  The wrapper's tile_shape picks NS samples
// per block, `threads` (a multiple of 32) and the shared row stride lds,
// and dot_pairs the pairs per item (1 or 4); 4 elements per thread in
// flight.  vec4: float4 (D % 4 == 0, a 16-byte aligned feats, lds % 4 ==
// 0); else scalar (any D, any alignment).  Shared memory NS*F*lds*4 bytes.
extern "C" int dot_interaction(const void* feats, void* out, int B, int F,
                               int D, int P, int self_inter, int NS,
                               int threads, int lds, int pairs, int vec4,
                               void* stream) {
  if (bad_shape(D, NS, threads, lds, vec4) || (pairs != 1 && pairs != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = static_cast<const float*>(feats);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (!vec4)
    return launch_tile<0, 1, 4, 1>(nullptr, f, o, B, F, D, P, 0, NS, threads,
                                   lds, self_inter, st);
  return pairs == 4 ? launch_tile<0, 4, 4, 4>(nullptr, f, o, B, F, D, P, 0,
                                              NS, threads, lds, self_inter,
                                              st)
                    : launch_tile<0, 4, 4, 1>(nullptr, f, o, B, F, D, P, 0,
                                              NS, threads, lds, self_inter,
                                              st);
}

template <int VEC>
static int launch_resume_s(const float* part_c, const float* part_h,
                           float* out, int B, int F, int D, int P, int S,
                           int NS, int threads, int lds,
                           cudaStream_t stream) {
  switch (S) {
    case 1:
      return launch_tile<1, VEC, 2, 1>(part_c, part_h, out, B, F, D, P, S,
                                       NS, threads, lds, 0, stream);
    case 2:
      return launch_tile<2, VEC, 2, 1>(part_c, part_h, out, B, F, D, P, S,
                                       NS, threads, lds, 0, stream);
    case 4:
      return launch_tile<4, VEC, 2, 1>(part_c, part_h, out, B, F, D, P, S,
                                       NS, threads, lds, 0, stream);
    case 8:
      return launch_tile<8, VEC, 2, 1>(part_c, part_h, out, B, F, D, P, S,
                                       NS, threads, lds, 0, stream);
    default:
      return launch_tile<-1, VEC, 2, 1>(part_c, part_h, out, B, F, D, P, S,
                                        NS, threads, lds, 0, stream);
  }
}

// part_c (S, B, F, D), part_h (B, F, D) float32 -> out (B, P) float32,
// P = F(F-1)/2.  The wrapper's tile_shape picks NS samples per block,
// `threads` (a multiple of 32) and the shared row stride lds >= D; vec4:
// D % 4 == 0 and both tiles 16-byte aligned, with lds % 4 == 0.  Shared
// memory NS*F*lds*4 bytes.
extern "C" int fused_resume(const void* part_c, const void* part_h,
                            void* out, int B, int F, int D, int P, int S,
                            int NS, int threads, int lds, int vec4,
                            void* stream) {
  if (S < 1 || bad_shape(D, NS, threads, lds, vec4))
    return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const float*>(part_c);
  auto h = static_cast<const float*>(part_h);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return vec4 ? launch_resume_s<4>(c, h, o, B, F, D, P, S, NS, threads, lds,
                                   st)
              : launch_resume_s<1>(c, h, o, B, F, D, P, S, NS, threads, lds,
                                   st);
}
