// DLRM pairwise-dot interaction with the triangle pack fused in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/interaction.py:
// dot_interaction_pallas.  out[b] = packed lower triangle of X_b X_b^T for
// X_b = feats[b] (F x D); the (B, F, F) product never reaches memory.
//
// Bound: bytes.  It reads B*F*D floats and writes B*P, and does 2*D flops
// per output: about P*D/(2*F*D) ~ 2 flops per byte at F = 9, far below
// the card's float32 balance.  Design: a block stages S samples' (F, D)
// tiles in shared memory (row stride D + 1 against bank conflicts) with
// coalesced loads; each thread then reduces whole (sample, pair) dots over
// d in a fixed order (interact_tile, shared with fused_front_end.cu).
//
// fused_resume (below) replaces src/repro/kernels/sls.py:
// fused_resume_pallas: the interaction on the partial-pool tiles
// (fused_front_end.cu, partial_pool_kernel).  Its tile is
// ((c_0 + c_1) + ...) + h, one rounded add per term: the S shards' cold
// tiles in shard order (the one-card stand-in of the psum over the tp
// axis), then the hot tile, the split path's operand order; each dot is
// z = fmaf(x_i[d], x_j[d], z) for d = 0..D-1 from z = 0, interact_tile's
// arithmetic.  So partial pool -> resume equals split bit for bit at any
// shard count.
//
// Bound: bytes (S + 1 tiles in, B * P out; 5 tiles of 4.6 KB per sample at
// RMC4 and 4 shards).  Design, sized to the bytes and not to the pairs:
// - a block of 128 or 256 threads (the wrapper's resume_shape) owns NS
//   samples, whose S + 1 tiles are each one contiguous run of NS*F*D
//   floats;
// - each thread reads those runs as float4 (any D that is not a multiple
//   of 4 takes a scalar path in the same kernel), two elements at a time,
//   and S is a template parameter (1, 2, 4, 8; a loop in groups of 8 for
//   any other S), so all 2 (S + 1) loads are in flight before the first
//   add;
// - the summed tile goes to shared memory as float4 stores at a row
//   stride of lds = 4 * (the least odd number > D / 4) floats: rows stay
//   16-byte aligned, and since lds / 4 is odd, the 8 rows a quarter-warp's
//   float4 reads touch at one d fall in 8 distinct 4-bank groups unless two
//   of them are equal mod 8 (rows 0 and 8 of a sample at F = 9: 2-way);
// - each thread then reduces whole (sample, pair) dots striding over
//   NS * P, reading x_i and x_j as float4 from shared memory.
// No tensor cores: Hopper's take float32 only as TF32, which the numerics
// contract (TF32 off) and the bitwise fused == split gate rule out.
#include "interaction.cuh"

__global__ void dot_interaction_kernel(const float* __restrict__ feats,
                                       float* __restrict__ out, int B, int F,
                                       int D, int P, int self_inter, int S) {
  extern __shared__ float tile[];
  const int lds = D + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * S;
  const int ns = static_cast<int>(min(static_cast<int64_t>(S), B - b0));
  const float* src = feats + b0 * F * D;
  for (int e = threadIdx.x; e < ns * F * D; e += blockDim.x) {
    const int row = e / D;
    tile[row * lds + (e - row * D)] = __ldg(src + e);
  }
  __syncthreads();
  interact_tile(tile, ns, F, D, lds, P, self_inter, out + b0 * P);
}

// feats (B, F, D) float32 -> out (B, P) float32.  S samples per block;
// shared memory S*F*(D+1)*4 bytes (the caller keeps it <= 227 KB).
extern "C" int dot_interaction(const void* feats, void* out, int B, int F,
                               int D, int P, int self_inter, int S,
                               void* stream) {
  const size_t smem = static_cast<size_t>(S) * F * (D + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dot_interaction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = S * P < 256 ? ((S * P + 31) / 32) * 32 : 256;
  const int blocks = (B + S - 1) / S;
  if (blocks > 0) {
    dot_interaction_kernel<<<blocks, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<float*>(out), B, F, D,
        P, self_inter, S);
  }
  return static_cast<int>(cudaGetLastError());
}

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

// The S + 1 terms of element e: t[0..S-1] the cold tiles in shard order,
// t[S] the hot tile.  SC > 0: all loads issue before the caller adds.
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
  V v = t[0];
#pragma unroll
  for (int s = 1; s < SC; ++s) v = add_rn(v, t[s]);
  return add_rn(v, t[SC]);
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

// The dots of interact_tile (strict triangle) on float4 rows: the same
// fmaf sequence over d = 0..D-1, two 16-byte shared loads per 4 steps.
__device__ __forceinline__ void interact_tile_vec4(const float* tile,
                                                   int n_samples, int F,
                                                   int D, int lds, int P,
                                                   float* __restrict__ out) {
  const int D4 = D / 4;
  for (int w = threadIdx.x; w < n_samples * P; w += blockDim.x) {
    const int s = w / P;
    const int p = w - s * P;
    int i, j;
    tri_pair(p, 0, &i, &j);
    const float4* xi =
        reinterpret_cast<const float4*>(tile + (s * F + i) * lds);
    const float4* xj =
        reinterpret_cast<const float4*>(tile + (s * F + j) * lds);
    float z = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D4; ++d) {
      const float4 a = xi[d];
      const float4 b = xj[d];
      z = __fmaf_rn(a.x, b.x, z);
      z = __fmaf_rn(a.y, b.y, z);
      z = __fmaf_rn(a.z, b.z, z);
      z = __fmaf_rn(a.w, b.w, z);
    }
    out[w] = z;
  }
}

// SC: the shard count S when it is 1, 2, 4 or 8, else 0 (S at run time).
// VEC: 4 (float4; D % 4 == 0, 16-byte aligned tiles) or 1 (scalar).
template <int SC, int VEC>
__global__ void fused_resume_kernel(const float* __restrict__ part_c,
                                    const float* __restrict__ part_h,
                                    float* __restrict__ out, int B, int F,
                                    int D, int P, int S, int NS,
                                    int lds) {
  using V = typename VecT<VEC>::type;
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * NS;
  const int ns = static_cast<int>(min(static_cast<int64_t>(NS), B - b0));
  // in units of V: one shard's tile, this block's run, a row
  const int64_t shard = static_cast<int64_t>(B) * F * D / VEC;
  const V* c = reinterpret_cast<const V*>(part_c) + b0 * F * D / VEC;
  const V* h = reinterpret_cast<const V*>(part_h) + b0 * F * D / VEC;
  const int n = ns * F * D / VEC;
  const int rv = D / VEC;
  const int step = blockDim.x;
  for (int e = threadIdx.x; e < n; e += 2 * step) {
    const int e2 = e + step;
    V a, b;
    if constexpr (SC > 0) {
      V ta[SC + 1], tb[SC + 1];
      load_terms<SC>(c, h, shard, e, ta);
      if (e2 < n) load_terms<SC>(c, h, shard, e2, tb);
      a = sum_terms<SC>(ta);
      if (e2 < n) b = sum_terms<SC>(tb);
    } else {
      a = tile_sum_any(c, h, shard, S, e);
      if (e2 < n) b = tile_sum_any(c, h, shard, S, e2);
    }
    int row = e / rv;
    *reinterpret_cast<V*>(tile + row * lds + (e - row * rv) * VEC) = a;
    if (e2 < n) {
      row = e2 / rv;
      *reinterpret_cast<V*>(tile + row * lds + (e2 - row * rv) * VEC) = b;
    }
  }
  __syncthreads();
  if constexpr (VEC == 4) {
    interact_tile_vec4(tile, ns, F, D, lds, P, out + b0 * P);
  } else {
    interact_tile(tile, ns, F, D, lds, P, 0, out + b0 * P);
  }
}

template <int SC, int VEC>
static int launch_resume(const float* part_c, const float* part_h,
                         float* out, int B, int F, int D, int P, int S,
                         int NS, int threads, int lds, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NS) * F * lds * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_resume_kernel<SC, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + NS - 1) / NS;
  if (blocks > 0) {
    fused_resume_kernel<SC, VEC><<<blocks, threads, smem, stream>>>(
        part_c, part_h, out, B, F, D, P, S, NS, lds);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
static int launch_resume_s(const float* part_c, const float* part_h,
                           float* out, int B, int F, int D, int P, int S,
                           int NS, int threads, int lds,
                           cudaStream_t stream) {
  switch (S) {
    case 1:
      return launch_resume<1, VEC>(part_c, part_h, out, B, F, D, P, S, NS,
                                   threads, lds, stream);
    case 2:
      return launch_resume<2, VEC>(part_c, part_h, out, B, F, D, P, S, NS,
                                   threads, lds, stream);
    case 4:
      return launch_resume<4, VEC>(part_c, part_h, out, B, F, D, P, S, NS,
                                   threads, lds, stream);
    case 8:
      return launch_resume<8, VEC>(part_c, part_h, out, B, F, D, P, S, NS,
                                   threads, lds, stream);
    default:
      return launch_resume<0, VEC>(part_c, part_h, out, B, F, D, P, S, NS,
                                   threads, lds, stream);
  }
}

// part_c (S, B, F, D), part_h (B, F, D) float32 -> out (B, P) float32,
// P = F(F-1)/2.  The wrapper's resume_shape picks NS samples per block,
// `threads` (a multiple of 32) and the shared row stride lds >= D; vec4:
// D % 4 == 0 and both tiles 16-byte aligned, with lds % 4 == 0.  Shared
// memory NS*F*lds*4 bytes.
extern "C" int fused_resume(const void* part_c, const void* part_h,
                            void* out, int B, int F, int D, int P, int S,
                            int NS, int threads, int lds, int vec4,
                            void* stream) {
  if (S < 1 || NS < 1 || threads < 32 || threads % 32 != 0 || lds < D ||
      (vec4 && (D % 4 != 0 || lds % 4 != 0)))
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
