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
// fused_resume_pallas: the same kernel on the partial-pool tiles
// (fused_front_end.cu, TILES).  Its tile load forms feats = ((c_0 + c_1) +
// ...) + h, one rounded add per term: the S shards' cold tiles in shard
// order (the one-card stand-in of the psum over the tp axis), then the hot
// tile, the split path's operand order; then interact_tile.  So
// partial pool -> resume equals split bit for bit at any shard count.
// Bound: bytes (S + 1 tiles in, B * P out).
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

__global__ void fused_resume_kernel(const float* __restrict__ part_c,
                                    const float* __restrict__ part_h,
                                    float* __restrict__ out, int B, int F,
                                    int D, int P, int S, int NS) {
  extern __shared__ float tile[];
  const int lds = D + 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * NS;
  const int ns = static_cast<int>(min(static_cast<int64_t>(NS), B - b0));
  const int64_t shard = static_cast<int64_t>(B) * F * D;
  const float* c = part_c + b0 * F * D;
  const float* h = part_h + b0 * F * D;
  for (int e = threadIdx.x; e < ns * F * D; e += blockDim.x) {
    float v = __ldg(c + e);
    for (int s = 1; s < S; ++s) v = __fadd_rn(v, __ldg(c + s * shard + e));
    v = __fadd_rn(v, __ldg(h + e));
    const int row = e / D;
    tile[row * lds + (e - row * D)] = v;
  }
  __syncthreads();
  interact_tile(tile, ns, F, D, lds, P, 0, out + b0 * P);
}

// part_c (S, B, F, D), part_h (B, F, D) float32 -> out (B, P) float32,
// P = F(F-1)/2.  NS samples per block; shared memory NS*F*(D+1)*4 bytes.
extern "C" int fused_resume(const void* part_c, const void* part_h,
                            void* out, int B, int F, int D, int P, int S,
                            int NS, void* stream) {
  const size_t smem = static_cast<size_t>(NS) * F * (D + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_resume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = NS * P < 256 ? ((NS * P + 31) / 32) * 32 : 256;
  const int blocks = (B + NS - 1) / NS;
  if (blocks > 0) {
    fused_resume_kernel<<<blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part_c), static_cast<const float*>(part_h),
        static_cast<float*>(out), B, F, D, P, S, NS);
  }
  return static_cast<int>(cudaGetLastError());
}
