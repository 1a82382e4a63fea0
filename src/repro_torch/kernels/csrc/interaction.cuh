// The pairwise-dot interaction on a feature tile resident in shared memory.
// dot_interaction.cu and fused_front_end.cu both end in interact_tile, so
// the fused front end equals split (SLS -> interaction) bit for bit.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

// Packed index p -> (i, j) of the lower triangle in row-major order (the
// order of np.tril_indices): strict (j < i) by default, diagonal included
// with self_inter.
__device__ __forceinline__ void tri_pair(int p, int self_inter, int* i,
                                         int* j) {
  int r = self_inter ? 0 : 1;
  // row r holds r (strict) or r + 1 (with diagonal) entries
  int base = 0;
  while (base + r + self_inter <= p) {
    base += r + self_inter;
    ++r;
  }
  *i = r;
  *j = p - base;
}

// tile: n_samples x F rows of D floats, row stride lds (shared memory).
// out: row-major (n_samples, P).  Each thread computes whole (sample, pair)
// dots as a sequential fixed-order sum over d with fmaf, so the result
// does not depend on the block shape.
__device__ __forceinline__ void interact_tile(const float* tile,
                                              int n_samples, int F, int D,
                                              int lds, int P, int self_inter,
                                              float* __restrict__ out) {
  for (int w = threadIdx.x; w < n_samples * P; w += blockDim.x) {
    const int s = w / P;
    const int p = w - s * P;
    int i, j;
    tri_pair(p, self_inter, &i, &j);
    const float* xi = tile + (s * F + i) * lds;
    const float* xj = tile + (s * F + j) * lds;
    float z = 0.0f;
    for (int d = 0; d < D; ++d) z = __fmaf_rn(xi[d], xj[d], z);
    out[w] = z;
  }
}
