// Warp-wide pairwise halving sum in the order of
// repro_torch/kernels/ref.py::halving_sum.
//
// Lane l of the warp holds the components l + 32 j, j < M, of a vector
// zero-padded to width max(32, 32 M) (M a power of two).  The registers
// are halved in place (v[j] += v[j + w] for w = M/2 .. 1), then
// __shfl_down_sync 16 .. 1 finishes the sum: the same pairs, in the same
// order, as halving the padded vector (adding the zero padding is exact).
// Every add is __fadd_rn and the sources are built with --fmad=false, so
// the result equals the plain version bit for bit.
//
// Used by the fused hop's scorers (fused_hop.cu) and gather_distances.cu.
// Every lane of the warp must call it; the sum is valid on lane 0.
#pragma once

template <int M>
__device__ __forceinline__ float warp_halving_sum(float (&v)[M]) {
#pragma unroll
  for (int w = M / 2; w >= 1; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = __fadd_rn(v[j], v[j + w]);
  }
  float s = v[0];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  return s;
}

// Registers a lane needs for a vector of `width` components: the M of
// warp_halving_sum (1 up to width 32, then next_pow2(width) / 32).
static inline int halving_regs(int width) {
  int p = 1;
  while (p < width) p <<= 1;
  return p < 32 ? 1 : p / 32;
}
