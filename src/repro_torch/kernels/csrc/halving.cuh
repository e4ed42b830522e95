// Pairwise halving sums in the order of
// repro_torch/kernels/ref.py::halving_sum.
//
// ref.halving_sum zero-pads a vector to a power-of-two width W, then adds
// the upper half onto the lower half until one value is left: component c
// meets c + W/2 first, then c + W/4, and so on.  Every add here is
// __fadd_rn and the sources are built with --fmad=false, so each function
// equals the plain version bit for bit (float addition commutes exactly,
// so only the pairs matter, not which operand comes first).
//
// Used by the fused hop's scorers (fused_hop.cu), gather_distances.cu and
// pq_adc.cu; butterfly8_sum by the hop and gather_distances.cu.
#pragma once

// Lane l of the warp holds the components l + 32 j, j < M, of a vector
// zero-padded to width max(32, 32 M) (M a power of two).  The registers
// are halved in place (v[j] += v[j + w] for w = M/2 .. 1), then
// __shfl_down_sync 16 .. 1 finishes the sum: the same pairs, in the same
// order, as halving the padded vector (adding the zero padding is exact).
// Every lane of the warp must call it; the sum is valid on lane 0.
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

// Eight rows' sums at once.  x[g] is this lane's partial of row g (position
// `lane` of row g's 32-wide vector, after warp_halving_sum's in-register
// halvings).  Lanes exchange halves of their rows over lane bits 4, 3 and
// 2, adding positions p and p + 16, then p + 8, then p + 4: the pairs of
// the per-row shuffle sum 16 .. 1.  Lane l ends with the sum of row l >> 2.
// 9 shuffles for 8 rows where warp_halving_sum takes 40.  Every lane of the
// warp must call it.
__device__ __forceinline__ float butterfly8_sum(const float (&x)[8],
                                                int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float y[4], z[2];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float send = b4 ? x[g] : x[g + 4];
    const float keep = b4 ? x[g + 4] : x[g];
    y[g] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const float send = b3 ? y[g] : y[g + 2];
    const float keep = b3 ? y[g + 2] : y[g];
    z[g] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  const float send = b2 ? z[0] : z[1];
  float w = __fadd_rn(b2 ? z[1] : z[0],
                      __shfl_xor_sync(0xffffffffu, send, 4));
  w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, 2));
  return __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, 1));
}

// The halving sum of the T values f(0), ..., f(T - 1), T a power of two,
// in ref.halving_sum's pairs (t meets t + T/2 first): the same tree read as
// adjacent pairs over the bit-reversed index, summed with a stack of at
// most log2(T) + 1 partial sums, so T needs no registers of its own.  Wide
// rows fold their components c + 1024 t into one register this way, and
// pq_adc sums more than 64 subspaces.
template <class F>
__device__ __forceinline__ float halving_fold(F f, int T) {
  float st[32];
  int top = 0;
  const int bits = 31 - __clz(T);
  for (int u = 0; u < T; ++u) {
    float x = f(bits ? (int)(__brev((unsigned)u) >> (32 - bits)) : 0);
    for (int w = u; w & 1; w >>= 1) x = __fadd_rn(st[--top], x);
    st[top++] = x;
  }
  return st[0];
}

// Registers a lane holds for a vector of `width` components: the M of
// warp_halving_sum (1 up to width 32, then next_pow2(width) / 32), at most
// 32; past width 1024 each register folds halving_fold_of(width) values.
__host__ __device__ inline int halving_regs(int width) {
  int p = 1;
  while (p < width) p <<= 1;
  return p < 32 ? 1 : (p > 1024 ? 32 : p / 32);
}

// Values a register folds (halving_fold's T): next_pow2(width) / 1024 past
// width 1024, else 1.
__host__ __device__ inline int halving_fold_of(int width) {
  int p = 1;
  while (p < width) p <<= 1;
  return p > 1024 ? p / 1024 : 1;
}
