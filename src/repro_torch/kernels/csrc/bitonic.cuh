// Stable bitonic sort over shared memory, one thread block.
//
// Replaces repro/kernels/bitonic.py::bitonic_sort_stable (a device function
// of the Pallas hop kernel).  The compare-exchange network orders entries
// by the strict total order (key, position), so the permutation it produces
// is exactly that of a stable ascending sort (torch.sort(stable=True)), and
// the payloads ride along.  Length must be a power of two; callers pad keys
// with +inf.
//
// Every thread of the block must call it.  It synchronises the block before
// the first stage and after every stage.
#pragma once

__device__ __forceinline__ void bitonic_sort_stable(float* keys, int* pos,
                                                    int* pay0, int* pay1,
                                                    int len) {
  __syncthreads();
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (len >> 1); t += blockDim.x) {
        const int lo = 2 * j * (t / j) + (t % j);  // partner pair (lo, lo + j)
        const int hi = lo + j;
        const bool desc = (lo & k) != 0;
        const float klo = keys[lo], khi = keys[hi];
        const int plo = pos[lo], phi = pos[hi];
        const bool greater = (klo > khi) || (klo == khi && plo > phi);
        if (greater != desc) {
          keys[lo] = khi; keys[hi] = klo;
          pos[lo] = phi; pos[hi] = plo;
          const int a0 = pay0[lo]; pay0[lo] = pay0[hi]; pay0[hi] = a0;
          const int a1 = pay1[lo]; pay1[lo] = pay1[hi]; pay1[hi] = a1;
        }
      }
      __syncthreads();
    }
  }
}

// The same network over `nseg` independent segments of `len` entries each
// (segment s starts at keys + s * len), ordered by the strict total order
// (key, tie).  `tie` rides along as the payload.  With a tie that grows
// with position inside each segment this is again a stable sort; the top-k
// kernel passes row ids, which do.  Every thread of the block must call it.
__device__ __forceinline__ void bitonic_sort_stable_segments(float* keys,
                                                             int* tie,
                                                             int len,
                                                             int nseg) {
  __syncthreads();
  const int half = len >> 1;
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half * nseg; t += blockDim.x) {
        const int seg = t / half, u = t - seg * half;
        const int lo = seg * len + 2 * j * (u / j) + (u % j);
        const int hi = lo + j;
        const bool desc = ((lo - seg * len) & k) != 0;
        const float klo = keys[lo], khi = keys[hi];
        const int tlo = tie[lo], thi = tie[hi];
        const bool greater = (klo > khi) || (klo == khi && tlo > thi);
        if (greater != desc) {
          keys[lo] = khi; keys[hi] = klo;
          tie[lo] = thi; tie[hi] = tlo;
        }
      }
      __syncthreads();
    }
  }
}
