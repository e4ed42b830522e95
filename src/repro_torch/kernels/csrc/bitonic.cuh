// Stable bitonic sorts: block-wide and warp-wide over shared memory, and
// warp-wide over registers.
//
// Replaces repro/kernels/bitonic.py::bitonic_sort_stable (a device function
// of the Pallas hop kernel).  The compare-exchange network orders entries
// by the strict total order (key, position), so the permutation it produces
// is exactly that of a stable ascending sort (torch.sort(stable=True)), and
// the payloads ride along.  Length must be a power of two; callers pad keys
// with +inf (or, over ordered_key images, INT_MAX).  Keys are float, or
// the int images of ordered_key where NaN keys must sort as the plain
// version sorts them.
#pragma once

// An int whose order is that of the stable sorts of torch and JAX over
// float keys: ascending, -0.0 equal to +0.0, and every NaN (any sign or
// payload) equal to every other and above +inf.  The magnitude bits, signed
// by the float's sign (so both zeros map to 0), and INT_MAX for a NaN
// (+inf maps to 0x7f800000); integer operations only, so no float compare
// decides what a NaN is.
__device__ __forceinline__ int ordered_key(float f) {
  const int u = __float_as_int(f);
  const int mag = u & 0x7fffffff;
  if (mag > 0x7f800000) return 0x7fffffff;
  return u < 0 ? -mag : mag;
}

// The network over shared memory run by one warp alone (lane =
// threadIdx.x & 31), with __syncwarp between stages: the fused hop's full
// merge, one warp a lane.  Every lane of the warp must call it; the warp's
// earlier writes to the arrays must be visible (a __syncwarp before the
// call).
__device__ __forceinline__ void warp_bitonic_sort_stable(float* keys,
                                                         int* pos, int* pay0,
                                                         int* pay1, int len,
                                                         int lane) {
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (len >> 1); t += 32) {
        const int lo = 2 * j * (t / j) + (t % j);
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
      __syncwarp();
    }
  }
}

// The network run by the whole block over `nseg` independent segments of
// `len` entries each (segment s starts at keys + s * len), ordered by the
// strict total order (key, tie).  `tie` rides along as the payload.  With
// a tie that grows with position inside each segment this is again a
// stable sort; the top-k kernel passes row ids, which do.  Every thread of the block must call it;
// it synchronises the block before the first stage and after every stage,
// so the arrays may lie in shared or in global memory.
template <class K>
__device__ __forceinline__ void bitonic_sort_stable_segments(K* keys,
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
        const K klo = keys[lo], khi = keys[hi];
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

// (ka, ia) < (kb, ib) in the order (key, tie).
template <class K>
__device__ __forceinline__ bool kv_less(K ka, int ia, K kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The stable (key, tie) network over one warp's registers: entry
// i = lane * E + r sits in slot r of that lane, so a compare-exchange at
// distance j < E stays in the lane and one at j >= E is a shuffle with
// lane ^ (j / E).  Ascending in (key, tie); with distinct ties (positions,
// or row ids) it is a stable sort.  Every lane of the warp must call it.
template <int E, class K>
__device__ __forceinline__ void warp_sort_kv(K (&key)[E], int (&tie)[E],
                                             int lane) {
#pragma unroll
  for (int kk = 2; kk <= 32 * E; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const bool asc = ((lane * E + r) & kk) == 0;
        if (j < E) {
          const int p = r ^ j;
          if (p > r && kv_less(key[p], tie[p], key[r], tie[r]) == asc) {
            const K tk = key[r]; key[r] = key[p]; key[p] = tk;
            const int ti = tie[r]; tie[r] = tie[p]; tie[p] = ti;
          }
        } else {
          const K ok = __shfl_xor_sync(0xffffffffu, key[r], j / E);
          const int oi = __shfl_xor_sync(0xffffffffu, tie[r], j / E);
          const bool lower = (lane & (j / E)) == 0;
          if (lower == asc ? kv_less(ok, oi, key[r], tie[r])
                           : kv_less(key[r], tie[r], ok, oi)) {
            key[r] = ok;
            tie[r] = oi;
          }
        }
      }
    }
  }
}
