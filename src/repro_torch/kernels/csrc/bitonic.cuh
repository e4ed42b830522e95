// Stable bitonic sorts: block-wide and warp-wide over shared memory, and
// warp-wide over registers.
//
// Replaces repro/kernels/bitonic.py::bitonic_sort_stable (a device function
// of the Pallas hop kernel).  The compare-exchange network orders entries
// by the strict total order (key, position), so the permutation it produces
// is exactly that of a stable ascending sort (torch.sort(stable=True)), and
// the payloads ride along.  Length must be a power of two; callers pad keys
// with +inf.
#pragma once

// Every thread of the block must call it.  It synchronises the block before
// the first stage and after every stage.
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

// The same network run by one warp alone (lane = threadIdx.x & 31), with
// __syncwarp between stages: the fused hop's full merge, one warp a lane.
// Every lane of the warp must call it; the warp's earlier writes to the
// arrays must be visible (a __syncwarp before the call).
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

// (ka, ia) < (kb, ib) in the order (key, tie).
__device__ __forceinline__ bool kv_less(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// The stable (key, tie) network over one warp's registers: entry
// i = lane * E + r sits in slot r of that lane, so a compare-exchange at
// distance j < E stays in the lane and one at j >= E is a shuffle with
// lane ^ (j / E).  Ascending in (key, tie); with distinct ties (positions,
// or row ids) it is a stable sort.  Every lane of the warp must call it.
template <int E>
__device__ __forceinline__ void warp_sort_kv(float (&key)[E], int (&tie)[E],
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
            const float tk = key[r]; key[r] = key[p]; key[p] = tk;
            const int ti = tie[r]; tie[r] = tie[p]; tie[p] = ti;
          }
        } else {
          const float ok = __shfl_xor_sync(0xffffffffu, key[r], j / E);
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
