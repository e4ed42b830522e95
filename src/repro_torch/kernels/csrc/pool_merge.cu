// Sorted pool merge: keep the L smallest of a (B, L) pool and (B, C)
// candidates per row, in ascending order.
//
// Replaces: repro/kernels/topk_merge.py::pool_merge_pallas (the composed
// beam step's trim) and, inside it, the unstable network
// repro/kernels/bitonic.py::bitonic_sort_kv.  Contract:
// repro_torch/kernels/ref.py::pool_merge, a stable sort of
// [pool | candidates] (the JAX ref's order, not the Pallas kernel's): this
// kernel equals it bit for bit, ties included.
//
// Design (first, simple, correct):
//   * each row of L + C entries is padded to S = next_pow2(L + C) with
//     (+inf, INT_MAX) and sorted by the strict total order (key, position)
//     of bitonic.cuh's stable network (bitonic_sort_stable_segments, the
//     position as the tie), so equal keys keep their input order and an
//     input +inf stays ahead of the padding;
//   * only (key, position) pairs move through the network; after it the
//     first L positions pick their ids from the pool or the candidates;
//   * G = max(1, 256 / S) rows a block of 128 threads, so one block's
//     network is about one compare-exchange per thread per stage.
// Keys must not be NaN (the plain version sorts NaN last; no caller
// produces one).
//
// Bound on the H100 (SXM data sheet, 700 W): device-memory bytes,
// B (L + C) 8 bytes read and B L 8 written; at B = 1024, L = 64, C = 32
// that is 1.3 MB, 0.0004 ms.
// A launch takes longer than that: the bound is below launch latency.
//
// Left for later PRs: the pool is already sorted, so a merge path (or a
// bitonic merge of the sorted candidates) would need log2(S) stages
// instead of log2(S) (log2(S) + 1) / 2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

#define MERGE_THREADS 128
#define MERGE_INT_MAX 2147483647

struct MergeArgs {
  const float* pool_dists;    // (B, L)
  const int32_t* pool_ids;    // (B, L)
  const float* cand_dists;    // (B, C)
  const int32_t* cand_ids;    // (B, C)
  float* out_dists;           // (B, L)
  int32_t* out_ids;           // (B, L)
  int32_t B, L, C, S, G;      // S = next_pow2(L + C); G rows a block
};

__global__ void __launch_bounds__(MERGE_THREADS)
pool_merge_kernel(const MergeArgs a) {
  extern __shared__ float keys[];                        // G * S
  int* pos = reinterpret_cast<int*>(keys + a.G * a.S);   // G * S
  const int L = a.L, C = a.C, S = a.S;
  const int row0 = blockIdx.x * a.G;
  const float inf = __int_as_float(0x7f800000);

  for (int i = threadIdx.x; i < a.G * S; i += blockDim.x) {
    const int g = i / S, j = i - g * S;
    const size_t b = (size_t)row0 + g;
    float k = inf;
    int p = MERGE_INT_MAX;
    if (b < (size_t)a.B && j < L + C) {
      k = j < L ? a.pool_dists[b * L + j] : a.cand_dists[b * C + (j - L)];
      p = j;
    }
    keys[i] = k;
    pos[i] = p;
  }
  bitonic_sort_stable_segments(keys, pos, S, a.G);

  for (int i = threadIdx.x; i < a.G * L; i += blockDim.x) {
    const int g = i / L, j = i - g * L;
    const size_t b = (size_t)row0 + g;
    if (b >= (size_t)a.B) continue;
    const int p = pos[g * S + j];
    a.out_dists[b * L + j] = keys[g * S + j];
    a.out_ids[b * L + j] =
        p < L ? a.pool_ids[b * L + p] : a.cand_ids[b * C + (p - L)];
  }
}

extern "C" int dqf_pool_merge(const MergeArgs* in, void* stream) {
  if (in->B == 0 || in->L == 0) return 0;
  if (in->L < 0 || in->C < 0) return (int)cudaErrorInvalidValue;
  MergeArgs a = *in;
  a.S = 1;
  while (a.S < a.L + a.C) a.S <<= 1;
  a.G = a.S >= 256 ? 1 : 256 / a.S;
  const size_t smem = (size_t)a.G * a.S * 8;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((a.B + a.G - 1) / a.G);
  pool_merge_kernel<<<blocks, MERGE_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
