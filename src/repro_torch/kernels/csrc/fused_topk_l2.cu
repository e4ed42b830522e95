// Brute-force top-k by squared L2: the k nearest of N rows for each query.
//
// Replaces: repro/kernels/fused_scorer.py::fused_topk_l2_pallas (the hot
// phase of hot_mode="mxu") and, inside it, the unstable key-value network
// repro/kernels/bitonic.py::bitonic_sort_kv.  Contract:
// repro_torch/kernels/ref.py::fused_topk_l2, which this kernel equals bit
// for bit: dist = (|q|^2 + |x|^2) - 2 q.x with each of the three sums taken
// over d in index order (__fmul_rn then __fadd_rn, --fmad=false), order
// (dist, id) so ties go to the smaller id, and with k > N the tail is
// (+inf, N).
//
// Design (first, simple, correct):
//   * one block of 256 threads takes QT = 8 queries, held in shared memory
//     with their norms;
//   * the N rows are taken in tiles of BN = 64, staged in shared memory
//     with a row stride of d + 1 (column reads are then free of bank
//     conflicts for even d); each thread scores (query, row) pairs with
//     one sequential dot product;
//   * each query keeps a running top-k in shared memory.  A tile is merged
//     into it by the stable network of bitonic.cuh over
//     sort_len = next_pow2(k + BN) entries laid out [running k | tile |
//     +inf pad], ordered by (key, id).  The running entries come from
//     earlier tiles and carry smaller ids, so (key, id) is the order of
//     lax.top_k;
//   * no TF32 and no tensor cores: the contract is float32.
//
// Bound on the H100: float32 operations.  At B = 1024, N = 5000, d = 128
// the scores are about 2 B N d = 1.31 GFLOP (0.020 ms at 67 TFLOP/s outside
// the tensor cores) against about 3.3 MB of inputs and outputs (0.001 ms).
//
// Left for later PRs: every tile is merged (28 barrier-separated stages at
// sort_len 128) even when no score beats the running k-th; the dot products
// run on the CUDA cores one pair per thread; each block rereads all N rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

#define TOPK_THREADS 256
#define TOPK_QT 8
#define TOPK_BN 64
#define TOPK_INT_MAX 2147483647

struct TopkArgs {
  const float* q;   // (B, d)
  const float* x;   // (N, d)
  float* dists;     // (B, k) out
  int32_t* ids;     // (B, k) out
  int32_t B, N, d, k;
};

static int topk_sort_len(int k) {
  int s = 1;
  while (s < k + TOPK_BN) s <<= 1;
  return s;
}

__global__ void __launch_bounds__(TOPK_THREADS)
fused_topk_l2_kernel(const TopkArgs a, const int S) {
  extern __shared__ float smem[];
  const int d = a.d, k = a.k, N = a.N, xs = d + 1;
  float* qs = smem;                              // QT * d
  float* xt = qs + TOPK_QT * d;                  // BN * xs
  float* qsq = xt + TOPK_BN * xs;                // QT
  float* xsq = qsq + TOPK_QT;                    // BN
  float* keys = xsq + TOPK_BN;                   // QT * S
  int* tie = reinterpret_cast<int*>(keys + TOPK_QT * S);  // QT * S
  const float inf = __int_as_float(0x7f800000);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TOPK_QT;
  const int nq = min(TOPK_QT, a.B - b0);

  for (int i = tid; i < TOPK_QT * d; i += blockDim.x) {
    const int qi = i / d;
    qs[i] = qi < nq ? a.q[(size_t)b0 * d + i] : 0.f;
  }
  for (int i = tid; i < TOPK_QT * S; i += blockDim.x) {
    keys[i] = inf;
    tie[i] = TOPK_INT_MAX;
  }
  __syncthreads();
  if (tid < TOPK_QT) {
    float acc = 0.f;
    for (int c = 0; c < d; ++c)
      acc = __fadd_rn(acc, __fmul_rn(qs[tid * d + c], qs[tid * d + c]));
    qsq[tid] = acc;
  }

  for (int r0 = 0; r0 < N; r0 += TOPK_BN) {
    const int nr = min(TOPK_BN, N - r0);
    const float* src = a.x + (size_t)r0 * d;
    for (int i = tid; i < nr * d; i += blockDim.x) {
      const int r = i / d;
      xt[r * xs + (i - r * d)] = src[i];
    }
    __syncthreads();
    for (int r = tid; r < nr; r += blockDim.x) {
      const float* xr = xt + r * xs;
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = __fadd_rn(acc, __fmul_rn(xr[c], xr[c]));
      xsq[r] = acc;
    }
    __syncthreads();
    for (int p = tid; p < TOPK_QT * TOPK_BN; p += blockDim.x) {
      const int qi = p / TOPK_BN, r = p - qi * TOPK_BN;
      float key = inf;
      int id = TOPK_INT_MAX;
      if (r < nr) {
        const float* qr = qs + qi * d;
        const float* xr = xt + r * xs;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = __fadd_rn(dot, __fmul_rn(qr[c], xr[c]));
        key = __fsub_rn(__fadd_rn(qsq[qi], xsq[r]), __fmul_rn(2.f, dot));
        id = r0 + r;
      }
      keys[qi * S + k + r] = key;
      tie[qi * S + k + r] = id;
    }
    const int pad = S - k - TOPK_BN;
    for (int p = tid; p < TOPK_QT * pad; p += blockDim.x) {
      const int qi = p / pad, i = qi * S + k + TOPK_BN + (p - qi * pad);
      keys[i] = inf;
      tie[i] = TOPK_INT_MAX;
    }
    bitonic_sort_stable_segments(keys, tie, S, TOPK_QT);
  }

  for (int p = tid; p < nq * k; p += blockDim.x) {
    const int qi = p / k, i = p - qi * k;
    const int id = tie[qi * S + i];
    const bool real = id < N;
    a.dists[(size_t)(b0 + qi) * k + i] = real ? keys[qi * S + i] : inf;
    a.ids[(size_t)(b0 + qi) * k + i] = real ? id : N;
  }
}

extern "C" int dqf_fused_topk_l2(const TopkArgs* a, void* stream) {
  if (a->B == 0) return 0;
  if (a->N < 1 || a->k < 1 || a->d < 1) return (int)cudaErrorInvalidValue;
  const int S = topk_sort_len(a->k);
  const size_t smem = sizeof(float) * ((size_t)TOPK_QT * a->d +
                                       (size_t)TOPK_BN * (a->d + 1) +
                                       TOPK_QT + TOPK_BN +
                                       (size_t)TOPK_QT * S * 2);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_topk_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a->B + TOPK_QT - 1) / TOPK_QT), block(TOPK_THREADS);
  fused_topk_l2_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(*a, S);
  return (int)cudaGetLastError();
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
