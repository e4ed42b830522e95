// PQ asymmetric distances, (B, N) = sum over m of luts[b, m, codes[i, m]].
//
// Replaces: repro/kernels/pq_adc.py::pq_adc_pallas, the PQ scan entry
// point of the kernel library.  Contract: repro_torch/kernels/ref.py::
// pq_adc, which this kernel equals bit for bit: the M looked-up values
// are summed in ref.halving_sum order (zero-padded to next_pow2(M), then
// v[j] += v[j + w] for w = Mp/2 .. 1, __fadd_rn), the order of the
// search's PQ scorer (ref.pq_score).  It is not the order of the TPU
// kernel's one-hot matmul: a one-hot product is a TPU idiom for a gather,
// and the card gathers from shared memory directly.  K = 2^pq_bits may be
// below 256, so the LUT stride is K.
//
// Design (first, simple, correct):
//   * one block of 256 threads takes qb queries (8, or fewer when their
//     (M, K) LUTs would not fit in shared memory) and loads their LUTs
//     into shared memory once; blockIdx.y walks the query groups;
//   * blockIdx.x takes 16,384 rows (the long axis); a thread takes one row
//     at a time, holds its M codes in registers and, for each of the
//     block's queries, gathers M values from shared memory, halves them
//     in registers and writes one output; neighbouring threads write
//     neighbouring rows, so the stores coalesce;
//   * past 64 subspaces (MP = 0) a thread folds the values in the same
//     pairs with halving_fold (halving.cuh), reading its codes as it goes;
//     a query's LUT larger than the block's shared memory is read from
//     device memory (STAGED = false, one query a block);
//   * every flat offset is a size_t (the output at B = 1024, N = 1M has
//     1.024e9 elements).
//
// Bound on the H100 (SXM data sheet, 700 W): device-memory bytes.  At
// B = 1024, N = 1,000,000, M = 8, K = 256 the output is 4.1 GB (1.22 ms at
// 3.35 TB/s) against 8 MB of codes and 8 MB of LUTs; the B N (M - 1) adds
// need about 0.1 ms.
//
// Left for later PRs: the gathers from shared memory hit random banks,
// codes are loaded a byte at a time, and each block rereads its rows'
// codes and its queries' LUTs from L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "halving.cuh"

#define PQ_THREADS 256
#define PQ_QB 8          // queries a block, at most
#define PQ_ROWS 16384    // rows a block
#define PQ_SMEM_MAX (200 * 1024)

struct PqArgs {
  const float* luts;     // (B, M, K)
  const uint8_t* codes;  // (N, M)
  float* out;            // (B, N)
  int32_t B, N, M, K, qb;
};

// MP: next_pow2(M) up to 64, or 0 for a folded sum of any M.
template <int MP, bool STAGED>
__global__ void __launch_bounds__(PQ_THREADS)
pq_adc_kernel(const PqArgs a) {
  extern __shared__ float lut[];  // qb * M * K when STAGED
  const int M = a.M, K = a.K, MK = M * K;
  const int b0 = blockIdx.y * a.qb;
  const int nq = min(a.qb, a.B - b0);
  const float* src = a.luts + (size_t)b0 * MK;
  if (STAGED) {
    for (int i = threadIdx.x; i < nq * MK; i += blockDim.x) lut[i] = src[i];
    __syncthreads();
  }
  const int mp = MP ? MP : 1 << (32 - __clz(M - 1));

  const size_t r0 = (size_t)blockIdx.x * PQ_ROWS;
  const size_t r1 = min(r0 + PQ_ROWS, (size_t)a.N);
  for (size_t i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const uint8_t* row = a.codes + i * M;
    int code[MP ? MP : 1];
#pragma unroll
    for (int m = 0; m < MP; ++m) code[m] = m < M ? (int)row[m] : 0;
    for (int qi = 0; qi < nq; ++qi) {
      const float* t = (STAGED ? lut : src) + (size_t)qi * MK;
      float s;
      if (MP) {
        float v[MP ? MP : 1];
#pragma unroll
        for (int m = 0; m < MP; ++m) v[m] = m < M ? t[m * K + code[m]] : 0.f;
#pragma unroll
        for (int w = MP / 2; w >= 1; w >>= 1) {
#pragma unroll
          for (int j = 0; j < w; ++j) v[j] = __fadd_rn(v[j], v[j + w]);
        }
        s = v[0];
      } else {
        s = halving_fold([&](int m) {
          return m < M ? t[m * K + (int)row[m]] : 0.f;
        }, mp);
      }
      a.out[(size_t)(b0 + qi) * a.N + i] = s;
    }
  }
}

template <int MP>
static int launch(const PqArgs& a, bool staged, cudaStream_t st) {
  const dim3 grid((a.N + PQ_ROWS - 1) / PQ_ROWS, (a.B + a.qb - 1) / a.qb);
  if (!staged) {
    pq_adc_kernel<MP, false><<<grid, PQ_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)a.qb * a.M * a.K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel<MP, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pq_adc_kernel<MP, true><<<grid, PQ_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dqf_pq_adc(const PqArgs* in, void* stream) {
  if (in->B == 0 || in->N == 0) return 0;
  if (in->M < 1 || in->K < 1 || in->K > 256)
    return (int)cudaErrorInvalidValue;
  PqArgs a = *in;
  const size_t per_query = (size_t)a.M * a.K * sizeof(float);
  const bool staged = per_query <= PQ_SMEM_MAX;
  a.qb = staged ? (int)(PQ_SMEM_MAX / per_query) : 1;
  if (a.qb > PQ_QB) a.qb = PQ_QB;
  if ((a.B + a.qb - 1) / a.qb > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int mp = 1;
  while (mp < a.M) mp <<= 1;
  switch (mp) {
    case 1: return launch<1>(a, staged, st);
    case 2: return launch<2>(a, staged, st);
    case 4: return launch<4>(a, staged, st);
    case 8: return launch<8>(a, staged, st);
    case 16: return launch<16>(a, staged, st);
    case 32: return launch<32>(a, staged, st);
    case 64: return launch<64>(a, staged, st);
    default: return launch<0>(a, staged, st);
  }
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
