// Pairwise squared L2, (B, N) = (|q|^2 + |x|^2) - 2 q.x, over float32 rows
// (F32 mode) or int8 codes decoded as code * scale + zero (SQ8 mode).
//
// Replaces: repro/kernels/distance.py::pairwise_l2_pallas (F32) and
// repro/kernels/sq_distance.py::sq8_pairwise_l2_pallas (SQ8), the
// exhaustive-scan entry points of the kernel library.  Contracts:
// repro_torch/kernels/ref.py::pairwise_l2 and ::sq8_pairwise_l2, which this
// kernel equals bit for bit: each of the three sums runs over d in index
// order, one __fmul_rn and one __fadd_rn per component (the file is built
// with --fmad=false), the result is __fsub_rn(__fadd_rn(|q|^2, |x|^2),
// 2 q.x), and SQ8 decodes __fadd_rn(__fmul_rn((float)code, scale), zero),
// the two roundings of the plain version's decode.  The result may be
// slightly negative: that is the contract.
//
// Design (first, simple, correct):
//   * one block of 256 threads computes a 128 x 128 tile of the output:
//     128 queries against 128 rows, N tiles on gridDim.x (the long axis),
//     B tiles on gridDim.y; every flat offset is a size_t;
//   * d is taken in chunks of 32 columns, staged in shared memory with a
//     row stride of 33 (conflict-free column reads); SQ8 decodes its codes
//     while it stages them, so the tile holds the decoded float32 rows;
//   * each thread keeps an 8 x 8 register tile of dot products: queries
//     ty + 16 i, rows tx + 16 j; the chunks run in order, so every dot
//     product is still one sequential sum over d;
//   * thread t < 128 also sums |q|^2 of the tile's query t, thread t >= 128
//     |x|^2 of row t - 128, in the same sequential order;
//   * no TF32 and no tensor cores: the contract is float32.
//
// Bound on the H100 (SXM data sheet, 700 W): float32 operations.  At
// B = 1024, N = 1,000,000, d = 128 the dot products alone are 2 B N d =
// 2.6e11 FLOP (3.9 ms at 67 TFLOP/s outside the tensor cores); the 4.1 GB
// output and 0.5 GB of rows need about 1.4 ms at 3.35 TB/s.  With
// --fmad=false every multiply and add is its own instruction, so this
// kernel cannot reach the FMA rate the bound assumes: at best half of it.
//
// Left for later PRs: the x tile is reread once per 128-query tile (8
// times at B = 1024), the loads are scalar, nothing is prefetched, and a
// redesign for the card would run the product on the tensor cores
// (3xTF32 or a split product) at a looser contract.
#include <cuda_runtime.h>
#include <stdint.h>

#define PW_THREADS 256
#define PW_TILE 128  // queries and rows of a block's output tile
#define PW_TM 8      // a thread's register tile: 8 queries x 8 rows
#define PW_DK 32     // columns of d per shared-memory chunk
#define PW_MODE_F32 0
#define PW_MODE_SQ8 1

struct PairwiseArgs {
  const float* q;      // (B, d)
  const void* x;       // (N, d) float32 (F32) or int8 codes (SQ8)
  const float* scale;  // SQ8: (d,)
  const float* zero;   // SQ8: (d,)
  float* out;          // (B, N)
  int32_t B, N, d, mode;
};

template <bool SQ8>
__global__ void __launch_bounds__(PW_THREADS)
pairwise_l2_kernel(const PairwiseArgs a) {
  __shared__ float qs[PW_TILE][PW_DK + 1];
  __shared__ float xs[PW_TILE][PW_DK + 1];
  __shared__ float norms[2 * PW_TILE];  // |q|^2 of the queries, |x|^2 of rows
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * PW_TILE, b0 = blockIdx.y * PW_TILE;
  const int d = a.d;

  float acc[PW_TM][PW_TM];
#pragma unroll
  for (int i = 0; i < PW_TM; ++i)
#pragma unroll
    for (int j = 0; j < PW_TM; ++j) acc[i][j] = 0.f;
  float norm = 0.f;

  for (int c0 = 0; c0 < d; c0 += PW_DK) {
    const int w = min(PW_DK, d - c0);
    for (int i = tid; i < PW_TILE * PW_DK; i += PW_THREADS) {
      const int r = i / PW_DK, c = i - r * PW_DK;
      float qv = 0.f, xv = 0.f;
      if (c < w) {
        if (b0 + r < a.B) qv = a.q[(size_t)(b0 + r) * d + c0 + c];
        if (n0 + r < a.N) {
          const size_t o = (size_t)(n0 + r) * d + c0 + c;
          if (SQ8) {
            const float code = (float)static_cast<const int8_t*>(a.x)[o];
            xv = __fadd_rn(__fmul_rn(code, a.scale[c0 + c]), a.zero[c0 + c]);
          } else {
            xv = static_cast<const float*>(a.x)[o];
          }
        }
      }
      qs[r][c] = qv;
      xs[r][c] = xv;
    }
    __syncthreads();

    const float* own = tid < PW_TILE ? qs[tid] : xs[tid - PW_TILE];
    for (int c = 0; c < w; ++c)
      norm = __fadd_rn(norm, __fmul_rn(own[c], own[c]));

    for (int c = 0; c < w; ++c) {
      float qv[PW_TM], xv[PW_TM];
#pragma unroll
      for (int i = 0; i < PW_TM; ++i) qv[i] = qs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < PW_TM; ++j) xv[j] = xs[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < PW_TM; ++i)
#pragma unroll
        for (int j = 0; j < PW_TM; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qv[i], xv[j]));
    }
    __syncthreads();
  }
  norms[tid] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < PW_TM; ++i) {
    const int qi = ty + 16 * i;
    if (b0 + qi >= a.B) continue;
    float* row = a.out + (size_t)(b0 + qi) * a.N;
#pragma unroll
    for (int j = 0; j < PW_TM; ++j) {
      const int xi = tx + 16 * j;
      if (n0 + xi < a.N)
        row[n0 + xi] = __fsub_rn(__fadd_rn(norms[qi], norms[PW_TILE + xi]),
                                 __fmul_rn(2.f, acc[i][j]));
    }
  }
}

extern "C" int dqf_pairwise_l2(const PairwiseArgs* a, void* stream) {
  if (a->B == 0 || a->N == 0) return 0;
  if (a->B < 0 || a->N < 0 || a->d < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((a->N + PW_TILE - 1) / PW_TILE,
                  (a->B + PW_TILE - 1) / PW_TILE);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mode) {
    case PW_MODE_F32:
      pairwise_l2_kernel<false><<<grid, PW_THREADS, 0, st>>>(*a);
      break;
    case PW_MODE_SQ8:
      pairwise_l2_kernel<true><<<grid, PW_THREADS, 0, st>>>(*a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
