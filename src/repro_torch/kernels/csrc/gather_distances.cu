// Neighbour gather + distance: (B, R) squared L2 of query b against
// x_pad[nbrs[b, r]].
//
// Replaces: repro/kernels/gather_distance.py::gather_distances_pallas
// (the composed beam step's scorer; on the TPU the ids ride in scalar
// memory and the DMA engine gathers the rows).  Contract:
// repro_torch/kernels/ref.py::gather_distances = ref.sq_l2 of the gathered
// rows, which this kernel equals bit for bit: __fsub_rn, __fmul_rn and the
// warp halving sum of halving.cuh, the same score code as the fused hop's
// f32 mode (fused_hop.cu), built with --fmad=false.  Ids lie in [0, n];
// the sentinel row n holds PAD_VALUE = 1e9 and scores about 1.3e20 at
// d = 128, finite, and equal to the plain version's too.
//
// Design (first, simple, correct): one warp per (b, r) pair, eight pairs
// a block of 256 threads; lane l loads components l + 32 j of the row and
// of the query (coalesced 128-byte reads of the row), squares the
// differences into M = halving_regs(d) registers and calls
// warp_halving_sum; lane 0 writes the result.  Past d = 1024 each of the
// 32 registers folds the components c + 1024 t in halving_fold's pairs.
//
// Bound on the H100 (SXM data sheet, 700 W): device-memory bytes, the
// B R rows of d x 4 bytes the gather must read (16.8 MB at B = 1024,
// R = 32, d = 128: 0.005 ms at 3.35 TB/s) plus the queries, ids and
// output; 3 B R d FLOP are far below.
//
// Left for later PRs: the query row is reloaded for each of its R pairs
// (from L1/L2), and a warp issues its row load only after it has read its
// id.
#include <cuda_runtime.h>
#include <stdint.h>

#include "halving.cuh"

#define GD_THREADS 256
#define GD_WARPS (GD_THREADS / 32)

struct GatherArgs {
  const float* q;        // (B, d)
  const float* x_pad;    // (n+1, d)
  const int32_t* nbrs;   // (B, R), ids in [0, n]
  float* out;            // (B, R)
  int32_t B, R, d;
};

template <int M>
__global__ void __launch_bounds__(GD_THREADS)
gather_distances_kernel(const GatherArgs a) {
  const size_t pair = (size_t)blockIdx.x * GD_WARPS + (threadIdx.x >> 5);
  if (pair >= (size_t)a.B * a.R) return;  // the whole warp leaves together
  const int wl = threadIdx.x & 31, d = a.d;
  const size_t b = pair / a.R;
  const float* row = a.x_pad + (size_t)a.nbrs[pair] * d;
  const float* q = a.q + b * d;
  const int fold = halving_fold_of(d);
  auto term = [&](int c) {
    const float diff = c < d ? __fsub_rn(row[c], q[c]) : 0.f;
    return __fmul_rn(diff, diff);
  };
  float v[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int c = wl + 32 * j;
    v[j] = M < 32 || fold == 1
               ? term(c)
               : halving_fold([&](int t) { return term(c + 1024 * t); },
                              fold);
  }
  const float s = warp_halving_sum<M>(v);
  if (wl == 0) a.out[pair] = s;
}

template <int M>
static int launch(const GatherArgs& a, cudaStream_t st) {
  const size_t pairs = (size_t)a.B * a.R;
  const size_t blocks = (pairs + GD_WARPS - 1) / GD_WARPS;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  gather_distances_kernel<M><<<(unsigned)blocks, GD_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dqf_gather_distances(const GatherArgs* a, void* stream) {
  if (a->B == 0 || a->R == 0) return 0;
  if (a->d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (halving_regs(a->d)) {
    case 1: return launch<1>(*a, st);
    case 2: return launch<2>(*a, st);
    case 4: return launch<4>(*a, st);
    case 8: return launch<8>(*a, st);
    case 16: return launch<16>(*a, st);
    default: return launch<32>(*a, st);
  }
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
