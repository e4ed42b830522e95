// Neighbour gather + distance: (B, R) squared L2 of query b against
// x_pad[nbrs[b, r]].
//
// Replaces: repro/kernels/gather_distance.py::gather_distances_pallas
// (the composed beam step's scorer; on the TPU the ids ride in scalar
// memory and the DMA engine gathers the rows).  Contract:
// repro_torch/kernels/ref.py::gather_distances = ref.sq_l2 of the gathered
// rows, which this kernel equals bit for bit for any d and R: __fsub_rn,
// __fmul_rn and the pairs of ref.halving_sum, the same score code as the
// fused hop's f32 mode (fused_hop.cu), built with --fmad=false.  Ids lie
// in [0, n]; the sentinel row n holds PAD_VALUE = 1e9 and scores about
// 1.3e20 at d = 128, finite, and equal to the plain version's too.
//
// Design (redesigned for the H100; the first port ran one warp per
// (query, row) pair, which read its id before it could issue its row load,
// reloaded the query for every row and summed each row alone in 5
// shuffles):
//   * one warp per query and group of 8 rows, GD_WARPS warps a block: lanes
//     0..7 read the group's ids in one load and hand them round by shuffle,
//     and the query's components are read once into registers;
//   * lane l takes components l + 32 j (j < M = halving_regs(d)) of each
//     row.  Up to d = 256 (M <= 8) the warp issues all 8 rows' loads before
//     any arithmetic, 8 M independent loads a lane in flight; wider rows
//     are read a row at a time (M loads in flight), and past d = 1024 each
//     register folds the components c + 1024 t with halving_fold;
//   * each lane halves its registers, then the 8 rows finish together in
//     halving.cuh::butterfly8_sum, 9 shuffles where 8 per-row sums take 40;
//     a group past the last row (R not a multiple of 8) computes rows it
//     discards; lane 4 g writes row g, one 32-byte store a group.
//
// Bound on the H100 (SXM data sheet, 700 W): device-memory bytes, the
// B R rows of d x 4 bytes the gather must read (16.8 MB at B = 1024,
// R = 32, d = 128: 0.005 ms at 3.35 TB/s) plus the queries, ids and
// output; 3 B R d FLOP are far below.
//
// What still holds it back: each warp reads its ids, and only then can it
// issue its row loads, so every warp waits two device-memory latencies in
// a row; at B = 1024, R = 32 the 4096 warps of one launch fit on the card
// at once, so nothing else hides that chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "halving.cuh"

#define GD_THREADS 256
#define GD_WARPS (GD_THREADS / 32)
#define GD_ROWS 8   // rows a warp: one butterfly8_sum

struct GatherArgs {
  const float* q;        // (B, d)
  const float* x_pad;    // (n+1, d)
  const int32_t* nbrs;   // (B, R), ids in [0, n]
  float* out;            // (B, R)
  int32_t B, R, d;
};

// Lane `lane`'s partial of one row (its M registers halved), read a row at
// a time: the widths past 256.  q holds the query's components lane + 32 j
// when the width needs no fold.
template <int M>
__device__ __forceinline__ float gd_row_partial(const float* row,
                                                const float* qg,
                                                const float (&q)[M], int d,
                                                int fold, int lane) {
  auto term = [&](int c, float qc) {
    const float diff = c < d ? __fsub_rn(row[c], qc) : 0.f;
    return __fmul_rn(diff, diff);
  };
  float v[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int c = lane + 32 * j;
    v[j] = fold == 1 ? term(c, q[j])
                     : halving_fold([&](int t) {
                         const int cc = c + 1024 * t;
                         return term(cc, cc < d ? qg[cc] : 0.f);
                       }, fold);
  }
#pragma unroll
  for (int w = M / 2; w >= 1; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = __fadd_rn(v[j], v[j + w]);
  }
  return v[0];
}

template <int M>
__global__ void __launch_bounds__(GD_THREADS)
gather_distances_kernel(const GatherArgs a) {
  const int groups = (a.R + GD_ROWS - 1) / GD_ROWS;
  const size_t w = (size_t)blockIdx.x * GD_WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)a.B * groups) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31, d = a.d;
  const size_t b = w / groups;
  const int r0 = (int)(w - b * groups) * GD_ROWS;
  const int nr = min(GD_ROWS, a.R - r0);
  const size_t o = b * a.R + r0;
  const int my_id = lane < nr ? a.nbrs[o + lane] : 0;
  const float* qg = a.q + b * d;
  const int fold = halving_fold_of(d);
  float q[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int c = lane + 32 * j;
    q[j] = fold == 1 && c < d ? qg[c] : 0.f;
  }
  float x[GD_ROWS];
  if constexpr (M <= 8) {
    // every row's loads first, then the arithmetic
    float r[GD_ROWS][M];
#pragma unroll
    for (int g = 0; g < GD_ROWS; ++g) {
      const int id = __shfl_sync(0xffffffffu, my_id, g);
      const float* row = a.x_pad + (size_t)id * d;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int c = lane + 32 * j;
        r[g][j] = g < nr && c < d ? row[c] : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GD_ROWS; ++g) {
      float v[M];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float diff = __fsub_rn(r[g][j], q[j]);
        v[j] = __fmul_rn(diff, diff);
      }
#pragma unroll
      for (int s = M / 2; s >= 1; s >>= 1) {
#pragma unroll
        for (int j = 0; j < s; ++j) v[j] = __fadd_rn(v[j], v[j + s]);
      }
      x[g] = v[0];
    }
  } else {
#pragma unroll 1
    for (int g = 0; g < GD_ROWS; ++g) {
      const int id = __shfl_sync(0xffffffffu, my_id, g);
      x[g] = g < nr ? gd_row_partial<M>(a.x_pad + (size_t)id * d, qg, q, d,
                                        fold, lane)
                    : 0.f;
    }
  }
  const float s = butterfly8_sum(x, lane);
  const int g = lane >> 2;
  if ((lane & 3) == 0 && g < nr) a.out[o + g] = s;
}

template <int M>
static int launch(const GatherArgs& a, cudaStream_t st) {
  const size_t warps = (size_t)a.B * ((a.R + GD_ROWS - 1) / GD_ROWS);
  const size_t blocks = (warps + GD_WARPS - 1) / GD_WARPS;
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
