// Pairwise squared L2, (B, N) = (|q|^2 + |x|^2) - 2 q.x, over float32 rows
// (F32 mode) or int8 codes decoded as code * scale + zero (SQ8 mode).
//
// Replaces: repro/kernels/distance.py::pairwise_l2_pallas (F32) and
// repro/kernels/sq_distance.py::sq8_pairwise_l2_pallas (SQ8), the
// exhaustive-scan entry points of the kernel library.  The two modes are
// two kernels and two contracts.
//
// F32 mode, pairwise_l2_tf32x3: the product on the tensor cores as 3xTF32.
//   Contract: |kernel - ref.pairwise_l2| <= 1e-5 (|q|^2 + |x|^2) elementwise,
//   the tolerance the port is held to against the JAX package.  The norms
//   are ref.pairwise_l2's bit for bit (a sequential __fmul_rn/__fadd_rn sum
//   over d); the dot product is not.
//   * each operand a is split as a_hi = cvt.rna.tf32(a), a_lo =
//     cvt.rna.tf32(a - a_hi) (the subtraction is exact), and each tile
//     accumulates a_lo b_hi + a_hi b_lo + a_hi b_hi in float32 with
//     mma.sync.m16n8k8 TF32; the dropped a_lo b_lo is about 2^-22 of each
//     product;
//   * a block of 256 threads computes a 128 x 128 output tile (8 warps of
//     64 queries x 32 rows); q (B, d) and x (N, d) are both K-major as
//     stored.  d runs in chunks of 32 columns through a ring of 3 stages
//     filled by cp.async (16-byte copies when d % 4 == 0), row stride 36
//     floats, so the fragment loads are free of bank conflicts; the tail of
//     d and rows past B or N are zero-filled;
//   * N tiles stay on gridDim.x, but blocks are numbered so that the B tiles
//     of one N tile run next to each other and read its rows from L2;
//   * epilogue __fsub_rn(__fadd_rn(|q|^2, |x|^2), 2 dot) with no clamp (the
//     result may be slightly negative), lane pairs swap halves so each lane
//     writes 16 bytes with a streaming store (__stcs): nothing rereads the
//     4.1 GB output.  Flat offsets are size_t.
//   Bound on the H100 (SXM data sheet, 700 W), at B = 1024, N = 1,000,000,
//   d = 128: bytes, the 4.1 GB output and 0.5 GB of rows at 3.35 TB/s,
//   1.376 ms; the function's 2 B N d = 2.6e11 FLOP at 495 TFLOP/s dense
//   TF32 take 0.530 ms.  This design issues three products, 3 * 2 B N d at
//   the same rate, 1.588 ms: its own floor, above the bound.  The CUDA-core
//   bound of the exact product, 2 B N d at 67 TFLOP/s, is 3.962 ms.
//   Left for later PRs: wgmma and TMA (mma.sync reaches only part of the
//   tensor cores' rate on Hopper), and a persistent grid whose epilogue
//   overlaps the next tile's loads.
//
// SQ8 mode, sq8_pairwise_l2_kernel: the first, simple kernel, equal to
//   ref.sq8_pairwise_l2 bit for bit: each of the three sums runs over d in
//   index order, one __fmul_rn and one __fadd_rn per component (the file is
//   built with --fmad=false), the result is __fsub_rn(__fadd_rn(|q|^2,
//   |x|^2), 2 q.x), and the decode is __fadd_rn(__fmul_rn((float)code,
//   scale), zero), the two roundings of the plain version's decode.
//   * one block of 256 threads computes a 128 x 128 tile of the output:
//     128 queries against 128 rows, N tiles on gridDim.x, B tiles on
//     gridDim.y; every flat offset is a size_t;
//   * d is taken in chunks of 32 columns, staged in shared memory with a
//     row stride of 33 (conflict-free column reads), codes decoded while
//     they are staged;
//   * each thread keeps an 8 x 8 register tile of dot products: queries
//     ty + 16 i, rows tx + 16 j; the chunks run in order, so every dot
//     product is still one sequential sum over d;
//   * thread t < 128 also sums |q|^2 of the tile's query t, thread t >= 128
//     |x|^2 of row t - 128, in the same sequential order.
//   Bound: float32 operations, 2 B N d (3.96 ms at 67 TFLOP/s); with
//   --fmad=false every multiply and add is its own instruction, so it
//   cannot pass half that rate (7.8 ms).  Left for later PRs: the decode in
//   the stage of the tensor-core loop above, at a restated contract.
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

__global__ void __launch_bounds__(PW_THREADS)
sq8_pairwise_l2_kernel(const PairwiseArgs a) {
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
          const float code = (float)static_cast<const int8_t*>(a.x)[o];
          xv = __fadd_rn(__fmul_rn(code, a.scale[c0 + c]), a.zero[c0 + c]);
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

// ------------------------------------------------- F32 mode: 3xTF32 on mma
#define TC_THREADS 256
#define TC_BM 128    // queries of a block's output tile
#define TC_BN 128    // rows of a block's output tile
#define TC_BK 32     // columns of d per stage
#define TC_LD 36     // row stride of a staged tile, in floats
#define TC_STAGES 3
#define TC_STAGE_FLOATS ((TC_BM + TC_BN) * TC_LD)

__device__ __forceinline__ void tc_cp_async(float* dst, const float* src,
                                            bool valid, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo with hi = tf32(a) rounded to nearest, ties away, and lo the
// tf32 of the exact remainder.
__device__ __forceinline__ void tc_split(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  const float rest = __fsub_rn(a, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void tc_mma(float* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// VEC: d % 4 == 0 and both bases 16-byte aligned, so a row's chunk
// moves in 16-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
pairwise_l2_tf32x3(const PairwiseArgs a) {
  extern __shared__ __align__(16) float tc_smem[];
  __shared__ float qn[TC_BM], xn[TC_BN];
  const float* q = a.q;
  const float* x = static_cast<const float*>(a.x);
  const int d = a.d, B = a.B, N = a.N;
  // the B tiles of one N tile are consecutive blocks: its rows come from L2
  const size_t bid = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int b0 = (int)(bid % gridDim.y) * TC_BM;
  const int n0 = (int)(bid / gridDim.y) * TC_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nch = (d + TC_BK - 1) / TC_BK;

  auto load = [&](int ch) {
    if (ch < nch) {
      float* qs = tc_smem + (ch % TC_STAGES) * TC_STAGE_FLOATS;
      const int c0 = ch * TC_BK;
      const int per = VEC ? 4 : 1;
      for (int i = tid; i < (TC_BM + TC_BN) * (TC_BK / per);
           i += TC_THREADS) {
        const int r = i / (TC_BK / per), c = (i - r * (TC_BK / per)) * per;
        const bool is_q = r < TC_BM;
        const int row = is_q ? b0 + r : n0 + r - TC_BM;
        const bool ok = c0 + c < d && row < (is_q ? B : N);
        const float* base = is_q ? q : x;
        tc_cp_async(qs + r * TC_LD + c,
                    ok ? base + (size_t)row * d + c0 + c : base, ok,
                    4 * per);
      }
    }
    tc_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float norm = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) load(s);
  for (int ch = 0; ch < nch; ++ch) {
    tc_wait<TC_STAGES - 2>();
    __syncthreads();  // chunk ch landed; the stage of chunk ch - 1 is free
    load(ch + TC_STAGES - 1);
    const float* qs = tc_smem + (ch % TC_STAGES) * TC_STAGE_FLOATS;
    const float* xs = qs + TC_BM * TC_LD;
    const int w = min(TC_BK, d - ch * TC_BK);
    const float* own = qs + tid * TC_LD;  // query tid, or row tid - 128
    for (int kc = 0; kc < w; kc += 8) {
      // the norm's sequential sum, eight columns at a time beside the mma,
      // read as two 16-byte words (a quarter-warp's rows hit distinct banks)
      const float4 n0 = *reinterpret_cast<const float4*>(own + kc);
      const float4 n1 = *reinterpret_cast<const float4*>(own + kc + 4);
      const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (kc + e < w) norm = __fadd_rn(norm, __fmul_rn(nv[e], nv[e]));
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* xr = xs + (wn + ni * 8 + g) * TC_LD + kc + t;
        tc_split(xr[0], bh[ni][0], bl[ni][0]);
        tc_split(xr[4], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* qr = qs + (wm + mi * 16 + g) * TC_LD + kc + t;
        uint32_t ah[4], al[4];
        tc_split(qr[0], ah[0], al[0]);
        tc_split(qr[8 * TC_LD], ah[1], al[1]);
        tc_split(qr[4], ah[2], al[2]);
        tc_split(qr[8 * TC_LD + 4], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          tc_mma(acc[mi][ni], al, bh[ni]);
          tc_mma(acc[mi][ni], ah, bl[ni]);
          tc_mma(acc[mi][ni], ah, bh[ni]);
        }
      }
    }
  }
  tc_wait<0>();
  if (tid < TC_BM) qn[tid] = norm;
  else xn[tid - TC_BM] = norm;
  __syncthreads();

  // lane pairs (t even, t odd) swap halves: the even lane writes row g,
  // the odd lane row g + 8, each four consecutive columns
  const bool odd = t & 1;
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __fsub_rn(__fadd_rn(qn[r + (e >> 1) * 8], xn[c + (e & 1)]),
                         __fmul_rn(2.f, acc[mi][ni][e]));
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      const float4 o = odd ? make_float4(s0, s1, v[2], v[3])
                           : make_float4(v[0], v[1], s0, s1);
      const int row = b0 + r + (odd ? 8 : 0);
      const int col = n0 + wn + ni * 8 + 4 * (t >> 1);
      if (row >= B) continue;
      float* dst = a.out + (size_t)row * N + col;
      if (vec_out && col + 3 < N) {
        __stcs(reinterpret_cast<float4*>(dst), o);
      } else {
        const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) __stcs(dst + e, ov[e]);
      }
    }
  }
}

template <bool VEC>
static int launch_tf32x3(const PairwiseArgs& a, dim3 grid, cudaStream_t st) {
  const int smem = TC_STAGES * TC_STAGE_FLOATS * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      pairwise_l2_tf32x3<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  pairwise_l2_tf32x3<VEC><<<grid, TC_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dqf_pairwise_l2(const PairwiseArgs* a, void* stream) {
  if (a->B == 0 || a->N == 0) return 0;
  if (a->B < 0 || a->N < 0 || a->d < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((a->N + PW_TILE - 1) / PW_TILE,
                  (a->B + PW_TILE - 1) / PW_TILE);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mode) {
    case PW_MODE_F32: {
      const bool vec = a->d % 4 == 0 &&
                       ((reinterpret_cast<uintptr_t>(a->q) |
                         reinterpret_cast<uintptr_t>(a->x)) & 15) == 0;
      return vec ? launch_tf32x3<true>(*a, grid, st)
                 : launch_tf32x3<false>(*a, grid, st);
    }
    case PW_MODE_SQ8:
      sq8_pairwise_l2_kernel<<<grid, PW_THREADS, 0, st>>>(*a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
