// Pairwise squared L2, (B, N) = (|q|^2 + |x|^2) - 2 q.x, over float32 rows
// (F32 mode) or int8 codes decoded as code * scale + zero (SQ8 mode).
//
// Replaces: repro/kernels/distance.py::pairwise_l2_pallas (F32) and
// repro/kernels/sq_distance.py::sq8_pairwise_l2_pallas (SQ8), the
// exhaustive-scan entry points of the kernel library.  Both modes are one
// kernel, pairwise_l2_tf32x3<MODE, ...>: one loop, one epilogue, one
// contract.
//
// Contract: |kernel - ref| <= 1e-5 (|q|^2 + |x|^2) elementwise, with ref =
// ref.pairwise_l2 (F32) or ref.sq8_pairwise_l2 and x the decoded rows
// (SQ8), the tolerance the port is held to against the JAX package.  The
// norms are ref's bit for bit (a sequential __fmul_rn/__fadd_rn sum over d,
// the file is built with --fmad=false); the dot product is not.
//   * F32: each operand a is split as a_hi = cvt.rna.tf32(a), a_lo =
//     cvt.rna.tf32(a - a_hi) (the subtraction is exact), and each tile
//     accumulates a_lo b_hi + a_hi b_lo + a_hi b_hi in float32 with
//     mma.sync.m16n8k8 TF32; the dropped a_lo b_lo is about 2^-22 of each
//     product;
//   * SQ8: q.x = sum_c (q_c scale_c) code_c + q.zero.  A code (-127..127)
//     is exact in TF32, so only the scaled query a = __fmul_rn(q_c,
//     scale_c) is split, taken where F32 splits q, and two products,
//     a_lo code + a_hi code, are exact: the rounding is in a, in the
//     float32 sums and in the dropped part of a_lo, as in F32.  q.zero is
//     a sequential sum of the query-owner threads, added to the dot before
//     the epilogue.  The row-owner threads (tid >= 128) decode their own row
//     as __fadd_rn(__fmul_rn((float)code, scale), zero), the plain
//     version's two roundings, for the sequential |x|^2 sum;
//   * a block of 256 threads computes a 128 x 128 output tile (8 warps of
//     64 queries x 32 rows); q (B, d) and x (N, d) are both K-major as
//     stored.  d runs in chunks of 32 columns through a ring of 3 stages
//     filled by cp.async; the tail of d and rows past B or N are
//     zero-filled.  Queries stage as float32 (16-byte copies when d % 4 == 0
//     and both bases are 16-byte aligned), row stride 36 floats, so the
//     fragment loads are free of bank conflicts;
//   * F32 rows stage the same way.  SQ8 rows stage as int8, 128 rows x 32
//     bytes a chunk (a quarter of the F32 stage), row stride 48 bytes (the
//     eight rows of a fragment load fall in distinct banks): 16-byte copies
//     when d % 16 == 0 and both bases are aligned, 4-byte copies when d % 4
//     == 0 and the codes' base is, plain loads otherwise.  The chunk's 32
//     scale and 32 zero values stage beside them;
//   * N tiles stay on gridDim.x, but blocks are numbered so that the B tiles
//     of one N tile run next to each other and read its rows from L2;
//   * epilogue __fsub_rn(__fadd_rn(|q|^2, |x|^2), 2 dot) with no clamp (the
//     result may be slightly negative), lane pairs swap halves so each lane
//     writes 16 bytes with a streaming store (__stcs): nothing rereads the
//     4.1 GB output.  Flat offsets are size_t.
// Bound on the H100 (SXM data sheet, 700 W), at B = 1024, N = 1,000,000,
//   d = 128: bytes.  F32: the 4.1 GB output and 0.5 GB of rows at 3.35
//   TB/s, 1.376 ms; the function's 2 B N d = 2.6e11 FLOP at 495 TFLOP/s
//   dense TF32 take 0.530 ms.  SQ8: the output and 128 MB of codes, 1.261
//   ms.  F32 issues three products, 3 * 2 B N d at the same rate, 1.588 ms:
//   its own floor, above the bound; SQ8 two, 1.059 ms, below its bytes.
//   The CUDA-core bound of the
//   exact product, 2 B N d at 67 TFLOP/s, is 3.962 ms.  Left for a later
//   PR: wgmma and TMA (mma.sync reaches only part of the tensor cores' rate
//   on Hopper), and a persistent grid whose epilogue overlaps the next
//   tile's loads.
#include <cuda_runtime.h>
#include <stdint.h>

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

#define TC_THREADS 256
#define TC_BM 128    // queries of a block's output tile
#define TC_BN 128    // rows of a block's output tile
#define TC_BK 32     // columns of d per stage
#define TC_LD 36     // row stride of a staged float32 tile, in floats
#define TC_LD8 48    // row stride of a staged int8 tile, in bytes
#define TC_STAGES 3
// stage bytes: F32 queries and rows; SQ8 queries, codes, scale and zero
#define TC_STAGE_F32 ((TC_BM + TC_BN) * TC_LD * 4)
#define TC_STAGE_SQ8 (TC_BM * TC_LD * 4 + TC_BN * TC_LD8 + 2 * TC_BK * 4)

// One cp.async of `bytes` (4 or 16); zero-fills the destination when
// !valid.
__device__ __forceinline__ void tc_cp_async(void* dst, const void* src,
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

// The plain version's decode: two roundings.
__device__ __forceinline__ float sq8_decode(int code, float scale,
                                            float zero) {
  return __fadd_rn(__fmul_rn((float)code, scale), zero);
}

// QB: bytes a copy of queries (and of F32 rows) moves, 16 or 4.  XB: bytes
// a copy of SQ8 codes moves, 16 or 4, or 1 for plain loads.
template <int MODE, int QB, int XB>
__global__ void __launch_bounds__(TC_THREADS, 2)
pairwise_l2_tf32x3(const PairwiseArgs a) {
  constexpr bool SQ8 = MODE == PW_MODE_SQ8;
  constexpr int STAGE = SQ8 ? TC_STAGE_SQ8 : TC_STAGE_F32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float qn[TC_BM], xn[TC_BN], qz[TC_BM];
  const float* q = a.q;
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
      unsigned char* st = tc_smem + (ch % TC_STAGES) * STAGE;
      float* qs = reinterpret_cast<float*>(st);
      const int c0 = ch * TC_BK;
      // queries, and F32 rows after them
      constexpr int per = QB / 4;
      constexpr int rows = SQ8 ? TC_BM : TC_BM + TC_BN;
      for (int i = tid; i < rows * (TC_BK / per); i += TC_THREADS) {
        const int r = i / (TC_BK / per), c = (i - r * (TC_BK / per)) * per;
        const bool is_q = r < TC_BM;
        const int row = is_q ? b0 + r : n0 + r - TC_BM;
        const bool ok = c0 + c < d && row < (is_q ? B : N);
        const float* base = is_q ? q : static_cast<const float*>(a.x);
        tc_cp_async(qs + r * TC_LD + c,
                    ok ? base + (size_t)row * d + c0 + c : base, ok, QB);
      }
      if constexpr (SQ8) {
        int8_t* xs = reinterpret_cast<int8_t*>(st + TC_BM * TC_LD * 4);
        float* sz = reinterpret_cast<float*>(xs + TC_BN * TC_LD8);
        const int8_t* x = static_cast<const int8_t*>(a.x);
        for (int i = tid; i < TC_BN * (TC_BK / XB); i += TC_THREADS) {
          const int r = i / (TC_BK / XB), c = (i - r * (TC_BK / XB)) * XB;
          const bool ok = c0 + c < d && n0 + r < N;
          const int8_t* src = ok ? x + (size_t)(n0 + r) * d + c0 + c : x;
          if constexpr (XB == 1)
            xs[r * TC_LD8 + c] = ok ? *src : (int8_t)0;
          else
            tc_cp_async(xs + r * TC_LD8 + c, src, ok, XB);
        }
        if (tid < 2 * TC_BK) {  // scale, then zero
          const int c = tid & (TC_BK - 1);
          const float* src = tid < TC_BK ? a.scale : a.zero;
          const bool ok = c0 + c < d;
          tc_cp_async(sz + tid, ok ? src + c0 + c : src, ok, 4);
        }
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
  float qzero = 0.f;  // SQ8: q.zero of query tid, a sequential sum

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) load(s);
  for (int ch = 0; ch < nch; ++ch) {
    tc_wait<TC_STAGES - 2>();
    __syncthreads();  // chunk ch landed; the stage of chunk ch - 1 is free
    load(ch + TC_STAGES - 1);
    const unsigned char* st = tc_smem + (ch % TC_STAGES) * STAGE;
    const float* qs = reinterpret_cast<const float*>(st);
    const float* xs = qs + TC_BM * TC_LD;  // F32 rows
    const int8_t* xs8 = reinterpret_cast<const int8_t*>(xs);  // SQ8 codes
    const float* sc = reinterpret_cast<const float*>(xs8 + TC_BN * TC_LD8);
    const float* zr = sc + TC_BK;
    const int w = min(TC_BK, d - ch * TC_BK);
    for (int kc = 0; kc < w; kc += 8) {
      // the norm's sequential sum, eight columns at a time beside the mma:
      // query tid, or row tid - 128 (decoded in SQ8 mode)
      float nv[8];
      if (!SQ8 || tid < TC_BM) {
        const float* own = qs + tid * TC_LD + kc;
        // two 16-byte words (a quarter-warp's rows hit distinct banks)
        const float4 n0 = *reinterpret_cast<const float4*>(own);
        const float4 n1 = *reinterpret_cast<const float4*>(own + 4);
        nv[0] = n0.x; nv[1] = n0.y; nv[2] = n0.z; nv[3] = n0.w;
        nv[4] = n1.x; nv[5] = n1.y; nv[6] = n1.z; nv[7] = n1.w;
      } else {
        const int2 cw = *reinterpret_cast<const int2*>(
            xs8 + (tid - TC_BM) * TC_LD8 + kc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int code = (int8_t)(((e < 4 ? cw.x : cw.y) >> (8 * (e & 3)))
                                    & 0xff);
          nv[e] = sq8_decode(code, sc[kc + e], zr[kc + e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (kc + e < w) norm = __fadd_rn(norm, __fmul_rn(nv[e], nv[e]));
      if (SQ8 && tid < TC_BM) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (kc + e < w)
            qzero = __fadd_rn(qzero, __fmul_rn(nv[e], zr[kc + e]));
      }
      // B: F32 rows split in two TF32 parts; SQ8 codes, exact in TF32
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (SQ8) {
          const int8_t* xr = xs8 + (wn + ni * 8 + g) * TC_LD8 + kc + t;
          bh[ni][0] = __float_as_uint((float)xr[0]);
          bh[ni][1] = __float_as_uint((float)xr[4]);
        } else {
          const float* xr = xs + (wn + ni * 8 + g) * TC_LD + kc + t;
          tc_split(xr[0], bh[ni][0], bl[ni][0]);
          tc_split(xr[4], bh[ni][1], bl[ni][1]);
        }
      }
      // A: queries, scaled column by column in SQ8 mode, split in two
      const float s0 = SQ8 ? sc[kc + t] : 1.f, s1 = SQ8 ? sc[kc + t + 4] : 1.f;
      auto a_of = [&](float v, float s) { return SQ8 ? __fmul_rn(v, s) : v; };
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* qr = qs + (wm + mi * 16 + g) * TC_LD + kc + t;
        uint32_t ah[4], al[4];
        tc_split(a_of(qr[0], s0), ah[0], al[0]);
        tc_split(a_of(qr[8 * TC_LD], s0), ah[1], al[1]);
        tc_split(a_of(qr[4], s1), ah[2], al[2]);
        tc_split(a_of(qr[8 * TC_LD + 4], s1), ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          tc_mma(acc[mi][ni], al, bh[ni]);
          if constexpr (!SQ8) tc_mma(acc[mi][ni], ah, bl[ni]);
          tc_mma(acc[mi][ni], ah, bh[ni]);
        }
      }
    }
  }
  tc_wait<0>();
  if (tid < TC_BM) {
    qn[tid] = norm;
    qz[tid] = qzero;
  } else {
    xn[tid - TC_BM] = norm;
  }
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
      for (int e = 0; e < 4; ++e) {
        const int qi = r + (e >> 1) * 8;
        const float dot =
            SQ8 ? __fadd_rn(acc[mi][ni][e], qz[qi]) : acc[mi][ni][e];
        v[e] = __fsub_rn(__fadd_rn(qn[qi], xn[c + (e & 1)]),
                         __fmul_rn(2.f, dot));
      }
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

template <int MODE, int QB, int XB>
static int launch_tf32x3(const PairwiseArgs& a, dim3 grid, cudaStream_t st) {
  const int smem = TC_STAGES *
                   (MODE == PW_MODE_SQ8 ? TC_STAGE_SQ8 : TC_STAGE_F32);
  const cudaError_t e = cudaFuncSetAttribute(
      pairwise_l2_tf32x3<MODE, QB, XB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  pairwise_l2_tf32x3<MODE, QB, XB><<<grid, TC_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

static bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

extern "C" int dqf_pairwise_l2(const PairwiseArgs* a, void* stream) {
  if (a->B == 0 || a->N == 0) return 0;
  if (a->B < 0 || a->N < 0 || a->d < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((a->N + TC_BN - 1) / TC_BN, (a->B + TC_BM - 1) / TC_BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = a->d;
  switch (a->mode) {
    case PW_MODE_F32:
      return d % 4 == 0 && aligned(a->q, 16) && aligned(a->x, 16)
                 ? launch_tf32x3<PW_MODE_F32, 16, 16>(*a, grid, st)
                 : launch_tf32x3<PW_MODE_F32, 4, 4>(*a, grid, st);
    case PW_MODE_SQ8:
      if (d % 16 == 0 && aligned(a->q, 16) && aligned(a->x, 16))
        return launch_tf32x3<PW_MODE_SQ8, 16, 16>(*a, grid, st);
      if (d % 4 == 0 && aligned(a->x, 4))
        return launch_tf32x3<PW_MODE_SQ8, 4, 4>(*a, grid, st);
      return launch_tf32x3<PW_MODE_SQ8, 4, 1>(*a, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
