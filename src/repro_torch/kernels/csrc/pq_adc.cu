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
// Bound on the H100 (SXM data sheet, 700 W): device-memory bytes.  At
// B = 1024, N = 1,000,000, M = 8, K = 256 the output is 4.1 GB (1.22 ms at
// 3.35 TB/s) against 8 MB of codes and 8 MB of LUTs; the B N (M - 1) adds
// need about 0.1 ms.  A gather from shared memory has its own floor: B N M
// loads at 32 a wavefront and one wavefront a clock on each SM, about
// 0.98 ms on 132 SMs at 1.98 GHz, and only if no load conflicts.
//
// Design, pq_adc_lanes (M <= 8, every K <= 256: the search's pq codes, 6 or
// 8 subspaces):
//   * queries across lanes: a block stages the LUTs of 16 queries, query
//     innermost and subspaces interleaved by parity, entry (m, k) of query
//     q at ((m >> 1) K + k) 32 + (m & 1) 16 + q (128 KB at M = 8, K = 256);
//     the transpose happens while staging.  Subspaces M .. next_pow2(M) - 1
//     stage as zeros and their codes read as 0, so the plain version's
//     zero padding needs no test in the loop.  A lane's query is lane & 15;
//   * two rows a warp: half-warp h takes one row, so its 16 lanes read 16
//     consecutive floats of one entry, 16 distinct banks.  Half-warp 0
//     takes the subspaces in the order m = s, half-warp 1 in the order
//     m = s ^ 1, so at every step the two halves read subspaces of other
//     parities, in the other 16 banks: one wavefront a warp load, whatever
//     the codes.  Half-warp 1 holds its values in the order s ^ 1; the
//     halving sum's pairs are the same (j ^ 1 and j ^ 1 + w for w >= 2,
//     and 0 and 1 in the other order at w = 1, which float addition does
//     not see), so both halves give ref.halving_sum's bits;
//   * a lookup is a byte_perm, an address add and a load at a 32-bit
//     shared address (generic pointers cost the lookup a window-base
//     computation each, and a branch did for a subspace test);
//   * codes read once: a lane's rows come in runs of 4 consecutive rows,
//     4 M contiguous bytes read in 16-byte loads when M is 4 or 8 and the
//     base is aligned (bytes otherwise), the same address across a
//     half-warp (a broadcast);
//   * whole-line streaming stores: a warp sums 16 queries x 32 rows into
//     an output tile in shared memory (row stride 36 floats), then 8 lanes
//     a query write it with float4 __stcs, four whole 128-byte lines a
//     store instruction that nothing rereads (a store that fills part of
//     a sector or a line per query costs more than the loop itself);
//   * persistent blocks: grid = SMs x resident blocks; the work items (16
//     queries x 2048 rows) are split into one contiguous range a block, so
//     a block stages a query group's LUTs once or twice in all.
// Past 8 subspaces, pq_adc_kernel: one block of 256 threads takes qb
// queries (8, or fewer when their (M, K) LUTs would not fit) and 16,384
// rows; a thread takes one row at a time and gathers its M values for each
// query.  Past 64 subspaces (MP = 0) a
// thread folds the values in the same pairs with halving_fold
// (halving.cuh); a query's LUT larger than the block's shared memory is
// read from device memory (STAGED = false, one query a block).
//
// Every flat offset is a size_t (the output at B = 1024, N = 1M has
// 1.024e9 elements).
#include <cuda_runtime.h>
#include <stdint.h>

#include "halving.cuh"

#define PQ_THREADS 256
#define PQ_QB 8          // queries a block, at most
#define PQ_ROWS 16384    // rows a block
#define PQ_SMEM_MAX (200 * 1024)
#define PQX_THREADS 1024 // threads of a pq_adc_lanes block: 32 warps
#define PQX_Q 16         // queries a block: the lanes of a half-warp
#define PQX_RUN 4        // consecutive rows of a lane's run
#define PQX_TILE 32      // rows of a warp's output tile: 128 bytes a query
#define PQX_LD 36        // row stride of an output tile, in floats
#define PQX_CHUNK 2048   // rows a work item

struct PqArgs {
  const float* luts;     // (B, M, K)
  const uint8_t* codes;  // (N, M)
  float* out;            // (B, N)
  int32_t B, N, M, K, qb;
};

struct PqLaneArgs {
  const float* luts;
  const uint8_t* codes;
  float* out;
  int32_t B, N, M, K;
  int32_t chunks;     // row chunks of PQX_CHUNK rows
  int64_t items;      // query groups x row chunks
  int32_t vec_codes;  // M is a power of two and the codes 16-byte aligned
  int32_t vec_out;    // N % 4 == 0 and the output 16-byte aligned
};

// The M codes of `row` packed four to a word, zero when row >= N.
template <int MP>
__device__ __forceinline__ void pqx_row_codes(const uint8_t* codes, int row,
                                              int N, int M, bool vec,
                                              uint32_t* w) {
  constexpr int W = (MP + 3) / 4;
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0;
  if (row >= N) return;
  const uint8_t* p = codes + (size_t)row * M;
  if (vec) {
    if constexpr (MP == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x; w[1] = u.y;
    } else if constexpr (MP == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (MP == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = __ldg(p);
    }
  } else {
#pragma unroll
    for (int m = 0; m < MP; ++m)
      if (m < M) w[m >> 2] |= (uint32_t)__ldg(p + m) << (8 * (m & 3));
  }
}

__device__ __forceinline__ float pqx_lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// MP: next_pow2(M), 1..8.
template <int MP>
__global__ void __launch_bounds__(PQX_THREADS)
pq_adc_lanes(const PqLaneArgs a) {
  constexpr int W = (MP + 3) / 4;          // code words a row
  constexpr bool RUN_VEC = MP >= 4;        // a run's codes as 16-byte words
  extern __shared__ __align__(16) float lut[];  // LUTs, then out tiles
  const int M = a.M, K = a.K, N = a.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & 15, half = lane >> 4;
  // half-warp 1 reads subspace s ^ 1 at step s (with one subspace there is
  // no other parity, and both halves read subspace 0)
  const int h = MP >= 2 ? half : 0;
  const int per_lut = ((MP + 1) >> 1) * K * 32;
  // 32-bit shared addresses: step s reads entry (s >> 1, code) at
  // at[s & 1] + (s >> 1) K 128 + code 128 bytes
  const unsigned lut_s = static_cast<unsigned>(__cvta_generic_to_shared(lut));
  const unsigned at_even = lut_s + 4u * (q + 16 * h);       // m & 1 == h
  const unsigned at_odd = lut_s + 4u * ((q + 16 * h) ^ 16);
  const unsigned pair_bytes = (unsigned)K * 128u;
  // this warp's output tile: 16 queries x PQX_TILE rows, row stride
  // PQX_LD floats (16-byte writes and reads free of bank conflicts)
  float* tile = lut + per_lut + warp * (PQX_Q * PQX_LD);

  const int64_t i0 = a.items * blockIdx.x / gridDim.x;
  const int64_t i1 = a.items * (blockIdx.x + 1) / gridDim.x;
  int64_t staged = -1;
  for (int64_t item = i0; item < i1; ++item) {
    const int64_t grp = item / a.chunks;
    const int chunk = (int)(item - grp * a.chunks);
    const int b0 = (int)grp * PQX_Q;
    const int nq = min(PQX_Q, a.B - b0);
    if (grp != staged) {
      __syncthreads();  // every warp is done with the last group's LUTs
      // subspaces M .. MP - 1 stage as zeros: their codes read as 0, so
      // they add the plain version's zero padding with no test
      const float* src = a.luts + (size_t)b0 * M * K;
      for (int i = tid; i < per_lut; i += PQX_THREADS) {
        const int qq = i & 15, pk = i >> 5;
        const int pair = pk / K, k = pk - pair * K;
        const int m = 2 * pair + ((i >> 4) & 1);
        lut[i] = qq < nq && m < M ? src[((size_t)qq * M + m) * K + k] : 0.f;
      }
      __syncthreads();
      staged = grp;
    }
    const int r_end = min(N, (chunk + 1) * PQX_CHUNK);
    for (int r0 = chunk * PQX_CHUNK + warp * PQX_TILE; r0 < r_end;
         r0 += (PQX_THREADS / 32) * PQX_TILE) {
#pragma unroll 1
      for (int t = 0; t < PQX_TILE; t += 16) {
        // 16 rows: the lane's two runs of 4, at t + 4 half and t + 8 + 4 half
        const int run0 = r0 + t + PQX_RUN * half;
        uint32_t cw[2 * PQX_RUN * W];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ru = run0 + 2 * PQX_RUN * u;
          uint32_t* wu = cw + u * PQX_RUN * W;
          if (RUN_VEC && a.vec_codes && ru + PQX_RUN <= N) {
            const uint4* p =
                reinterpret_cast<const uint4*>(a.codes + (size_t)ru * MP);
#pragma unroll
            for (int i = 0; i < PQX_RUN * W / 4; ++i) {
              const uint4 v = __ldg(p + i);
              wu[4 * i] = v.x; wu[4 * i + 1] = v.y;
              wu[4 * i + 2] = v.z; wu[4 * i + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < PQX_RUN; ++j)
              pqx_row_codes<MP>(a.codes, ru + j, N, M, a.vec_codes,
                                wu + j * W);
          }
        }
        float o[2 * PQX_RUN];
#pragma unroll
        for (int j = 0; j < 2 * PQX_RUN; ++j) {
          uint32_t* w = cw + j * W;
          if (h) {  // bytes 2i and 2i + 1 swap: step s reads code s ^ 1
#pragma unroll
            for (int i = 0; i < W; ++i) w[i] = __byte_perm(w[i], 0, 0x2301);
          }
          float v[MP];
#pragma unroll
          for (int s = 0; s < MP; ++s) {
            const unsigned code = __byte_perm(w[s >> 2], 0, 0x4440 + (s & 3));
            v[s] = pqx_lds(((s & 1) ? at_odd : at_even) +
                           (s >> 1) * pair_bytes + code * 128u);
          }
#pragma unroll
          for (int wd = MP / 2; wd >= 1; wd >>= 1) {
#pragma unroll
            for (int i = 0; i < wd; ++i) v[i] = __fadd_rn(v[i], v[i + wd]);
          }
          o[j] = v[0];
        }
        float* tq = tile + q * PQX_LD + t + PQX_RUN * half;
        *reinterpret_cast<float4*>(tq) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(tq + 2 * PQX_RUN) =
            make_float4(o[4], o[5], o[6], o[7]);
      }
      __syncwarp();
      // the tile out: 8 lanes a query, each 4 consecutive rows, so every
      // store instruction writes four whole 128-byte lines
      const int qk = lane >> 3, c = (lane & 7) * 4, rc = r0 + c;
#pragma unroll
      for (int i = 0; i < PQX_Q / 4; ++i) {
        const int qq = 4 * i + qk;
        const float4 v =
            *reinterpret_cast<const float4*>(tile + qq * PQX_LD + c);
        if (qq >= nq || rc >= N) continue;
        float* dst = a.out + (size_t)(b0 + qq) * N + rc;
        if (a.vec_out && rc + 4 <= N) {
          __stcs(reinterpret_cast<float4*>(dst), v);
        } else {
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (rc + e < N) __stcs(dst + e, vv[e]);
        }
      }
      __syncwarp();  // the tile is read before the next one is written
    }
  }
}

// MP: next_pow2(M) up to 64, or 0 for a folded sum of any M.
template <int MP, bool STAGED>
__global__ void __launch_bounds__(PQ_THREADS)
pq_adc_kernel(const PqArgs a) {
  extern __shared__ float lut_q[];  // qb * M * K when STAGED
  const int M = a.M, K = a.K, MK = M * K;
  const int b0 = blockIdx.y * a.qb;
  const int nq = min(a.qb, a.B - b0);
  const float* src = a.luts + (size_t)b0 * MK;
  if (STAGED) {
    for (int i = threadIdx.x; i < nq * MK; i += blockDim.x) lut_q[i] = src[i];
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
      const float* t = (STAGED ? lut_q : src) + (size_t)qi * MK;
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

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int MP>
static int launch_lanes(const PqArgs& in, size_t smem, cudaStream_t st) {
  PqLaneArgs a;
  a.luts = in.luts;
  a.codes = in.codes;
  a.out = in.out;
  a.B = in.B;
  a.N = in.N;
  a.M = in.M;
  a.K = in.K;
  a.chunks = (in.N + PQX_CHUNK - 1) / PQX_CHUNK;
  a.items = (int64_t)((in.B + PQX_Q - 1) / PQX_Q) * a.chunks;
  a.vec_codes = in.M == MP && aligned16(in.codes);
  a.vec_out = in.N % 4 == 0 && aligned16(in.out);
  cudaError_t e = cudaFuncSetAttribute(
      pq_adc_lanes<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pq_adc_lanes<MP>, PQX_THREADS, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t blocks = (int64_t)sms * per_sm;
  const int grid = (int)(a.items < blocks ? a.items : blocks);
  pq_adc_lanes<MP><<<grid, PQX_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int mp = 1;
  while (mp < in->M) mp <<= 1;
  if (mp <= 8) {
    // the LUTs of PQX_Q queries over mp subspaces, paired, then a PQX_Q x
    // PQX_LD output tile a warp: 200 KB at M = 8, K = 256
    const size_t smem =
        ((size_t)((mp + 1) / 2) * in->K * 2 * PQX_Q +
         (size_t)(PQX_THREADS / 32) * PQX_Q * PQX_LD) * sizeof(float);
    switch (mp) {
      case 1: return launch_lanes<1>(*in, smem, st);
      case 2: return launch_lanes<2>(*in, smem, st);
      case 4: return launch_lanes<4>(*in, smem, st);
      default: return launch_lanes<8>(*in, smem, st);
    }
  }
  PqArgs a = *in;
  const size_t per_query = (size_t)a.M * a.K * sizeof(float);
  const bool staged = per_query <= PQ_SMEM_MAX;
  a.qb = staged ? (int)(PQ_SMEM_MAX / per_query) : 1;
  if (a.qb > PQ_QB) a.qb = PQ_QB;
  if ((a.B + a.qb - 1) / a.qb > 65535) return (int)cudaErrorInvalidValue;
  switch (mp) {
    case 16: return launch<16>(a, staged, st);
    case 32: return launch<32>(a, staged, st);
    case 64: return launch<64>(a, staged, st);
    default: return launch<0>(a, staged, st);
  }
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
