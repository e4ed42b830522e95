// Pool merge: keep the L smallest of a (B, L) pool and (B, C) candidates
// per row, in ascending order.
//
// Replaces: repro/kernels/topk_merge.py::pool_merge_pallas (the composed
// beam step's trim) and, inside it, the unstable network
// repro/kernels/bitonic.py::bitonic_sort_kv.  Contract:
// repro_torch/kernels/ref.py::pool_merge, a stable sort of
// [pool | candidates] (the JAX ref's order, not the Pallas kernel's): this
// kernel equals it bit for bit for every input the plain version takes —
// any L and C, a pool that is not sorted, +inf, INF_DIST and NaN keys.
// Keys are compared through bitonic.cuh::ordered_key, the order of the
// stable sorts of torch and JAX: -0.0 ties +0.0, and every NaN ties every
// other NaN above +inf, so equal keys keep their input order; the output
// keeps each key's own bits.
//
// Design (redesigned for the H100; the first port ran a block-wide
// network over next_pow2(L + C) entries for every row, 28 stages behind
// __syncthreads at L = 64, C = 32, though the search's pool is sorted):
//   * one warp a row, MERGE_WARPS rows a block, no __syncthreads and no
//     shared memory while L + C <= 256;
//   * L <= 64 and C <= 32 (the search's full_pool and out_degree): a ballot
//     checks that the pool is sorted, and if it is every entry is placed by
//     rank, as the fused hop merges (fused_hop.cu::hop_count_merge, which
//     keeps its own copy over shared memory): pool entry i goes to
//     i + #(candidates with a smaller key), from C shuffles of the
//     candidates' keys; candidate j to j' + #(pool keys <= its key), j' its
//     rank among the candidates by (key, position) from the same shuffles,
//     the count a 7-step binary search over the pool by shuffle.  Only
//     ranks below L are written, each lane storing its own entries;
//   * otherwise (a pool that is not sorted, or L > 64 or C > 32) the warp
//     sorts the row's (key, position) pairs in registers, E = S / 32 a lane
//     (bitonic.cuh::warp_sort_kv, S = next_pow2(L + C) <= 256), and picks
//     the first L by position;
//   * rows past 256 entries: a block a row, the block-wide network over
//     (key, position) in shared memory, or in a global scratch the wrapper
//     allocates when 8 S bytes pass the shared memory's 227 KB.
//
// Bound on the H100 (SXM data sheet, 700 W): device-memory bytes,
// B (L + C) 8 bytes read and B L 8 written; at B = 1024, L = 64, C = 32
// that is 1.3 MB, 0.0004 ms.
// A launch takes longer than that: the bound is below launch latency.
//
// What still holds it back: nothing of the work; one launch is about the
// time of its own scheduling and of one device-memory round trip (the
// loads, then the scattered stores of each row).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

#define MERGE_WARPS 4              // rows a block of the warp form
#define MERGE_WARP_S 256           // widest row of the warp form
#define MERGE_BLOCK_THREADS 256    // the block form: one row a block
#define MERGE_SMEM_MAX (227 * 1024)
#define MERGE_INT_MAX 2147483647
#define MERGE_FULL 0xffffffffu

struct MergeArgs {
  const float* pool_dists;    // (B, L)
  const int32_t* pool_ids;    // (B, L)
  const float* cand_dists;    // (B, C)
  const int32_t* cand_ids;    // (B, C)
  float* out_dists;           // (B, L)
  int32_t* out_ids;           // (B, L)
  int32_t* scratch;           // (B, 2 S) when 8 S bytes pass shared memory
  int32_t B, L, C;
};

// One row: entry p < L is pool entry p, entry L + j candidate j.
struct MergeRow {
  const float* pd;
  const int32_t* pi;
  const float* cd;
  const int32_t* ci;
  float* od;
  int32_t* oi;
  int L, C;
  __device__ __forceinline__ MergeRow(const MergeArgs& a, size_t b)
      : pd(a.pool_dists + b * a.L), pi(a.pool_ids + b * a.L),
        cd(a.cand_dists + b * a.C), ci(a.cand_ids + b * a.C),
        od(a.out_dists + b * a.L), oi(a.out_ids + b * a.L), L(a.L),
        C(a.C) {}
  // ordered key of entry p, INT_MAX past the row (the padding sorts last,
  // after any NaN, by its larger position)
  __device__ __forceinline__ int key(int p) const {
    return p < L ? ordered_key(pd[p])
                 : (p < L + C ? ordered_key(cd[p - L]) : MERGE_INT_MAX);
  }
  // entry p to output slot s
  __device__ __forceinline__ void put(int s, int p) const {
    od[s] = p < L ? pd[p] : cd[p - L];
    oi[s] = p < L ? pi[p] : ci[p - L];
  }
};

// The rank merge, L <= 64 and C <= 32: lane l holds pool entries l and
// l + 32 and candidate l.  Returns false, having written nothing, when the
// pool is not sorted.  Warp-uniform.
__device__ __forceinline__ bool merge_by_rank(const MergeRow& m, int lane) {
  const int L = m.L, C = m.C;
  float pv[2];
  int pid[2], pk[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = lane + 32 * t;
    pv[t] = i < L ? m.pd[i] : 0.f;
    pid[t] = i < L ? m.pi[i] : 0;
    pk[t] = i < L ? ordered_key(pv[t]) : MERGE_INT_MAX;
  }
  // sorted: every entry i + 1 < L at least entry i
  int next0 = __shfl_down_sync(MERGE_FULL, pk[0], 1);
  const int head1 = __shfl_sync(MERGE_FULL, pk[1], 0);
  const int next1 = __shfl_down_sync(MERGE_FULL, pk[1], 1);
  if (lane == 31) next0 = head1;
  const bool bad = (lane + 1 < L && pk[0] > next0) ||
                   (lane + 33 < L && pk[1] > next1);
  if (__any_sync(MERGE_FULL, bad)) return false;

  const float cv = lane < C ? m.cd[lane] : 0.f;
  const int cid = lane < C ? m.ci[lane] : 0;
  const int ck = lane < C ? ordered_key(cv) : MERGE_INT_MAX;
  int before = 0, slot[2] = {lane, lane + 32};
  for (int j = 0; j < C; ++j) {
    const int kj = __shfl_sync(MERGE_FULL, ck, j);
    before += kj < ck || (kj == ck && j < lane);
#pragma unroll
    for (int t = 0; t < 2; ++t) slot[t] += kj < pk[t];
  }
  // pool keys at most ck: a binary search over the sorted pool, each step
  // reading entry i from lane i & 31
  int at_most = 0;
#pragma unroll
  for (int step = 64; step >= 1; step >>= 1) {
    const int i = at_most + step - 1;
    const int k0 = __shfl_sync(MERGE_FULL, pk[0], i & 31);
    const int k1 = __shfl_sync(MERGE_FULL, pk[1], i & 31);
    if (i < L && (i < 32 ? k0 : k1) <= ck) at_most += step;
  }
  const int s = before + at_most;
  if (lane < C && s < L) {
    m.od[s] = cv;
    m.oi[s] = cid;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (lane + 32 * t < L && slot[t] < L) {
      m.od[slot[t]] = pv[t];
      m.oi[slot[t]] = pid[t];
    }
  }
  return true;
}

template <int E>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
pool_merge_warps(const MergeArgs a) {
  const size_t b = (size_t)blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (b >= (size_t)a.B) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const MergeRow m(a, b);
  if (a.L <= 64 && a.C <= 32 && merge_by_rank(m, lane)) return;
  // the (key, position) network over the warp's registers
  int key[E], pos[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    pos[r] = lane * E + r;
    key[r] = m.key(pos[r]);
  }
  warp_sort_kv<E>(key, pos, lane);
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (lane * E + r < m.L) m.put(lane * E + r, pos[r]);
}

__global__ void __launch_bounds__(MERGE_BLOCK_THREADS)
pool_merge_block(const MergeArgs a, int S) {
  extern __shared__ int sm[];
  const size_t b = blockIdx.x;
  const MergeRow m(a, b);
  int* key = a.scratch != nullptr ? a.scratch + b * 2 * S : sm;
  int* pos = key + S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    key[i] = m.key(i);
    pos[i] = i;
  }
  bitonic_sort_stable_segments(key, pos, S, 1);
  for (int i = threadIdx.x; i < m.L; i += blockDim.x) m.put(i, pos[i]);
}

template <int E>
static int launch_warps(const MergeArgs& a, cudaStream_t st) {
  const unsigned blocks = (unsigned)((a.B + MERGE_WARPS - 1) / MERGE_WARPS);
  pool_merge_warps<E><<<blocks, 32 * MERGE_WARPS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dqf_pool_merge(const MergeArgs* a, void* stream) {
  if (a->B == 0 || a->L == 0) return 0;
  if (a->L < 0 || a->C < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long S = 32;
  while (S < (long long)a->L + a->C) S <<= 1;
  switch (S) {
    case 32: return launch_warps<1>(*a, st);
    case 64: return launch_warps<2>(*a, st);
    case 128: return launch_warps<4>(*a, st);
    case MERGE_WARP_S: return launch_warps<8>(*a, st);
  }
  if (S > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const size_t smem = a->scratch != nullptr ? 0 : (size_t)S * 8;
  if (smem > MERGE_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_merge_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pool_merge_block<<<(unsigned)a->B, MERGE_BLOCK_THREADS, smem, st>>>(
      *a, (int)S);
  return (int)cudaGetLastError();
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
