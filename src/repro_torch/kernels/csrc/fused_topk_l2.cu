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
// Design: two launches from one entry point.
//   1. fused_topk_l2_part: the grid is (query tiles, row ranges).  A block
//      of 128 threads takes QT = 32 queries and one contiguous range of
//      rows; the ranges are as many as fill the three block slots of every
//      SM once (384 blocks at B = 1024, N = 5000 on 132 SMs).
//      * rows come in tiles of BN = 64, d in chunks of DK = 32 columns;
//        each chunk of the query and row tiles reaches shared memory
//        through cp.async (8-byte copies when d is even), three stages
//        deep, row stride 34 (column reads free of bank conflicts);
//      * each thread keeps a 4 x 4 register tile of dot products (queries
//        ty + 8 i, rows tx + 16 j; two columns a step, 8-byte loads); the
//        chunks run in order, so each dot
//        product is one sequential sum over d and every key equals the
//        plain version's;
//      * each query keeps a running top-k, sorted by (key, id), and its
//        k-th entry as a threshold.  A score enters the query's buffer of
//        CAP = S - k entries (S = 128 for k <= 64) only if its (key, id)
//        is smaller (half-warp aggregated appends).  The running list starts as (+inf, INT_MAX),
//        so a range's first k rows enter untested;
//      * a query's buffer is merged into its running list only when the
//        tile's entries would not fit in it, or the range ends: one warp a
//        query runs the stable (key, id) bitonic network of bitonic.cuh
//        over [running k | buffer | +inf pad], S entries, in its registers
//        (entry lane * E + r in slot r, shuffles for distances of E and
//        up; E the least power of two that holds the query's entries) and
//        keeps the first k.  Then its threshold moves up.  S <= 512,
//        so this launch takes k <= 448 (TOPK_MAX_K); past it, launch 1';
//      * each block writes its queries' range top-k to (B, P, k) scratch.
//   1'. fused_topk_l2_range, in place of launch 1 when k > 448: the rows
//      split into P ranges of C rows, C the least power of two >= k and
//      1024 up to 8192, but no more than N needs; one block of 1024
//      threads takes one (query,
//      range), computes the range's keys in the same order (one
//      sequential __fmul_rn/__fadd_rn sum over d per dot product), sorts
//      them with the block-wide stable (key, id) network of bitonic.cuh in
//      shared memory and writes the first min(k, C), then (+inf, INT_MAX)
//      to length k.  No limit on k but the (B, P, k) scratch.
//   2. fused_topk_l2_merge: one block per query merges its P sorted lists
//      in pairs, ceil(log2 P) rounds in shared memory: an entry's place is
//      its index plus its rank in the partner list (binary search; (key,
//      id) is a total order over distinct ids), kept below k.  Slots past
//      min(N, k) get (+inf, N).
// Why this stays exact: the keys are exact and (key, id) is a total order,
// so the union of the per-range top-k lists holds the global top-k, the
// argument of ref.fused_topk_l2's own chunking.
//
// Bound on the H100: float32 operations.  At B = 1024, N = 5000, d = 128
// the scores are about 2 B N d = 1.31 GFLOP (0.020 ms at 67 TFLOP/s outside
// the tensor cores) against about 3.3 MB of inputs and outputs (0.001 ms).
// With --fmad=false each multiply and add is its own instruction, so the
// dot products alone need about 0.04 ms of issue.
//
// Left for later PRs: each thread reads 8 shared-memory words for every
// 16 multiplies and adds, so the SM's shared-memory port and its FP32
// pipes are about equally loaded; each merge re-sorts the running k with
// the buffer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

#define TOPK_THREADS 128
#define TOPK_QT 32       // queries of a block
#define TOPK_BN 64       // rows of a tile
#define TOPK_DK 32       // columns of a chunk
#define TOPK_XS (TOPK_DK + 2)  // even: 8-byte copies; 2 r + c: no conflicts
#define TOPK_MIN_CAP 64  // buffer entries per query, at least BN
#define TOPK_BLOCKS_PER_SM 3  // what registers and shared memory allow at S = 128
#define TOPK_STAGES 3
// a merge sorts <= 512 entries; a larger k takes the range launch
#define TOPK_MAX_K (16 * 32 - TOPK_MIN_CAP)
#define TOPK_RANGE_THREADS 1024
#define TOPK_RANGE_ROWS 8192  // rows of a range, at most: 64 KB of keys and ids
// after a merge a query's buffer is empty and must take a whole tile
static_assert(TOPK_MIN_CAP >= TOPK_BN, "a buffer holds at least a tile");
#define TOPK_MERGE_THREADS 256
#define TOPK_MERGE_STAGED (48 * 1024)  // largest P * k * 16 staged
#define TOPK_INT_MAX 2147483647

struct TopkArgs {
  const float* q;       // (B, d)
  const float* x;       // (N, d)
  float* part_keys;     // (B, P, k) scratch: each range's top-k
  int32_t* part_ids;    // (B, P, k)
  float* tree_keys;     // (B, P, k) scratch of the merge rounds
  int32_t* tree_ids;    // (B, P, k)
  float* dists;         // (B, k) out
  int32_t* ids;         // (B, k) out
  int32_t B, N, d, k, P;
};

// Entries a merge sorts: [running k | buffer] padded to a power of two,
// with at least TOPK_MIN_CAP buffer entries.  The buffer takes the rest.
static int topk_sort_len(int k) {
  int s = 32;
  while (s < k + TOPK_MIN_CAP) s <<= 1;
  return s;
}

// BYTES (4 or 8) from global src to shared dst, zeros when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Number of entries of the sorted list (lk, li)[0, n) below (key, id).
__device__ __forceinline__ int topk_rank_in(const float* lk, const int32_t* li,
                                            int n, float key, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kv_less(lk[mid], li[mid], key, id)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

struct TopkShared {
  float* keys;   // QT * S: [running k | buffer S - k]
  int* tie;      // QT * S
  float* thr_key;
  int* thr_id;
  int* cnt;
  int* need;
  int* filled;   // QT: real entries of the running list, up to k
};

// Query qi's `filled` running entries and `cnt` buffered ones, padded with
// (+inf, INT_MAX) to 32 E >= filled + cnt, sorted; the first k go back as
// the running list.  The network sorts whatever order it is given, so the
// loads go slot-major (conflict-free) and the stores lane-major.
template <int E>
__device__ __forceinline__ void topk_merge_one(const TopkShared& sh, int qi,
                                               int k, int S, int lane) {
  const int filled = sh.filled[qi], n = filled + sh.cnt[qi];
  float* rk = sh.keys + qi * S;
  int* ri = sh.tie + qi * S;
  float key[E];
  int id[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    const int at = i < filled ? i : k + i - filled;  // running, then buffer
    key[r] = i < n ? rk[at] : __int_as_float(0x7f800000);
    id[r] = i < n ? ri[at] : TOPK_INT_MAX;
  }
  warp_sort_kv<E>(key, id, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (lane * E + r < k) {
      rk[lane * E + r] = key[r];
      ri[lane * E + r] = id[r];
    }
  }
  __syncwarp();
  if (lane == 0) {
    sh.thr_key[qi] = rk[k - 1];
    sh.thr_id[qi] = ri[k - 1];
    sh.filled[qi] = min(k, n);
    sh.cnt[qi] = 0;
  }
}

// Merge into its running top-k the buffer of every query whose buffer
// cannot take its next `need` entries (all with entries when need is
// null), one warp a query, and move those thresholds up.  Block-wide.
__device__ void topk_merge_buffers(const TopkShared& sh, int k, int S,
                                   const int* need) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  for (int qi = threadIdx.x >> 5; qi < TOPK_QT; qi += TOPK_THREADS / 32) {
    const int cnt = sh.cnt[qi];
    if (need ? cnt + need[qi] <= S - k : cnt == 0) continue;
    const int n = sh.filled[qi] + cnt;
    if (n <= 32) topk_merge_one<1>(sh, qi, k, S, lane);
    else if (n <= 64) topk_merge_one<2>(sh, qi, k, S, lane);
    else if (n <= 128) topk_merge_one<4>(sh, qi, k, S, lane);
    else if (n <= 256) topk_merge_one<8>(sh, qi, k, S, lane);
    else topk_merge_one<16>(sh, qi, k, S, lane);
  }
  __syncthreads();
}

// PAIRS: d is even and q, x are 8-byte aligned, so rows move in 8-byte
// copies.
template <bool PAIRS>
__global__ void __launch_bounds__(TOPK_THREADS, TOPK_BLOCKS_PER_SM)
fused_topk_l2_part(const TopkArgs a, const int S) {
  extern __shared__ float smem[];
  const int d = a.d, k = a.k, N = a.N, cap = S - k;
  const int stage_floats = (TOPK_QT + TOPK_BN) * TOPK_XS;
  float* stage = smem;                                   // STAGES * stage
  float* qsq = stage + TOPK_STAGES * stage_floats;       // QT
  float* xsq = qsq + TOPK_QT;                            // BN
  TopkShared sh;
  sh.thr_key = xsq + TOPK_BN;                            // QT
  sh.keys = sh.thr_key + TOPK_QT;                        // QT * S
  sh.tie = reinterpret_cast<int*>(sh.keys + TOPK_QT * S);  // QT * S
  sh.thr_id = sh.tie + TOPK_QT * S;                    // QT
  sh.cnt = sh.thr_id + TOPK_QT;                          // QT
  sh.need = sh.cnt + TOPK_QT;                            // QT
  sh.filled = sh.need + TOPK_QT;                         // QT
  const float inf = __int_as_float(0x7f800000);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, half = lane >> 4;
  const unsigned half_mask = 0xffffu << (16 * half);
  const int b0 = blockIdx.x * TOPK_QT;
  const int nq = min(TOPK_QT, a.B - b0);
  const int part = blockIdx.y;
  const int span = (N + a.P - 1) / a.P;
  const int row_lo = part * span, row_hi = min(N, row_lo + span);
  const int ntiles = (row_hi - row_lo + TOPK_BN - 1) / TOPK_BN;
  const int nch = (d + TOPK_DK - 1) / TOPK_DK;
  const int nsteps = ntiles * nch;

  for (int i = tid; i < TOPK_QT * S; i += blockDim.x) {
    sh.keys[i] = inf;
    sh.tie[i] = TOPK_INT_MAX;
  }
  if (tid < TOPK_QT) {
    sh.thr_key[tid] = inf;
    sh.thr_id[tid] = TOPK_INT_MAX;
    sh.cnt[tid] = 0;
    sh.need[tid] = 0;
    sh.filled[tid] = 0;
  }

  // step s = (tile s / nch, chunk s % nch) goes to stage s % STAGES; every
  // step commits one group, empty past the last.  Thread tid copies column
  // pair (or column) cc of staged rows rr + m * rstep.
  constexpr int per = PAIRS ? 2 : 1, lanes = TOPK_DK / per;
  constexpr int rstep = TOPK_THREADS / lanes;
  const int cc = (tid % lanes) * per, rr = tid / lanes;
  auto issue = [&](int s) {
    if (s < nsteps) {
      const int t = s / nch, c0 = (s - t * nch) * TOPK_DK;
      const int r0 = row_lo + t * TOPK_BN;
      float* dst = stage + (s % TOPK_STAGES) * stage_floats + cc;
      const bool col = c0 + cc < d;
#pragma unroll
      for (int m = 0; m < (TOPK_QT + TOPK_BN) / rstep; ++m) {
        const int r = rr + m * rstep;
        const bool is_q = r < TOPK_QT;   // uniform in m
        const int row = is_q ? b0 + r : r0 + r - TOPK_QT;
        const bool ok = col && (is_q ? r < nq : row < row_hi);
        const float* base = is_q ? a.q : a.x;
        cp_async<4 * per>(dst + r * TOPK_XS,
                          ok ? base + (size_t)row * d + c0 + cc : base, ok);
      }
    }
    cp_async_commit();
  };

  float acc[4][4];
  float xn = 0.f, qn = 0.f;  // |x|^2 of row tid; |q|^2 of query tid - 64
#pragma unroll
  for (int s = 0; s < TOPK_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < nsteps; ++s) {
    const int t = s / nch, ch = s - t * nch;
    const int c0 = ch * TOPK_DK, w = min(TOPK_DK, d - c0);
    const int r0 = row_lo + t * TOPK_BN, nr = min(TOPK_BN, row_hi - r0);
    cp_async_wait<TOPK_STAGES - 2>();
    __syncthreads();  // step s landed; the stage of step s - 1 is free
    issue(s + TOPK_STAGES - 1);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      xn = 0.f;
    }
    const float* qs = stage + (s % TOPK_STAGES) * stage_floats;
    const float* xs = qs + TOPK_QT * TOPK_XS;
    // warps 0 and 1 also sum |x|^2 of their row, warp 2 in the first tile
    // |q|^2 of its query, each in the same sequential order over d
    const int norm_warp = tid < TOPK_BN ? 0 : (t == 0 && tid < TOPK_BN + TOPK_QT) ? 1 : 2;
    const float* own = norm_warp == 0 ? xs + tid * TOPK_XS
                                      : qs + (tid & (TOPK_QT - 1)) * TOPK_XS;
    // two columns a step; an odd w reads one zero column past it
#pragma unroll 2
    for (int c = 0; c < w; c += 2) {
      float2 qv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float2*>(qs + (ty + 8 * i) * TOPK_XS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xv[j] = *reinterpret_cast<const float2*>(xs + (tx + 16 * j) * TOPK_XS + c);
      if (norm_warp == 0) {
        xn = __fadd_rn(xn, __fmul_rn(own[c], own[c]));
        if (c + 1 < w) xn = __fadd_rn(xn, __fmul_rn(own[c + 1], own[c + 1]));
      } else if (norm_warp == 1) {
        qn = __fadd_rn(qn, __fmul_rn(own[c], own[c]));
        if (c + 1 < w) qn = __fadd_rn(qn, __fmul_rn(own[c + 1], own[c + 1]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qv[i].x, xv[j].x));
      if (c + 1 < w) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qv[i].y, xv[j].y));
      }
    }
    if (ch < nch - 1) continue;

    // the tile is scored: keys, and how many beat each query's threshold
    if (norm_warp == 0) xsq[tid] = xn;
    if (norm_warp == 1) qsq[tid - TOPK_BN] = qn;
    __syncthreads();
    float key[4][4];
    bool pass[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty + 8 * i;
      const float tk = sh.thr_key[qi];
      const int ti = sh.thr_id[qi];
      int n = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        key[i][j] = __fsub_rn(__fadd_rn(qsq[qi], xsq[r]),
                              __fmul_rn(2.f, acc[i][j]));
        pass[i][j] = qi < nq && r < nr &&
                     kv_less(key[i][j], r0 + r, tk, ti);
        n += __popc(__ballot_sync(0xffffffffu, pass[i][j]) & half_mask);
      }
      if (tx == 0 && n) atomicAdd(&sh.need[qi], n);
    }
    __syncthreads();
    const bool full = tid < TOPK_QT && sh.cnt[tid] + sh.need[tid] > cap;
    if (__syncthreads_or(full)) {
      topk_merge_buffers(sh, k, S, sh.need);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pass[i][j] = pass[i][j] &&
                       kv_less(key[i][j], r0 + tx + 16 * j,
                                 sh.thr_key[qi], sh.thr_id[qi]);
      }
    }
    // append: one atomic per half-warp and query
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty + 8 * i;
      unsigned bal[4];
      int n = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bal[j] = __ballot_sync(0xffffffffu, pass[i][j]) & half_mask;
        n += __popc(bal[j]);
      }
      int base = 0;
      if (tx == 0 && n) base = atomicAdd(&sh.cnt[qi], n);
      base = __shfl_sync(0xffffffffu, base, 16 * half);
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (pass[i][j]) {
          const int slot = qi * S + k + base + __popc(bal[j] & below);
          sh.keys[slot] = key[i][j];
          sh.tie[slot] = r0 + tx + 16 * j;
        }
        base += __popc(bal[j]);
      }
    }
    if (tid < TOPK_QT) sh.need[tid] = 0;
  }
  cp_async_wait<0>();

  if (__syncthreads_or(tid < TOPK_QT && sh.cnt[tid] > 0))
    topk_merge_buffers(sh, k, S, nullptr);
  for (int p = tid; p < nq * k; p += blockDim.x) {
    const int qi = p / k, i = p - qi * k;
    const size_t o = ((size_t)(b0 + qi) * a.P + part) * k + i;
    a.part_keys[o] = sh.keys[qi * S + i];
    a.part_ids[o] = sh.tie[qi * S + i];
  }
}

// The query's P sorted lists merge in pairs, ceil(log2 P) rounds: entry i
// of list l goes to i + (entries of list l ^ 1 below it) in list l / 2,
// kept when below k.  Ranks are distinct over real entries; the (+inf,
// INT_MAX) padding of a short range lands past them (and where two pads
// meet they write the same value).  STAGED: both buffers fit in shared
// memory; otherwise the rounds run in the global scratch.
template <bool STAGED>
__global__ void __launch_bounds__(TOPK_MERGE_THREADS)
fused_topk_l2_merge(const TopkArgs a) {
  extern __shared__ float lists[];
  const int b = blockIdx.x, k = a.k, n = a.P * k;
  float* xk = a.part_keys + (size_t)b * n;
  int32_t* xi = a.part_ids + (size_t)b * n;
  float* yk = a.tree_keys + (size_t)b * n;
  int32_t* yi = a.tree_ids + (size_t)b * n;
  if (STAGED) {
    float* sk = lists;
    int32_t* si = reinterpret_cast<int32_t*>(lists + n);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      sk[e] = xk[e];
      si[e] = xi[e];
    }
    xk = sk;
    xi = si;
    yk = lists + 2 * n;
    yi = reinterpret_cast<int32_t*>(lists + 3 * n);
    __syncthreads();
  }
  for (int m = a.P; m > 1; m = (m + 1) >> 1) {
    for (int e = threadIdx.x; e < m * k; e += blockDim.x) {
      const int l = e / k, i = e - l * k, other = l ^ 1;
      const float key = xk[e];
      const int id = xi[e];
      const int pos = other < m ? i + topk_rank_in(xk + other * k,
                                                   xi + other * k, k, key, id)
                                : i;
      if (pos < k) {
        yk[(l >> 1) * k + pos] = key;
        yi[(l >> 1) * k + pos] = id;
      }
    }
    __syncthreads();
    float* tk = xk; xk = yk; yk = tk;
    int32_t* ti = xi; xi = yi; yi = ti;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const bool real = xi[i] != TOPK_INT_MAX;  // else past min(N, k)
    a.dists[(size_t)b * k + i] = real ? xk[i] : __int_as_float(0x7f800000);
    a.ids[(size_t)b * k + i] = real ? xi[i] : a.N;
  }
}

// Rows of a range of the k > TOPK_MAX_K launch: a power of two that holds
// k when k <= TOPK_RANGE_ROWS, no more than the next power of two of N.
static int topk_range_rows(int N, int k) {
  int c = 1024;
  while (c < k && c < TOPK_RANGE_ROWS) c <<= 1;
  while (c > 32 && c / 2 >= N) c >>= 1;
  return c;
}

// One (query, range) of C rows: keys in the plain version's order, the
// stable (key, id) network over them, the first min(k, C) out and
// (+inf, INT_MAX) past them.
__global__ void __launch_bounds__(TOPK_RANGE_THREADS)
fused_topk_l2_range(const TopkArgs a, const int C) {
  extern __shared__ float smem[];
  float* keys = smem;                               // C
  int* ids = reinterpret_cast<int*>(keys + C);      // C
  float* qs = reinterpret_cast<float*>(ids + C);    // d
  __shared__ float s_qsq;
  const int b = blockIdx.x, part = blockIdx.y, d = a.d, tid = threadIdx.x;
  const int lo = part * C, hi = min(a.N, lo + C);
  const float inf = __int_as_float(0x7f800000);
  for (int c = tid; c < d; c += blockDim.x) qs[c] = a.q[(size_t)b * d + c];
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = __fadd_rn(s, __fmul_rn(qs[c], qs[c]));
    s_qsq = s;
  }
  __syncthreads();
  const float qsq = s_qsq;
  for (int i = tid; i < C; i += blockDim.x) {
    const int row = lo + i;
    float key = inf;
    int id = TOPK_INT_MAX;
    if (row < hi) {
      const float* x = a.x + (size_t)row * d;
      float xs = 0.f, dot = 0.f;
      for (int c = 0; c < d; ++c) {
        const float v = x[c];
        xs = __fadd_rn(xs, __fmul_rn(v, v));
        dot = __fadd_rn(dot, __fmul_rn(qs[c], v));
      }
      key = __fsub_rn(__fadd_rn(qsq, xs), __fmul_rn(2.f, dot));
      id = row;
    }
    keys[i] = key;
    ids[i] = id;
  }
  bitonic_sort_stable_segments(keys, ids, C, 1);
  const int kk = min(a.k, C);
  for (int i = tid; i < a.k; i += blockDim.x) {
    const size_t o = ((size_t)b * a.P + part) * a.k + i;
    a.part_keys[o] = i < kk ? keys[i] : inf;
    a.part_ids[o] = i < kk ? ids[i] : TOPK_INT_MAX;
  }
}

static size_t topk_smem(int k) {
  const size_t seg = (size_t)topk_sort_len(k);
  return sizeof(float) * (TOPK_STAGES * (TOPK_QT + TOPK_BN) * TOPK_XS +
                          TOPK_QT + TOPK_BN + TOPK_QT +
                          2 * TOPK_QT * seg + 4 * TOPK_QT);
}

// Row ranges of one call: for k <= TOPK_MAX_K as many as fill the block
// slots of every SM once (TOPK_BLOCKS_PER_SM on each of `sms`), at most
// one per tile of rows, none empty; past it ceil(N / topk_range_rows).
// The wrapper sizes the (B, P, k) scratch with it.
extern "C" int dqf_fused_topk_l2_parts(int B, int N, int k, int sms) {
  if (B < 1 || N < 1) return 1;
  if (k > TOPK_MAX_K) {
    const int C = topk_range_rows(N, k);
    return (N + C - 1) / C;
  }
  const int qtiles = (B + TOPK_QT - 1) / TOPK_QT;
  int P = TOPK_BLOCKS_PER_SM * (sms > 0 ? sms : 1) / qtiles;
  P = min(P, (N + TOPK_BN - 1) / TOPK_BN);
  P = max(P, 1);
  const int span = (N + P - 1) / P;
  return (N + span - 1) / span;
}

static cudaError_t topk_set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

static int topk_merge_launch(const TopkArgs& a, cudaStream_t st) {
  const size_t lists = (size_t)a.P * a.k * 16;
  if (lists <= TOPK_MERGE_STAGED) {
    fused_topk_l2_merge<true><<<a.B, TOPK_MERGE_THREADS, lists, st>>>(a);
  } else {
    fused_topk_l2_merge<false><<<a.B, TOPK_MERGE_THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// k > TOPK_MAX_K: the range launch, then the merge.
static int topk_large(const TopkArgs& a, cudaStream_t st) {
  const int C = topk_range_rows(a.N, a.k);
  if (a.P != (a.N + C - 1) / C || a.P > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * 8 + (size_t)a.d * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = topk_set_smem((const void*)fused_topk_l2_range, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.B, a.P);
  fused_topk_l2_range<<<grid, TOPK_RANGE_THREADS, smem, st>>>(a, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return topk_merge_launch(a, st);
}

extern "C" int dqf_fused_topk_l2(const TopkArgs* a, void* stream) {
  if (a->B == 0) return 0;
  if (a->N < 1 || a->k < 1 || a->d < 1 || a->P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->k > TOPK_MAX_K) return topk_large(*a, st);
  // every row range must hold a row: (P - 1) * ceil(N / P) < N
  if (a->P > 65535 ||
      (long long)(a->P - 1) * ((a->N + a->P - 1) / a->P) >= a->N)
    return (int)cudaErrorInvalidValue;
  const int S = topk_sort_len(a->k);
  const size_t smem = topk_smem(a->k);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const bool pairs = a->d % 2 == 0 &&
                     ((reinterpret_cast<uintptr_t>(a->q) |
                       reinterpret_cast<uintptr_t>(a->x)) & 7) == 0;
  const void* part = pairs ? (const void*)fused_topk_l2_part<true>
                           : (const void*)fused_topk_l2_part<false>;
  cudaError_t e = topk_set_smem(part, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->B + TOPK_QT - 1) / TOPK_QT, a->P);
  if (pairs) fused_topk_l2_part<true><<<grid, TOPK_THREADS, smem, st>>>(*a, S);
  else fused_topk_l2_part<false><<<grid, TOPK_THREADS, smem, st>>>(*a, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return topk_merge_launch(*a, st);
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
