// Fused wave-hop kernel: `hops` beam expansions per search lane in one launch.
//
// Replaces: repro/kernels/fused_hop.py::fused_hop_pallas (body _hop_kernel)
// in its three score modes, with and without the liveness bitmap and the
// decision tree:
//   f32  float32 rows (n+1, d);
//   sq8  int8 codes (n+1, d) decoded as code * scale + zero, scale and
//        zero (d,) float32;
//   pq   uint8 codes (n+1, M) and per-lane LUTs (B, M, K) float32, the
//        distance being the sum of M looked-up values.
// Contract: repro_torch/kernels/ref.py::fused_hop, which this kernel
// equals bit for bit in every mode.
//
// Paged mode (a template flag beside MODE) also replaces
// repro/kernels/fused_hop.py::fused_hop_paged_pallas; its contract is
// ref.py::fused_hop_paged.  The seen bitmap then lives in a shared page
// pool (n_pages, page_cols) bool, page_cols = 2^s, and bit v of lane b is
// pool[pt[b, v >> s] * page_cols + (v & (page_cols - 1))] for the page
// table pt (B, ppl) int32, ppl = ceil((n+1) / page_cols).  There is no
// dense gather and no scatter: the lane reads and writes its bits in the
// pool in place, and zeroes the columns [n+1, ppl * page_cols) of its last
// page, which the plain version writes back as zeros for every lane.
// The pages of active lanes must be distinct (the serving allocator,
// repro_torch/serving/paged.py::PagePool, hands each lane its own).
// Padding lanes may share the scratch lane's pages: they must be inactive
// with identical state, so the only bytes they write (the sentinel column
// and the zeroed tail) are the same bytes from every block.  Each hop follows ref.fused_hop_body
// line for line: frontier, adjacency row, seen/live dedup, score, stable
// merge, counters, hop cap, tree check.  The modes differ in step 4 only.
//
// Design (first, simple, correct):
//   * one thread block of 128 threads per lane; the lane's pool lives in
//     shared memory for all hops as sort_len = next_pow2(L + R) keys, ids,
//     expanded flags and positions;
//   * the lane's `seen` row stays in device memory as bytes, (B, n+1), and
//     is updated in place; all R seen bytes of a hop are read before any is
//     written (a __syncthreads between), so an id that appears twice in one
//     adjacency row is valid, scored and merged twice, as in the plain
//     version;
//   * one warp scores one neighbour: lane i holds components i + 32 j, the
//     M = max(next_pow2(width), 32) / 32 registers are halved in place,
//     then __shfl_down_sync 16..1 finishes the pairwise halving sum of
//     ref.halving_sum in the same order (warp_halving_sum, halving.cuh),
//     with __fsub_rn/__fmul_rn/__fadd_rn (and the file is built with
//     --fmad=false).  sq8 keeps its lane's scale and zero in registers
//     and decodes (float)(int8_t)c first; pq
//     stages the lane's (M, K) LUT in shared memory once per launch and
//     sums the looked-up values in the same halving order (no square);
//   * invalid neighbours (sentinel, seen, dead) are never scored: their
//     key is INF_DIST before the merge, so the sentinel code row, which
//     decodes to garbage, never reaches the pool;
//   * the merge is the stable (key, position) bitonic network of
//     bitonic.cuh over [pool (L) | candidates (R) | +inf pad];
//   * the tree walk runs on thread 0; inactive lanes leave the hop loop at
//     once (their remaining hops are exact no-ops).
//
// Bound on the H100: device-memory bytes.  A hop moves one adjacency row
// (R x 4 bytes), R seen bytes read and written (in paged mode also R x 4
// bytes of page-table entries, and once per launch the zeroed tail of the
// lane's last page), R liveness bytes, and one
// table row per valid neighbour (d x 4 bytes in f32, d bytes in sq8, M
// bytes in pq): in all about sum(dist_count) x row bytes + hops x R x
// (4 + 1 + 1 + 1) bytes, plus the pool state read and written once per
// launch and, in pq, the B x M x K x 4 bytes of LUTs.  There are almost no
// FLOPs.
//
// Left for later PRs: the row loads of one warp are issued one neighbour
// after another (no cp.async/TMA prefetch of the next rows), the frontier
// pick and the bitonic stages synchronise the whole block, the tree walk is
// serial, and one block per lane leaves most of each block idle during the
// serial parts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "halving.cuh"

#define DQF_INF_DIST 3.0e38f
#define DQF_EPS 1e-12f
#define DQF_INT_MAX 2147483647
#define DQF_THREADS 128
#define DQF_MODE_F32 0
#define DQF_MODE_SQ8 1
#define DQF_MODE_PQ 2

struct HopArgs {
  // state in
  const int32_t* ids_in;
  const float* dists_in;
  const uint8_t* exp_in;
  const uint8_t* active_in;
  const int32_t* dist_count_in;
  const int32_t* update_count_in;
  const int32_t* hops_in;
  const uint8_t* terminated_in;
  const int32_t* evals_done_in;
  const int32_t* stop_at_in;
  // state out
  int32_t* ids_out;
  float* dists_out;
  uint8_t* exp_out;
  uint8_t* active_out;
  int32_t* dist_count_out;
  int32_t* update_count_out;
  int32_t* hops_out;
  uint8_t* terminated_out;
  int32_t* evals_done_out;
  int32_t* stop_at_out;
  // (B, n+1) seen bitmap, updated in place
  uint8_t* seen;
  // tables
  const int32_t* adj;      // (n+1, R)
  const void* table;       // (n+1, tw): float32 | int8 | uint8 by mode
  const float* t1;         // sq8: scale (d,); pq: LUTs (B, M, K)
  const float* t2;         // sq8: zero (d,)
  const float* queries;    // (B, d)
  const uint8_t* live;     // (n+1,) or null
  // decision tree (null t_feature = no tree)
  const int32_t* t_feature;
  const float* t_threshold;
  const int32_t* t_left;
  const int32_t* t_right;
  const float* t_value;
  const float* hot_first;  // (B,)
  const float* hot_ratio;  // (B,)
  // paged mode: `seen` is the page pool and pt the (B, ppl) page table;
  // null pt = dense (B, n+1) seen rows
  const int32_t* pt;
  int32_t B, L, R, n, d;
  int32_t hops, max_hops, k, eval_gap, add_step, tree_depth, sort_len;
  int32_t mode, tw, K;     // score mode, table row width, pq centroids
  int32_t ppl, page_shift; // paged mode: pages per lane, log2(page_cols)
};

// One lane's seen bitmap: its dense row, or its pages of the pool reached
// through its page-table row.
template <bool PAGED>
struct SeenRow {
  uint8_t* base;       // dense: the lane's row; paged: the pool
  const int32_t* pt;   // paged: the lane's page-table row (ppl,)
  int shift;           // paged: log2(page_cols)
  __device__ __forceinline__ uint8_t& operator[](int v) const {
    if (PAGED)
      return base[((size_t)pt[v >> shift] << shift)
                  + (v & ((1 << shift) - 1))];
    return base[v];
  }
};

template <int MODE, int M, bool PAGED>
__global__ void __launch_bounds__(DQF_THREADS)
fused_hop_kernel(const HopArgs a) {
  extern __shared__ unsigned char smem[];
  const int S = a.sort_len, L = a.L, R = a.R, n = a.n, d = a.d;
  float* keys = reinterpret_cast<float*>(smem);   // S
  int* pos = reinterpret_cast<int*>(keys + S);    // S
  int* vid = pos + S;                              // S
  int* vexp = vid + S;                             // S
  int* nbr = vexp + S;                             // R: cols (sentinel n)
  int* valid = nbr + R;                            // R
  float* d2 = reinterpret_cast<float*>(valid + R); // R
  float* lut = d2 + R;                             // pq: tw * K
  __shared__ int s_slot, s_inserted, s_nvalid, s_stop;
  const int tw = a.tw;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, wl = tid & 31, nwarps = nthreads >> 5;
  const bool has_tree = a.t_feature != nullptr;

  for (int i = tid; i < L; i += nthreads) {
    keys[i] = a.dists_in[(size_t)b * L + i];
    vid[i] = a.ids_in[(size_t)b * L + i];
    vexp[i] = a.exp_in[(size_t)b * L + i] != 0;
  }
  // Block-uniform lane state, kept identical in every thread.
  bool active = a.active_in[b] != 0;
  int dist_count = a.dist_count_in[b];
  int update_count = a.update_count_in[b];
  int hops_ct = a.hops_in[b];
  bool terminated = a.terminated_in[b] != 0;
  int evals_done = a.evals_done_in[b];
  int stop_at = a.stop_at_in[b];

  // Per-lane score operands: query components (f32, sq8), the decode
  // parameters (sq8) or the lane's LUT in shared memory (pq).
  float q[M], sc[M], ze[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int c = wl + 32 * j;
    q[j] = (MODE != DQF_MODE_PQ && c < d) ? a.queries[(size_t)b * d + c]
                                          : 0.f;
    sc[j] = (MODE == DQF_MODE_SQ8 && c < tw) ? a.t1[c] : 0.f;
    ze[j] = (MODE == DQF_MODE_SQ8 && c < tw) ? a.t2[c] : 0.f;
  }
  if (MODE == DQF_MODE_PQ) {
    const float* src = a.t1 + (size_t)b * tw * a.K;
    for (int i = tid; i < tw * a.K; i += nthreads) lut[i] = src[i];
  }
  SeenRow<PAGED> seen;
  if (PAGED) {
    seen.base = a.seen;
    seen.pt = a.pt + (size_t)b * a.ppl;
    seen.shift = a.page_shift;
    // columns past n of the last page: zeros, as the plain version writes
    // them back; no hop reads or writes them
    const int page_cols = 1 << a.page_shift;
    uint8_t* last = a.seen + ((size_t)seen.pt[a.ppl - 1] << a.page_shift);
    for (int c = (n + 1) - (a.ppl - 1) * page_cols + tid; c < page_cols;
         c += nthreads)
      last[c] = 0;
  } else {
    seen.base = a.seen + (size_t)b * (n + 1);
    seen.pt = nullptr;
    seen.shift = 0;
  }

  for (int h = 0; h < a.hops; ++h) {
    // --- 1. frontier: first unexpanded, non-sentinel slot ---
    if (tid == 0) s_slot = DQF_INT_MAX;
    __syncthreads();
    for (int i = tid; i < L; i += nthreads)
      if (!vexp[i] && vid[i] != n) atomicMin(&s_slot, i);
    __syncthreads();
    const int slot = s_slot;
    if (!(active && slot != DQF_INT_MAX)) {
      // lane is False: the plain hop scatters only the sentinel column and
      // retires the lane; every later hop is the same no-op.
      if (tid == 0) seen[n] = 1;
      active = false;
      break;
    }
    const int p = vid[slot];
    if (tid == 0) vexp[slot] = 1;

    // --- 2+3. adjacency row, then seen/live dedup: read all, then write ---
    for (int r = tid; r < R; r += nthreads) {
      const int v = a.adj[(size_t)p * R + r];
      bool ok = v != n && !seen[v];
      if (a.live != nullptr) ok = ok && a.live[v] != 0;
      nbr[r] = ok ? v : n;
      valid[r] = ok;
    }
    __syncthreads();
    for (int r = tid; r < R; r += nthreads) seen[nbr[r]] = 1;

    // --- 4. score: one warp per neighbour, halving-sum order ---
    for (int r = warp; r < R; r += nwarps) {
      float acc = DQF_INF_DIST;
      if (valid[r]) {
        const size_t row0 = (size_t)nbr[r] * tw;
        float v[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int c = wl + 32 * j;
          if (MODE == DQF_MODE_F32) {
            const float* row = static_cast<const float*>(a.table) + row0;
            const float diff = __fsub_rn(c < tw ? row[c] : 0.f, q[j]);
            v[j] = __fmul_rn(diff, diff);
          } else if (MODE == DQF_MODE_SQ8) {
            const int8_t* row = static_cast<const int8_t*>(a.table) + row0;
            const float g =
                c < tw ? __fadd_rn(__fmul_rn((float)row[c], sc[j]), ze[j])
                       : 0.f;
            const float diff = __fsub_rn(g, q[j]);
            v[j] = __fmul_rn(diff, diff);
          } else {
            const uint8_t* row = static_cast<const uint8_t*>(a.table) + row0;
            v[j] = c < tw ? lut[c * a.K + (int)row[c]] : 0.f;
          }
        }
        acc = warp_halving_sum<M>(v);
      }
      if (wl == 0) d2[r] = acc;
    }
    __syncthreads();

    // --- 5. stable merge of [pool | candidates | +inf pad] ---
    if (tid == 0) {
      const float worst = keys[L - 1];
      int ins = 0, nv = 0;
      for (int r = 0; r < R; ++r) {
        ins += d2[r] < worst;
        nv += valid[r];
      }
      s_inserted = ins;
      s_nvalid = nv;
    }
    for (int i = L + tid; i < S; i += nthreads) {
      const int r = i - L;
      keys[i] = r < R ? d2[r] : __int_as_float(0x7f800000);  // +inf pad
      vid[i] = r < R ? nbr[r] : 0;
      vexp[i] = 0;
    }
    for (int i = tid; i < S; i += nthreads) pos[i] = i;
    bitonic_sort_stable(keys, pos, vid, vexp, S);

    // --- 6+7. counters, liveness, hop cap ---
    dist_count += s_nvalid;
    update_count += s_inserted;
    hops_ct += 1;
    int mine = 0;
    for (int i = tid; i < L; i += nthreads) mine |= (!vexp[i] && vid[i] != n);
    const bool still = __syncthreads_or(mine) != 0;
    active = active && still && hops_ct < a.max_hops;

    // --- 8. decision-tree termination ---
    if (has_tree) {
      const bool due = (dist_count / a.eval_gap) > evals_done && active;
      if (due) {
        if (tid == 0) {
          const float first = keys[0];
          const float kth = keys[(a.k < L ? a.k : L) - 1];
          float feats[6];
          feats[0] = a.hot_first[b];
          feats[1] = a.hot_ratio[b];
          feats[2] = first;
          feats[3] = __fdiv_rn(first, __fadd_rn(kth, DQF_EPS));
          feats[4] = __int2float_rn(dist_count);
          feats[5] = __int2float_rn(update_count);
          int node = 0;
          for (int t = 0; t < a.tree_depth; ++t) {
            const int f = max(a.t_feature[node], 0);
            node = feats[f] <= a.t_threshold[node] ? a.t_left[node]
                                                    : a.t_right[node];
          }
          s_stop = a.t_value[node] < 0.5f;
        }
        __syncthreads();
        if (s_stop && stop_at == DQF_INT_MAX) stop_at = dist_count + a.add_step;
        evals_done = dist_count / a.eval_gap;
      }
      const bool stop_now = dist_count >= stop_at;
      terminated = terminated || (stop_now && active);
      active = active && !stop_now;
    }
  }

  for (int i = tid; i < L; i += nthreads) {
    a.dists_out[(size_t)b * L + i] = keys[i];
    a.ids_out[(size_t)b * L + i] = vid[i];
    a.exp_out[(size_t)b * L + i] = vexp[i] != 0;
  }
  if (tid == 0) {
    a.active_out[b] = active;
    a.dist_count_out[b] = dist_count;
    a.update_count_out[b] = update_count;
    a.hops_out[b] = hops_ct;
    a.terminated_out[b] = terminated;
    a.evals_done_out[b] = evals_done;
    a.stop_at_out[b] = stop_at;
  }
}

template <int MODE, int M, bool PAGED>
static int launch(const HopArgs& a, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_hop_kernel<MODE, M, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_hop_kernel<MODE, M, PAGED><<<a.B, DQF_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, bool PAGED>
static int launch_width(const HopArgs& a, size_t smem, cudaStream_t st) {
  switch (halving_regs(a.tw)) {
    case 1: return launch<MODE, 1, PAGED>(a, smem, st);
    case 2: return launch<MODE, 2, PAGED>(a, smem, st);
    case 4: return launch<MODE, 4, PAGED>(a, smem, st);
    case 8: return launch<MODE, 8, PAGED>(a, smem, st);
    case 16: return launch<MODE, 16, PAGED>(a, smem, st);
    case 32: return launch<MODE, 32, PAGED>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
static int launch_mode(const HopArgs& a, size_t smem, cudaStream_t st) {
  switch (a.mode) {
    case DQF_MODE_F32: return launch_width<DQF_MODE_F32, PAGED>(a, smem, st);
    case DQF_MODE_SQ8: return launch_width<DQF_MODE_SQ8, PAGED>(a, smem, st);
    case DQF_MODE_PQ: return launch_width<DQF_MODE_PQ, PAGED>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dqf_fused_hop(const HopArgs* a, void* stream) {
  if (a->B == 0) return 0;
  size_t smem = (size_t)a->sort_len * 16 + (size_t)a->R * 12;
  if (a->mode == DQF_MODE_PQ) smem += (size_t)a->tw * a->K * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->pt != nullptr) return launch_mode<true>(*a, smem, st);
  return launch_mode<false>(*a, smem, st);
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
