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
// Paged mode (a non-null page table) also replaces
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
// and the zeroed tail) are the same bytes from every block.
//
// Per-lane table base (lane_base, null-able (B,) int32): lane b reads
// adjacency row lane_base[b] + p, table row lane_base[b] + v and liveness
// entry lane_base[b] + v, with its ids local (sentinel n): the stacked
// multi-tenant hot phase, a (T, n+1, .) stack read as (T (n+1), .).
//
// Each hop follows ref.fused_hop_body: frontier, adjacency row, seen/live
// dedup, score, stable merge, counters, hop cap, tree check.  The modes
// differ in the score only.  Inactive lanes leave the hop loop at once
// (their remaining hops are exact no-ops), so a launch with hops = max_hops
// carries every lane to retirement: the search loops make one launch a
// phase (core/beam_search.py::fused_beam_loop).
//
// Design (redesigned for the H100; the first port ran one 128-thread block
// a lane with 4 barriers and a 28-stage block-wide network a hop):
//   * one warp a lane, one lane a block: no block-wide barrier anywhere,
//     only __syncwarp; the pool sits in shared memory, double-buffered;
//   * frontier, counts and the "still open" test are warp ballots (the
//     first unexpanded non-sentinel slot is the first set bit);
//   * the R adjacency ids and their seen and liveness bytes are read
//     together (one 32-wide load each, seen before any write, so an id
//     twice in a row is valid, scored and merged twice, as in the plain
//     version); the valid rows are compacted by ballot;
//   * every valid row of the hop is fetched at once into a shared stage of
//     up to 48 KB: a Hopper bulk copy a row (cp.async.bulk, one lane a row,
//     completion on an mbarrier) when rows are 16-byte multiples on a
//     16-byte aligned table, else cp.async pieces of 8 or 4 bytes (a row a
//     lane for narrow rows); rows wider than the stage come in chunks,
//     rows wider than 64 KB are read in place;
//   * scoring: lane l takes components l + 32 j (j < M, M = halving_regs;
//     past width 1024 each register folds components c + 1024 t with
//     halving_fold) and halves them in registers; eight rows then finish
//     together in a transposed butterfly (halving.cuh::butterfly8_sum:
//     shuffles over lane bits 16, 8, 4 exchange row halves, then 2 and 1),
//     9 shuffles for 8 rows where a per-row warp sum takes 40.  Each add pairs the same components as
//     ref.halving_sum (__fsub_rn/__fmul_rn/__fadd_rn, --fmad=false);
//   * merge: the pool is sorted after every hop, so for R <= 32 and
//     L <= 64 (every configuration of the repo) every entry is placed by
//     rank: pool entry i goes to i + #(candidates with key < its key),
//     candidate j to j' + #(pool entries with key <= its key), where j' is
//     its rank among the candidates by (key, position), kept below L; both
//     counts come from R shuffles of the candidates' keys round the warp.
//     That is the stable sort of [pool | candidates | +inf pad] of the
//     plain version.  A lane whose input pool is not sorted runs the full
//     (key, position) network (warp_bitonic_sort_stable) once, and larger
//     R or L run it every hop;
//   * the tree arrays are staged in shared memory once a launch (up to
//     16 KB) and walked by lane 0; pq stages the lane's (M, K) LUT up to
//     64 KB and reads a larger one from device memory, sq8 keeps scale and
//     zero in registers, f32 and sq8 the query.
// Tried on an H100 and slower, so left out: issuing every non-sentinel
// row's copy before the seen bytes arrive, an L2 prefetch of the likely
// next adjacency rows, and sorting the candidates in registers
// (bitonic.cuh::warp_sort_kv) in place of the shuffle counts.
//
// Bound on the H100: device-memory bytes.  A hop moves one adjacency row
// (R x 4 bytes), R seen bytes read and written (in paged mode also R x 4
// bytes of page-table entries, and once per launch the zeroed tail of the
// lane's last page), R liveness bytes, and one table row per valid
// neighbour (d x 4 bytes in f32, d bytes in sq8, M bytes in pq): in all
// about sum(dist_count) x row bytes + hops x R x (4 + 1 + 1 + 1) bytes,
// plus the pool state read and written once per launch and, in pq, the
// B x M x K x 4 bytes of LUTs.  There are almost no FLOPs.  What the chain
// cannot hide is latency: each hop waits for the adjacency row, then its
// seen bytes, then the rows, one after another, and a lane is one warp
// (about 8 a SM at B = 1024), so little else runs in the meantime.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "halving.cuh"

#define DQF_INF_DIST 3.0e38f
#define DQF_EPS 1e-12f
#define DQF_INT_MAX 2147483647
#define DQF_MODE_F32 0
#define DQF_MODE_SQ8 1
#define DQF_MODE_PQ 2
#define HOP_FULL 0xffffffffu
#define HOP_STAGE_BYTES (48 * 1024)   // row stage of a lane, at most
#define HOP_DIRECT_ROW (64 * 1024)    // rows wider than this are read in place
#define HOP_LUT_SMEM (64 * 1024)      // pq LUT staged up to this size
#define HOP_TREE_SMEM (16 * 1024)     // tree arrays staged up to this size
#define HOP_SMEM_MAX (227 * 1024)

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
  // (B,) row offset of each lane's tables, or null (offset 0)
  const int32_t* lane_base;
  int32_t B, L, R, n, d;
  int32_t hops, max_hops, k, eval_gap, add_step, tree_depth, sort_len;
  int32_t mode, tw, K;     // score mode, table row width, pq centroids
  int32_t ppl, page_shift; // paged mode: pages per lane, log2(page_cols)
  int32_t tree_nodes;      // entries of each tree array
  int32_t copy_vec;        // bytes a row copy moves at once: 16, 8, 4 or 1
};

// Byte offsets of a block's shared memory, the same on host and device.
struct HopLayout {
  int bar;               // the row copies' mbarrier (8 bytes)
  int pool[2];           // keys (L float), ids (L int), expanded (L byte)
  int d2, nbr, vrow;     // R float, R int, R int
  int lut, tree, scratch;
  int total;
  int row_bytes, rstride, stage_rows, sort_len;
  bool lut_smem, tree_smem, direct;
};

__host__ __device__ inline int hop_align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline HopLayout hop_layout(const HopArgs& a) {
  HopLayout o;
  const int L = a.L, R = a.R;
  o.row_bytes = a.mode == DQF_MODE_F32 ? a.tw * 4 : a.tw;
  o.rstride = hop_align16(o.row_bytes);
  o.direct = o.rstride > HOP_DIRECT_ROW;
  int sr = HOP_STAGE_BYTES / o.rstride;
  sr = sr < 1 ? 1 : (sr > R ? R : sr);
  o.stage_rows = o.direct ? R : sr;
  o.sort_len = a.sort_len;
  int off = 0;
  o.bar = off; off += 16;
  for (int i = 0; i < 2; ++i) {
    o.pool[i] = off;
    off += hop_align16(9 * L);
  }
  o.d2 = off; off += hop_align16(4 * R);
  o.nbr = off; off += hop_align16(4 * R);
  o.vrow = off; off += hop_align16(4 * R);
  const long long lut_bytes = (long long)a.tw * a.K * 4;
  o.lut_smem = a.mode == DQF_MODE_PQ && lut_bytes <= HOP_LUT_SMEM;
  o.lut = off; off += o.lut_smem ? hop_align16((int)lut_bytes) : 0;
  const long long tree_bytes = a.t_feature ? (long long)a.tree_nodes * 20 : 0;
  o.tree_smem = a.t_feature != nullptr && tree_bytes <= HOP_TREE_SMEM;
  o.tree = off; off += o.tree_smem ? hop_align16((int)tree_bytes) : 0;
  // the stage is free while the pool merges, so the full network's
  // scratch (key, position, id, expanded) shares its bytes
  const int stage = o.direct ? 0 : o.stage_rows * o.rstride;
  const int full = 16 * a.sort_len;
  o.scratch = off; off += stage > full ? stage : full;
  o.total = off;
  return o;
}

// One lane's seen bitmap: its dense row, or (pt not null) its pages of the
// pool reached through its page-table row.
struct SeenRow {
  uint8_t* base;       // dense: the lane's row; paged: the pool
  const int32_t* pt;   // paged: the lane's page-table row (ppl,)
  int shift;           // paged: log2(page_cols)
  __device__ __forceinline__ uint8_t& operator[](int v) const {
    if (pt != nullptr)
      return base[((size_t)pt[v >> shift] << shift)
                  + (v & ((1 << shift) - 1))];
    return base[v];
  }
};

// A lane's score operands.
template <int M>
struct Scorer {
  float q[M], sc[M], ze[M];    // components lane + 32 j (fold 1 only)
  const float* qg;             // the query row (global), for folded widths
  const float* scg;            // sq8 scale and zero (global)
  const float* zeg;
  const float* lut;            // pq: the lane's (tw, K) LUT
  int tw, d, K, fold;
};

// Score term of component c of a row (zero past the width): the squared
// difference (f32, sq8 decoded in two roundings) or the looked-up value.
template <int MODE>
__device__ __forceinline__ float hop_term(const unsigned char* row, int c,
                                          int tw, float q, float sc,
                                          float ze, const float* lut,
                                          int K) {
  if (MODE == DQF_MODE_F32) {
    const float x = c < tw ? reinterpret_cast<const float*>(row)[c] : 0.f;
    const float diff = __fsub_rn(x, q);
    return __fmul_rn(diff, diff);
  } else if (MODE == DQF_MODE_SQ8) {
    const float g =
        c < tw ? __fadd_rn(__fmul_rn(
                     (float)reinterpret_cast<const int8_t*>(row)[c], sc), ze)
               : 0.f;
    const float diff = __fsub_rn(g, q);
    return __fmul_rn(diff, diff);
  }
  return c < tw ? lut[c * K + (int)row[c]] : 0.f;
}

// Lane `lane`'s partial of one row: the in-register halvings of
// warp_halving_sum, the value at position `lane` of the 32 that remain.
// Past width 1024 (M = 32, fold > 1) register j folds c + 1024 t first.
template <int MODE, int M>
__device__ __forceinline__ float hop_lane_partial(const unsigned char* row,
                                                  const Scorer<M>& s,
                                                  int lane) {
  float v[M];
  if (M < 32 || s.fold == 1) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      v[j] = hop_term<MODE>(row, lane + 32 * j, s.tw, s.q[j], s.sc[j],
                            s.ze[j], s.lut, s.K);
  } else {
#pragma unroll 1
    for (int j = 0; j < M; ++j) {
      const int c = lane + 32 * j;
      v[j] = halving_fold([&](int t) {
        const int cc = c + 1024 * t;
        const float qv = MODE != DQF_MODE_PQ && cc < s.d ? s.qg[cc] : 0.f;
        const bool dec = MODE == DQF_MODE_SQ8 && cc < s.tw;
        return hop_term<MODE>(row, cc, s.tw, qv, dec ? s.scg[cc] : 0.f,
                              dec ? s.zeg[cc] : 0.f, s.lut, s.K);
      }, s.fold);
    }
  }
#pragma unroll
  for (int w = M / 2; w >= 1; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = __fadd_rn(v[j], v[j + w]);
  }
  return v[0];
}

__device__ __forceinline__ unsigned hop_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The row stage's mbarrier: arrival count 1 (lane 0's expect_tx), then one
// phase per chunk of rows.
__device__ __forceinline__ void hop_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               ::"r"(hop_smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void hop_bar_expect(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(hop_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void hop_bar_wait(uint64_t* bar,
                                             unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(hop_smem(bar)), "r"(phase) : "memory");
  }
}

// One bulk copy (the TMA engine) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared, completing on `bar`.
__device__ __forceinline__ void hop_bulk_copy(unsigned char* dst,
                                              const unsigned char* src,
                                              unsigned bytes,
                                              uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(hop_smem(dst)), "l"(src), "r"(bytes),
                 "r"(hop_smem(bar)) : "memory");
}

// `vec` bytes (8, 4 or 1) from global to shared: a cp.async, or a plain
// copy of a byte; 16-byte rows go by bulk copy instead.
__device__ __forceinline__ void hop_copy(unsigned char* dst,
                                         const unsigned char* src, int vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else if (vec == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  else
    *dst = *src;
}

// A pool buffer in shared memory.
struct Pool {
  float* key;
  int* id;
  uint8_t* exp;
};

__device__ __forceinline__ Pool hop_pool(unsigned char* smem, int off,
                                         int L) {
  Pool p;
  p.key = reinterpret_cast<float*>(smem + off);
  p.id = reinterpret_cast<int*>(smem + off + 4 * L);
  p.exp = smem + off + 8 * L;
  return p;
}

// First unexpanded, non-sentinel slot of the pool, or -1.  Warp-uniform.
__device__ __forceinline__ int hop_first_open(const Pool& p, int L, int n,
                                              int lane) {
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int i = i0 + lane;
    const unsigned m =
        __ballot_sync(HOP_FULL, i < L && !p.exp[i] && p.id[i] != n);
    if (m) return i0 + __ffs(m) - 1;
  }
  return -1;
}

// Number of the first n entries of ascending `keys` at most `key`.
__device__ __forceinline__ int hop_count_at_most(const float* keys, int n,
                                                 float key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Rank merge for R <= 32 and L <= 32 T: the candidates' keys go round the
// warp in R shuffles; each lane counts, for its candidate, the candidates
// before it by (key, position) and, for its T pool entries, the
// candidates below them.
template <int T>
__device__ __forceinline__ void hop_count_merge(const Pool& cur,
                                                const Pool& nxt,
                                                const float* d2,
                                                const int* nbr, int L, int R,
                                                int lane) {
  const float inf = __int_as_float(0x7f800000);
  const float kc = lane < R ? d2[lane] : inf;
  float pk[T];
  int ps[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = lane + 32 * t;
    pk[t] = i < L ? cur.key[i] : inf;
    ps[t] = i;
  }
  int before = 0;
#pragma unroll 8
  for (int j = 0; j < R; ++j) {
    const float kj = __shfl_sync(HOP_FULL, kc, j);
    before += kj < kc || (kj == kc && j < lane);
#pragma unroll
    for (int t = 0; t < T; ++t) ps[t] += kj < pk[t];
  }
  if (lane < R) {
    const int s = before + hop_count_at_most(cur.key, L, kc);
    if (s < L) {
      nxt.key[s] = kc;
      nxt.id[s] = nbr[lane];
      nxt.exp[s] = 0;
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = lane + 32 * t;
    if (i < L && ps[t] < L) {
      nxt.key[ps[t]] = pk[t];
      nxt.id[ps[t]] = cur.id[i];
      nxt.exp[ps[t]] = cur.exp[i];
    }
  }
}

// The full network: a pool that is not sorted, R > 32 or L > 64.
__device__ __forceinline__ void hop_full_merge(const Pool& cur,
                                               const Pool& nxt,
                                               const float* d2,
                                               const int* nbr,
                                               unsigned char* scratch,
                                               int L, int R, int S,
                                               int lane) {
  float* fk = reinterpret_cast<float*>(scratch);
  int* fp = reinterpret_cast<int*>(fk + S);
  int* fi = fp + S;
  int* fe = fi + S;
  for (int i = lane; i < S; i += 32) {
    const int r = i - L;
    fk[i] = i < L ? cur.key[i]
                  : (r < R ? d2[r] : __int_as_float(0x7f800000));
    fi[i] = i < L ? cur.id[i] : (r < R ? nbr[r] : 0);
    fe[i] = i < L ? cur.exp[i] : 0;
    fp[i] = i;
  }
  __syncwarp();
  warp_bitonic_sort_stable(fk, fp, fi, fe, S, lane);
  for (int i = lane; i < L; i += 32) {
    nxt.key[i] = fk[i];
    nxt.id[i] = fi[i];
    nxt.exp[i] = fe[i] != 0;
  }
}

template <int MODE, int M, bool DIRECT>
__global__ void __launch_bounds__(32)
fused_hop_kernel(const HopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const HopLayout lay = hop_layout(a);
  const int L = a.L, R = a.R, n = a.n, tw = a.tw;
  const int b = blockIdx.x, lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  Pool cur = hop_pool(smem, lay.pool[0], L);
  Pool nxt = hop_pool(smem, lay.pool[1], L);
  float* d2 = reinterpret_cast<float*>(smem + lay.d2);
  int* nbr = reinterpret_cast<int*>(smem + lay.nbr);
  int* vrow = reinterpret_cast<int*>(smem + lay.vrow);
  unsigned char* stage = smem + lay.scratch;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const bool bulk = !DIRECT && a.copy_vec == 16;
  unsigned bar_phase = 0;
  if (bulk && lane == 0) hop_bar_init(bar);
  const bool has_tree = a.t_feature != nullptr;
  const int base = a.lane_base != nullptr ? a.lane_base[b] : 0;
  const int32_t* adj = a.adj + (size_t)base * R;
  const unsigned char* table =
      static_cast<const unsigned char*>(a.table) + (size_t)base * lay.row_bytes;
  const uint8_t* live = a.live != nullptr ? a.live + base : nullptr;

  for (int i = lane; i < L; i += 32) {
    cur.key[i] = a.dists_in[(size_t)b * L + i];
    cur.id[i] = a.ids_in[(size_t)b * L + i];
    cur.exp[i] = a.exp_in[(size_t)b * L + i] != 0;
  }
  // Warp-uniform lane state.
  bool active = a.active_in[b] != 0;
  int dist_count = a.dist_count_in[b];
  int update_count = a.update_count_in[b];
  int hops_ct = a.hops_in[b];
  bool terminated = a.terminated_in[b] != 0;
  int evals_done = a.evals_done_in[b];
  int stop_at = a.stop_at_in[b];

  Scorer<M> sc;
  sc.tw = tw;
  sc.d = a.d;
  sc.K = a.K;
  sc.fold = halving_fold_of(tw);
  sc.qg = a.queries + (size_t)b * a.d;
  sc.scg = a.t1;
  sc.zeg = a.t2;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int c = lane + 32 * j;
    const bool regs = sc.fold == 1;
    sc.q[j] = (MODE != DQF_MODE_PQ && regs && c < a.d) ? sc.qg[c] : 0.f;
    sc.sc[j] = (MODE == DQF_MODE_SQ8 && regs && c < tw) ? a.t1[c] : 0.f;
    sc.ze[j] = (MODE == DQF_MODE_SQ8 && regs && c < tw) ? a.t2[c] : 0.f;
  }
  sc.lut = nullptr;
  if (MODE == DQF_MODE_PQ) {
    const float* src = a.t1 + (size_t)b * tw * a.K;
    if (lay.lut_smem) {
      float* lut = reinterpret_cast<float*>(smem + lay.lut);
      for (int i = lane; i < tw * a.K; i += 32) lut[i] = src[i];
      sc.lut = lut;
    } else {
      sc.lut = src;
    }
  }
  const int32_t* tf = a.t_feature;
  const float* tt = a.t_threshold;
  const int32_t* tl = a.t_left;
  const int32_t* tr = a.t_right;
  const float* tv = a.t_value;
  float hot_first = 0.f, hot_ratio = 0.f;
  if (has_tree) {
    hot_first = a.hot_first[b];
    hot_ratio = a.hot_ratio[b];
    if (lay.tree_smem) {
      const int T = a.tree_nodes;
      int* s_f = reinterpret_cast<int*>(smem + lay.tree);
      float* s_t = reinterpret_cast<float*>(s_f + T);
      int* s_l = reinterpret_cast<int*>(s_t + T);
      int* s_r = s_l + T;
      float* s_v = reinterpret_cast<float*>(s_r + T);
      for (int i = lane; i < T; i += 32) {
        s_f[i] = tf[i];
        s_t[i] = tt[i];
        s_l[i] = tl[i];
        s_r[i] = tr[i];
        s_v[i] = tv[i];
      }
      tf = s_f; tt = s_t; tl = s_l; tr = s_r; tv = s_v;
    }
  }
  SeenRow seen;
  if (a.pt != nullptr) {
    seen.base = a.seen;
    seen.pt = a.pt + (size_t)b * a.ppl;
    seen.shift = a.page_shift;
    // columns past n of the last page: zeros, as the plain version writes
    // them back; no hop reads or writes them
    const int page_cols = 1 << a.page_shift;
    uint8_t* last = a.seen + ((size_t)seen.pt[a.ppl - 1] << a.page_shift);
    for (int c = (n + 1) - (a.ppl - 1) * page_cols + lane; c < page_cols;
         c += 32)
      last[c] = 0;
  } else {
    seen.base = a.seen + (size_t)b * (n + 1);
    seen.pt = nullptr;
    seen.shift = 0;
  }
  __syncwarp();

  // A pool that is not sorted takes the full network on its first hop;
  // every merge leaves the pool sorted.
  bool unsorted = false;
  for (int i = lane + 1; i < L; i += 32)
    unsorted |= cur.key[i - 1] > cur.key[i];
  bool sorted = !__any_sync(HOP_FULL, unsorted);
  int slot = hop_first_open(cur, L, n, lane);

  for (int h = 0; h < a.hops; ++h) {
    // --- 1. frontier ---
    if (!(active && slot >= 0)) {
      // lane is False: the plain hop scatters only the sentinel column and
      // retires the lane; every later hop is the same no-op.
      if (lane == 0) seen[n] = 1;
      active = false;
      break;
    }
    const int p = cur.id[slot];
    const float worst = cur.key[L - 1];

    // --- 2+3. adjacency row, seen/live dedup: read all, then write ---
    int nv = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      bool ok = false;
      int v = n;
      if (r < R) {
        v = adj[(size_t)p * R + r];
        const bool was = seen[v] != 0;
        const bool alive = live == nullptr || live[v] != 0;
        ok = v != n && !was && alive;
      }
      const unsigned m = __ballot_sync(HOP_FULL, ok);
      if (r < R) {
        nbr[r] = ok ? v : n;
        d2[r] = DQF_INF_DIST;
        if (ok) vrow[nv + __popc(m & below)] = r;
      }
      nv += __popc(m);
    }
    if (lane == 0) cur.exp[slot] = 1;
    __syncwarp();
    for (int r = lane; r < R; r += 32) seen[nbr[r]] = 1;

    // --- 4. rows of every valid neighbour, then their scores ---
    for (int c0 = 0; c0 < nv; c0 += lay.stage_rows) {
      const int cn = min(lay.stage_rows, nv - c0);
      if (bulk) {
        if (lane == 0) hop_bar_expect(bar, (unsigned)(cn * lay.row_bytes));
        __syncwarp();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int s = lane; s < cn; s += 32)
          hop_bulk_copy(stage + s * lay.rstride,
                        table + (size_t)nbr[vrow[c0 + s]] * lay.row_bytes,
                        (unsigned)lay.row_bytes, bar);
        hop_bar_wait(bar, bar_phase);
        bar_phase ^= 1;
      } else if (!DIRECT) {
        const int vec = a.copy_vec, per = lay.row_bytes / vec;
        if (per >= 32) {      // wide rows: a row a warp instruction
          for (int s = 0; s < cn; ++s) {
            const unsigned char* src =
                table + (size_t)nbr[vrow[c0 + s]] * lay.row_bytes;
            unsigned char* dst = stage + s * lay.rstride;
            for (int o = lane; o < per; o += 32)
              hop_copy(dst + o * vec, src + o * vec, vec);
          }
        } else {              // narrow rows: a row a lane
          for (int s = lane; s < cn; s += 32) {
            const unsigned char* src =
                table + (size_t)nbr[vrow[c0 + s]] * lay.row_bytes;
            unsigned char* dst = stage + s * lay.rstride;
            for (int o = 0; o < per; ++o)
              hop_copy(dst + o * vec, src + o * vec, vec);
          }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
      }
      for (int g0 = 0; g0 < cn; g0 += 8) {
        float x[8];
        auto partial = [&](int g) {
          const int s = g0 + g;
          x[g] = 0.f;
          if (s < cn) {
            const unsigned char* row =
                DIRECT ? table + (size_t)nbr[vrow[c0 + s]] * lay.row_bytes
                       : stage + s * lay.rstride;
            x[g] = hop_lane_partial<MODE, M>(row, sc, lane);
          }
        };
        if (M < 32) {
#pragma unroll
          for (int g = 0; g < 8; ++g) partial(g);
        } else {
#pragma unroll 1
          for (int g = 0; g < 8; ++g) partial(g);
        }
        const float sum = butterfly8_sum(x, lane);
        const int s = g0 + (lane >> 2);
        if ((lane & 3) == 0 && s < cn) d2[vrow[c0 + s]] = sum;
      }
      __syncwarp();
    }

    // --- 5. counters of the hop, then the merge into the other buffer ---
    int ins = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      ins += __popc(__ballot_sync(HOP_FULL, r < R && d2[r] < worst));
    }
    if (sorted && R <= 32 && L <= 32) {
      hop_count_merge<1>(cur, nxt, d2, nbr, L, R, lane);
    } else if (sorted && R <= 32 && L <= 64) {
      hop_count_merge<2>(cur, nxt, d2, nbr, L, R, lane);
    } else {
      hop_full_merge(cur, nxt, d2, nbr, stage, L, R, lay.sort_len, lane);
      sorted = true;
    }
    __syncwarp();
    const Pool t = cur; cur = nxt; nxt = t;

    // --- 6+7. counters, liveness, hop cap ---
    dist_count += nv;
    update_count += ins;
    hops_ct += 1;
    slot = hop_first_open(cur, L, n, lane);
    active = active && slot >= 0 && hops_ct < a.max_hops;

    // --- 8. decision-tree termination ---
    if (has_tree) {
      const bool due = (dist_count / a.eval_gap) > evals_done && active;
      if (due) {
        int stop = 0;
        if (lane == 0) {
          const float first = cur.key[0];
          const float kth = cur.key[(a.k < L ? a.k : L) - 1];
          float feats[6];
          feats[0] = hot_first;
          feats[1] = hot_ratio;
          feats[2] = first;
          feats[3] = __fdiv_rn(first, __fadd_rn(kth, DQF_EPS));
          feats[4] = __int2float_rn(dist_count);
          feats[5] = __int2float_rn(update_count);
          int node = 0;
          for (int t2 = 0; t2 < a.tree_depth; ++t2) {
            const int f = max(tf[node], 0);
            node = feats[f] <= tt[node] ? tl[node] : tr[node];
          }
          stop = tv[node] < 0.5f;
        }
        stop = __shfl_sync(HOP_FULL, stop, 0);
        if (stop && stop_at == DQF_INT_MAX) stop_at = dist_count + a.add_step;
        evals_done = dist_count / a.eval_gap;
      }
      const bool stop_now = dist_count >= stop_at;
      terminated = terminated || (stop_now && active);
      active = active && !stop_now;
    }
  }

  for (int i = lane; i < L; i += 32) {
    a.dists_out[(size_t)b * L + i] = cur.key[i];
    a.ids_out[(size_t)b * L + i] = cur.id[i];
    a.exp_out[(size_t)b * L + i] = cur.exp[i] != 0;
  }
  if (lane == 0) {
    a.active_out[b] = active;
    a.dist_count_out[b] = dist_count;
    a.update_count_out[b] = update_count;
    a.hops_out[b] = hops_ct;
    a.terminated_out[b] = terminated;
    a.evals_done_out[b] = evals_done;
    a.stop_at_out[b] = stop_at;
  }
}

template <int MODE, int M, bool DIRECT>
static int launch(const HopArgs& a, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_hop_kernel<MODE, M, DIRECT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_hop_kernel<MODE, M, DIRECT><<<a.B, 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
static int launch_width(const HopArgs& a, const HopLayout& lay,
                        cudaStream_t st) {
  const size_t smem = (size_t)lay.total;
  if (lay.direct) return launch<MODE, 32, true>(a, smem, st);
  switch (halving_regs(a.tw)) {
    case 1: return launch<MODE, 1, false>(a, smem, st);
    case 2: return launch<MODE, 2, false>(a, smem, st);
    case 4: return launch<MODE, 4, false>(a, smem, st);
    case 8: return launch<MODE, 8, false>(a, smem, st);
    case 16: return launch<MODE, 16, false>(a, smem, st);
    default: return launch<MODE, 32, false>(a, smem, st);
  }
}

extern "C" int dqf_fused_hop(const HopArgs* a, void* stream) {
  if (a->B == 0) return 0;
  if (a->L < 1 || a->R < 1 || a->tw < 1 ||
      !(a->copy_vec == 16 || a->copy_vec == 8 || a->copy_vec == 4 ||
        a->copy_vec == 1))
    return (int)cudaErrorInvalidValue;
  const HopLayout lay = hop_layout(*a);
  if (lay.total > HOP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a->mode) {
    case DQF_MODE_F32: return launch_width<DQF_MODE_F32>(*a, lay, st);
    case DQF_MODE_SQ8: return launch_width<DQF_MODE_SQ8>(*a, lay, st);
    case DQF_MODE_PQ: return launch_width<DQF_MODE_PQ>(*a, lay, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dqf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
