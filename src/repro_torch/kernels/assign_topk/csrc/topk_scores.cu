// topk_scores — fused x·embᵀ scoring with a running top-k, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/assign_topk/kernel.py::_topk_kernel
// with its selection _select_topk (entry topk_scores, pallas_call at
// kernel.py:124): per row of x, the k largest plain inner products with the
// rows of emb (no -½‖c‖² bias), ordered by score descending and, on equal
// scores, by index ascending — lax.top_k's order.
//
// Bound on the H100: operations.  2·N·L·h fp32 multiply-adds against the
// 67 TFLOP/s non-tensor-core fp32 peak (TF32 tensor cores would change the
// dispatch ids on near-ties, so the products stay in fp32 FMAs); the inputs
// are small (emb is 31 MB at L=10,000, h=768) and the (N, L) score plane is
// never written.
//
// Design.  A block of kThreads (256) takes kQB (32) queries and one slice
// of the centroids, and walks that slice in tiles of kCT (256) centroids.
//
//   * Loads.  Each tile's x and emb rows stream through shared memory in
//     chunks of kHC (32) features, copied global → shared by cp.async into
//     kStages (2) stages: the next chunk (of this tile or the next) is in
//     flight while the current one is multiplied, with one block barrier a
//     chunk.  The ragged N, L and h edges are zero-filled through the
//     copy's source size.  The 16-byte instance (VEC) needs x and emb
//     16-byte aligned and h % 4 == 0, which the C entry checks, and sets a
//     thread's row pointers once per tile; otherwise the same kernel copies
//     4 bytes an element (VEC = false).
//   * Register tiles.  Warps form a kQWarps x kCWarps (2 x 4) grid over
//     the score tile and each warp's lanes a kLQ x kLC (4 x 8) grid, so a
//     thread owns kTQ = 4 queries (rows lq + 4 i of its warp's 16) by kTC =
//     8 centroids (lc + 8 r of its warp's 64).  x and emb chunks are kept
//     row-major with rows padded to kHC + 4 floats, so one 128-bit shared
//     read gives 4 consecutive features of a row without bank conflicts: a
//     warp's x reads touch 4 rows (broadcast to 8 lanes each), its emb
//     reads 8.  That is 12 such reads per 128 FMAs a thread, where the
//     parent read 6 scalars per 8.
//   * Order.  Each accumulator takes its features in the order d = 0 ..
//     h-1, one fmaf each (zero-filled features add exact zeros), as the
//     kernel always has, so scores — and with them the ids — equal the
//     earlier kernels' bit for bit, whatever the tiling.  A quad of
//     features goes across all 32 accumulators one feature at a time, so
//     the fmafs chained on one accumulator lie 32 instructions apart.
//   * Selection.  Each query keeps a running list of its best P = 32·KPL
//     candidates in shared memory, best first (P the power of two >= k,
//     at least 32; KPL keys a lane of the warp that merges the query), and
//     the list's k-th entry as its admission bar, which only rises.  At
//     the end of a tile every thread tests its kTQ·kTC scores against
//     their queries' bars where they were produced, in registers; those
//     that beat the bar take slots of their query's kBuf-slot buffer,
//     ranked among the kLC lanes that share the query by a ballot a
//     centroid column and reserved by one shared atomic a lane group.
//     After a barrier, one warp a query (kQB / kWarps = 4 queries a warp)
//     sorts a chunk of P buffered candidates worst first by a bitonic
//     network in registers (__shfl_xor_sync across lanes, compare-
//     exchanges within a lane), keeps the better of each list / chunk
//     pair (the top P, as a bitonic sequence) and sorts that best first by
//     the network's last log2 P steps: a fixed cost a chunk, however many
//     candidates it holds.  The networks are latency-bound chains of
//     shuffles, so a warp runs those of its (up to four) queries with
//     candidates side by side, or two chunks of a lone query.  A
//     buffer that fills leaves the rest pending: after the merge they are
//     tested against the risen bar and offered again in another round
//     (__syncthreads_or), so every order of scores gives the same top k.
//     Slices run in parallel to fill the card; every block writes its
//     slice's k best to a small (N, n_slices, k) scratch, and the last
//     block of a query tile to finish (an atomic ticket after a memory
//     fence) merges each query's slice lists by a tree of pairwise merges
//     in place in the scratch, ceil(log2 n_slices) rounds with the pairs
//     of a round spread over its warps, the last round writing the (N, k)
//     result.  One launch per call.
//   * What the selection replaced (PERF.md §6).  The earlier kernel took
//     0.434 ms at the served shape (N 256, L 10,000, h 768, k 30; 14
//     slices of 3 tiles) and 0.202 ms without its per-tile merge: each
//     tile went through a 33.8 KB score tile in shared memory and was
//     merged into the lists one candidate at a time (4 ballots, a shift of
//     the list and 2 __syncwarp an insert; ~127 inserts a query a slice at
//     random order, ~500 a warp, while the other warps' products waited at
//     the next barrier), and the last block inserted the 14 × 30 slice
//     entries a query the same way (40 × 30 at N <= 32).  Now a query's
//     merge is a few fixed-cost network passes (after a slice's first
//     tile, ~21 and then ~12 candidates a tile pass the bar at random
//     order) and the slice merge ceil(log2 n_slices) rounds: 0.205 ms at
//     the served shape, 0.177 without the selection (H100 80GB HBM3 at
//     700 W).
//   * Residency.  The stages, the lists and the buffers take 145 KB of
//     dynamic shared memory: one block (8 warps) an SM, its registers
//     uncapped (PERF.md §6 has ptxas' counts).  Two blocks an SM at 16-
//     feature chunks, or 16-query blocks, measured slower (PERF.md §6).
//     The wrapper sizes the slices so that one wave covers the grid
//     (topk_scores_tiles reports the tile shape and the occupancy).
#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// The tile shape: queries a thread owns (by kTC centroids), lanes of a
// warp along the queries (the rest along the centroids), warps along the
// queries (kCWarps along the centroids), features a chunk, chunks in
// flight, the blocks per SM the registers are capped for, and a query's
// candidate slots a round.  One constant a line: the variants tool builds
// other shapes from copies.
constexpr int kTQ = 4;
constexpr int kTC = 8;
constexpr int kLQ = 4;
constexpr int kLC = 32 / kLQ;
constexpr int kQWarps = 2;
constexpr int kCWarps = 4;
constexpr int kHC = 32;          // features per chunk
constexpr int kStages = 2;
constexpr int kMinBlocks = 1;
constexpr int kBuf = 128;        // candidate slots a query a round
constexpr int kQB = kQWarps * kLQ * kTQ;    // queries per block
constexpr int kCT = kCWarps * kLC * kTC;    // centroids per tile
constexpr int kRow = kHC + 4;    // padded row: conflict-free 128-bit reads
constexpr int kThreads = kQWarps * kCWarps * 32;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;       // list keys a query: 4 a lane
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQB % kWarps == 0, "whole queries per merging warp");
static_assert(kHC % 4 == 0 && 32 % kLQ == 0 && kLC >= 8,
              "4-feature reads; a quarter warp reads 8 centroid rows");
static_assert(kStages >= 2, "a chunk in flight while one is multiplied");
static_assert(kTQ * kTC <= 32, "a thread's candidates in one bit mask");
static_assert(kBuf >= 1, "a buffer slot a query");
static_assert(kQB / kWarps == 4, "a warp merges 4 queries");

struct Shared {
  alignas(16) float x[kStages][kQB][kRow];    // stages of chunks
  alignas(16) float e[kStages][kCT][kRow];
  float ls[kQB][kMaxK];          // running top-P list per query, best
  int li[kQB][kMaxK];            // first: scores and indices
  float bs[kQB][kBuf];           // this round's candidates per query
  int bi[kQB][kBuf];
  float bar_s[kQB];              // the list's k-th entry: the bar a
  int bar_i[kQB];                // candidate must beat
  int bn[kQB];                   // candidates offered this round (may
                                 // pass kBuf: the rest stay pending)
  int is_last;
};

// VEC: one 16-byte copy, else 4 bytes; zeros when !in
template <bool VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies of chunks into the stages.  A thread copies the same kW
// features of every kRowsPer-th of the kQB + kCT rows (queries first).
// VEC: 16 bytes a copy (h % 4 == 0) from row pointers set once per tile;
// else 4 bytes, addressed anew each chunk.  Zeros past N, hi and h.
template <bool VEC>
struct Copier {
  static constexpr int kW = VEC ? 4 : 1;      // floats a copy
  static constexpr int kPerRow = kHC / kW;
  static constexpr int kRowsPer = kThreads / kPerRow;
  static constexpr int kRows = kQB + kCT;
  static constexpr int kPasses = (kRows + kRowsPer - 1) / kRowsPer;
  static_assert(kThreads % kPerRow == 0, "whole rows a pass");

  const float* x;
  const float* emb;
  int N, h, d, row0, q0, c0, hi;
  const float* src[VEC ? kPasses : 1];   // this tile's rows (VEC)
  bool live[VEC ? kPasses : 1];

  __device__ __forceinline__ bool has(int j) const {
    return kRows % kRowsPer == 0 || row0 + j * kRowsPer < kRows;
  }
  __device__ __forceinline__ float* dst(Shared& sm, int buf, int row) const {
    return row < kQB ? &sm.x[buf][row][d] : &sm.e[buf][row - kQB][d];
  }
  // row → (pointer to its feature d, whether it exists)
  __device__ __forceinline__ const float* row_src(int row, bool& ok) const {
    const bool xrow = row < kQB;
    const int g = xrow ? q0 + row : c0 + row - kQB;
    ok = xrow ? g < N : g < hi;
    return (xrow ? x : emb) + static_cast<size_t>(ok ? g : 0) * h + d;
  }
  __device__ __forceinline__ void tile(int tile_c0) {
    c0 = tile_c0;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kPasses; ++j)
        if (has(j)) src[j] = row_src(row0 + j * kRowsPer, live[j]);
    }
  }
  __device__ __forceinline__ void chunk(Shared& sm, int buf, int h0) const {
    const bool din = h0 + d < h;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kPasses; ++j) {
        if (!has(j)) break;
        const bool in = din && live[j];
        cp_async<true>(dst(sm, buf, row0 + j * kRowsPer),
                       in ? src[j] + h0 : src[j], in);
      }
    } else {
#pragma unroll 1
      for (int row = row0; row < kRows; row += kRowsPer) {
        bool ok;
        const float* p = row_src(row, ok);
        const bool in = din && ok;
        cp_async<false>(dst(sm, buf, row), in ? p + h0 : p, in);
      }
    }
  }
};

// acc[i][r] += x[qrow + kLQ i] · e[crow + kLC r] over the kHC features
// of stage `buf`, one fmaf per feature in feature order.  A quad of
// features is read for all rows first and then taken one feature at a
// time across all kTQ·kTC accumulators, so the fmafs chained on one
// accumulator lie kTQ·kTC instructions apart.
__device__ __forceinline__ void product(const Shared& sm, int buf, int qrow,
                                        int crow, float (&acc)[kTQ][kTC]) {
#pragma unroll
  for (int d = 0; d < kHC; d += 4) {
    float a[kTQ][4], b[kTC][4];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(
          &sm.x[buf][qrow + kLQ * i][d]);
#pragma unroll
    for (int r = 0; r < kTC; ++r)
      *reinterpret_cast<float4*>(b[r]) = *reinterpret_cast<const float4*>(
          &sm.e[buf][crow + kLC * r][d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < kTC; ++r)
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
          acc[i][r] = fmaf(a[i][j], b[r][j], acc[i][r]);
  }
}

// (s1, i1) precedes (s2, i2) in the selection order
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// A candidate: score and centroid index.  Unfilled slots are none(),
// which every candidate precedes (a -inf score with a real index too).
struct Key {
  float s;
  int i;
};
__device__ __forceinline__ Key none() { return {-CUDART_INF_F, INT_MAX}; }
__device__ __forceinline__ bool before(Key a, Key b) {
  return before(a.s, a.i, b.s, b.i);
}
__device__ __forceinline__ Key shfl(Key a, int lane) {
  return {__shfl_sync(kFull, a.s, lane), __shfl_sync(kFull, a.i, lane)};
}
__device__ __forceinline__ Key shfl_xor(Key a, int mask) {
  return {__shfl_xor_sync(kFull, a.s, mask),
          __shfl_xor_sync(kFull, a.i, mask)};
}

// One step of a bitonic network over a warp's 32·KPL keys, key e = KPL·lane
// + j in v[j]: keys e and e ^ stride are compared, and the lower of the
// two takes the better where `best_first` or e's bit `size` is set, else
// the worse.  best_first: the steps of a merge, which sort a bitonic
// sequence best first; else a step of a sort at block size `size`, worst
// first once `size` is the whole network.  Across lanes by shuffles
// (stride >= KPL), within a lane otherwise.
template <int KPL>
__device__ __forceinline__ void exchange(Key (&v)[KPL], int lane, int size,
                                         int stride, bool best_first) {
  if (stride >= KPL) {
    const int m = stride / KPL;
    const bool lower = (lane & m) == 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const bool lower_better =
          best_first || ((KPL * lane + j) & size) != 0;
      const Key o = shfl_xor(v[j], m);
      v[j] = (lower == lower_better) == before(v[j], o) ? v[j] : o;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if (j & stride) continue;
      const bool lower_better =
          best_first || ((KPL * lane + j) & size) != 0;
      const Key a = v[j], b = v[j | stride];
      const bool keep = lower_better == before(a, b);
      v[j] = keep ? a : b;
      v[j | stride] = keep ? b : a;
    }
  }
}

// Sort each of G sets of the warp's 32·KPL keys worst first, their
// networks side by side (one's shuffles wait while the others compare).
template <int KPL, int G>
__device__ __forceinline__ void sort_worst_first(Key (&v)[G][KPL],
                                                 int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * KPL; size *= 2)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
#pragma unroll
      for (int g = 0; g < G; ++g)
        exchange<KPL>(v[g], lane, size, stride, false);
}

// list[g] (best first) ← the best 32·KPL of list[g] ∪ c[g] (c[g] worst
// first), best first, for each g side by side: the better of each pair
// is a bitonic sequence holding them.
template <int KPL, int G>
__device__ __forceinline__ void merge_into(Key (&list)[G][KPL],
                                           Key (&c)[G][KPL], int lane) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      if (before(c[g][j], list[g][j])) list[g][j] = c[g][j];
#pragma unroll
  for (int stride = 16 * KPL; stride > 0; stride /= 2)
#pragma unroll
    for (int g = 0; g < G; ++g)
      exchange<KPL>(list[g], lane, 0, stride, true);
}

// The k-th key of a best-first list, in every lane.
template <int KPL>
__device__ __forceinline__ Key kth(const Key (&list)[KPL], int k,
                                   int lane) {
  Key t = list[0];
#pragma unroll
  for (int j = 1; j < KPL; ++j)
    if (j == (k - 1) % KPL) t = list[j];
  return shfl(t, (k - 1) / KPL);
}

// Offer this thread's pending candidates (bit kTC·i + r of pend: score
// acc[i][r] of query row qrow + kLQ·i, centroid c0 + crow + kLC·r) to
// their queries' buffers.  One that does not beat its query's bar is
// dropped; one that does takes a slot, ranked among the kLC lanes that
// share the query by a ballot a centroid column, the group's slots
// reserved by one shared atomic.  One that finds the buffer full stays
// pending.
__device__ __forceinline__ void offer(Shared& sm, const float (&acc)[kTQ][kTC],
                                      unsigned& pend, int qrow, int crow,
                                      int c0, int lane) {
  const int lead = lane & ~(kLC - 1);
  const unsigned group = ((1u << kLC) - 1) << lead;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int q = qrow + kLQ * i;
    const float bar_s = sm.bar_s[q];
    const int bar_i = sm.bar_i[q];
    unsigned want = 0;
#pragma unroll
    for (int r = 0; r < kTC; ++r) {
      const unsigned bit = 1u << (kTC * i + r);
      if (!(pend & bit)) continue;
      if (before(acc[i][r], c0 + crow + kLC * r, bar_s, bar_i))
        want |= 1u << r;
      else
        pend &= ~bit;
    }
    unsigned cols[kTC];
    int total = 0;
#pragma unroll
    for (int r = 0; r < kTC; ++r) {
      cols[r] = __ballot_sync(kFull, (want >> r) & 1u) & group;
      total += __popc(cols[r]);
    }
    int base = 0;
    if (lane == lead && total) base = atomicAdd(&sm.bn[q], total);
    base = __shfl_sync(kFull, base, lead);
#pragma unroll
    for (int r = 0; r < kTC; ++r) {
      const int slot = base + __popc(cols[r] & below);
      if ((want >> r) & 1u && slot < kBuf) {
        sm.bs[q][slot] = acc[i][r];
        sm.bi[q][slot] = c0 + crow + kLC * r;
        pend &= ~(1u << (kTC * i + r));
      }
      base += __popc(cols[r]);
    }
  }
}

// Merge the n[g] candidates in the buffers of G queries q[g] into their
// lists and bars, by the warp, a chunk of 32·KPL at a time: the networks
// of the G queries, or of W chunks of one query, run side by side, so one
// network's shuffles wait while another's compare.  Empties the buffers.
template <int KPL, int G>
__device__ __forceinline__ void merge_chunks(Shared& sm, const int (&q)[G],
                                             const int (&n)[G], int k,
                                             int lane) {
  constexpr int P = 32 * KPL;
  constexpr int W = G == 1 && KPL <= 2 ? 2 : 1;   // chunks a query a pass
  Key list[G][KPL];
  int most = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    most = max(most, n[g]);
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      list[g][j] = {sm.ls[q[g]][KPL * lane + j], sm.li[q[g]][KPL * lane + j]};
  }
  for (int from = 0; from < most; from += W * P) {
    Key chunk[G * W][KPL];       // chunk g·W + w: query g, from + w·P on
#pragma unroll
    for (int c = 0; c < G * W; ++c)
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int g = c / W, e = from + c % W * P + KPL * lane + j;
        chunk[c][j] = e < n[g] ? Key{sm.bs[q[g]][e], sm.bi[q[g]][e]} : none();
      }
    sort_worst_first<KPL, G * W>(chunk, lane);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (from + w * P >= most) break;
      Key c[G][KPL];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < KPL; ++j) c[g][j] = chunk[g * W + w][j];
      merge_into<KPL, G>(list, c, lane);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      sm.ls[q[g]][KPL * lane + j] = list[g][j].s;
      sm.li[q[g]][KPL * lane + j] = list[g][j].i;
    }
    const Key bar = kth<KPL>(list[g], k, lane);
    if (lane == 0) {
      sm.bar_s[q[g]] = bar.s;
      sm.bar_i[q[g]] = bar.i;
      sm.bn[q[g]] = 0;
    }
  }
  __syncwarp();
}

// Each warp merges the buffers of its queries warp + kWarps·u that hold
// candidates: four at a time (KPL 1), else two at a time (KPL <= 2), the
// rest one at a time, so that no network runs for an empty buffer.
template <int KPL>
__device__ void merge_buffers(Shared& sm, int q0, int N, int k, int warp,
                              int lane) {
  constexpr int kPer = kQB / kWarps;
  int q[kPer], n[kPer], c = 0;   // the queries with candidates, first
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int qu = warp + u * kWarps;
    const int nu = q0 + qu < N ? min(sm.bn[qu], kBuf) : 0;
#pragma unroll
    for (int v = 0; v <= u; ++v)
      if (nu && c == v) {
        q[v] = qu;
        n[v] = nu;
      }
    c += nu != 0;
  }
  if (KPL == 1 && c == 4) {
    merge_chunks<KPL, 4>(sm, {q[0], q[1], q[2], q[3]},
                         {n[0], n[1], n[2], n[3]}, k, lane);
    return;
  }
  int done = 0;
  if (KPL <= 2 && c >= 2) {
    merge_chunks<KPL, 2>(sm, {q[0], q[1]}, {n[0], n[1]}, k, lane);
    done = 2;
    if (c == 4) {
      merge_chunks<KPL, 2>(sm, {q[2], q[3]}, {n[2], n[3]}, k, lane);
      done = 4;
    }
  }
#pragma unroll
  for (int v = 0; v < kPer; ++v)
    if (v >= done && v < c) merge_chunks<KPL, 1>(sm, {q[v]}, {n[v]}, k, lane);
}

// The last block of a query tile: each live query's n_slices lists in the
// scratch (best first, k each) merged by a tree of pairwise merges in
// place, list a taking list a + stride in the round of `stride`, the
// pairs of a round spread over the warps two at a time (their loads in
// flight together); the last round writes out_s / out_i.
template <int KPL>
__device__ void merge_slices(float* part_s, int* part_i, float* out_s,
                             int* out_i, int q0, int N, int k, int n_slices,
                             int warp, int lane) {
  constexpr int P = 32 * KPL;
  constexpr int kPair = 2;       // merges a warp has in flight
  const int live = min(kQB, N - q0);
  for (int stride = 1;; stride *= 2) {
    const bool last = 2 * stride >= n_slices;
    const int pairs = (n_slices + 2 * stride - 1) / (2 * stride);
    const int items = live * pairs;
    for (int base = warp * kPair; base < items; base += kWarps * kPair) {
      Key m[kPair][KPL], o[kPair][KPL];
      size_t dst[kPair];
      bool act[kPair];
#pragma unroll
      for (int p = 0; p < kPair; ++p) {
        const int item = base + p;
        const int q = q0 + item / pairs;
        const int a = item % pairs * 2 * stride, b = a + stride;
        act[p] = item < items && (b < n_slices || last);
        const size_t row = static_cast<size_t>(q) * n_slices;
        dst[p] = last ? static_cast<size_t>(q) * k : (row + a) * k;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int e = KPL * lane + j, f = P - 1 - e;   // o worst first
          m[p][j] = act[p] && e < k
                        ? Key{__ldcg(part_s + (row + a) * k + e),
                              __ldcg(part_i + (row + a) * k + e)}
                        : none();
          o[p][j] = act[p] && b < n_slices && f < k
                        ? Key{__ldcg(part_s + (row + b) * k + f),
                              __ldcg(part_i + (row + b) * k + f)}
                        : none();
        }
      }
#pragma unroll
      merge_into<KPL, kPair>(m, o, lane);
#pragma unroll
      for (int p = 0; p < kPair; ++p) {
        if (!act[p]) continue;
        float* ds = (last ? out_s : part_s) + dst[p];
        int* di = (last ? out_i : part_i) + dst[p];
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int e = KPL * lane + j;
          if (e < k) {
            ds[e] = m[p][j].s;
            di[e] = m[p][j].i;
          }
        }
      }
    }
    if (last) break;
    __syncthreads();             // this round's lists are written
  }
}

// grid (ceil(N / kQB), n_slices), kThreads threads, sizeof(Shared) bytes
// of dynamic shared memory
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
topk_kernel(const float* __restrict__ x, const float* __restrict__ emb,
            float* __restrict__ out_s, int* __restrict__ out_i,
            float* part_s, int* part_i, int* counters, int N, int L, int h,
            int k, int n_slices, int per_slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sm = *reinterpret_cast<Shared*>(smem);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * kQB;
  const int slice = blockIdx.y;
  const int lo = slice * per_slice;
  const int hi = min(L, lo + per_slice);
  // this thread's score rows qrow + kLQ i and columns crow + kLC r
  const int qrow = warp / kCWarps * (kLQ * kTQ) + lane / kLC;
  const int crow = warp % kCWarps * (kLC * kTC) + lane % kLC;

  // empty lists (unfilled slots sort last), bars and buffers
  for (int j = t; j < kQB * kMaxK; j += kThreads) {
    sm.ls[j / kMaxK][j % kMaxK] = -CUDART_INF_F;
    sm.li[j / kMaxK][j % kMaxK] = INT_MAX;
  }
  if (t < kQB) {
    sm.bar_s[t] = -CUDART_INF_F;
    sm.bar_i[t] = INT_MAX;
    sm.bn[t] = 0;
  }
  __syncthreads();

  // (tile, chunk) steps of this slice; chunks are copied kStages - 1
  // steps ahead, one copy group a step (empty past the end)
  const int n_chunks = (h + kHC - 1) / kHC;
  const int steps = hi > lo ? (hi - lo + kCT - 1) / kCT * n_chunks : 0;
  Copier<VEC> cp{x, emb, N, h, t % Copier<VEC>::kPerRow * Copier<VEC>::kW,
                 t / Copier<VEC>::kPerRow, q0, lo, hi};
  cp.tile(lo);
  int lh0 = 0, lbuf = 0;               // the next chunk to copy
  auto copy_next = [&](int step) {
    if (step < steps) {
      cp.chunk(sm, lbuf, lh0);
      lh0 += kHC;
      if (lh0 >= h) { lh0 = 0; cp.tile(cp.c0 + kCT); }
      lbuf = lbuf + 1 == kStages ? 0 : lbuf + 1;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) copy_next(s);
  float acc[kTQ][kTC] = {};
  int c0 = lo, h0 = 0, buf = 0;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();             // this chunk landed; the oldest stage free
    copy_next(step + kStages - 1);
    const int nh0 = h0 + kHC < h ? h0 + kHC : 0;
    product(sm, buf, qrow, crow, acc);
    buf = buf + 1 == kStages ? 0 : buf + 1;
    h0 = nh0;
    if (nh0 != 0) continue;
    // the tile is done: its scores are offered and merged, a round at a
    // time until none is pending
    // <per-tile selection>
    {
      unsigned pend = 0;
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int r = 0; r < kTC; ++r)
          if (q0 + qrow + kLQ * i < N && c0 + crow + kLC * r < hi)
            pend |= 1u << (kTC * i + r);
      bool more;
      do {
        offer(sm, acc, pend, qrow, crow, c0, lane);
        more = __syncthreads_or(pend != 0);    // the buffers are filled
        if (k <= 32)
          merge_buffers<1>(sm, q0, N, k, warp, lane);
        else if (k <= 64)
          merge_buffers<2>(sm, q0, N, k, warp, lane);
        else
          merge_buffers<4>(sm, q0, N, k, warp, lane);
        if (more) __syncthreads();             // the bars have risen
      } while (more);
    }
    // </per-tile selection>
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int r = 0; r < kTC; ++r) acc[i][r] = 0.f;
    c0 += kCT;                   // the next step's loop-top barrier orders
  }                              // the merges before the next offers

  // this slice's k best → scratch (the merging warp's own lists)
#pragma unroll
  for (int u = 0; u < kQB / kWarps; ++u) {
    const int q = warp + u * kWarps, gq = q0 + q;
    if (gq >= N) continue;
    const size_t off = (static_cast<size_t>(gq) * n_slices + slice) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[off + j] = sm.ls[q][j];
      part_i[off + j] = sm.li[q][j];
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const int ticket = atomicAdd(&counters[blockIdx.x], 1);
    sm.is_last = ticket == n_slices - 1;
  }
  __syncthreads();
  if (!sm.is_last) return;

  // last block of this query tile: merge the slice lists
  if (k <= 32)
    merge_slices<1>(part_s, part_i, out_s, out_i, q0, N, k, n_slices, warp,
                    lane);
  else if (k <= 64)
    merge_slices<2>(part_s, part_i, out_s, out_i, q0, N, k, n_slices, warp,
                    lane);
  else
    merge_slices<4>(part_s, part_i, out_s, out_i, q0, N, k, n_slices, warp,
                    lane);
}

// Raises both instances' dynamic shared memory limit to sizeof(Shared),
// once per device (the attribute belongs to the device's context).
constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_raised[kMaxDevices];

cudaError_t raise_smem_limit() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && g_smem_raised[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  using Kernel = decltype(&topk_kernel<true>);
  const Kernel kernels[] = {topk_kernel<true>, topk_kernel<false>};
  for (Kernel kernel : kernels) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Shared));
    if (err != cudaSuccess) return err;
  }
  if (cached) g_smem_raised[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The tile shape of this build and how many blocks of the 16-byte
// instance fit an SM of the current device (the occupancy API, after
// raising its dynamic shared memory limit).  Returns a cudaError_t.
int topk_scores_tiles(int* queries_per_block, int* centroid_tile,
                      int* blocks_per_sm) {
  *queries_per_block = kQB;
  *centroid_tile = kCT;
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, topk_kernel<true>, kThreads, sizeof(Shared)));
}

// x (N, h) f32; emb (L, h) f32 → out_s (N, k) f32, out_i (N, k) i32, with
// scratch part_s / part_i (N, n_slices, k) and counters (ceil(N / kQB),)
// zeroed.  All contiguous on the current device; k <= 128, k <= L.  x and
// emb 16-byte aligned with h % 4 == 0 take the 16-byte copies, anything
// else the 4-byte ones.  Launches on `stream` without synchronizing;
// returns cudaGetLastError().
int topk_scores_launch(const void* x, const void* emb, void* out_s,
                       void* out_i, void* part_s, void* part_i,
                       void* counters, int N, int L, int h, int k,
                       int n_slices, void* stream) {
  if (k < 1 || k > kMaxK || k > L || n_slices < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  // slices cover whole tiles so every tile but the last is full
  const int per = (L + n_slices - 1) / n_slices;
  const int per_slice = (per + kCT - 1) / kCT * kCT;
  const dim3 grid((N + kQB - 1) / kQB, n_slices);
  const bool vec = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(emb) % 16 == 0 &&
                   h % 4 == 0;
  auto kernel = vec ? topk_kernel<true> : topk_kernel<false>;
  kernel<<<grid, kThreads, sizeof(Shared),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb),
      static_cast<float*>(out_s), static_cast<int*>(out_i),
      static_cast<float*>(part_s), static_cast<int*>(part_i),
      static_cast<int*>(counters), N, L, h, k, n_slices, per_slice);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
