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
//   * Selection.  Each finished score tile goes through shared memory and
//     is merged into a per-query running top-k list in shared memory by
//     one warp per query (kQB / kWarps = 4 queries a warp): a ballot finds
//     the lanes that beat the current k-th entry and those are inserted in
//     index order, so the list stays in (score desc, index asc) order
//     exactly as the TPU kernel's concatenate-and-reselect merge keeps it
//     (kernel.py:92-104).  Slices run in parallel to fill the card; every
//     block writes its slice's list to a small (N, n_slices, k) scratch,
//     and the last block of a query tile to finish (an atomic ticket after
//     a memory fence) merges the slice lists with the same insertion into
//     the final (N, k) result.  One launch per call.
//   * Residency.  The stages, the score tile and the lists take 146 KB of
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
// flight, and the blocks per SM the registers are capped for.  One
// constant a line: the variants tool builds other shapes from copies.
constexpr int kTQ = 4;
constexpr int kTC = 8;
constexpr int kLQ = 4;
constexpr int kLC = 32 / kLQ;
constexpr int kQWarps = 2;
constexpr int kCWarps = 4;
constexpr int kHC = 32;          // features per chunk
constexpr int kStages = 2;
constexpr int kMinBlocks = 1;
constexpr int kQB = kQWarps * kLQ * kTQ;    // queries per block
constexpr int kCT = kCWarps * kLC * kTC;    // centroids per tile
constexpr int kRow = kHC + 4;    // padded row: conflict-free 128-bit reads
constexpr int kThreads = kQWarps * kCWarps * 32;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRow = kCT + kLC;  // a warp's kLQ stored rows in
                                     // different banks
constexpr int kMaxK = 128;
constexpr int kSlots = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQB % kWarps == 0, "whole queries per merging warp");
static_assert(kHC % 4 == 0 && 32 % kLQ == 0 && kLC >= 8,
              "4-feature reads; a quarter warp reads 8 centroid rows");
static_assert(kStages >= 2, "a chunk in flight while one is multiplied");

struct Shared {
  alignas(16) float x[kStages][kQB][kRow];    // stages of chunks
  alignas(16) float e[kStages][kCT][kRow];
  float tile[kQB][kTileRow];
  float ls[kQB][kMaxK];          // running top-k scores per query
  int li[kQB][kMaxK];            // running top-k indices per query
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

// Insert (s, i) into the sorted list (ls, li) of length cnt <= k; the
// caller has checked that it belongs in the top k.  Warp-uniform.
__device__ void warp_insert(float* ls, int* li, int& cnt, float s, int i,
                            int k, int lane) {
  int pos = 0;
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int j = u * 32 + lane;
    const bool p = j < cnt && before(ls[j], li[j], s, i);
    pos += __popc(__ballot_sync(kFull, p));
  }
  const int last = min(cnt, k - 1);    // entries [pos, last) shift by one
  float vs[kSlots];
  int vi[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int j = u * 32 + lane;
    if (j >= pos && j < last) { vs[u] = ls[j]; vi[u] = li[j]; }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int j = u * 32 + lane;
    if (j >= pos && j < last) { ls[j + 1] = vs[u]; li[j + 1] = vi[u]; }
  }
  if (lane == 0) { ls[pos] = s; li[pos] = i; }
  __syncwarp();
  cnt = min(cnt + 1, k);
}

// Merge n candidates into the list; get(c, s, i) loads candidate c.
template <typename Get>
__device__ void warp_merge(float* ls, int* li, int& cnt, int n, int k,
                           int lane, Get get) {
  for (int base = 0; base < n; base += 32) {
    const int c = base + lane;
    float s = 0.f;
    int i = 0;
    if (c < n) get(c, s, i);
    const bool want =
        c < n && (cnt < k || before(s, i, ls[k - 1], li[k - 1]));
    unsigned mask = __ballot_sync(kFull, want);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float ss = __shfl_sync(kFull, s, src);
      const int ii = __shfl_sync(kFull, i, src);
      if (cnt < k || before(ss, ii, ls[k - 1], li[k - 1]))
        warp_insert(ls, li, cnt, ss, ii, k, lane);
    }
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

  int cnt[kQB / kWarps];
#pragma unroll
  for (int u = 0; u < kQB / kWarps; ++u) cnt[u] = 0;

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
    // the tile is done: scores → shared, merged into the lists
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int r = 0; r < kTC; ++r) {
        sm.tile[qrow + kLQ * i][crow + kLC * r] = acc[i][r];
        acc[i][r] = 0.f;
      }
    __syncthreads();
    const int n = min(kCT, hi - c0);
#pragma unroll
    for (int u = 0; u < kQB / kWarps; ++u) {
      const int q = warp + u * kWarps;
      if (q0 + q >= N) continue;
      const float* row = sm.tile[q];
      warp_merge(sm.ls[q], sm.li[q], cnt[u], n, k, lane,
                 [&](int c, float& s, int& i) { s = row[c]; i = c0 + c; });
    }
    c0 += kCT;                   // the next step's loop-top barrier
  }                              // orders these reads before new stores

  // this slice's list → scratch; unfilled slots sort last
#pragma unroll
  for (int u = 0; u < kQB / kWarps; ++u) {
    const int q = warp + u * kWarps, gq = q0 + q;
    if (gq >= N) continue;
    const size_t off = (static_cast<size_t>(gq) * n_slices + slice) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[off + j] = j < cnt[u] ? sm.ls[q][j] : -CUDART_INF_F;
      part_i[off + j] = j < cnt[u] ? sm.li[q][j] : INT_MAX;
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

  // last block of this query tile: merge the slice lists in slice order
#pragma unroll
  for (int u = 0; u < kQB / kWarps; ++u) {
    const int q = warp + u * kWarps, gq = q0 + q;
    if (gq >= N) continue;
    int c = 0;
    const size_t off = static_cast<size_t>(gq) * n_slices * k;
    warp_merge(sm.ls[q], sm.li[q], c, n_slices * k, k, lane,
               [&](int e, float& s, int& i) {
                 s = __ldcg(part_s + off + e);
                 i = __ldcg(part_i + off + e);
               });
    for (int j = lane; j < k; j += 32) {
      out_s[static_cast<size_t>(gq) * k + j] = sm.ls[q][j];
      out_i[static_cast<size_t>(gq) * k + j] = sm.li[q][j];
    }
  }
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
