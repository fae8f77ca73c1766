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
// Design.  A block takes kQB queries and one slice of the centroids, and
// streams that slice through shared memory in tiles of kCT centroids by kHC
// features, each thread holding a 2-query x 4-centroid register tile.  Each
// finished score tile is merged into a per-query running top-k list in
// shared memory by one warp per query: a ballot finds the lanes that beat
// the current k-th entry and those are inserted in index order, so the list
// stays in (score desc, index asc) order exactly as the TPU kernel's
// concatenate-and-reselect merge keeps it (kernel.py:92-104).  Slices run in
// parallel to fill the card; every block writes its slice's list to a small
// (N, n_slices, k) scratch, and the last block of a query tile to finish
// (an atomic ticket after a memory fence) merges the slice lists with the
// same insertion into the final (N, k) result.  One launch per call.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kQB = 16;          // queries per block
constexpr int kCT = 64;          // centroids per tile
constexpr int kHC = 32;          // features per chunk
constexpr int kThreads = 128;    // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kSlots = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  float x[kQB][kHC + 1];         // +1: the two query rows of a warp
                                 //     fall in different banks
  float e[kCT][kHC + 1];         // +1: conflict-free column reads
  float tile[kQB][kCT];
  float ls[kQB][kMaxK];          // running top-k scores per query
  int li[kQB][kMaxK];            // running top-k indices per query
  int is_last;
};

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

// grid (ceil(N / kQB), n_slices)
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, const float* __restrict__ emb,
            float* __restrict__ out_s, int* __restrict__ out_i,
            float* part_s, int* part_i, int* counters, int N, int L, int h,
            int k, int n_slices, int per_slice) {
  __shared__ Shared sm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * kQB;
  const int slice = blockIdx.y;
  const int lo = slice * per_slice;
  const int hi = min(L, lo + per_slice);
  const int tq = t >> 4;           // queries tq, tq + 8
  const int tc = t & 15;           // centroids tc + 16 r, r < 4

  int cnt[kQB / kWarps];
#pragma unroll
  for (int u = 0; u < kQB / kWarps; ++u) cnt[u] = 0;

  for (int c0 = lo; c0 < hi; c0 += kCT) {
    float acc[2][4] = {};
    for (int h0 = 0; h0 < h; h0 += kHC) {
      for (int e = t; e < kQB * kHC; e += kThreads) {
        const int q = e / kHC, d = e % kHC;
        const int gq = q0 + q, gd = h0 + d;
        sm.x[q][d] = (gq < N && gd < h) ? x[static_cast<size_t>(gq) * h + gd]
                                        : 0.f;
      }
      for (int e = t; e < kCT * kHC; e += kThreads) {
        const int c = e / kHC, d = e % kHC;
        const int gc = c0 + c, gd = h0 + d;
        sm.e[c][d] = (gc < hi && gd < h)
                         ? emb[static_cast<size_t>(gc) * h + gd] : 0.f;
      }
      __syncthreads();
      const int dn = min(kHC, h - h0);
      // features in order d = 0 .. h-1, one FMA each
#pragma unroll 8
      for (int d = 0; d < dn; ++d) {
        const float a0 = sm.x[tq][d], a1 = sm.x[tq + 8][d];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bv = sm.e[tc + 16 * r][d];
          acc[0][r] = fmaf(a0, bv, acc[0][r]);
          acc[1][r] = fmaf(a1, bv, acc[1][r]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sm.tile[tq][tc + 16 * r] = acc[0][r];
      sm.tile[tq + 8][tc + 16 * r] = acc[1][r];
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
    __syncthreads();
  }

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

}  // namespace

extern "C" {

// x (N, h) f32; emb (L, h) f32 → out_s (N, k) f32, out_i (N, k) i32, with
// scratch part_s / part_i (N, n_slices, k) and counters (ceil(N / 16),)
// zeroed.  All contiguous on the current device; k <= 128, k <= L.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
int topk_scores_launch(const void* x, const void* emb, void* out_s,
                       void* out_i, void* part_s, void* part_i,
                       void* counters, int N, int L, int h, int k,
                       int n_slices, void* stream) {
  if (k < 1 || k > kMaxK || k > L || n_slices < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // slices cover whole tiles so every tile but the last is full
  const int per = (L + n_slices - 1) / n_slices;
  const int per_slice = (per + kCT - 1) / kCT * kCT;
  const dim3 grid((N + kQB - 1) / kQB, n_slices);
  topk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
