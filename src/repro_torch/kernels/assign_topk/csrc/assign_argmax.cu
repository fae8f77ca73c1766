// assign_argmax — fused point x centroid scoring with a running argmax, the
// KMeans assignment step, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/assign_topk/kernel.py::
// _assign_kernel (entry assign_argmax, pallas_call at kernel.py:156):
//
//     best_s[b, i] = max_j     <x[b, i], c[b, j]> - ½‖c[b, j]‖²
//     best_i[b, i] = argmax_j  (the same), ties to the lower index
//
// which is the L2 argmin of KMeans, batched over a leading axis b (PQ's m
// fragments; b = 1 for the cluster selector).
//
// Bound on the H100: operations.  2·N·L·h fp32 multiply-adds (16.1 TFLOP
// at the build's N = 1,048,576, L = 10,000, h = 768) against the 67 TFLOP/s
// non-tensor-core fp32 peak; the inputs are read once per tile pass and
// only (N,) scores and ids are written.  The products stay in fp32 FMAs:
// TF32 would move assignments against the plain fp32 version.
//
// Order.  Every score is one fmaf per feature in the order d = 0 .. h-1,
// from 0, minus ½‖c‖², which is the same fmaf chain over c's features
// times 0.5; zero-filled features past h add exact zeros.  So scores (and
// ids) equal the earlier kernels' bit for bit, whatever the tiling, and two
// equal centroids score the same.  Each thread walks its centroids in
// ascending index and replaces a point's running best only on a strictly
// greater score; partial bests merge under (score desc, index asc), so the
// lower index wins ties (kernel.py:41-45).  The (N, L) plane never exists,
// so one call covers the whole batch, and the ragged N, L and h edges are
// masked from the true sizes: nothing is padded (the reference pads L with
// copies of centroid 0, ops.py:31-37).  Points are read through their batch
// and row strides (features unit-stride), so PQ's (m, n, d_sub) view of an
// (n, h) matrix needs no copy.
//
// One call is two launches on the stream, counted as one by the wrapper:
// half_norms writes ½‖c‖² of every centroid into a (B, L) scratch, one
// thread a centroid; then one of two assignment kernels reads it.
//
//   * Wide (h > kNarrowMax; the KMeans shape).  A block of kThreads (256)
//     owns kBP (128) points of one batch entry (grid x over points, grid z
//     over the batch) and walks all centroids in tiles of kCT (128).  The
//     point and centroid rows stream through shared memory in chunks of kHC
//     (64) features, copied row-major (no transposition) by cp.async into
//     kStages (2) stages of 70 KB, the next chunk in flight while the
//     current one is multiplied, one block barrier a chunk.  The 16-byte
//     instance (VEC) needs 16-byte aligned bases, row and batch strides and
//     h % 4 == 0, which the wrapper checks and the C entry enforces;
//     anything else copies 4 bytes an element.  Warps form a kPWarps x
//     kCWarps (4 x 2) grid and each warp's lanes a kLP x kLC (4 x 8) grid,
//     so a thread owns kTP = 8 points (rows lp + 4 i of its warp's 32) by
//     kTC = 8 centroids (lc + 8 j of its warp's 64).  Rows are padded to
//     kHC + 4 floats, so a 128-bit shared read gives 4 features of a row
//     and the 8 rows a warp reads at once start in 8 different bank
//     groups: 16 such reads per 256 fmafs, without conflicts.  The product
//     is unrolled over the whole chunk.  After a tile, each thread folds
//     its 8 x 8 scores into its 8 running bests, kept in shared memory to
//     spare registers; at the end the 8 lanes and kCWarps warps that share
//     a point merge theirs.
//   * Narrow (h <= kNarrowMax; PQ's d_sub).  Each thread holds kNarrowRegs
//     / HC points' features in registers, HC = h rounded up to 4 (8 at the
//     served OPQ, where the earlier kernel staged 16), and the block stages
//     kNCT centroids and their ½‖c‖² in shared memory at a time (PQ's whole
//     256-centroid codebook at once); every lane reads the same centroid,
//     so the reads are broadcasts, and each point belongs to one thread, so
//     nothing is merged.
//
// Residency: the wide instance is one block (8 warps) an SM, its registers
// uncapped (kMinBlocks); PERF.md §6 has ptxas' registers and spills and
// the variants measured (32-feature chunks, 3 stages, two blocks an SM,
// 8 x 16 register tiles, other lane grids, partial unrolling).  The
// dynamic shared memory limit is raised once per device.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// The wide instance's tile shape: points and centroids a thread owns,
// lanes of a warp along the points (the rest along the centroids), warps
// along the points and along the centroids, features a chunk, chunks in
// flight, and the blocks per SM the registers are capped for.  One
// constant a line: the variants tool builds other shapes from copies.
constexpr int kTP = 8;
constexpr int kTC = 8;
constexpr int kLP = 4;
constexpr int kLC = 32 / kLP;
constexpr int kPWarps = 4;
constexpr int kCWarps = 2;
constexpr int kHC = 64;          // features per chunk
constexpr int kUnroll = kHC / 4; // 4-feature quads unrolled in a chunk
constexpr int kStages = 2;
constexpr int kMinBlocks = 1;
constexpr int kBP = kPWarps * kLP * kTP;    // points per block
constexpr int kCT = kCWarps * kLC * kTC;    // centroids per tile
constexpr int kRow = kHC + 4;    // padded row: conflict-free 128-bit reads
constexpr int kThreads = kPWarps * kCWarps * 32;
// The narrow instance: widest h it takes, point features a thread holds in
// registers, threads, centroids staged at a time, blocks per SM.
constexpr int kNarrowMax = 16;
constexpr int kNarrowRegs = 64;
constexpr int kNThreads = 256;
constexpr int kNCT = 256;
constexpr int kNMinBlocks = 2;
constexpr int kNormThreads = 256;
static_assert(kHC % 4 == 0 && (kLC & (kLC - 1)) == 0,
              "4-feature reads; the lanes of a point merge by xor");
static_assert(kStages >= 2, "a chunk in flight while one is multiplied");
static_assert(kNarrowMax % 4 == 0 && kNarrowMax <= 16 && kNarrowRegs >= 16,
              "narrow instances of HC = 4, 8, 12, 16; 0 turns them off");

struct Shared {
  alignas(16) float x[kStages][kBP][kRow];    // stages of chunks
  alignas(16) float c[kStages][kCT][kRow];
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

// ½‖c_r‖² for the rows r < rows of c (rows, h): one thread a row, the
// fmafs in feature order.
__global__ void __launch_bounds__(kNormThreads)
half_norms(const float* __restrict__ c, float* __restrict__ half,
           long long rows, int h) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kNormThreads + threadIdx.x;
  if (r >= rows) return;
  const float* row = c + r * h;
  float n = 0.f;
  for (int d = 0; d < h; ++d) {
    const float v = __ldg(row + d);
    n = fmaf(v, v, n);
  }
  half[r] = 0.5f * n;
}

// Copies of chunks into the stages.  A thread copies the same kW features
// of every kRowsPer-th point row and every kRowsPer-th centroid row, from
// its first row's pointer and a fixed stride, so it holds two pointers
// rather than one a row.  VEC: 16 bytes a copy, else 4.  Zeros past N, L
// and h; a copy of nothing reads from the (valid) first row.
template <bool VEC>
struct Copier {
  static constexpr int kW = VEC ? 4 : 1;      // floats a copy
  static constexpr int kPerRow = kHC / kW;
  static constexpr int kRowsPer = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kBP % kRowsPer == 0 &&
                    kCT % kRowsPer == 0,
                "whole rows a pass, whole passes a tile");

  const float* x;                // first point row, at feature d
  const float* cb;               // this batch entry's centroids
  const float* c;                // first centroid row of the tile, at d
  long long x_row;
  int N, L, h, d, row0, p0, c0;

  __device__ __forceinline__ void tile(int tile_c0) {
    c0 = tile_c0;
    c = cb + static_cast<long long>(min(c0 + row0, L - 1)) * h + d;
  }
  __device__ __forceinline__ void chunk(Shared& sm, int buf, int h0) const {
    const bool din = h0 + d < h;
#pragma unroll
    for (int j = 0; j < kBP / kRowsPer; ++j) {
      const bool in = din && p0 + row0 + j * kRowsPer < N;
      cp_async<VEC>(&sm.x[buf][row0 + j * kRowsPer][d],
                    in ? x + j * kRowsPer * x_row + h0 : x, in);
    }
#pragma unroll
    for (int j = 0; j < kCT / kRowsPer; ++j) {
      const bool in = din && c0 + row0 + j * kRowsPer < L;
      cp_async<VEC>(&sm.c[buf][row0 + j * kRowsPer][d],
                    in ? c + static_cast<long long>(j * kRowsPer) * h + h0
                       : c,
                    in);
    }
  }
};

// acc[i][j] += x[prow + kLP i] · c[crow + kLC j] over the kHC features of
// stage `buf`, one fmaf per feature in feature order.  A quad of features
// is read for the thread's kTP points; then each centroid's quad is read
// and taken one feature at a time across its kTP accumulators, so the
// fmafs chained on one accumulator lie kTP instructions apart.
__device__ __forceinline__ void product(const Shared& sm, int buf, int prow,
                                        int crow, float (&acc)[kTP][kTC]) {
#pragma unroll (kUnroll)
  for (int d = 0; d < kHC; d += 4) {
    float a[kTP][4];
#pragma unroll
    for (int i = 0; i < kTP; ++i)
      *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(
          &sm.x[buf][prow + kLP * i][d]);
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(
          &sm.c[buf][crow + kLC * j][d]);
      const float b[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < kTP; ++i)
          acc[i][j] = fmaf(a[i][e], b[e], acc[i][j]);
    }
  }
}

// (s1, i1) precedes (s2, i2): higher score, then lower index
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// grid (ceil(N / kBP), 1, B), kThreads threads, sizeof(Shared) bytes of
// dynamic shared memory
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
assign_wide(const float* __restrict__ x, const float* __restrict__ c,
            const float* __restrict__ half, float* __restrict__ out_s,
            int* __restrict__ out_i, long long x_batch, long long x_row,
            int N, int L, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sm = *reinterpret_cast<Shared*>(smem);
  __shared__ float r_s[kTP][kThreads];       // running bests, per thread
  __shared__ int r_i[kTP][kThreads];
  __shared__ float m_s[kCWarps][kBP];        // per centroid warp, at the end
  __shared__ int m_i[kCWarps][kBP];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int bz = blockIdx.z;
  const int p0 = blockIdx.x * kBP;
  const float* hb = half + static_cast<long long>(bz) * L;
  // this thread's points prow + kLP i and centroids crow + kLC j
  const int prow = warp / kCWarps * (kLP * kTP) + lane / kLC;
  const int crow = warp % kCWarps * (kLC * kTC) + lane % kLC;

  // (tile, chunk) steps; chunks are copied kStages - 1 steps ahead, one
  // copy group a step (empty past the end)
  const int n_chunks = (h + kHC - 1) / kHC;
  const int steps = (L + kCT - 1) / kCT * n_chunks;
  using Cp = Copier<VEC>;
  const int d = t % Cp::kPerRow * Cp::kW, row0 = t / Cp::kPerRow;
  Cp cp{x + bz * x_batch + static_cast<long long>(min(p0 + row0, N - 1)) *
                               x_row + d,
        c + static_cast<long long>(bz) * L * h, nullptr, x_row, N, L, h, d,
        row0, p0, 0};
  cp.tile(0);
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
  float acc[kTP][kTC] = {};
#pragma unroll
  for (int i = 0; i < kTP; ++i) { r_s[i][t] = -CUDART_INF_F; r_i[i][t] = 0; }
  int c0 = 0, h0 = 0, buf = 0;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();             // this chunk landed; the oldest stage free
    copy_next(step + kStages - 1);
    product(sm, buf, prow, crow, acc);
    buf = buf + 1 == kStages ? 0 : buf + 1;
    h0 += kHC;
    if (h0 < h) continue;
    // the tile is done: its scores → the running bests, centroids in
    // ascending index, replaced only on a strictly greater score
    h0 = 0;
    float best[kTP];
    int arg[kTP];
#pragma unroll
    for (int i = 0; i < kTP; ++i) { best[i] = r_s[i][t]; arg[i] = r_i[i][t]; }
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int gc = c0 + crow + kLC * j;
      if (gc < L) {
        const float hj = __ldg(hb + gc);
#pragma unroll
        for (int i = 0; i < kTP; ++i) {
          const float v = acc[i][j] - hj;
          if (v > best[i]) { best[i] = v; arg[i] = gc; }
        }
      }
#pragma unroll
      for (int i = 0; i < kTP; ++i) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTP; ++i) { r_s[i][t] = best[i]; r_i[i][t] = arg[i]; }
    c0 += kCT;
  }

  // merge the kLC lanes of a point (shuffles), then the kCWarps warps
  // (shared memory).  A thread without a valid centroid holds (-inf, 0),
  // which is right when every score is -inf and loses otherwise.
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    float s = r_s[i][t];
    int a = r_i[i][t];
#pragma unroll
    for (int off = kLC / 2; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oa = __shfl_xor_sync(0xffffffffu, a, off);
      if (before(os, oa, s, a)) { s = os; a = oa; }
    }
    if (lane % kLC == 0) {
      m_s[warp % kCWarps][prow + kLP * i] = s;
      m_i[warp % kCWarps][prow + kLP * i] = a;
    }
  }
  __syncthreads();
  for (int p = t; p < kBP; p += kThreads) {
    const int gp = p0 + p;
    if (gp >= N) continue;
    float s = m_s[0][p];
    int a = m_i[0][p];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w)
      if (before(m_s[w][p], m_i[w][p], s, a)) { s = m_s[w][p]; a = m_i[w][p]; }
    out_s[static_cast<long long>(bz) * N + gp] = s;
    out_i[static_cast<long long>(bz) * N + gp] = a;
  }
}

// grid (ceil(N / (kNThreads · kNP)), 1, B), kNThreads threads.  HC = h
// rounded up to 4; VEC: h == HC and 16-byte aligned rows, read as float4.
template <int HC, bool VEC>
__global__ void __launch_bounds__(kNThreads, kNMinBlocks)
assign_narrow(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ half, float* __restrict__ out_s,
              int* __restrict__ out_i, long long x_batch, long long x_row,
              int N, int L, int h) {
  constexpr int kNP = kNarrowRegs / HC;      // points a thread owns
  __shared__ __align__(16) float cs[kNCT][HC];
  __shared__ float hs[kNCT];
  const int t = threadIdx.x, bz = blockIdx.z;
  const int p0 = blockIdx.x * (kNThreads * kNP);
  const float* xb = x + bz * x_batch;
  const float* cb = c + static_cast<long long>(bz) * L * h;
  const float* hb = half + static_cast<long long>(bz) * L;

  float xr[kNP][HC];             // point p0 + t + kNThreads i
#pragma unroll
  for (int i = 0; i < kNP; ++i) {
    const int gp = p0 + t + kNThreads * i;
    const float* row = xb + static_cast<long long>(gp < N ? gp : 0) * x_row;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < HC / 4; ++q) {
        const float4 v = gp < N ? __ldg(reinterpret_cast<const float4*>(row)
                                        + q)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        xr[i][4 * q] = v.x;
        xr[i][4 * q + 1] = v.y;
        xr[i][4 * q + 2] = v.z;
        xr[i][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < HC; ++d)
        xr[i][d] = gp < N && d < h ? __ldg(row + d) : 0.f;
    }
  }
  float best[kNP];
  int arg[kNP];
#pragma unroll
  for (int i = 0; i < kNP; ++i) { best[i] = -CUDART_INF_F; arg[i] = 0; }

  for (int c0 = 0; c0 < L; c0 += kNCT) {
    __syncthreads();             // the last tile's reads are done
    for (int e = t; e < kNCT * HC; e += kNThreads) {
      const int j = e / HC, d = e % HC, gc = c0 + j;
      cs[j][d] = gc < L && d < h ? __ldg(cb + static_cast<long long>(gc) * h
                                         + d)
                                 : 0.f;
    }
    for (int j = t; j < kNCT; j += kNThreads)
      hs[j] = c0 + j < L ? __ldg(hb + c0 + j) : 0.f;
    __syncthreads();
    const int nj = min(kNCT, L - c0);
#pragma unroll 2
    for (int j = 0; j < nj; ++j) {
      float cc[HC];
#pragma unroll
      for (int q = 0; q < HC / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&cs[j][4 * q]);
        cc[4 * q] = v.x;
        cc[4 * q + 1] = v.y;
        cc[4 * q + 2] = v.z;
        cc[4 * q + 3] = v.w;
      }
      const float hj = hs[j];
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HC; ++d) s = fmaf(xr[i][d], cc[d], s);
        const float v = s - hj;
        if (v > best[i]) { best[i] = v; arg[i] = c0 + j; }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNP; ++i) {
    const int gp = p0 + t + kNThreads * i;
    if (gp < N) {
      out_s[static_cast<long long>(bz) * N + gp] = best[i];
      out_i[static_cast<long long>(bz) * N + gp] = arg[i];
    }
  }
}

template <int HC>
cudaError_t launch_narrow(bool vec, const float* x, const float* c,
                          const float* half, float* out_s, int* out_i,
                          long long x_batch, long long x_row, int B, int N,
                          int L, int h, cudaStream_t st) {
  constexpr int per_block = kNThreads * (kNarrowRegs / HC);
  const dim3 grid((N + per_block - 1) / per_block, 1, B);
  auto kernel = vec ? assign_narrow<HC, true> : assign_narrow<HC, false>;
  kernel<<<grid, kNThreads, 0, st>>>(x, c, half, out_s, out_i, x_batch,
                                     x_row, N, L, h);
  return cudaGetLastError();
}

// Raises both wide instances' dynamic shared memory limit to
// sizeof(Shared), once per device (the attribute belongs to the device's
// context).
constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_raised[kMaxDevices];

cudaError_t raise_smem_limit() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && g_smem_raised[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  using Kernel = decltype(&assign_wide<true>);
  const Kernel kernels[] = {assign_wide<true>, assign_wide<false>};
  for (Kernel kernel : kernels) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Shared));
    if (err != cudaSuccess) return err;
  }
  if (cached) g_smem_raised[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x (B, N, h) f32 given by its batch and row strides in elements (features
// unit-stride); c (B, L, h) f32 contiguous → out_s (B, N) f32 and out_i
// (B, N) i32, contiguous, through the scratch half (B, L) f32.  B <=
// 65,535, L >= 1.  vec (the 16-byte copies) needs x and c 16-byte aligned,
// h and x's row stride (and batch stride, for B > 1) multiples of 4;
// otherwise the call is refused.  Two launches on `stream` (½‖c‖², then
// the assignment) without synchronizing; returns cudaGetLastError().
int assign_argmax_launch(const void* x, const void* c, void* out_s,
                         void* out_i, void* half, long long x_batch,
                         long long x_row, int B, int N, int L, int h,
                         int vec, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || L < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(aligned16(x) && aligned16(c) && h % 4 == 0 &&
               x_row % 4 == 0 && (B == 1 || x_batch % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* cf = static_cast<const float*>(c);
  auto* hf = static_cast<float*>(half);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  const long long rows = static_cast<long long>(B) * L;
  half_norms<<<static_cast<unsigned>((rows + kNormThreads - 1) /
                                     kNormThreads),
               kNormThreads, 0, st>>>(cf, hf, rows, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= kNarrowMax) {
    switch ((h + 3) / 4) {
      case 1:
        err = launch_narrow<4>(vec, xf, cf, hf, os, oi, x_batch, x_row, B,
                               N, L, h, st);
        break;
      case 2:
        err = launch_narrow<8>(vec, xf, cf, hf, os, oi, x_batch, x_row, B,
                               N, L, h, st);
        break;
      case 3:
        err = launch_narrow<12>(vec, xf, cf, hf, os, oi, x_batch, x_row, B,
                                N, L, h, st);
        break;
      default:
        err = launch_narrow<16>(vec, xf, cf, hf, os, oi, x_batch, x_row, B,
                                N, L, h, st);
    }
    return static_cast<int>(err);
  }
  const dim3 grid((N + kBP - 1) / kBP, 1, B);
  auto kernel = vec ? assign_wide<true> : assign_wide<false>;
  kernel<<<grid, kThreads, sizeof(Shared), st>>>(xf, cf, hf, os, oi,
                                                 x_batch, x_row, N, L, h);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
