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
// Design.  The TPU kernel runs the centroid axis as a sequential grid axis
// and revisits the output block (kernel.py:27-45).  Here one block of 256
// threads owns 128 points of one batch entry (grid x over points, grid z
// over the batch) and loops over all centroids itself in tiles of 128,
// staging 32 features (16 for PQ's 8-wide fragments) of the point tile and
// of the centroid tile at a time in shared memory, feature-major, so that
// each thread reads its operands as 16-byte vectors; the stages are double
// buffered, the next chunk's asynchronous copies (cp.async) running while
// the current one is computed.  Each thread holds an 8-point x 8-centroid register
// tile (points and centroids 4·lane + {0..3} and 64 + 4·lane + {0..3}, so
// 16 lanes read 256 contiguous bytes: no bank conflicts) and adds one FMA
// per feature in order d = 0 .. h-1, so two equal centroids score bit for
// bit the same.  ½‖c‖² is summed once per centroid tile from the staged
// features.  After a tile, each thread takes the best of its 8 centroids
// in index order, the 16 lanes that share a point merge under (score desc,
// index asc) with shuffles, and the point's running best is replaced only
// on a strictly greater score (the running bests live in shared memory,
// one owning lane per point): later tiles hold higher indices, so the
// lower index wins ties (kernel.py:41-45).  The (N, L) score plane never
// exists, so one launch covers the whole batch.  The ragged N and L edges
// are masked from the true sizes: nothing is padded (the reference pads L
// with copies of centroid 0, ops.py:31-37).  Points are read through their
// batch and row strides (features unit-stride), so PQ's (m, n, d_sub) view
// of an (n, h) matrix needs no copy.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBN = 128;         // points per block
constexpr int kBL = 128;         // centroids per tile
constexpr int kPad = 4;          // keeps rows 16-byte aligned, spreads banks
constexpr int kThreads = 256;    // 16 point lanes x 16 centroid lanes
constexpr unsigned kFull = 0xffffffffu;

// the tile slot of register i (< 8) of lane l: 4 l + i, then 64 + 4 l + i - 4
__device__ __forceinline__ int slot(int lane, int i) {
  return (i < 4 ? 0 : 64 - 4) + 4 * lane + i;
}

// one staged chunk: kBH features of the point tile and of the centroid tile
template <int kBH>
struct Stage {
  float x[kBH][kBN + kPad];                  // feature-major
  float c[kBH][kBL + kPad];
};

// 4-byte asynchronous copy global → shared; zero-fills when !valid
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// grid (ceil(N / kBN), 1, B); dynamic shared memory 2 * sizeof(Stage<kBH>);
// kBH features per staged chunk (16 for PQ's narrow fragments, 32
// otherwise).  At most 128 registers, so two blocks fit on an SM.
template <int kBH>
__global__ void __launch_bounds__(kThreads, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              float* __restrict__ out_s, int* __restrict__ out_i,
              long long x_batch, long long x_row, int N, int L, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<kBH>* stage = reinterpret_cast<Stage<kBH>*>(smem);   // 2 buffers
  __shared__ float s_half[kBL];              // ½‖c‖² of the tile
  __shared__ float s_best[kBN];              // running best per point
  __shared__ int s_arg[kBN];

  const int t = threadIdx.x;
  const int tp = t >> 4;                     // point lane
  const int tc = t & 15;                     // centroid lane
  const int bz = blockIdx.z;
  const int p0 = blockIdx.x * kBN;
  const float* xb = x + bz * x_batch;
  const float* cb = c + static_cast<long long>(bz) * L * h;
  const int n_h = (h + kBH - 1) / kBH;
  const int n_steps = (L + kBL - 1) / kBL * n_h;

  // step s stages chunk s % n_h of centroid tile s / n_h into buffer s & 1
  auto issue = [&](int step) {
    Stage<kBH>& st = stage[step & 1];
    const int c0 = step / n_h * kBL, h0 = step % n_h * kBH;
    for (int e = t; e < kBN * kBH; e += kThreads) {
      const int r = e / kBH, d = e % kBH;
      const int gp = p0 + r, gc = c0 + r, gd = h0 + d;
      const bool okx = gp < N && gd < h, okc = gc < L && gd < h;
      copy4(&st.x[d][r], okx ? xb + gp * x_row + gd : xb, okx);
      copy4(&st.c[d][r], okc ? cb + static_cast<long long>(gc) * h + gd : cb,
            okc);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  issue(0);
  float acc[8][8];
  float norm = 0.f;                          // thread t < kBL: centroid t
  for (int step = 0; step < n_steps; ++step) {
    const int c0 = step / n_h * kBL;
    const bool first = step % n_h == 0, last = step % n_h == n_h - 1;
    if (first) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      norm = 0.f;
    }
    // the next chunk's copies run while this one is computed
    if (step + 1 < n_steps) {
      issue(step + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const Stage<kBH>& st = stage[step & 1];
    if (t < kBL) {
#pragma unroll
      for (int d = 0; d < kBH; ++d) norm = fmaf(st.c[d][t], st.c[d][t], norm);
    }
    // features in order; zero padding past h adds exact zeros
#pragma unroll 8
    for (int d = 0; d < kBH; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(&st.x[d][4 * tp]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&st.x[d][64 + 4 * tp]);
      const float4 b0 = *reinterpret_cast<const float4*>(&st.c[d][4 * tc]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&st.c[d][64 + 4 * tc]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (last) {
      if (t < kBL) s_half[t] = 0.5f * norm;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float s = -CUDART_INF_F;
        int idx = 0x7fffffff;
#pragma unroll
        for (int j = 0; j < 8; ++j) {        // ascending index: strict >
          const int gc = c0 + slot(tc, j);
          const float v = acc[i][j] - s_half[slot(tc, j)];
          if (gc < L && (idx == 0x7fffffff || v > s)) {
            s = v;
            idx = gc;
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float os = __shfl_xor_sync(kFull, s, off);
          const int oi = __shfl_xor_sync(kFull, idx, off);
          if (os > s || (os == s && oi < idx)) {
            s = os;
            idx = oi;
          }
        }
        const int p = slot(tp, i);           // one lane owns each point
        if (tc == 0 && (c0 == 0 || s > s_best[p])) {
          s_best[p] = s;
          s_arg[p] = idx;
        }
      }
    }
    __syncthreads();              // buffer step & 1 and s_half free again
  }

  for (int p = t; p < kBN; p += kThreads) {
    const int gp = p0 + p;
    if (gp < N) {
      out_s[static_cast<long long>(bz) * N + gp] = s_best[p];
      out_i[static_cast<long long>(bz) * N + gp] = s_arg[p];
    }
  }
}

template <int kBH>
int launch(const void* x, const void* c, void* out_s, void* out_i,
           long long x_batch, long long x_row, int B, int N, int L, int h,
           cudaStream_t stream) {
  constexpr int bytes = 2 * static_cast<int>(sizeof(Stage<kBH>));
  const cudaError_t err = cudaFuncSetAttribute(
      assign_kernel<kBH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, 1, B);
  assign_kernel<kBH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<float*>(out_s), static_cast<int*>(out_i), x_batch, x_row,
      N, L, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, N, h) f32 given by its batch and row strides in elements (features
// unit-stride); c (B, L, h) f32 contiguous → out_s (B, N) f32 and out_i
// (B, N) i32, contiguous.  B <= 65,535, L >= 1.  Launches on `stream`
// without synchronizing; returns cudaGetLastError().
int assign_argmax_launch(const void* x, const void* c, void* out_s,
                         void* out_i, long long x_batch, long long x_row,
                         int B, int N, int L, int h, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || L < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return h <= 16 ? launch<16>(x, c, out_s, out_i, x_batch, x_row, B, N, L, h,
                              st)
                 : launch<32>(x, c, out_s, out_i, x_batch, x_row, B, N, L, h,
                              st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
