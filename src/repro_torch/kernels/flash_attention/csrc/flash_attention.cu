// flash_attention — forward attention with causal and sliding-window masks
// and grouped-query heads, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (entry flash_attention, pallas_call at kernel.py:117):
//
//     out[b, h, i] = sum_j softmax_j(scale * <q[b, h, i], k[b, h / g, j]>
//                                    masked) * v[b, h / g, j]
//     lse[b, h, i] = logsumexp_j(the same masked scores)
//
// with NEG_INF = -1e30 on masked scores, masks by absolute position, and a
// query row with no visible key giving zeros and lse = NEG_INF
// (kernel.py:88-94).
//
// Bound on the H100.  At the HI²_sup term scorer's shape (S = 64, d = 64)
// the score plane of a head is one 64 x 64 tile, so the work is 4·S²·d
// FLOPs per (batch, head) against 4·S·d·4 bytes of q, k, v and out: about
// 8 FLOPs a byte, below the 20 the card's fp32 rate needs to outrun its
// memory, so the kernel is bound by bytes.  At long sequences (S = 4,096)
// it is bound by operations.  The products stay in fp32 FMAs, not TF32 or
// bf16 tensor cores: the port keeps TF32 off so the card agrees with the
// plain version to fp32 rounding.
//
// Design.  The TPU kernel runs its kv dimension as a sequential grid axis
// carrying (m, l, acc) in VMEM scratch across grid steps (kernel.py:54-94).
// Here one block of 256 threads owns one (batch, q-head, 64-row q tile) and
// loops over the 64-row kv tiles itself, so the online-softmax state never
// leaves the block: each thread keeps m and l of its 4 rows and the
// accumulator of its 4 rows x d/16 output columns in registers.  Per kv
// tile: k and v are staged in shared memory as f32 (bf16 inputs are
// widened on load); each thread computes a 4 x 4 register tile of scores
// (rows 4·(t/16) + i, keys t%16 + 16·j) with one FMA per feature in order;
// the 16 lanes that share rows reduce the row max and sum with shuffles;
// p goes through shared memory for the p·v product.  Padding the q and k
// rows to d + 1 floats keeps the column reads free of bank conflicts.
// Kv tiles that the causal or window mask leaves fully dead are skipped
// (kernel.py:46-53); within a live tile p is masked explicitly, since with
// a finite NEG_INF exp(s - m) would be 1 on a fully-masked row.  The ragged
// Sq / Sk edges are masked from the true lengths: the wrapper pads nothing.
// q, k, v and out are read and written through their strides (last dim
// unit), so (B, S, H, d) data viewed as (B, H, S, d) needs no copy.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;             // elements; the feature stride is 1
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

// grid (ceil(Sq / kBQ), Hq, B); dynamic shared memory smem_floats<D>() f32
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int hq, int group, int sq, int sk, int causal,
                 int window, float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                          // [kBQ][D + 1], pre-scaled
  float* s_k = s_q + kBQ * (D + 1);           // [kBK][D + 1]
  float* s_v = s_k + kBK * (D + 1);           // [kBK][D]
  float* s_p = s_v + kBK * D;                 // [kBQ][kBK + 1]

  constexpr int kCols = D / 16;               // output columns per thread
  const int t = threadIdx.x;
  const int tr = t >> 4;                      // rows 4 tr + i, i < 4
  const int tc = t & 15;                      // keys / columns tc + 16 j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = t; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = q0 + r;
    s_q[r * (D + 1) + c] = gr < sq ? load(qb + gr * qs.s + c) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[i][u] = 0.f;
  }

  const int first_q = q0, last_q = min(q0 + kBQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += kBK) {
    // tile-level skip, uniform over the block (kernel.py:46-53)
    const int last_k = min(k0 + kBK, sk) - 1;
    bool live = true;
    if (causal) live = live && k0 <= last_q;
    if (window > 0) {
      live = live && last_k > first_q - window;
      if (!causal) live = live && k0 < last_q + window;
    }
    if (!live) continue;

    __syncthreads();                          // previous tile's readers done
    for (int e = t; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int gr = k0 + r;
      const bool in = gr < sk;
      s_k[r * (D + 1) + c] = in ? load(kb + gr * ks.s + c) : 0.f;
      s_v[r * D + c] = in ? load(vb + gr * vs.s + c) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(4 * tr + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = s_k[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * tr + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        bool valid = qp < sq && kp < sk;
        if (causal) valid = valid && qp >= kp;
        if (window > 0) {
          valid = valid && qp - kp < window;
          if (!causal) valid = valid && kp - qp < window;
        }
        ok[j] = valid;
        s[i][j] = valid ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // explicit mask: exp(s - m) is 1 where a whole row is NEG_INF
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        s_p[(4 * tr + i) * (kBK + 1) + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[i][u] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(4 * tr + i) * (kBK + 1) + j];
#pragma unroll
      for (int u = 0; u < kCols; ++u) vv[u] = s_v[j * D + tc + 16 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          acc[i][u] = fmaf(pv[i], vv[u], acc[i][u]);
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * tr + i;
    if (qp >= sq) continue;
    const bool any = l[i] > 0.f;
    const float inv = any ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      store(ob + qp * os.s + tc + 16 * u, acc[i][u] * inv);
    if (tc == 0)
      lse[(static_cast<long long>(b) * hq + h) * sq + qp] =
          any ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, Strides qs, Strides ks, Strides vs, Strides os, int B,
           int hq, int hkv, int sq, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), qs, ks, vs, os, hq, hq / hkv, sq, sk,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               void* lse, Strides qs, Strides ks, Strides vs, Strides os,
               int B, int hq, int hkv, int sq, int sk, int causal,
               int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, qs, ks, vs, os, B, hq, hkv,
                           sq, sk, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, qs, ks, vs, os, B, hq, hkv,
                           sq, sk, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, qs, ks, vs, os, B, hq, hkv,
                           sq, sk, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, qs, ks, vs, os, B, hq, hkv,
                            sq, sk, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, d), k / v (B, Hkv, Sk, d), out (B, Hq, Sq, d), each given
// by its batch, head and row strides in elements (the feature stride is
// 1); lse (B, Hq, Sq) f32 contiguous.  dtype 0 = f32, 1 = bf16 for q, k,
// v and out.  d in {16, 32, 64, 128}; Hq a multiple of Hkv; B <= 65,535.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh,
                        long long vss, long long osb, long long osh,
                        long long oss, int B, int hq, int hkv, int sq,
                        int sk, int d, int dtype, int causal, int window,
                        float scale, void* stream) {
  if (B < 1 || B > 65535 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 ||
      sk < 1 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, out, lse, qs, ks, vs, os, B, hq,
                             hkv, sq, sk, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, lse, qs, ks, vs, os,
                                     B, hq, hkv, sq, sk, causal, window,
                                     scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
