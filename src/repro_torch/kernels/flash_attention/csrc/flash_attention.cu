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
// 8 FLOPs a byte, so the byte floor (0.97 ms per encoder chunk) and the
// fp32 FMA floor (0.77 ms) lie close together, and the kernel nears its
// bound only if its loads overlap its FMAs and the FMA pipes are fed.  At
// long sequences (S = 4,096) it is bound by operations.  The products stay
// in fp32 FMAs, not TF32 or bf16 tensor cores: the port keeps TF32 off so
// the card agrees with the plain version to fp32 rounding.
//
// Design.  The TPU kernel runs its kv dimension as a sequential grid axis
// carrying (m, l, acc) in VMEM scratch across grid steps (kernel.py:54-94).
// Here a block of 128 threads owns one work item (batch, q-head, 64-row q
// tile) and loops over its 64-key kv tiles itself, so the online-softmax
// state stays in registers across the item's steps.
//
//   * Loads.  q, k and v tiles are copied global → shared by cp.async, 16
//     bytes a thread (8 bf16 or 4 f32 features of a row), with the ragged
//     Sq / Sk edge zero-filled through the copy's source size; bf16 stays
//     bf16 in shared memory and is widened on read.  q and k form one copy
//     group and v another, so the score product starts while v is still in
//     flight.  The wrapper picks this instance only when every base pointer
//     is 16-byte aligned and every (b, h, s) stride is a multiple of 16
//     bytes; otherwise the same kernel runs with VEC = false, which copies
//     element by element through registers.  Inputs are read through their
//     strides (last dim unit), so (B, S, H, d) data viewed as (B, H, S, d)
//     needs no copy.
//   * Overlap.  The tiles are single-buffered, and a block's loads overlap
//     the FMAs of the other blocks on its SM: at d <= 64 the registers
//     (128 a thread) and shared memory (51 KB at f32) let four blocks
//     reside per SM, two at d = 128.  A persistent grid that double-buffers
//     the next step's tiles was measured slower at both the encoder's and
//     llama3-8b's shapes, with half the blocks resident (PERF.md §6).
//   * Fed FMA pipes.  Thread t owns query rows 4·(t/8) + i (i < 4) and keys
//     t%8 + 8·j (j < 8) of the score tile, and the same rows × d/8 output
//     columns of the accumulator.  q and k rows are staged padded by 16
//     bytes, so the 8 lanes of a row group read 8 consecutive k rows
//     without bank conflicts; each 128-bit shared read feeds 4 features, so
//     the score loop issues 12 such reads per 128 FMAs, and the p·v loop the
//     same (p is read 4 keys at a time, v 4 columns at a time).  p goes
//     through shared memory in the row layout of its warp only, so the p·v
//     product needs a warp barrier, not a block one; at d·size >= 256 bytes
//     p reuses the k buffer of the step.  Scores are kept in log2 units
//     (scale·log2 e folded into one multiply), so each p is one exp2.
//   * Masks.  Each item walks only its live kv range (the causal and window
//     masks bound it by absolute position, kernel.py:46-53); a tile with no
//     mask inside skips the per-key tests, and within any other tile p is
//     masked explicitly, since with a finite NEG_INF exp(s - m) would be 1
//     on a fully-masked row.  An item with no live key runs one masked step
//     and writes zeros and NEG_INF.
//   * Head dims.  Instances exist for D in {16, 32, 64, 128}.  A head dim
//     d that is none of them (SASRec's d = 50) runs in the next instance
//     up (RAG = true): its columns d .. D - 1 are zero-filled on load (the
//     cp.async source size, or an explicit guard in the element-wise
//     copies) and never stored, and the scale is the caller's 1/sqrt(d).
//     Zero columns add exact zeros to every score, so a ragged row costs
//     D / d of the FMAs and no other rounding.  The RAG = false instances
//     are the code they were before the ragged path existed.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per item
constexpr int kBK = 64;          // keys per step
constexpr int kThreads = 128;    // 16 row groups x 8 key lanes
constexpr int kPStride = kBK + 4;  // floats per staged p row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSmemPerSM = 232448;   // shared memory an SM can give blocks
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;             // elements; the feature stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  Strides qs, ks, vs, os;
  int hq, group, sq, sk, causal, window, n_qtiles, n_items;
  int dh;                        // the true head dim, <= the instance's D
  float scale;
};

// shared layout of one instance
template <typename T, int D>
struct Layout {
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elems
  static constexpr int kRow = D + kChunk;          // staged q / k row, elems
  static constexpr int kVW = D >= 32 ? 4 : 2;      // output columns a vector
  static constexpr int kGroups = D / (8 * kVW);    // vectors per row a thread
  static constexpr int kCols = D / 8;              // output columns a thread
  static constexpr bool kAliasP =
      sizeof(T) * kRow >= sizeof(float) * kPStride;
  static constexpr int kQKBytes = kBQ * kRow * static_cast<int>(sizeof(T));
  static constexpr int kVBytes = kBK * D * static_cast<int>(sizeof(T));
  static constexpr int kPBytes = kAliasP ? 0 : kBQ * kPStride * 4;
  static constexpr int kQKVBytes = 2 * kQKBytes + kVBytes;
  static constexpr int kBytes = kQKVBytes + kPBytes;
  static constexpr int kFit = kSmemPerSM / (kBytes + 1024);
  // blocks per SM the registers are sized for (at most what shared memory
  // allows): 4 at d <= 64 (128 registers a thread), 2 at d = 128
  static constexpr int kWant = D <= 64 ? 4 : 2;
  static constexpr int kMinBlocks =
      kFit < 1 ? 1 : (kFit > kWant ? kWant : kFit);
  static_assert(D % 16 == 0 && kGroups >= 1, "d in {16, 32, 64, 128}");
};

// ---- 16-byte asynchronous copies -------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- element conversion and shared reads -----------------------------

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 4 consecutive elements widened to f32 (16- or 8-byte shared read)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// W consecutive elements of v (W = 4 or 2) widened to f32
template <int W, typename T>
__device__ __forceinline__ void ldv(const T* p, float* o) {
  if constexpr (W == 4) {
    const float4 x = ld4(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (sizeof(T) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = x.x; o[1] = x.y;
  }
}

// W consecutive output elements from f32, as one vector store when VEC
template <bool VEC, int W, typename T>
__device__ __forceinline__ void stv(T* p, const float* x) {
  if constexpr (VEC && sizeof(T) == 4 && W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC && sizeof(T) == 4 && W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else if constexpr (VEC && W == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (VEC) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) put(p + c, x[c]);
  }
}

// rows row0 .. row0 + 63 of a (rows, D) slab whose row r starts at
// src + r * row_stride, into dst rows of dst_row elements; rows >= n are
// zeros, and under RAG so are columns >= dh.  VEC: one 16-byte cp.async
// per chunk (src size 0 past the edge, short on the chunk that holds
// column dh); otherwise element by element through registers.
template <bool VEC, bool RAG, typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int dst_row, const T* src,
                                          long long row_stride, int row0,
                                          int n, int dh) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kChunk;
  for (int c = threadIdx.x; c < 64 * kPerRow; c += kThreads) {
    const int r = c / kPerRow, e = (c % kPerRow) * kChunk;
    const int gr = row0 + r;
    const bool in = gr < n;
    T* d = dst + r * dst_row + e;
    const T* s = src + static_cast<long long>(in ? gr : 0) * row_stride + e;
    if constexpr (VEC && RAG) {
      const int live = (dh - e) * static_cast<int>(sizeof(T));
      cp_async16(d, s, in ? (live < 0 ? 0 : live > 16 ? 16 : live) : 0);
    } else if constexpr (VEC) {
      cp_async16(d, s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        d[u] = in && (!RAG || e + u < dh) ? s[u] : zero<T>();
    }
  }
}

// ---- one item's steps -------------------------------------------------

// The block's item, (b · hq + h) · n_qtiles + q tile, read from %ctaid.x
// where it is used: an asm read is not hoisted out of the step loop, so
// the per-item base pointers are recomputed at each step's copy instead
// of staying live across the score product, where they spilled d = 64
// f32 past its 128 registers (PERF.md §6).
__device__ __forceinline__ int item_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(id));
  return static_cast<int>(id);
}

struct Keys {
  int beg, end;   // the item's live key range
};

// the causal and window masks bound the live keys by absolute position
// (kernel.py:46-53); with no live key, one fully-masked step still writes
// the item's rows
__device__ __forceinline__ Keys live_keys(const Params& p, int q0) {
  const int last_q = min(q0 + kBQ, p.sq) - 1;
  int beg = 0, end = p.sk;
  if (p.window > 0) beg = max(0, q0 - p.window + 1) / kBK * kBK;
  if (p.causal) end = min(end, last_q + 1);
  if (p.window > 0 && !p.causal) end = min(end, last_q + p.window);
  if (end <= beg) end = beg + 1;
  return Keys{beg, end};
}

// copy the tiles of the step at key k0: q (on the first step) and k as one
// cp.async group, v as the next
template <typename T, int D, bool VEC, bool RAG>
__device__ __forceinline__ void issue(const Params& p, int k0, bool with_q,
                                      T* qb, T* kb, T* vb) {
  constexpr int kRow = D + 16 / static_cast<int>(sizeof(T));
  const int item = item_id();
  const int qt = item % p.n_qtiles;
  const int bh = item / p.n_qtiles;
  const int h = bh % p.hq, b = bh / p.hq;
  const int hk = h / p.group;
  if (with_q) {
    const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
    load_tile<VEC, RAG, T, D>(qb, kRow, q, p.qs.s, qt * kBQ, p.sq, p.dh);
  }
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h;
  load_tile<VEC, RAG, T, D>(kb, kRow, k, p.ks.s, k0, p.sk, p.dh);
  cp_async_commit();
  load_tile<VEC, RAG, T, D>(vb, D, v, p.vs.s, k0, p.sk, p.dh);
  cp_async_commit();
}

// ---- the kernel ------------------------------------------------------

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = qp < p.sq && kp < p.sk;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window > 0) {
    ok = ok && qp - kp < p.window;
    if (!p.causal) ok = ok && kp - qp < p.window;
  }
  return ok;
}

// grid: one block per item; dynamic shared memory Layout<T, D>::kBytes
template <typename T, int D, bool VEC, bool RAG>
__global__ void __launch_bounds__(kThreads, Layout<T, D>::kMinBlocks)
flash_fwd_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int kRow = L::kRow, kVW = L::kVW, kCols = L::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qbuf = reinterpret_cast<T*>(smem);
  T* kbuf = reinterpret_cast<T*>(smem + L::kQKBytes);
  T* vbuf = reinterpret_cast<T*>(smem + 2 * L::kQKBytes);
  // p rows: the k tile's buffer once the scores are taken, or their own
  float* pbuf = reinterpret_cast<float*>(
      L::kAliasP ? smem + L::kQKBytes : smem + L::kQKVBytes);

  const int t = threadIdx.x;
  const int tr = t >> 3;                      // rows 4 tr + i, i < 4
  const int tc = t & 7;                       // keys tc + 8 j, j < 8
  const float qk_scale = p.scale * kLog2e;    // scores in log2 units
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[i][u] = 0.f;
  }

  const Keys keys = live_keys(p, (item_id() % p.n_qtiles) * kBQ);
  issue<T, D, VEC, RAG>(p, keys.beg, true, qbuf, kbuf, vbuf);
  for (int k0 = keys.beg;; k0 += kBK) {
    cp_async_wait<1>();                       // q and k landed
    __syncthreads();

    const T* qs = qbuf + (4 * tr) * kRow;
    const T* ks = kbuf + tc * kRow;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    // one feature quad an iteration keeps d = 64 f32 within 128 registers
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(qs + i * kRow + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bk = ld4(ks + 8 * j * kRow + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(a[i].x, bk.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk.w, s[i][j]);
        }
      }
    }
    cp_async_wait<0>();                       // v landed
    __syncthreads();                          // and every warp is done with k

    // no mask inside the tile: the common case skips the per-key tests
    const int q0 = (item_id() % p.n_qtiles) * kBQ;
    const bool full = !p.causal && p.window == 0 && k0 + kBK <= p.sk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * tr + i;
      unsigned ok = 0xffu;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!full) {
          const bool valid = visible(p, qp, k0 + tc + 8 * j);
          ok &= ~(static_cast<unsigned>(!valid) << j);
        }
        s[i][j] = (ok >> j) & 1u ? s[i][j] * qk_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
      float* prow = pbuf + (4 * tr + i) * kPStride + tc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // explicit mask: exp(s - m) is 1 where a whole row is NEG_INF
        const float pj = (ok >> j) & 1u ? exp2f(s[i][j] - m_new) : 0.f;
        prow[8 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = exp2f(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[i][u] *= alpha;
    }
    __syncwarp();                             // a warp reads its own p rows

    const float* ps = pbuf + (4 * tr) * kPStride;
    const T* vs = vbuf + tc * kVW;
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pp[i] = *reinterpret_cast<const float4*>(ps + i * kPStride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < L::kGroups; ++g) {
          float vv[kVW];
          ldv<kVW>(vs + (kk + e) * D + g * 8 * kVW, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? pp[i].x : e == 1 ? pp[i].y
                           : e == 2 ? pp[i].z : pp[i].w;
#pragma unroll
            for (int c = 0; c < kVW; ++c)
              acc[i][g * kVW + c] = fmaf(pe, vv[c], acc[i][g * kVW + c]);
          }
        }
      }
    }
    if (k0 + kBK >= keys.end) break;          // the item's last step
    __syncthreads();                          // the tiles may be refilled
    issue<T, D, VEC, RAG>(p, k0 + kBK, false, qbuf, kbuf, vbuf);
  }

  const int item = item_id();
  const int q0 = (item % p.n_qtiles) * kBQ;
  const int bh = item / p.n_qtiles;
  const int h = bh % p.hq, b = bh / p.hq;
  T* ob = static_cast<T*>(p.out) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * tr + i;
    if (qp >= p.sq) continue;
    const bool any = l[i] > 0.f;
    const float inv = any ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g) {
      float x[kVW];
#pragma unroll
      for (int c = 0; c < kVW; ++c) x[c] = acc[i][g * kVW + c] * inv;
      const int col = g * 8 * kVW + tc * kVW;
      if (RAG && col + kVW > p.dh) {        // columns >= dh are not stored
#pragma unroll
        for (int c = 0; c < kVW; ++c)
          if (col + c < p.dh) put(ob + qp * p.os.s + col + c, x[c]);
      } else {
        stv<VEC, kVW>(ob + qp * p.os.s + col, x);
      }
    }
    if (tc == 0)
      p.lse[static_cast<long long>(bh) * p.sq + qp] =
          any ? m[i] * kLn2 + logf(l[i]) : kNegInf;
  }
}

template <typename T, int D, bool VEC, bool RAG>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Layout<T, D>::kBytes;
  auto kernel = flash_fwd_kernel<T, D, VEC, RAG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_items, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the instance of head dim d: D = the least of {16, 32, 64, 128} >= d,
// ragged (RAG) when d < D
template <typename T, bool VEC, bool RAG>
int dispatch_d(int d, const Params& p, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16, VEC, RAG>(p, stream);
  if (d <= 32) return launch<T, 32, VEC, RAG>(p, stream);
  if (d <= 64) return launch<T, 64, VEC, RAG>(p, stream);
  return launch<T, 128, VEC, RAG>(p, stream);
}

template <typename T, bool VEC>
int dispatch_d(int d, const Params& p, cudaStream_t stream) {
  const bool rag = d != 16 && d != 32 && d != 64 && d != 128;
  return rag ? dispatch_d<T, VEC, true>(d, p, stream)
             : dispatch_d<T, VEC, false>(d, p, stream);
}

bool aligned16(const void* ptr, const Strides& s, int size) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0 &&
         (s.b * size) % 16 == 0 && (s.h * size) % 16 == 0 &&
         (s.s * size) % 16 == 0;
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, d), k / v (B, Hkv, Sk, d), out (B, Hq, Sq, d), each given
// by its batch, head and row strides in elements (the feature stride is
// 1); lse (B, Hq, Sq) f32 contiguous.  dtype 0 = f32, 1 = bf16 for q, k,
// v and out.  1 <= d <= 128 (d outside {16, 32, 64, 128} runs ragged in the
// next instance up); Hq a multiple of Hkv; B·Hq·ceil(Sq / 64) < 2^31.  vec = 1 takes the 16-byte cp.async instance, which needs
// every base pointer 16-byte aligned and every stride a multiple of 16
// bytes (refused otherwise); vec = 0 the element-wise one.  Launches on
// `stream` without synchronizing; returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh,
                        long long vss, long long osb, long long osh,
                        long long oss, int B, int hq, int hkv, int sq,
                        int sk, int d, int dtype, int causal, int window,
                        float scale, int vec, void* stream) {
  if (B < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 ||
      d < 1 || d > 128 || window < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qtiles = (sq + kBQ - 1) / kBQ;
  const long long n_items = static_cast<long long>(B) * hq * n_qtiles;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, static_cast<float*>(lse),
                 Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
                 Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
                 hq, hq / hkv, sq, sk, causal, window,
                 static_cast<int>(n_qtiles), static_cast<int>(n_items),
                 d, scale};
  const int size = dtype == 0 ? 4 : 2;
  if (vec && !(aligned16(q, p.qs, size) && aligned16(k, p.ks, size) &&
               aligned16(v, p.vs, size) && aligned16(out, p.os, size)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? dispatch_d<float, true>(d, p, st)
               : dispatch_d<float, false>(d, p, st);
  return vec ? dispatch_d<__nv_bfloat16, true>(d, p, st)
             : dispatch_d<__nv_bfloat16, false>(d, p, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
