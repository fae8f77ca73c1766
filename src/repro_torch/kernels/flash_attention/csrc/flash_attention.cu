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
// (kernel.py:88-94).  The TPU kernel runs its kv dimension as a sequential
// grid axis carrying (m, l, acc) in VMEM scratch (kernel.py:54-94); here a
// block owns one work item (batch, q-head, q tile) and loops over the
// item's live kv tiles itself, so the online-softmax state stays in
// registers.  The causal and window masks bound each item's live keys by
// absolute position (kernel.py:46-53), and only those tiles are walked.
// Inputs are read through their (b, h, s) strides (the feature stride is
// 1), so (B, S, H, d) projections viewed as (B, H, S, d) need no copy.
// Two kernels share that frame, one for each dtype.
//
// bf16: the tensor-core kernel (flash_tc_kernel).  At the LM shapes (S
// 4,096, d 80-128) the work is over 1,000 FLOPs a byte of q, k, v and
// out, so the bound is the bf16 tensor cores' 989 TFLOP/s.  A product of
// two bf16 values is exact in fp32, so bf16 mma with fp32 accumulation
// forms the reference's q.f32 · k.f32 products; only the order of
// summation differs.  With 16 query rows a warp, each warp reads the whole
// K and V tile from shared memory for its rows (16 FLOPs a shared byte),
// so shared memory's bandwidth holds the kernel near half the tensor-core
// peak; PERF.md §6 has what it reaches.
//   * Products.  QKᵀ and P·V run on mma.sync m16n8k16 (bf16 in, fp32
//     accumulate).  A block of kWarps warps owns kQRows query rows, 16 a
//     warp; a warp's Q fragments are read by ldmatrix once and stay in
//     registers for the whole kv loop.  K fragments come by ldmatrix, V's
//     by ldmatrix.trans (V is [key][d] in shared memory, the B operand
//     wants it column-major).
//   * Softmax in registers.  The row max of the fp32 scores is taken across
//     a quad of lanes by __shfl_xor_sync, then each p is one FFMA (s · scale
//     · log2 e − m: the scale after the product, where the reference scales
//     q before, one f32 rounding apart) and one ex2.approx; a negative
//     scale negates Q's fragments instead (exactly), so the scale the
//     scores take is positive.  l sums the fp32 p, across the quad at the
//     end.  P is rounded to bf16 and fed straight in as the A operand of
//     P·V: the accumulator layout of m16n8k16 is the A layout of the next
//     product, so P never leaves registers.  That rounding is the one this
//     kernel adds: lse does not see it, and out is bf16.  The
//     accumulators are rescaled only when a row max of the warp moved.
//   * Copies.  K and V tiles go global → shared by 16-byte cp.async into a
//     ring of kStages tiles: tile j + kStages - 1 is in flight while tile
//     j computes, and one barrier a tile frees the stage the next copy
//     fills.  The ragged Sk edge and a ragged head dim are zero-filled
//     through the copy's source size (a whole tile skips that
//     arithmetic).  Rows are padded by 16 bytes (D + 8 elements), so the
//     eight 16-byte rows one ldmatrix reads fall in distinct bank groups
//     at every D (at D 128, 272-byte rows; at D 80, 176-byte rows): no
//     swizzle.  Misaligned inputs (vec = 0) run the same kernel with
//     element-wise copies through registers.
//   * Masks.  A warp tests its 16 rows against a tile's keys as a whole:
//     a tile no key of which its rows can see is skipped, a tile all of
//     which they see takes no per-element test, and only tiles that cross
//     the diagonal, the window's edge or the ragged Sk edge are masked
//     element by element (to -inf; a row max of -inf subtracts 0, so a
//     row that has seen no key keeps p = 0, l = 0).
//   * Order.  Items are numbered head by head, each head's q tiles from
//     the last to the first: under a causal mask the last tiles walk the
//     most kv tiles, so each head's longest items start first and the
//     grid ends on short ones, while the blocks resident together still
//     share a few heads' K and V in L2.
//   * Output.  A warp writes its rows, scaled by 1 / l and rounded to
//     bf16, into its own rows of the Q tile in shared memory, then copies
//     them out 16 bytes a lane (columns >= d are never stored).
//   Instances: D in {16, 32, 64, 80, 128}; a head dim d that is none of
//   them runs in the next one up, columns d .. D - 1 zero-filled (exact
//   zeros added to every score).
//
// f32: the FMA kernel (flash_fwd_kernel), redesigned for the HI²_sup
// encoder's shape (S 64, d 64), where the score plane of a head is one
// 64 x 64 tile and the work is 4·S²·d FLOPs per (batch, head) against
// 4·S·d·4 bytes: about 8 FLOPs a byte, so the byte floor (0.97 ms per
// encoder chunk) and the fp32 FMA floor (0.77 ms) lie close together.  The
// products stay in fp32 FMAs, not TF32: the port keeps TF32 off so the
// card agrees with the plain version to fp32 rounding.
//   * Loads.  A block of 128 threads owns a 64-row q tile and walks 64-key
//     kv tiles, copied by cp.async, 16 bytes a thread; q and k form one
//     copy group and v another, so the score product starts while v is
//     still in flight.  The element-wise instance (VEC = false) serves
//     misaligned inputs.
//   * Overlap.  The tiles are single-buffered, and a block's loads overlap
//     the FMAs of the other blocks on its SM: at d <= 64 the registers
//     (128 a thread) and shared memory (51 KB) let four blocks reside per
//     SM, two at d = 128.  A persistent grid that double-buffers the next
//     step's tiles was measured slower at the encoder's shape (PERF.md §6).
//   * Fed FMA pipes.  Thread t owns query rows 4·(t/8) + i (i < 4) and keys
//     t%8 + 8·j (j < 8) of the score tile, and the same rows × d/8 output
//     columns of the accumulator.  q and k rows are staged padded by 16
//     bytes, so the 8 lanes of a row group read 8 consecutive k rows
//     without bank conflicts; each 128-bit shared read feeds 4 features.  p
//     goes through shared memory in the row layout of its warp only, so
//     the p·v product needs a warp barrier, not a block one; at d >= 64 p
//     reuses the k buffer of the step.  Scores are kept in log2 units
//     (scale·log2 e folded into one multiply), so each p is one exp2.
//   * Masks.  A tile with no mask inside skips the per-key tests, and
//     within any other tile p is masked explicitly, since with a finite
//     NEG_INF exp(s - m) would be 1 on a fully-masked row.  An item with
//     no live key runs one masked step and writes zeros and NEG_INF.
//   * Head dims.  Instances exist for D in {16, 32, 64, 128}; a head dim
//     outside them (SASRec's d = 50) runs ragged in the next instance up
//     (RAG = true), its columns d .. D - 1 zero-filled on load and never
//     stored.  The RAG = false instances are the code they were before the
//     ragged path existed.
#include <climits>
#include <cmath>
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
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
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 4 consecutive f32 elements (one 16-byte shared read)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// W consecutive elements of v (W = 4 or 2)
template <int W>
__device__ __forceinline__ void ldv(const float* p, float* o) {
  if constexpr (W == 4) {
    const float4 x = ld4(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
}

// W consecutive output elements, as one vector store when VEC
template <bool VEC, int W>
__device__ __forceinline__ void stv(float* p, const float* x) {
  if constexpr (VEC && W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
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

// ---- the bf16 tensor-core kernel ---------------------------------------

// the tile shape, chosen by measurement (kernel_variants --variant sets
// these; PERF.md §6 has the shapes tried)
constexpr int kQRows = 128;      // query rows an item
constexpr int kKeys = 64;        // keys a kv tile
constexpr int kWarps = 8;        // warps a block, 16 query rows each
constexpr int kStages = 2;       // kv tiles in the shared ring
constexpr int kTcThreads = 32 * kWarps;
static_assert(kWarps * 16 == kQRows, "16 query rows a warp");
static_assert(kQRows >= kBQ, "the entry's item limit counts 64 rows");
static_assert(kKeys % 16 == 0 && kStages >= 2, "tile shape");

using bf16 = __nv_bfloat16;

template <int D>
struct TcLayout {
  static constexpr int kRow = D + 8;   // staged row, elements (16-byte pad)
  static constexpr int kTile = kKeys * kRow;      // one K or V stage
  static constexpr int kBytes =
      (kQRows + 2 * kStages * kKeys) * kRow * static_cast<int>(sizeof(bf16));
  static constexpr int kFit = kSmemPerSM / (kBytes + 1024);
  // blocks an SM the registers are sized for: 8 warps at D >= 64 (up to
  // 255 registers a thread; D 64 spilled at 128), 16 below
  static constexpr int kWant = (D >= 64 ? 8 : 16) / kWarps;
  static constexpr int kMinBlocks =
      kFit < 1 ? 1 : (kFit < kWant ? kFit : (kWant < 1 ? 1 : kWant));
  static_assert(D % 16 == 0, "d in {16, 32, 64, 80, 128}");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2 (the hardware approximation, ~2 ulp; results
// below 2^-126 flush to zero, which a p that small contributes anyway);
// exp2f adds range fixes around the same instruction
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as a bf16 pair: lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// rows row0 .. row0 + ROWS - 1 of a (n, D) slab whose row r starts at
// src + r * row_stride into dst rows of D + 8 elements; rows >= n and
// columns >= dh are zeros.  VEC: one 16-byte cp.async per chunk (the
// source size cut at the edges, and not computed where the tile is whole);
// otherwise element by element.
template <bool VEC, int D, int ROWS>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src,
                                        long long row_stride, int row0,
                                        int n, int dh) {
  constexpr int kPerRow = D / 8;
  constexpr int kChunks = ROWS * kPerRow;
  if (VEC && row0 + ROWS <= n && dh == D) {   // every chunk whole
#pragma unroll
    for (int i = 0; i < (kChunks + kTcThreads - 1) / kTcThreads; ++i) {
      const int c = static_cast<int>(threadIdx.x) + i * kTcThreads;
      if (kChunks % kTcThreads != 0 && c >= kChunks) break;
      const int r = c / kPerRow, e = (c % kPerRow) * 8;
      cp_async16(dst + r * TcLayout<D>::kRow + e,
                 src + static_cast<long long>(row0 + r) * row_stride + e);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < (kChunks + kTcThreads - 1) / kTcThreads; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * kTcThreads;
    if (kChunks % kTcThreads != 0 && c >= kChunks) break;
    const int r = c / kPerRow, e = (c % kPerRow) * 8;
    const int gr = row0 + r;
    const bool in = gr < n;
    bf16* d = dst + r * TcLayout<D>::kRow + e;
    const bf16* s = src + static_cast<long long>(in ? gr : 0) * row_stride + e;
    if constexpr (VEC) {
      const int live = (dh - e) * 2;
      cp_async16(d, s, in ? (live < 0 ? 0 : live > 16 ? 16 : live) : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        d[u] = in && e + u < dh ? s[u] : zero<bf16>();
    }
  }
}

// grid: one block per item; dynamic shared memory TcLayout<D>::kBytes:
// the Q tile, then kStages K tiles, then kStages V tiles
template <int D, bool VEC>
__global__ void __launch_bounds__(kTcThreads, TcLayout<D>::kMinBlocks)
flash_tc_kernel(const Params p) {
  using L = TcLayout<D>;
  constexpr int kRow = L::kRow;
  constexpr int kKD = D / 16;          // k-steps of QKᵀ
  constexpr int kND = D / 8;           // n-tiles of P·V (output columns)
  constexpr int kNK = kKeys / 8;       // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kQRows * kRow;
  bf16* sv = sk + kStages * L::kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row, column pair
  // items head by head, each head's q tiles from the last to the first
  const int bh = blockIdx.x / p.n_qtiles;
  const int qt = p.n_qtiles - 1 - static_cast<int>(blockIdx.x) % p.n_qtiles;
  const int h = bh % p.hq, b = bh / p.hq, hk = h / p.group;
  const int q0 = qt * kQRows;
  const int w0 = q0 + 16 * warp;               // the warp's first row
  const int wl = min(w0 + 15, p.sq - 1);       // its last stored row
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h;

  // the item's live keys (kernel.py:46-53), from a tile boundary
  const int last_q = min(q0 + kQRows, p.sq) - 1;
  int beg = 0, end = p.sk;
  if (p.window > 0) beg = max(0, q0 - p.window + 1) / kKeys * kKeys;
  if (p.causal) end = min(end, last_q + 1);
  if (p.window > 0 && !p.causal) end = min(end, last_q + p.window);
  const int n_tiles = end > beg ? (end - beg + kKeys - 1) / kKeys : 0;

  auto issue = [&](int j) {          // kv tile j into stage j % kStages
    if (j < n_tiles) {
      const int st = j % kStages, k0 = beg + j * kKeys;
      tc_load<VEC, D, kKeys>(sk + st * L::kTile, kg, p.ks.s, k0, p.sk, p.dh);
      tc_load<VEC, D, kKeys>(sv + st * L::kTile, vg, p.vs.s, k0, p.sk, p.dh);
    }
    cp_async_commit();
  };
  if (n_tiles > 0)
    tc_load<VEC, D, kQRows>(sq, qg, p.qs.s, q0, p.sq, p.dh);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  // scores in log2 units: s · sc, with sc > 0 (a negative scale negates
  // Q's fragments instead, exactly), so the row max of s · sc is the
  // scaled row max of s and each p is one FFMA and one ex2
  const float sc = fabsf(p.scale) * kLog2e;
  // a key kp is visible to row qp when kp < sk and lo <= qp - kp < hi
  // (and qp < sq: rows past it are never stored, so never masked)
  const int lo = p.causal ? 0 : p.window > 0 ? 1 - p.window : INT_MIN;
  const int hi = p.window > 0 ? p.window : INT_MAX;
  unsigned qf[kKD][4];                         // the warp's Q fragments
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};         // rows g and g + 8
  float l[2] = {0.f, 0.f};                     // this lane's columns only

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();              // tile j landed
    __syncthreads();                           // ... for every thread, and
    issue(j + kStages - 1);                    // its stage from j - 1 is free
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < kKD; ++kd) {
        ldsm_x4(qf[kd], sq + (16 * warp + (lane & 15)) * kRow + kd * 16
                            + (lane >> 4) * 8);
        if (p.scale < 0.f) {
#pragma unroll
          for (int u = 0; u < 4; ++u) qf[kd][u] ^= 0x80008000u;
        }
      }
    }
    // the warp's rows [w0, wl] against the tile's keys [k0, kl]
    const int k0 = beg + j * kKeys, kl = k0 + kKeys - 1;
    bool dead = w0 >= p.sq, full = kl < p.sk;
    if (p.causal) {
      dead |= k0 > wl;
      full &= kl <= w0;
    }
    if (p.window > 0) {
      dead |= w0 - kl >= p.window;
      full &= wl - k0 < p.window;
      if (!p.causal) {
        dead |= k0 - wl >= p.window;
        full &= kl - w0 < p.window;
      }
    }
    if (dead) continue;                        // no key visible to the warp

    const bf16* kt = sk + j % kStages * L::kTile;
    const bf16* vt = sv + j % kStages * L::kTile;
    float s[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd) {
#pragma unroll
      for (int n = 0; n < kNK; n += 2) {
        unsigned bk[4];
        ldsm_x4(bk, kt + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * kRow
                       + kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qf[kd], bk[0], bk[1]);
        mma_bf16(s[n + 1], qf[kd], bk[2], bk[3]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
    if (full) {
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    } else {                 // the diagonal, the window's edge, Sk's edge
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * tq + (e & 1);
          const int diff = w0 + g + 8 * (e >> 1) - kp;
          if (!(kp < p.sk && diff >= lo && diff < hi)) s[n][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sc);
      // a row that has seen no key yet keeps m = -inf: subtract 0, so its
      // p and alpha are 2^-inf = 0
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // most tiles move no row max of the warp: then alpha is 1 everywhere
    if (!__all_sync(kFull, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], sc, -base[e >> 1]));
        l[e >> 1] += s[n][e];
      }
    }
    // P (bf16, in registers) · V: the accumulators of score n-tiles 2kk
    // and 2kk + 1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kND; n += 2) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * kRow + 8 * n + (lane >> 4) * 8);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // out: 1 / l and bf16 into the warp's own rows of the Q tile (no other
  // warp reads them), then 16 bytes a lane to global memory
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  bf16* stage = sq + 16 * warp * kRow;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    *reinterpret_cast<unsigned*>(stage + g * kRow + 8 * n + 2 * tq) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * kRow + 8 * n + 2 * tq) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(p.out) + b * p.os.b + h * p.os.h;
  for (int c = lane; c < 16 * kND; c += 32) {
    const int r = c / kND, e = (c % kND) * 8;
    const int qp = w0 + r;
    if (qp >= p.sq) continue;
    const bf16* src = stage + r * kRow + e;
    bf16* dst = ob + qp * p.os.s + e;
    if (VEC && e + 8 <= p.dh) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int u = 0; u < 8 && e + u < p.dh; ++u) dst[u] = src[u];
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = w0 + g + 8 * r;
      if (qp < p.sq)
        p.lse[static_cast<long long>(bh) * p.sq + qp] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
    }
  }
}

template <int D, bool VEC>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int bytes = TcLayout<D>::kBytes;
  auto kernel = flash_tc_kernel<D, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_items, kTcThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 instance of head dim d: D = the least of {16, 32, 64, 80, 128}
// >= d (columns d .. D - 1 zero-filled)
template <bool VEC>
int dispatch_tc(int d, const Params& p, cudaStream_t stream) {
  if (d <= 16) return launch_tc<16, VEC>(p, stream);
  if (d <= 32) return launch_tc<32, VEC>(p, stream);
  if (d <= 64) return launch_tc<64, VEC>(p, stream);
  if (d <= 80) return launch_tc<80, VEC>(p, stream);
  return launch_tc<128, VEC>(p, stream);
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
// 1); lse (B, Hq, Sq) f32 contiguous.  dtype 0 = f32 (the FMA kernel), 1 =
// bf16 (the tensor-core kernel) for q, k, v and out.  1 <= d <= 128 (a d
// outside the dtype's instances, {16, 32, 64, 128} for f32 and {16, 32,
// 64, 80, 128} for bf16, runs ragged in the next one up); Hq a multiple of
// Hkv; B·Hq·ceil(Sq / 64) < 2^31.  vec = 1 takes the 16-byte cp.async
// instance, which needs every base pointer 16-byte aligned and every
// stride a multiple of 16 bytes (refused otherwise); vec = 0 the
// element-wise one.  Launches on `stream` without synchronizing; returns
// cudaGetLastError().
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
  if (static_cast<long long>(B) * hq * ((sq + kBQ - 1) / kBQ) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = dtype == 0 ? kBQ : kQRows;     // query rows an item
  const int n_qtiles = (sq + rows - 1) / rows;
  const Params p{q, k, v, out, static_cast<float*>(lse),
                 Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
                 Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
                 hq, hq / hkv, sq, sk, causal, window, n_qtiles,
                 B * hq * n_qtiles, d, scale};
  const int size = dtype == 0 ? 4 : 2;
  if (vec && !(aligned16(q, p.qs, size) && aligned16(k, p.ks, size) &&
               aligned16(v, p.vs, size) && aligned16(out, p.os, size)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? dispatch_d<float, true>(d, p, st)
               : dispatch_d<float, false>(d, p, st);
  return vec ? dispatch_tc<true>(d, p, st) : dispatch_tc<false>(d, p, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
