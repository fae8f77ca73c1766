// sq8_dot_fused — fused gather + SQ8 dequantized dot + live mask for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/sq8_dot/kernel.py::_sq8_fused_kernel
// (entry sq8_dot_fused, pallas_call at kernel.py:79):
//
//     out[b, c] = sum_{d < h} q_scaled[b, d] * float(plane[clip(ids[b, c]), d])
//                                                          if live[b, c]
//               = -inf                                     otherwise
//
// Bias-free, as on the TPU: the SQ8 scorer adds <q, lo> after the mask.
//
// Bound on the H100: bytes.  The work is a random gather of h-byte rows
// (768 B at h = 768) from a plane far larger than L2, one FMA per byte.
// The least traffic reads each distinct live row once; the queries of a
// served batch share rows (every query that probes an inverted list holds
// its ids in the same order), and reading each live lane's row, as the
// kernel before this one did, moves 2.3x the distinct rows at the
// serve_msmarco shape.  Random row gathers saturate near 2.7-2.9 TB/s of
// requested rows on the H100, so the time follows the rows requested.
// Here a row is requested once for a group of queries:
//
//   * Items and groups.  The (B, C) candidate plane is cut into items of
//     kTileSlots slots, one query's slots [t kTileSlots, (t + 1)
//     kTileSlots).  The wrapper (ops.schedule) keys each item by the
//     clipped id of its first slot (a key of its own where that slot is
//     dead: PAD tails) and sorts the keys on the device.  A block takes a
//     group: up to kGroupMax equal keys, cut from the start of their run
//     inside one window of kWindow sorted positions, so the block at a
//     position decides from the keys of its window (one warp's look back)
//     whether it leads one; the grid has one block per position and the
//     others exit at once.  Groups of one key run in neighbouring blocks,
//     so their repeated rows tend to hit L2.
//   * Slots.  A thread owns a slot: the row is that of the first item whose
//     lane is live there, and it serves every item live there with that id
//     (the match mask); an item live with another id reads its own row
//     afterwards (the differ mask), so the result is exact for any ids.
//     Dead lanes read nothing and score -inf; scores are written by the
//     slot's thread, coalesced across the warp.
//   * Rows.  A warp's 32 rows stream through shared memory in chunks of
//     kChunk bytes, copied by the whole warp with 16-byte cp.async (each
//     instruction 4 whole 128-byte lines), kStages chunks in flight; rows
//     are padded so that each thread reads its own row back without bank
//     conflicts.  Each byte becomes a float once, exactly and without I2F
//     (a PRMT puts it in the mantissa of 2^23, an FADD subtracts 2^23),
//     and feeds every query of the match mask.
//   * Queries.  The group's query rows are staged in shared memory; all
//     lanes of a warp read the same query element at the same time, so each
//     128-bit read is one broadcast.  (Lanes owning vectors of one row, as
//     before, read a distinct query element an FMA: as slow as the gather
//     itself.)
//   * Registers.  A thread keeps 16 lane sums per query of the group, so
//     kGroupMax = 2 keeps it at three 128-thread blocks an SM; larger
//     groups request fewer rows but lose residency (PERF.md §6 has the
//     variants).
//   * The scalar instance (h % 16 != 0, or a plane not 16-byte aligned)
//     copies the 4-byte words that cover each row's chunk (rows start at
//     any byte; cp.async where a word lies inside the plane, else byte by
//     byte) and shifts its bytes out of them.
//
// Order: every score is summed as by the kernel before this one, so the
// results are equal bit for bit.  That kernel gave a slot 16 lanes; lane l
// summed dot16 of vectors v = l, l + 16, ... (each a chain of 16 fmaf from
// 0 in byte order; on the scalar instance one fmaf chain over bytes d = l,
// l + 16, ...) and the 16 lane sums met in an xor shuffle tree.  Here the
// slot's thread keeps the 16 lane sums in registers, adds each vector's
// chain into sum v % 16 in ascending v (byte d into sum d % 16 on the
// scalar instance), and adds the sums in the tree's pairs.  The byte
// conversion is exact, so it equals static_cast<float>(byte).  Against the
// plain version, whose sum order differs, scores agree to rounding
// (DESIGN.md §11).
//
// The dynamic shared memory limit is raised once per device.  PERF.md §6
// has ptxas' registers and the variants measured.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Threads a block (a thread a slot), slots an item, items a group, bytes of
// a row a copy stage holds, stages in flight, and the blocks an SM the
// registers are capped for.  One constant a line: the variants tool builds
// other shapes from copies.  kSums = 16 lane sums keep the sum order above.
constexpr int kThreads = 128;
constexpr int kTileSlots = 1024;
constexpr int kGroupMax = 2;
constexpr int kChunk = 128;
constexpr int kStages = 2;
constexpr int kMinBlocks = 3;
constexpr int kSums = 16;
constexpr int kWindow = 32 * kGroupMax;  // sorted positions a group stays in
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = kChunk + 16;     // a row's chunk, padded: no conflicts
constexpr int kVecs = kChunk / 16;      // 16-byte vectors a chunk
constexpr int kWords = kChunk / 4 + 1;  // 4-byte words covering a chunk
constexpr int kMaxSmem = 232448;        // sm_90: 227 KB a block
static_assert(kThreads % 32 == 0 && kTileSlots % kThreads == 0,
              "whole warps, whole passes of the slots");
static_assert(kGroupMax >= 1 && kGroupMax <= 32,
              "a group's items are the bits of a 32-bit mask and the lanes "
              "of the warp that finds them");
static_assert(kChunk % 16 == 0 && kSums % kVecs == 0 && kStages >= 2 &&
                  kPitch >= 4 * kWords,
              "16-byte pieces, a chunk's vectors within one round of the "
              "sums, a chunk in flight, a padded row holds a chunk's words");

// Shared memory, all of it dynamic: the group's queries (h floats each),
// each warp's kStages stages of 32 rows' chunks, the items' queries and
// first slots, and the group's size.
__host__ __device__ long long ring_offset(int h) {
  return (4LL * kGroupMax * h + 15) / 16 * 16;
}

long long smem_bytes(int h) {
  return ring_offset(h) + static_cast<long long>(kWarps) * kStages * 32 *
                              kPitch + 4 * (2 * kGroupMax + 1);
}

__device__ __forceinline__ int clip_id(int id, long long n_rows) {
  return id < 0 ? 0 : (id >= n_rows ? static_cast<int>(n_rows - 1) : id);
}

// Byte k of w as a float, exactly: 0x4B0000bb is 2^23 + bb.
__device__ __forceinline__ float byte_float(unsigned w, unsigned k) {
  return __int_as_float(static_cast<int>(
             __byte_perm(w, 0x4B000000u, 0x7440u | k))) -
         8388608.0f;
}

// The 16 bytes of a vector as floats, in byte order.
__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[16]) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (unsigned k = 0; k < 4; ++k) f[4 * i + k] = byte_float(words[i], k);
}

// One vector's chain: 16 fmaf from 0, query element t (q16[t], read by
// every lane at once) times byte t.
__device__ __forceinline__ float dot16(const float* q16,
                                       const float (&f)[16]) {
  float a = 0.f;
#pragma unroll
  for (int t4 = 0; t4 < 4; ++t4) {
    const float4 qq = reinterpret_cast<const float4*>(q16)[t4];
    a = fmaf(qq.x, f[4 * t4], a);
    a = fmaf(qq.y, f[4 * t4 + 1], a);
    a = fmaf(qq.z, f[4 * t4 + 2], a);
    a = fmaf(qq.w, f[4 * t4 + 3], a);
  }
  return a;
}

// The 16 lane sums added as the xor shuffle tree over 16 lanes added them
// (offsets 8, 4, 2, 1: lane 0 ends with this).
__device__ __forceinline__ float tree16(const float (&s)[kSums]) {
  const float a0 = s[0] + s[8], a1 = s[1] + s[9], a2 = s[2] + s[10],
              a3 = s[3] + s[11], a4 = s[4] + s[12], a5 = s[5] + s[13],
              a6 = s[6] + s[14], a7 = s[7] + s[15];
  return ((a0 + a4) + (a2 + a6)) + ((a1 + a5) + (a3 + a7));
}

// Called by one whole warp: whether sorted position p starts a group.
// Groups never cross a multiple of kWindow; inside a window, a run of
// equal keys is cut into groups of kGroupMax from its first position.
__device__ __forceinline__ bool leads(const int32_t* skey, int p, int lane) {
  const int w0 = p - p % kWindow;
  int start = w0;                     // the run's first position, >= w0
  for (int top = p; top > w0; top -= 32) {
    const int x = top - lane;         // does a run start at x?
    const bool cut = x > w0 && skey[x] != skey[x - 1];
    const unsigned found = __ballot_sync(0xffffffffu, cut);
    if (found) { start = top - (__ffs(found) - 1); break; }
  }
  return (p - start) % kGroupMax == 0;
}

// 16 bytes global → shared, asynchronously, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
// 4 bytes global → shared, asynchronously (both addresses 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row's contribution to the lane sums of the queries in `mask`: the
// vectors of row bytes [16 v0, 16 v0 + 16 kVecs) (v0 a multiple of kVecs),
// read through `vec(i)`, sums index (v0 + i) % 16.
template <typename Vec>
__device__ __forceinline__ void add_vectors(Vec vec, int v0, int nvec,
                                            unsigned mask,
                                            const float* s_q, int h,
                                            float (&sums)[kGroupMax][kSums]) {
  const int base = v0 % kSums;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (v0 + i < nvec) {
      float f[16];
      unpack16(vec(i), f);
#pragma unroll
      for (int j = 0; j < kGroupMax; ++j) {
        if (mask >> j & 1u) {
          const float a = dot16(s_q + j * h + 16 * (v0 + i), f);
#pragma unroll
          for (int b = 0; b < kSums / kVecs; ++b)
            if (base == b * kVecs) sums[j][b * kVecs + i] += a;
        }
      }
    }
  }
}

// The scalar instance's row: byte d into sum d % 16 of each query in
// `mask`, one fmaf chain a sum in ascending d.
__device__ __forceinline__ void add_bytes(const uint8_t* __restrict__ src,
                                          unsigned mask, const float* s_q,
                                          int h,
                                          float (&sums)[kGroupMax][kSums]) {
  for (int d0 = 0; d0 < h; d0 += kSums) {
#pragma unroll
    for (int l = 0; l < kSums; ++l) {
      if (d0 + l < h) {
        const float f = __int_as_float(static_cast<int>(
                            0x4B000000u | __ldg(src + d0 + l))) -
                        8388608.0f;
#pragma unroll
        for (int j = 0; j < kGroupMax; ++j)
          if (mask >> j & 1u)
            sums[j][l] = fmaf(s_q[j * h + d0 + l], f, sums[j][l]);
      }
    }
  }
}

// The scalar instance's chunk of a row, bytes d0 .. d0 + kChunk - 1 (d0 a
// multiple of 16): the copied words mw hold them `sh` bits in; byte d goes
// into sum d % 16 of each query in `mask`, one fmaf chain a sum in
// ascending d.
__device__ __forceinline__ void add_byte_groups(
    const unsigned* mw, unsigned sh, int d0, unsigned mask, const float* s_q,
    int h, float (&sums)[kGroupMax][kSums]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (d0 + 16 * k < h) {
      const unsigned* w = mw + 4 * k;
      const uint4 v = {__funnelshift_r(w[0], w[1], sh),
                       __funnelshift_r(w[1], w[2], sh),
                       __funnelshift_r(w[2], w[3], sh),
                       __funnelshift_r(w[3], w[4], sh)};
      float f[16];
      unpack16(v, f);
#pragma unroll
      for (int j = 0; j < kGroupMax; ++j)
        if (mask >> j & 1u)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (d0 + 16 * k + i < h)
              sums[j][i] = fmaf(s_q[j * h + d0 + 16 * k + i], f[i],
                                sums[j][i]);
    }
  }
}

// grid (n_items), kThreads threads, smem_bytes(h) of dynamic shared memory.
// skey, order: the items' keys sorted (stable) and their item numbers.
// Item i is query i / tiles, slots (i % tiles) kTileSlots onward.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sq8_grouped(const float* __restrict__ q, const uint8_t* __restrict__ plane,
            const int32_t* __restrict__ ids, const bool* __restrict__ live,
            const int32_t* __restrict__ skey,
            const long long* __restrict__ order, float* __restrict__ out,
            int n_items, int tiles, int C, int h, long long n_rows) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x;
  if (threadIdx.x < 32) {            // smem[0] is free until the staging
    const bool lead = leads(skey, p, threadIdx.x);
    if (threadIdx.x == 0) *reinterpret_cast<int*>(smem) = lead;
  }
  __syncthreads();
  if (!*reinterpret_cast<volatile int*>(smem)) return;
  float* s_q = smem;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem) + ring_offset(h);
  int* s_b = reinterpret_cast<int*>(
      ring + static_cast<size_t>(kWarps) * kStages * 32 * kPitch);
  int* s_c0 = s_b + kGroupMax;
  int* s_g = s_c0 + kGroupMax;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  // the group: sorted positions p, p + 1, ... while the key holds, up to
  // kGroupMax and within p's window
  if (t < 32) {
    const bool in = t == 0 || (t < kGroupMax && p + t < n_items &&
                               (p + t) % kWindow != 0 &&
                               skey[p + t] == skey[p]);
    const unsigned out_lanes = __ballot_sync(0xffffffffu, !in);
    const int g = out_lanes ? __ffs(out_lanes) - 1 : 32;
    if (t < g) {
      const int item = static_cast<int>(order[p + t]);
      s_b[t] = item / tiles;
      s_c0[t] = item % tiles * kTileSlots;
    }
    if (t == 0) *s_g = g;
  }
  __syncthreads();
  const int g = *s_g;
  for (int e = t; e < h; e += kThreads) {
    float v[kGroupMax];
#pragma unroll
    for (int j = 0; j < kGroupMax; ++j)
      if (j < g) v[j] = __ldg(q + static_cast<size_t>(s_b[j]) * h + e);
#pragma unroll
    for (int j = 0; j < kGroupMax; ++j)
      if (j < g) s_q[j * h + e] = v[j];
  }
  __syncthreads();

  const int nvec = h / 16, n_chunks = (h + kChunk - 1) / kChunk;
  uint8_t* wring = ring + static_cast<size_t>(warp) * kStages * 32 * kPitch;
  for (int s = t; s < kTileSlots; s += kThreads) {
    // this slot: its row, the items it serves, the items that read their
    // own; dead lanes score -inf here
    bool lv[kGroupMax];
    int id[kGroupMax];
#pragma unroll
    for (int j = 0; j < kGroupMax; ++j) {
      const int c = s_c0[j < g ? j : 0] + s;
      const size_t at = static_cast<size_t>(s_b[j < g ? j : 0]) * C + c;
      lv[j] = j < g && c < C && live[at];
      id[j] = lv[j] ? ids[at] : 0;
    }
    int row = 0;
    unsigned match = 0, differ = 0;
#pragma unroll
    for (int j = 0; j < kGroupMax; ++j) {
      if (j >= g || s_c0[j] + s >= C) continue;
      float* o = out + static_cast<size_t>(s_b[j]) * C + s_c0[j] + s;
      if (!lv[j]) { *o = -CUDART_INF_F; continue; }
      const int r = clip_id(id[j], n_rows);
      if (!match) row = r;
      if (r == row) match |= 1u << j;
      else differ |= 1u << j;
    }
    float sums[kGroupMax][kSums];
#pragma unroll
    for (int j = 0; j < kGroupMax; ++j)
#pragma unroll
      for (int l = 0; l < kSums; ++l) sums[j][l] = 0.f;

    // the warp's match rows through the ring, a chunk at a time, copied by
    // the whole warp: 16-byte cp.async pieces on the vector instance; on
    // the scalar one the 4-byte words covering each row's chunk (rows start
    // at any byte), cp.async where a word lies inside the plane, else byte
    // by byte
    const int my_row = match ? row : -1;
    auto copy = [&](int c) {
      if (c < n_chunks) {
        uint8_t* st = wring + (c % kStages) * 32 * kPitch;
        if constexpr (kVec) {
          const int bytes = min(kChunk, h - c * kChunk);
#pragma unroll
          for (int x = lane; x < 32 * kVecs; x += 32) {
            const int r = x / kVecs, k = x % kVecs;
            const int rid = __shfl_sync(0xffffffffu, my_row, r);
            if (rid >= 0 && 16 * k < bytes)
              cp_async16(st + r * kPitch + 16 * k,
                         plane + static_cast<size_t>(rid) * h +
                             c * kChunk + 16 * k);
          }
        } else {
          const uintptr_t lo = reinterpret_cast<uintptr_t>(plane);
          const uintptr_t hi = lo + static_cast<uintptr_t>(n_rows) * h;
#pragma unroll 4
          for (int x = lane; x < 32 * kWords; x += 32) {
            const int r = x / kWords, wi = x % kWords;
            const int rid = __shfl_sync(0xffffffffu, my_row, r);
            if (rid < 0) continue;
            const uintptr_t a =
                (reinterpret_cast<uintptr_t>(plane +
                                             static_cast<size_t>(rid) * h +
                                             c * kChunk) &
                 ~static_cast<uintptr_t>(3)) + 4 * wi;
            uint8_t* dst = st + r * kPitch + 4 * wi;
            if (a >= lo && a + 4 <= hi) {
              cp_async4(dst, reinterpret_cast<const void*>(a));
            } else {
              unsigned v = 0;
              for (int b = 0; b < 4; ++b)
                if (a + b >= lo && a + b < hi)
                  v |= static_cast<unsigned>(
                           __ldg(reinterpret_cast<const uint8_t*>(a + b)))
                       << (8 * b);
              *reinterpret_cast<unsigned*>(dst) = v;
            }
          }
        }
      }
      cp_async_commit();
    };
    __syncwarp();                     // the last slot's reads are done
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) copy(c);
    for (int c = 0; c < n_chunks; ++c) {
      __syncwarp();                   // every lane is done with stage c - 1
      copy(c + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncwarp();                   // the warp's copies of chunk c landed
      if (!match) continue;
      const uint8_t* mine =
          wring + (c % kStages) * 32 * kPitch + lane * kPitch;
      if constexpr (kVec) {
        const uint4* mv = reinterpret_cast<const uint4*>(mine);
        add_vectors([&](int i) { return mv[i]; }, c * kVecs, nvec, match,
                    s_q, h, sums);
      } else {
        const unsigned* mw = reinterpret_cast<const unsigned*>(mine);
        const unsigned sh = 8u * static_cast<unsigned>(
            (reinterpret_cast<uintptr_t>(plane) +
             static_cast<uintptr_t>(row) * h) & 3);
        add_byte_groups(mw, sh, c * kChunk, match, s_q, h, sums);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroupMax; ++j)
      if (match >> j & 1u)
        out[static_cast<size_t>(s_b[j]) * C + s_c0[j] + s] = tree16(sums[j]);

    // items live here with another row: their own, read directly (their
    // sums are still zero: no item is in both masks)
    for (unsigned rest = differ; rest; rest &= rest - 1) {
      const int jd = __ffs(rest) - 1;
      const uint8_t* src =
          plane + static_cast<size_t>(clip_id(
                      ids[static_cast<size_t>(s_b[jd]) * C + s_c0[jd] + s],
                      n_rows)) * h;
      if constexpr (kVec) {
        const uint4* vrow = reinterpret_cast<const uint4*>(src);
        for (int v0 = 0; v0 < nvec; v0 += kVecs)
          add_vectors([&](int i) { return __ldg(vrow + v0 + i); }, v0, nvec,
                      1u << jd, s_q, h, sums);
      } else {
        add_bytes(src, 1u << jd, s_q, h, sums);
      }
#pragma unroll
      for (int j = 0; j < kGroupMax; ++j)
        if (j == jd)
          out[static_cast<size_t>(s_b[j]) * C + s_c0[j] + s] =
              tree16(sums[j]);
    }
  }
}

// Raises both instances' dynamic shared memory limit to kMaxSmem, once per
// device (the attribute belongs to the device's context).
constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_raised[kMaxDevices];

cudaError_t raise_smem_limit() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && g_smem_raised[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  using Kernel = decltype(&sq8_grouped<true>);
  const Kernel kernels[] = {sq8_grouped<true>, sq8_grouped<false>};
  for (Kernel kernel : kernels) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  if (cached) g_smem_raised[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The schedule's shape: slots an item, items a group, and the widest h a
// block's shared memory holds.
int sq8_dot_tiles(int* tile_slots, int* group_max, int* max_h) {
  *tile_slots = kTileSlots;
  *group_max = kGroupMax;
  *max_h = static_cast<int>((kMaxSmem - smem_bytes(0)) / (4 * kGroupMax)) /
           16 * 16;
  return 0;
}

// q_scaled (B, h) f32; plane (n_rows, h) uint8; ids (B, C) i32; live (B, C)
// bool; skey (B T) i32, the items' keys sorted (stable), and order (B T)
// i64, their item numbers (T = ceil(C / tile_slots), ops.schedule); out
// (B, C) f32.  All contiguous on the current device.  vec (16-byte row
// copies) needs h % 16 == 0 and a 16-byte aligned plane; otherwise, or
// where h exceeds max_h, the call is refused.  Launches on `stream`
// without synchronizing; returns cudaGetLastError().
int sq8_dot_fused_launch(const void* q_scaled, const void* plane,
                         const void* ids, const void* live, const void* skey,
                         const void* order, void* out, int B, int C, int h,
                         long long n_rows, int vec, void* stream) {
  const long long tiles = (static_cast<long long>(C) + kTileSlots - 1) /
                          kTileSlots;
  if (B < 1 || C < 1 || h < 1 || n_rows < 1 || B * tiles > 0x7fffffffLL ||
      smem_bytes(h) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(h % 16 == 0 &&
               reinterpret_cast<std::uintptr_t>(plane) % 16 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = static_cast<int>(B * tiles);
  auto kernel = vec ? sq8_grouped<true> : sq8_grouped<false>;
  kernel<<<n_items, kThreads, smem_bytes(h),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_scaled),
      static_cast<const uint8_t*>(plane), static_cast<const int32_t*>(ids),
      static_cast<const bool*>(live), static_cast<const int32_t*>(skey),
      static_cast<const long long*>(order), static_cast<float*>(out),
      n_items, static_cast<int>(tiles), C, h, n_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
