// pq_adc_fused — fused gather + PQ ADC + live mask for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/pq_adc/kernel.py::_adc_fused_kernel
// (entry pq_adc_fused, pallas_call at kernel.py:163):
//
//     out[b, c] = sum_{j < m} lut[b, j, plane[clip(ids[b, c]), j]]   if live[b, c]
//               = -inf                                               otherwise
//
// The TPU kernel DMAs candidate rows into VMEM and turns the lookup into a
// one-hot matmul, because a TPU has no per-lane gather.  Hopper has one: the
// query's (m, k) LUT sits in shared memory and every thread looks its
// candidate's m entries up directly.
//
// Bound on the H100: bytes.  Per live slot the kernel reads one m-byte code
// row (96 B at m = 96: three 32-byte sectors) gathered at random from a
// plane far larger than L2, plus the 4-byte id, the 1-byte live flag and the
// 4-byte score it writes; the arithmetic is one add per code.  What held the
// kernel before this one far from that bound was latency: each thread ran
// live -> id -> row -> 96 lookups for one slot before it asked for the next
// row, and each block of 8,192 slots staged its query's whole LUT (96 KB at
// m 96, k 256) before it scored anything.  Here:
//
//   * Work.  One wave of persistent blocks (the grid the wrapper sizes from
//     the occupancy of each instance) cuts the flattened (B, C) plane into
//     equal contiguous ranges; a range holds one or a few queries, and a
//     block stages a query's LUT once for its part of that query (by 16-byte
//     cp.async where the LUT allows), not once per 8,192 slots.
//   * Rows in flight.  A warp scores 32 consecutive slots at a time (dead
//     lanes come in runs at list ends, so most warps are all live or all
//     dead).  Its code rows go through a ring of kStages stages in shared
//     memory: while it scores one group, the rows of the next kStages - 1
//     groups are on their way by 16-byte cp.async, copied by the whole warp
//     (neighbouring lanes take neighbouring pieces of a row), and the ids
//     and live flags of the group after those are already loaded.  Dead lanes
//     request no row.  Rows are padded to an odd number of 16-byte pieces, so
//     a lane reads its own row back without bank conflicts.
//   * Lookups.  The served shape (uint8 codes, k = 256, m a multiple of 16)
//     has an instance of its own: k is a constant, a byte is taken by one
//     PRMT, its fragment's offset is an immediate, and no clamp is needed (a
//     byte is at most 255).  Other vector shapes clamp codes to k - 1.  The
//     32 lanes of a warp look up one fragment of 32 random codes at a time
//     (3.15 shared-memory wavefronts on average, the codes' most crowded
//     bank); a conflict-free layout (lanes skewed by one fragment) saved 3%
//     on the card, so the gathers, not the lookups, set the time (PERF.md
//     §6).
//   * The scalar instance (rows not whole 16-byte pieces, a plane not 16-byte
//     aligned, or a LUT that leaves no room for the ring) reads each lane's
//     row directly, code by code, with the ids and live flags of its next
//     group loaded one group ahead.
//
// Order: each score starts at 0.f and adds lut[b, j, code_j] for j = 0 ..
// m - 1, one fp32 add per fragment, as the TPU kernel accumulates it
// (kernel.py:125-128) and as the kernel before this one and pq_adc.cu do: the
// three agree bit for bit.  The plain version in ref.py sums in PyTorch's
// reduction order, so it agrees to rounding (DESIGN.md §11).
//
// The dynamic shared memory limit is raised once per device.  PERF.md §6 has
// ptxas' registers and the variants measured.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Threads a block, ring stages in flight, the fewest slots a block takes,
// the blocks an SM the ring instances' registers are capped for.  One
// constant a line: the variants tool builds other shapes from copies.
constexpr int kThreads = 512;
constexpr int kStages = 2;
constexpr int kMinSlots = 512;
constexpr int kMinBlocks = 1;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;        // sm_90: 227 KB a block
static_assert(kThreads % 32 == 0 && kStages >= 2 && kMinSlots >= 32,
              "whole warps, a group in flight while one is scored");

// The instances: the served shape's, the generic vector one, the scalar.
enum Instance { kServed = 0, kVector = 1, kScalar = 2 };

__host__ __device__ long long lut_bytes(int m, int k) {
  return (4LL * m * k + 15) / 16 * 16;
}

// A row's bytes in the ring: whole 16-byte pieces, an odd number of them,
// so that 32 lanes reading their own rows 16 bytes at a time hit every bank
// once a quarter-warp.
__host__ __device__ int ring_pitch(int row_bytes) {
  const int pieces = (row_bytes + 15) / 16;
  return 16 * (pieces | 1);
}

// Dynamic shared memory of an instance: the LUT, then (vector instances)
// kWarps rings of kStages stages of 32 rows.
long long smem_bytes(int m, int k, int elem, bool vec) {
  const long long lut = lut_bytes(m, k);
  if (!vec) return lut;
  return lut + static_cast<long long>(kWarps) * kStages * 32 *
                   ring_pitch(m * elem);
}

__device__ __forceinline__ long long clip_id(int id, long long n_rows) {
  return id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
}

// 16 (or 4) bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
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

// Code t of a 16-byte vector holding 16 uint8 or 4 int32 codes.
template <typename T>
__device__ __forceinline__ unsigned code_at(const uint4& v, int t) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 1) {
    return __byte_perm(w[t >> 2], 0u, 0x4440u | static_cast<unsigned>(t & 3));
  } else {
    return w[t];
  }
}

// One candidate's score from its row in shared memory, read as 16-byte
// vectors.  kK > 0: k is that constant and codes need no clamp.
template <typename T, int kK>
__device__ __forceinline__ float adc_vec(const float* s_lut, const uint4* row,
                                         int m, int k_rt) {
  constexpr int kPer = 16 / sizeof(T);
  const int k = kK > 0 ? kK : k_rt;
  const unsigned kmax = static_cast<unsigned>(k - 1);
  float acc = 0.f;
#pragma unroll 2
  for (int g = 0; g < m / kPer; ++g) {
    const uint4 q = row[g];
    const float* lg = s_lut + g * kPer * k;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      unsigned code = code_at<T>(q, t);
      if constexpr (kK == 0) code = min(code, kmax);
      acc += lg[t * k + code];
    }
  }
  return acc;
}

// One candidate's score read code by code from its row in global memory.
template <typename T>
__device__ __forceinline__ float adc_direct(const float* s_lut,
                                            const T* __restrict__ row, int m,
                                            int k) {
  const unsigned kmax = static_cast<unsigned>(k - 1);
  float acc = 0.f;
  for (int j0 = 0; j0 < m; j0 += 16) {
    unsigned code[16];
#pragma unroll
    for (int t = 0; t < 16; ++t)
      code[t] = j0 + t < m ? static_cast<unsigned>(__ldg(row + j0 + t)) : 0u;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (j0 + t < m) acc += s_lut[(j0 + t) * k + min(code[t], kmax)];
  }
  return acc;
}

// The query's LUT into shared memory by the whole block, as one cp.async
// group: 16-byte pieces where the source allows, else 4-byte ones.
__device__ __forceinline__ void stage_lut(float* s_lut, const float* src,
                                          int mk) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (mk & 3) == 0) {
    for (int i = threadIdx.x; i < mk / 4; i += kThreads)
      cp_async16(s_lut + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < mk; i += kThreads)
      cp_async4(s_lut + i, src + i);
  }
  cp_async_commit();
}

// One block's range of the flattened (B, C) plane: an equal share, the
// first total % gridDim.x blocks one slot more (ops.block_ranges mirrors it).
__device__ __forceinline__ void block_range(long long total, long long* lo,
                                            long long* hi) {
  const long long g = gridDim.x, i = blockIdx.x;
  const long long per = total / g, rem = total % g;
  *lo = per * i + (i < rem ? i : rem);
  *hi = *lo + per + (i < rem ? 1 : 0);
}

// grid: one wave of blocks (or fewer, kMinSlots slots a block at least);
// kThreads threads; smem_bytes(m, k, sizeof(T), kVec) of dynamic shared
// memory.  kK: 256 for the served instance (uint8), else 0.
template <typename T, int kK, bool kVec>
__global__ void __launch_bounds__(kThreads, kVec ? kMinBlocks : 2)
adc_fused(const float* __restrict__ lut, const T* __restrict__ plane,
          const int32_t* __restrict__ ids, const bool* __restrict__ live,
          float* __restrict__ out, int B, int C, int m, int k,
          long long n_rows) {
  extern __shared__ __align__(16) float s_lut[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mk = m * k;
  const int row_bytes = m * static_cast<int>(sizeof(T));
  const int pitch = ring_pitch(row_bytes);
  uint8_t* ring = reinterpret_cast<uint8_t*>(s_lut) + lut_bytes(m, k) +
                  static_cast<size_t>(warp) * kStages * 32 * pitch;
  // this lane's pieces of a group's rows: piece x = lane + 32 p is piece
  // x % P of row x / P (P pieces a row), stepped without a division
  const int P = row_bytes / 16;
  const int r0 = lane / (P > 0 ? P : 1), q0 = lane % (P > 0 ? P : 1);
  const int dr = 32 / (P > 0 ? P : 1), dq = 32 % (P > 0 ? P : 1);
  const uint8_t* plane_b = reinterpret_cast<const uint8_t*>(plane);

  long long lo, hi;
  block_range(static_cast<long long>(B) * C, &lo, &hi);
  for (long long s0 = lo; s0 < hi;) {
    const int b = static_cast<int>(s0 / C);
    const long long seg_end = min(hi, static_cast<long long>(b + 1) * C);
    const int c_lo = static_cast<int>(s0 - static_cast<long long>(b) * C);
    const int c_hi = static_cast<int>(seg_end - static_cast<long long>(b) * C);
    s0 = seg_end;
    cp_async_wait<0>();
    __syncthreads();                  // the last query's readers are done
    stage_lut(s_lut, lut + static_cast<size_t>(b) * mk, mk);
    cp_async_wait<0>();
    __syncthreads();

    const size_t base = static_cast<size_t>(b) * C;
    const int n_groups = (c_hi - c_lo + 31) / 32;
    const int mine = n_groups > warp ? (n_groups - warp + kWarps - 1) / kWarps
                                     : 0;
    // the slot of this lane in the warp's group i, and its id and live flag
    // (raw: not looked at until they are needed, so the loads stay in flight)
    auto slot = [&](int i) { return c_lo + (warp + kWarps * i) * 32 + lane; };
    auto fetch = [&](int i, int& id, bool& lv) {
      const int c = slot(i);
      lv = false;
      id = 0;
      if (i < mine && c < c_hi) {
        lv = live[base + c];
        id = ids[base + c];
      }
    };

    if constexpr (!kVec) {
      int id, nid;
      bool lv, nlv;
      fetch(0, nid, nlv);
      for (int i = 0; i < mine; ++i) {
        id = nid;
        lv = nlv;
        fetch(i + 1, nid, nlv);
        const int c = slot(i);
        if (c < c_hi)
          out[base + c] =
              lv ? adc_direct<T>(s_lut, plane + clip_id(id, n_rows) * m, m, k)
                 : -CUDART_INF_F;
      }
    } else {
      // group g's rows into stage g % kStages, one cp.async group a call
      // (empty past the warp's groups); bit g % kStages of `lbits` is this
      // lane's live flag there
      unsigned lbits = 0;
      auto copy = [&](int g, int id, bool lv) {
        const long long row = lv ? clip_id(id, n_rows) : -1;
        const int st = g % kStages;
        lbits = (lbits & ~(1u << st)) | (static_cast<unsigned>(lv) << st);
        if (__any_sync(0xffffffffu, lv)) {
          uint8_t* stage = ring + st * 32 * pitch;
          int r = r0, q = q0;
          for (int p = 0; p < P; ++p) {
            const long long rid = __shfl_sync(0xffffffffu, row, r);
            if (rid >= 0)
              cp_async16(stage + r * pitch + 16 * q,
                         plane_b + rid * row_bytes + 16 * q);
            r += dr;
            q += dq;
            if (q >= P) { q -= P; ++r; }
          }
        }
        cp_async_commit();
      };
      int nid;
      bool nlv;
      fetch(0, nid, nlv);
#pragma unroll
      for (int g = 0; g < kStages - 1; ++g) {
        copy(g, nid, nlv);
        fetch(g + 1, nid, nlv);
      }
      for (int i = 0; i < mine; ++i) {
        __syncwarp();                 // every lane is done with stage i - 1
        copy(i + kStages - 1, nid, nlv);
        fetch(i + kStages, nid, nlv);
        cp_async_wait<kStages - 1>();
        __syncwarp();                 // the warp's copies of group i landed
        const int c = slot(i);
        const int st = i % kStages;
        if (c < c_hi) {
          const uint4* row = reinterpret_cast<const uint4*>(
              ring + (st * 32 + lane) * pitch);
          out[base + c] = (lbits >> st & 1u) ? adc_vec<T, kK>(s_lut, row, m, k)
                                             : -CUDART_INF_F;
        }
      }
    }
  }
  cp_async_wait<0>();
}

const void* kernel_of(int instance, int elem) {
  if (instance == kServed)
    return reinterpret_cast<const void*>(adc_fused<uint8_t, 256, true>);
  if (instance == kVector)
    return elem == 1
               ? reinterpret_cast<const void*>(adc_fused<uint8_t, 0, true>)
               : reinterpret_cast<const void*>(adc_fused<int32_t, 0, true>);
  return elem == 1
             ? reinterpret_cast<const void*>(adc_fused<uint8_t, 0, false>)
             : reinterpret_cast<const void*>(adc_fused<int32_t, 0, false>);
}

// The instance for (m, k, code bytes, vec), or -1 where none can run it.
int instance_of(int m, int k, int elem, bool vec) {
  if (m < 1 || k < 1 || (elem != 1 && elem != 4) ||
      lut_bytes(m, k) > kMaxSmem)
    return -1;
  if (!vec) return kScalar;
  if ((m * elem) % 16 != 0 || smem_bytes(m, k, elem, true) > kMaxSmem)
    return -1;
  return elem == 1 && k == 256 ? kServed : kVector;
}

// Raises every instance's dynamic shared memory limit to kMaxSmem, once per
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
  const void* kernels[] = {kernel_of(kServed, 1), kernel_of(kVector, 1),
                           kernel_of(kVector, 4), kernel_of(kScalar, 1),
                           kernel_of(kScalar, 4)};
  for (const void* kernel : kernels) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  if (cached) g_smem_raised[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <typename T>
void launch_as(int instance, dim3 grid, size_t smem, cudaStream_t stream,
               const void* lut, const void* plane, const void* ids,
               const void* live, void* out, int B, int C, int m, int k,
               long long n_rows) {
  const auto* l = static_cast<const float*>(lut);
  const auto* p = static_cast<const T*>(plane);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* v = static_cast<const bool*>(live);
  auto* o = static_cast<float*>(out);
  if constexpr (sizeof(T) == 1) {
    if (instance == kServed) {
      adc_fused<uint8_t, 256, true><<<grid, kThreads, smem, stream>>>(
          l, p, i, v, o, B, C, m, k, n_rows);
      return;
    }
  }
  if (instance == kVector)
    adc_fused<T, 0, true><<<grid, kThreads, smem, stream>>>(
        l, p, i, v, o, B, C, m, k, n_rows);
  else
    adc_fused<T, 0, false><<<grid, kThreads, smem, stream>>>(
        l, p, i, v, o, B, C, m, k, n_rows);
}

}  // namespace

extern "C" {

// What a launch at (m, k, code bytes elem, vec) runs: its instance (0 the
// served shape's, 1 the generic vector one, 2 the scalar one), the blocks of
// it resident on the whole card, and the fewest slots a block takes.  The
// wrapper sizes the grid from these once per shape.  Returns
// cudaErrorInvalidValue where no instance can run it.
int pq_adc_fused_plan(int m, int k, int elem, int vec, int* instance,
                      int* resident, int* min_slots) {
  const int inst = instance_of(m, k, elem, vec != 0);
  if (inst < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  const size_t bytes = static_cast<size_t>(smem_bytes(m, k, elem, vec != 0));
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel_of(inst, elem), kThreads, bytes)) != cudaSuccess)
    return static_cast<int>(err);
  *instance = inst;
  *resident = per_sm * sms;
  *min_slots = kMinSlots;
  return per_sm > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// lut (B, m, k) f32; plane (n_rows, m) of elem-byte codes (1: uint8, 4:
// int32); ids (B, C) i32; live (B, C) bool; out (B, C) f32.  All contiguous
// on the current device.  vec (rows copied as 16-byte pieces through the
// ring) needs m * elem % 16 == 0, a 16-byte aligned plane and room for the
// ring (pq_adc_fused_plan); otherwise the call is refused.  grid: the blocks
// to launch (any count >= 1 gives the same scores).  Launches on `stream`
// without synchronizing; returns cudaGetLastError().
int pq_adc_fused_launch(const void* lut, const void* plane, const void* ids,
                        const void* live, void* out, int B, int C, int m,
                        int k, long long n_rows, int elem, int vec, int grid,
                        void* stream) {
  const int inst = instance_of(m, k, elem, vec != 0);
  if (inst < 0 || B < 1 || C < 1 || n_rows < 1 || grid < 1 ||
      (vec && reinterpret_cast<uintptr_t>(plane) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(smem_bytes(m, k, elem, vec != 0));
  auto s = static_cast<cudaStream_t>(stream);
  if (elem == 1)
    launch_as<uint8_t>(inst, dim3(grid), smem, s, lut, plane, ids, live, out,
                       B, C, m, k, n_rows);
  else
    launch_as<int32_t>(inst, dim3(grid), smem, s, lut, plane, ids, live, out,
                       B, C, m, k, n_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
