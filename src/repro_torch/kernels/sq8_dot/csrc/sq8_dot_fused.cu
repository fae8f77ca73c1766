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
// The TPU kernel DMAs one candidate row at a time into VMEM and runs one MXU
// dot over the block.  On the H100 the work is a random gather of h-byte rows
// (768 B at h = 768) from a plane far larger than L2, with one FMA per byte,
// so the kernel is bound by bytes.  The design keeps every byte it can out of
// device memory: no (B, C, h) rows tensor exists, dead lanes read no row, the
// query row is read once per block of kTile candidates rather than per lane,
// and a row is read as 16-byte vectors where its width and alignment allow.
//
// Layout: a block serves one query.  It stages q_scaled[b] in shared memory,
// then each group of kGroup = 16 lanes takes one candidate at a time.  On the
// vector path lane l reads 16-byte vectors v = l, l + 16, ... of the row and
// the query is staged transposed (element t of vector v at t * nvec + v), so
// the 16 lanes read 16 consecutive floats: no bank conflicts.  The scalar path
// (h not a multiple of 16, or a plane not 16-byte aligned) reads bytes
// d = l, l + 16, ... against the query in its own order.  Lanes reduce with
// shuffles inside their half-warp.  The sum order differs from the MXU's and
// from the plain version's, so the two agree to rounding (DESIGN.md §11).
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;                      // lanes per candidate
constexpr int kGroups = kThreads / kGroup;      // candidates in flight
constexpr int kItems = 32;                      // candidates per group
constexpr int kTile = kGroups * kItems;         // candidates per block

__device__ __forceinline__ float dot16(const float* s_q, int nvec, int v,
                                       const uint4& w) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const unsigned byte = (words[t >> 2] >> ((t & 3) * 8)) & 0xffu;
    acc = fmaf(s_q[t * nvec + v], static_cast<float>(byte), acc);
  }
  return acc;
}

// grid (B, ceil(C / kTile)); dynamic shared memory h floats.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sq8_fused_kernel(const float* __restrict__ q, const uint8_t* __restrict__ plane,
                 const int32_t* __restrict__ ids,
                 const bool* __restrict__ live, float* __restrict__ out,
                 int C, int h, long long n_rows) {
  extern __shared__ float s_q[];
  const int b = blockIdx.x;
  const int nvec = h / 16;
  const float* q_row = q + static_cast<size_t>(b) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    // vector path: element t of vector v lives at t * nvec + v
    s_q[kVec ? (i % 16) * nvec + i / 16 : i] = q_row[i];
  }
  __syncthreads();

  const int group = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const unsigned mask = 0xffffu << (16 * (group & 1));   // this half-warp
  const size_t row0 = static_cast<size_t>(b) * C;
  const int c0 = blockIdx.y * kTile + group;
  for (int it = 0; it < kItems; ++it) {
    const int c = c0 + it * kGroups;
    if (c >= C) break;
    if (!live[row0 + c]) {
      if (lane == 0) out[row0 + c] = -CUDART_INF_F;
      continue;
    }
    long long id = ids[row0 + c];
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const uint8_t* row = plane + static_cast<size_t>(id) * h;
    float acc = 0.f;
    if constexpr (kVec) {
      const uint4* vrow = reinterpret_cast<const uint4*>(row);
      for (int v = lane; v < nvec; v += kGroup) {
        acc += dot16(s_q, nvec, v, __ldg(vrow + v));
      }
    } else {
      for (int d = lane; d < h; d += kGroup) {
        acc = fmaf(s_q[d], static_cast<float>(row[d]), acc);
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) {
      acc += __shfl_xor_sync(mask, acc, off, kGroup);
    }
    if (lane == 0) out[row0 + c] = acc;
  }
}

template <bool kVec>
cudaError_t launch(const float* q, const uint8_t* plane, const int32_t* ids,
                   const bool* live, float* out, int B, int C, int h,
                   long long n_rows, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sq8_fused_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (C + kTile - 1) / kTile);
  sq8_fused_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      q, plane, ids, live, out, C, h, n_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_scaled (B, h) f32; plane (n_rows, h) uint8; ids (B, C) i32; live (B, C)
// bool; out (B, C) f32.  All contiguous on the current device.  Launches on
// `stream` without synchronizing; returns cudaGetLastError().
int sq8_dot_fused(const void* q_scaled, const void* plane, const void* ids,
                  const void* live, void* out, int B, int C, int h,
                  long long n_rows, void* stream) {
  // 16-byte row loads need every row start 16-byte aligned
  const bool vec = h % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(plane) % 16 == 0;
  const auto* q = static_cast<const float*>(q_scaled);
  const auto* p = static_cast<const uint8_t*>(plane);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* v = static_cast<const bool*>(live);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch<true>(q, p, i, v, o, B, C, h, n_rows, s)
          : launch<false>(q, p, i, v, o, B, C, h, n_rows, s));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
