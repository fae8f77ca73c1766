// pq_adc_fused — fused gather + PQ ADC + live mask for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/pq_adc/kernel.py::_adc_fused_kernel
// (entry pq_adc_fused, pallas_call at kernel.py:163):
//
//     out[b, c] = sum_{j < m} lut[b, j, plane[clip(ids[b, c]), j]]   if live[b, c]
//               = -inf                                               otherwise
//
// The TPU kernel DMAs candidate rows into VMEM and turns the lookup into a
// one-hot matmul, because a TPU has no per-lane gather.  Hopper has one:
// each block stages its query's (m, k) LUT in shared memory once and every
// thread looks its candidate's m entries up directly.
//
// Bound on the H100: bytes.  Per live slot the kernel reads one code row
// (m bytes, 96 at m=96) from a plane far larger than L2, plus the 4-byte id,
// the 1-byte live flag and the 4-byte score it writes; the arithmetic is one
// add per code.  The design keeps every byte it can out of device memory:
// no (B, C, m) codes tensor exists, dead lanes read no code row, the LUT is
// read once per block of kThreads * kItems candidates rather than per lane,
// and a code row is read as 16-byte vectors where its width and alignment
// allow.
//
// Order: the sum runs j = 0 .. m-1, one add per fragment, as the TPU kernel
// accumulates it (kernel.py:125-128).  The plain version in ref.py sums in
// PyTorch's reduction order, so the two agree to rounding (DESIGN.md §11).
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 16;                    // candidates per thread
constexpr int kTile = kThreads * kItems;      // candidates per block

// Code t of a 16-byte vector holding 16 uint8 or 4 int32 codes.
template <typename T>
__device__ __forceinline__ unsigned code_at(const uint4& v, int t) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 1) {
    return (w[t >> 2] >> ((t & 3) * 8)) & 0xffu;
  } else {
    return w[t];
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ float adc_row(const float* s_lut, const T* row,
                                         int m, int k) {
  const unsigned kmax = static_cast<unsigned>(k - 1);
  float acc = 0.f;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int g = 0; g < m / kPer; ++g) {
      const uint4 q = __ldg(v + g);
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const unsigned code = min(code_at<T>(q, t), kmax);
        acc += s_lut[(g * kPer + t) * k + code];
      }
    }
  } else {
    for (int j = 0; j < m; ++j) {
      const unsigned code = min(static_cast<unsigned>(row[j]), kmax);
      acc += s_lut[j * k + code];
    }
  }
  return acc;
}

// grid (B, ceil(C / kTile)); dynamic shared memory m * k floats.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
adc_fused_kernel(const float* __restrict__ lut, const T* __restrict__ plane,
                 const int32_t* __restrict__ ids,
                 const bool* __restrict__ live, float* __restrict__ out,
                 int C, int m, int k, long long n_rows) {
  extern __shared__ float s_lut[];
  const int b = blockIdx.x;
  const int mk = m * k;
  const float* q_lut = lut + static_cast<size_t>(b) * mk;
  for (int i = threadIdx.x; i < mk; i += kThreads) s_lut[i] = q_lut[i];
  __syncthreads();

  const size_t row0 = static_cast<size_t>(b) * C;
  const int c0 = blockIdx.y * kTile + threadIdx.x;
  for (int it = 0; it < kItems; ++it) {
    const int c = c0 + it * kThreads;
    if (c >= C) break;
    float s = -CUDART_INF_F;
    if (live[row0 + c]) {
      long long id = ids[row0 + c];
      id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
      s = adc_row<T, kVec>(s_lut, plane + id * m, m, k);
    }
    out[row0 + c] = s;
  }
}

template <typename T, bool kVec>
cudaError_t launch(const float* lut, const T* plane, const int32_t* ids,
                   const bool* live, float* out, int B, int C, int m, int k,
                   long long n_rows, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      adc_fused_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (C + kTile - 1) / kTile);
  adc_fused_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(
      lut, plane, ids, live, out, C, m, k, n_rows);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* lut, const void* plane, const void* ids,
             const void* live, void* out, int B, int C, int m, int k,
             long long n_rows, void* stream) {
  // 16-byte row loads need every row start 16-byte aligned
  const int per_vec = 16 / static_cast<int>(sizeof(T));
  const bool vec = m % per_vec == 0 &&
                   reinterpret_cast<uintptr_t>(plane) % 16 == 0;
  const auto* l = static_cast<const float*>(lut);
  const auto* p = static_cast<const T*>(plane);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* v = static_cast<const bool*>(live);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch<T, true>(l, p, i, v, o, B, C, m, k, n_rows, s)
          : launch<T, false>(l, p, i, v, o, B, C, m, k, n_rows, s));
}

}  // namespace

extern "C" {

// lut (B, m, k) f32; plane (n_rows, m) uint8; ids (B, C) i32; live (B, C)
// bool; out (B, C) f32.  All contiguous on the current device.  Launches on
// `stream` without synchronizing; returns cudaGetLastError().
int pq_adc_fused_u8(const void* lut, const void* plane, const void* ids,
                    const void* live, void* out, int B, int C, int m, int k,
                    long long n_rows, void* stream) {
  return dispatch<uint8_t>(lut, plane, ids, live, out, B, C, m, k, n_rows,
                           stream);
}

// As pq_adc_fused_u8 for an int32 plane (k > 256).
int pq_adc_fused_i32(const void* lut, const void* plane, const void* ids,
                     const void* live, void* out, int B, int C, int m, int k,
                     long long n_rows, void* stream) {
  return dispatch<int32_t>(lut, plane, ids, live, out, B, C, m, k, n_rows,
                           stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
