// pq_adc — unfused PQ ADC over pre-gathered codes for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/pq_adc/kernel.py::_adc_kernel
// (entry pq_adc_fragmajor, pallas_call at kernel.py:58):
//
//     out[b, c] = sum_{j < m} lut[b, j, codes[b, c, j]]
//
// The TPU kernel takes the codes fragment-major (B, m, C), padded to its
// candidate tile, and turns each lookup into a one-hot matmul: the layout
// and the padding serve the TPU's 128-lane vectors and its lack of a
// per-lane gather.  Hopper gathers from shared memory directly, so this
// kernel reads the codes candidate-major, as the caller gathered them, and
// needs no padding: each block stages one query's (m, k) LUT in shared
// memory and each thread looks its candidates' m entries up.
//
// Bound on the H100: bytes.  The codes tensor (B * C * m bytes for uint8,
// four times that for int32) is read once, as 16-byte vectors where the row
// width and alignment allow; the LUT is read once per block from L2; one
// 4-byte score is written per candidate.  The arithmetic is one add per
// code.
//
// Order: the sum runs j = 0 .. m-1 in fp32 adds, as the TPU kernel
// accumulates it (kernel.py:35-45) and as pq_adc_fused.cu does, so the two
// kernels agree bit for bit on the same codes (kernel.py:92-95).
#include <cstdint>
#include <cuda_runtime.h>

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

// One candidate's score: codes are clamped to k - 1 so that a bad code
// reads inside the LUT (the caller guarantees codes < k).
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
adc_kernel(const float* __restrict__ lut, const T* __restrict__ codes,
           float* __restrict__ out, int C, int m, int k) {
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
    out[row0 + c] = adc_row<T, kVec>(s_lut, codes + (row0 + c) * m, m, k);
  }
}

template <typename T, bool kVec>
cudaError_t launch(const float* lut, const T* codes, float* out, int B,
                   int C, int m, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      adc_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (C + kTile - 1) / kTile);
  adc_kernel<T, kVec><<<grid, kThreads, smem, stream>>>(lut, codes, out, C,
                                                        m, k);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* lut, const void* codes, void* out, int B, int C,
             int m, int k, void* stream) {
  // 16-byte row loads need every row start 16-byte aligned
  const int per_vec = 16 / static_cast<int>(sizeof(T));
  const bool vec = m % per_vec == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const auto* l = static_cast<const float*>(lut);
  const auto* c = static_cast<const T*>(codes);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<T, true>(l, c, o, B, C, m, k, s)
                              : launch<T, false>(l, c, o, B, C, m, k, s));
}

}  // namespace

extern "C" {

// lut (B, m, k) f32; codes (B, C, m) uint8; out (B, C) f32.  All
// contiguous on the current device.  Launches on `stream` without
// synchronizing; returns cudaGetLastError().
int pq_adc_u8(const void* lut, const void* codes, void* out, int B, int C,
              int m, int k, void* stream) {
  return dispatch<uint8_t>(lut, codes, out, B, C, m, k, stream);
}

// As pq_adc_u8 for int32 codes.
int pq_adc_i32(const void* lut, const void* codes, void* out, int B, int C,
               int m, int k, void* stream) {
  return dispatch<int32_t>(lut, codes, out, B, C, m, k, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
