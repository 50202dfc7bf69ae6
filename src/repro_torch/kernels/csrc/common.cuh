// Shared helpers for the port's hand-written Hopper kernels: 16-byte vector
// loads/stores with conversion to fp32, warp reductions, dtype codes.
//
// Every kernel entry point is a plain C function (bound with ctypes) that
// launches on the stream it is given and returns cudaGetLastError(), or
// kBadArgs for a shape/dtype it does not take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// The TPU kernels' finite mask value.  Kept finite on purpose: the online
// softmax rescale alpha = exp(m_prev - m_new) stays 0 (not NaN) when a row's
// earlier tiles were all masked.
constexpr float NEG_INF = -1.0e38f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };
constexpr int kBadArgs = -1;

// ---------------------------------------------------------------------------
// 16-byte vectors: N elements of T <-> N floats
// ---------------------------------------------------------------------------
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* i) {
    *reinterpret_cast<float4*>(p) = make_float4(i[0], i[1], i[2], i[3]);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x; o[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* i) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(i[2 * j], i[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// n consecutive floats from shared memory (n = 2, 4 or 8; p aligned to 4n bytes)
template <int n> __device__ __forceinline__ void load_smem(const float* p, float* o) {
  if constexpr (n == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < n; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      o[j] = v.x; o[j + 1] = v.y; o[j + 2] = v.z; o[j + 3] = v.w;
    }
  }
}

// n consecutive elements of T from global memory, element by element
template <typename T, int n> __device__ __forceinline__ void load_row(const T* p, float* o) {
#pragma unroll
  for (int j = 0; j < n; ++j) o[j] = to_float(p[j]);
}

// whether query position qp sees key position kp: keys below kv_len, causal,
// and inside the window (qp - kp < window) when one is set
__device__ __forceinline__ bool live_pair(int qp, int kp, int kv_len, int causal,
                                          int window) {
  return kp < kv_len && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rt
