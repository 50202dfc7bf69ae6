// K1: RMSNorm forward, y = x * rsqrt(mean(x^2) + eps) * s with s = scale or
// 1 + scale, in fp32, written in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py:_rmsnorm_kernel (entry `rmsnorm`).
//
// Bound on the H100: bytes.  Per row it reads D elements and writes D
// (2 flops per element), far below the ~20 flop/byte where fp32 compute
// would matter.  Design: one block per row, 16-byte vector loads with
// neighbouring threads on neighbouring addresses, the sum of squares reduced
// in fp32 through warp shuffles and one shared-memory hop.  The second pass
// re-reads the row, which was just touched by the same block and hits L1/L2,
// so device memory sees each byte of x once.
#include "common.cuh"

using namespace rt;

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int D, float eps, int plus_one) {
  constexpr int V = Vec16<T>::N;
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* yr = out + (int64_t)blockIdx.x * D;
  const int nvec = D / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    float v[V];
    Vec16<T>::load(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
  }
  __shared__ float red[THREADS / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / (float)D + eps);

  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    float v[V], s[V];
    Vec16<T>::load(xr + i * V, v);
#pragma unroll
    for (int j = 0; j < V; j += 4) Vec16<float>::load(scale + i * V + j, s + j);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = v[j] * r * (plus_one ? 1.f + s[j] : s[j]);
    Vec16<T>::store(yr + i * V, v);
  }
}

extern "C" int rt_rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                              int D, float eps, int plus_one, int dtype, void* stream) {
  constexpr int THREADS = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return kBadArgs;
  if (dtype == kFloat32) {
    if (D % 4) return kBadArgs;
    rmsnorm_kernel<float, THREADS><<<rows, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), D, eps, plus_one);
  } else if (dtype == kBFloat16) {
    if (D % 8) return kBadArgs;
    rmsnorm_kernel<__nv_bfloat16, THREADS><<<rows, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), D, eps, plus_one);
  } else {
    return kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
