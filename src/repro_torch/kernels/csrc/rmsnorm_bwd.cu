// K2: RMSNorm backward in one pass over (x, g).  With s = scale (or
// 1 + scale) and r = rsqrt(mean(x^2) + eps) recomputed per row:
//   dx     = (g*s - x*(r^2/D)*sum(g*s*x)) * r          (in x's dtype)
//   dscale = sum over rows of g*x*r                     (fp32)
// Each block writes its rows' dscale partial to ds_part[block, D]; the
// wrapper sums the partials (as the TPU kernel's caller does), so the result
// does not depend on scheduling and no atomics are needed.
//
// Replaces: src/repro/kernels/rmsnorm.py:_rmsnorm_bwd_kernel (entry
// `rmsnorm_bwd`).
//
// Bound on the H100: bytes.  Per row it reads x and g and writes dx (about
// 10 flops per element).  Design: a block takes a run of consecutive rows;
// each thread keeps its columns' scale and dscale partial in registers
// across the run (VPT 16-byte vectors), loads a row of x and g once with
// 16-byte loads, and one shared-memory hop reduces sum(x^2) and sum(g*s*x)
// for the block.  The partials buffer is [blocks, D] fp32, a few MB.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;

// the block's sums of a and b, returned to every thread
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < THREADS / 32 ? red[lane] : make_float2(0.f, 0.f);
    t.x = warp_sum(t.x);
    t.y = warp_sum(t.y);
    if (lane == 0) red[THREADS / 32] = t;
  }
  __syncthreads();
  const float2 out = red[THREADS / 32];
  __syncthreads();  // red is reused by the next row
  return out;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ ds_part, int rows, int D, float eps,
                   int plus_one, int rows_per_block) {
  constexpr int V = Vec16<T>::N;
  __shared__ float2 red[THREADS / 32 + 1];
  const int nvec = D / V;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);

  float se[VPT][V], ds[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = (threadIdx.x + j * THREADS) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      ds[j][e] = 0.f;
      se[j][e] = 0.f;
    }
    if (c < D) {
#pragma unroll
      for (int e = 0; e < V; e += 4) Vec16<float>::load(scale + c + e, se[j] + e);
#pragma unroll
      for (int e = 0; e < V; ++e) se[j][e] = plus_one ? 1.f + se[j][e] : se[j][e];
    }
  }

  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (int64_t)row * D;
    const T* gr = g + (int64_t)row * D;
    float xv[VPT][V], gv[VPT][V];
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < nvec) {
        Vec16<T>::load(xr + i * V, xv[j]);
        Vec16<T>::load(gr + i * V, gv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[j][e] = gv[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(xv[j][e], xv[j][e], ss);
        sgx = fmaf(gv[j][e] * se[j][e], xv[j][e], sgx);
      }
    }
    const float2 sums = block_sum2(ss, sgx, red);
    const float r = rsqrtf(sums.x / (float)D + eps);
    const float k = r * r / (float)D * sums.y;
    T* dxr = dx + (int64_t)row * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= nvec) continue;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = (gv[j][e] * se[j][e] - xv[j][e] * k) * r;
        ds[j][e] = fmaf(gv[j][e] * xv[j][e], r, ds[j][e]);
      }
      Vec16<T>::store(dxr + i * V, o);
    }
  }

  float* dsr = ds_part + (int64_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = (threadIdx.x + j * THREADS) * V;
    if (c >= D) continue;
#pragma unroll
    for (int e = 0; e < V; e += 4) Vec16<float>::store(dsr + c + e, ds[j] + e);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* g, void* dx, void* ds_part,
           int rows, int D, float eps, int plus_one, int blocks, cudaStream_t st) {
  constexpr int V = Vec16<T>::N;
  if (D % V) return kBadArgs;
  const int vpt = (D / V + THREADS - 1) / THREADS;
  const int rpb = (rows + blocks - 1) / blocks;
  if ((rows + rpb - 1) / rpb != blocks) return kBadArgs;  // every block owns a row
#define RT_RMSNORM_BWD(VPT_)                                                         \
  rmsnorm_bwd_kernel<T, VPT_><<<blocks, THREADS, 0, st>>>(                           \
      static_cast<const T*>(x), static_cast<const float*>(scale),                    \
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(ds_part),   \
      rows, D, eps, plus_one, rpb)
  // a thread keeps VPT * V elements of x, g, s and dscale in registers: up
  // to 32 (rows of up to 8192 elements) they fit without spilling
  if (vpt * V > 32) return kBadArgs;
  if (vpt == 1) RT_RMSNORM_BWD(1);
  else if (vpt == 2) RT_RMSNORM_BWD(2);
  else if (vpt <= 4) RT_RMSNORM_BWD(4);
  else if constexpr (V == 4) RT_RMSNORM_BWD(8);
#undef RT_RMSNORM_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g, dx: dense [rows, D] of `dtype`; scale: fp32 [D]; ds_part: fp32
// [blocks, D] with blocks = ceil(rows / ceil(rows / blocks)) (the wrapper
// picks it).  dscale = ds_part.sum(0).
extern "C" int rt_rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                              void* ds_part, int rows, int D, float eps, int plus_one,
                              int blocks, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || blocks <= 0 || blocks > rows) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, scale, g, dx, ds_part, rows, D, eps, plus_one, blocks, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, scale, g, dx, ds_part, rows, D, eps, plus_one, blocks,
                                 st);
  return kBadArgs;
}
