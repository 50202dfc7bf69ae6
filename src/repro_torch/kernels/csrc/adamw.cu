// K6: one-pass AdamW on one storage leaf, in place.
//   g *= gscale
//   m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g^2
//   p' = p - lr*((m'/b1c)/(sqrt(v'/b2c)+eps) + wd*p)
// with (lr, b1c = 1-b1^t, b2c = 1-b2^t, gscale) read from a device fp32[4],
// so a step never syncs the host and never rebuilds anything.  p and g are
// fp32 (the storage layout); m and v are fp32 or bf16 (moment_dtype).
//
// Replaces: src/repro/kernels/adamw.py:_adamw_kernel (entry `adamw_update`).
//
// Bound on the H100: bytes.  Per element it reads p, m, v, g and writes p,
// m, v (28 bytes with fp32 moments) for about 15 flops.  Design: a
// grid-stride pass over 4-element groups, 16-byte loads of p and g (8 bytes
// for bf16 moments), all math in registers; the outputs overwrite the inputs
// (no new leaf-sized buffers), and a scalar loop takes a tail that is not a
// multiple of 4.  (1-b1) and (1-b2) come from the host, rounded from double
// as the JAX kernel's Python constants are.
#include "common.cuh"

using namespace rt;

namespace {

template <typename M> struct Moment4;

template <> struct Moment4<float> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    Vec16<float>::load(p, o);
  }
  __device__ __forceinline__ static void store(float* p, const float* i) {
    Vec16<float>::store(p, i);
  }
};

template <> struct Moment4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* i) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(i[0], i[1]);
    h[1] = __floats2bfloat162_rn(i[2], i[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void update(float& p, float& m, float& v, float g,
                                       const Hyper& h, float lr, float b1c,
                                       float b2c, float gscale) {
  g = g * gscale;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  const float mh = m / b1c;
  const float vh = v / b2c;
  p = p - lr * (mh / (sqrtf(vh) + h.eps) + h.wd * p);
}

template <typename M>
__global__ void __launch_bounds__(256)
adamw_kernel(float* __restrict__ p, M* __restrict__ m, M* __restrict__ v,
             const float* __restrict__ g, const float* __restrict__ scalars,
             int64_t n, Hyper h) {
  const float lr = scalars[0], b1c = scalars[1], b2c = scalars[2], gscale = scalars[3];
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float pv[4], mv[4], vv[4], gv[4];
    Vec16<float>::load(p + 4 * i, pv);
    Vec16<float>::load(g + 4 * i, gv);
    Moment4<M>::load(m + 4 * i, mv);
    Moment4<M>::load(v + 4 * i, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) update(pv[j], mv[j], vv[j], gv[j], h, lr, b1c, b2c, gscale);
    Vec16<float>::store(p + 4 * i, pv);
    Moment4<M>::store(m + 4 * i, mv);
    Moment4<M>::store(v + 4 * i, vv);
  }
  // the tail, element by element
  for (int64_t i = 4 * n4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float pe = p[i], me = to_float(m[i]), ve = to_float(v[i]);
    update(pe, me, ve, g[i], h, lr, b1c, b2c, gscale);
    p[i] = pe;
    m[i] = from_float<M>(me);
    v[i] = from_float<M>(ve);
  }
}

}  // namespace

// p, g: fp32 [n]; m, v: [n] of `moment_dtype` (kFloat32 or kBFloat16); all
// dense, 16-byte aligned; scalars: fp32[4] on the device.  Updates p, m, v
// in place.
extern "C" int rt_adamw(void* p, void* m, void* v, const void* g, const void* scalars,
                        long long n, float b1, float omb1, float b2, float omb2,
                        float eps, float wd, int moment_dtype, void* stream) {
  if (n <= 0) return kBadArgs;
  constexpr int THREADS = 256;
  const long long groups = (n + 3) / 4;
  const int blocks = static_cast<int>(groups / THREADS + 1 < 132 * 16 ? groups / THREADS + 1
                                                                       : 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  if (moment_dtype == kFloat32) {
    adamw_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<float*>(p), static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const float*>(g), static_cast<const float*>(scalars), n, h);
  } else if (moment_dtype == kBFloat16) {
    adamw_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<float*>(p), static_cast<__nv_bfloat16*>(m),
        static_cast<__nv_bfloat16*>(v), static_cast<const float*>(g),
        static_cast<const float*>(scalars), n, h);
  } else {
    return kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
