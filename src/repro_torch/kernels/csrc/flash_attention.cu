// K3: flash-attention forward.  Causal/windowed GQA attention with logit
// softcap and kv_len masking, online fp32 softmax, emitting out (in q's
// dtype) and the per-row log-sum-exp (fp32) the backward will need.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_fwd_kernel (entry
// `flash_attention_fwd`).
//
// Bound on the H100: operations once S passes about 600 (causal: ~2*S^2*D
// flops per head against ~4*S*D bytes of q and out, and the card needs ~295
// flops per byte); below that, as at the serving path's S <= 512, the bytes
// of q and out.  This first version runs the products on the fp32 CUDA
// cores, not the tensor cores (wgmma/TMA are a later step), so it sits far
// from either bound; its design keeps the fp32 units fed from shared memory:
//   * grid (q-block, q-head, batch); the q head maps to KV head h / rep, so
//     GQA needs no repeated K/V;
//   * q/k/v are read in the JAX layout [B, S, H, D] through their strides
//     (no transposed copy); K/V stream through shared memory in 32-key
//     tiles, converted to fp32 once per tile;
//   * each warp owns 8 query rows; for the scores a lane owns one key of the
//     tile and reuses each K value for all 8 rows (q reads are broadcasts),
//     K rows are padded by 4 floats so the lanes' 16-byte reads do not
//     conflict; for P*V a lane owns D/32 output columns, so the accumulator
//     is 8 * D/32 floats per lane (no spill at D = 256);
//   * tiles are pruned with the TPU kernel's causal/window loop bounds, and
//     masked logits take the finite NEG_INF (see common.cuh); a row that
//     sees no live key ends with out 0 and lse NEG_INF.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 8;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BK = 32;               // keys per tile (one per lane)
constexpr int THREADS = WARPS * 32;

template <int D> struct Smem {
  static constexpr int KSTRIDE = D + 4;  // padded K/V row, in floats
  static constexpr size_t bytes =
      sizeof(float) * (BQ * D + 2 * BK * KSTRIDE + WARPS * ROWS * BK);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Hq, int Hkv,
                 int64_t qsB, int64_t qsS, int64_t qsH,
                 int64_t ksB, int64_t ksS, int64_t ksH,
                 int64_t vsB, int64_t vsS, int64_t vsH,
                 int kv_len, int causal, int window, float softcap, float scale) {
  constexpr int KSTRIDE = Smem<D>::KSTRIDE;
  constexpr int V = Vec16<T>::N;
  constexpr int VPR = D / V;   // 16-byte vectors per row
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][D], scaled
  float* Ks = Qs + BQ * D;          // [BK][KSTRIDE]
  float* Vs = Ks + BK * KSTRIDE;    // [BK][KSTRIDE]
  float* Ps = Vs + BK * KSTRIDE;    // [WARPS][ROWS][BK]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * qsB + h * qsH;
  const T* kb = k + b * ksB + hk * ksH;
  const T* vb = v + b * vsB + hk * vsH;

  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * V;
    float buf[V];
    if (q0 + r < S) {
      Vec16<T>::load(qb + (q0 + r) * qsS + c, buf);
#pragma unroll
      for (int j = 0; j < V; ++j) buf[j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) buf[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; j += 4) Vec16<float>::store(Qs + r * D + c + j, buf + j);
  }

  // k-tile range: the TPU kernel's pruning, on 32-key tiles
  int hi = (kv_len + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  const int lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;

  float acc[ROWS][DPL], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* Qw = Qs + warp * ROWS * D;
  float* Pw = Ps + warp * ROWS * BK;
  const int qw0 = q0 + warp * ROWS;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed (and Qs is staged)
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * V;
      float kbuf[V], vbuf[V];
      if (k0 + r < S) {
        Vec16<T>::load(kb + (k0 + r) * ksS + c, kbuf);
        Vec16<T>::load(vb + (k0 + r) * vsS + c, vbuf);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kbuf[j] = vbuf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        Vec16<float>::store(Ks + r * KSTRIDE + c + j, kbuf + j);
        Vec16<float>::store(Vs + r * KSTRIDE + c + j, vbuf + j);
      }
    }
    __syncthreads();

    // scores: this lane's key against the warp's ROWS query rows
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * KSTRIDE;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qp = qw0 + r;
      const bool live = kp < kv_len && (!causal || qp >= kp) &&
                        (window <= 0 || qp - kp < window);
      float sr = s[r];
      if (softcap > 0.f) sr = softcap * tanhf(sr / softcap);
      sr = live ? sr : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float p = live ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      Pw[r * BK + lane] = p;
    }
    __syncwarp();

    // P * V: this lane's DPL output columns
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
      load_smem<DPL>(Vs + j * KSTRIDE + lane * DPL, vv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = Pw[r * BK + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qp = qw0 + r;  // warp-uniform
    if (qp >= S) continue;
    float lt = warp_sum(l[r]);
    lt = lt == 0.f ? 1.f : lt;
    T* o = out + (((int64_t)b * S + qp) * Hq + h) * D + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[c] = from_float<T>(acc[r][c] / lt);
    if (lane == 0) lse[((int64_t)b * Hq + h) * S + qp] = m[r] + logf(lt);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
           int S, int Hq, int Hkv, const long long* qs, const long long* ks,
           const long long* vs, int kv_len, int causal, int window, float softcap,
           cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), S, Hq, Hkv, qs[0], qs[1], qs[2],
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], kv_len, causal, window, softcap,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, void* lse,
               int B, int S, int Hq, int Hkv, const long long* qs, const long long* ks,
               const long long* vs, int kv_len, int causal, int window, float softcap,
               cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, lse, B, S, Hq, Hkv, qs, ks, vs, kv_len, causal, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, S, Hq, Hkv, qs, ks, vs, kv_len, causal, window, softcap, st);
    case 256: return launch<T, 256>(q, k, v, out, lse, B, S, Hq, Hkv, qs, ks, vs, kv_len, causal, window, softcap, st);
    default: return kBadArgs;
  }
}

}  // namespace

// q/k/v strides are (batch, seq, head) in elements; the last dim is dense.
// out is a dense [B, S, Hq, D] tensor of q's dtype, lse a dense fp32 [B, Hq, S].
extern "C" int rt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      void* out, void* lse, int B, int S, int Hq,
                                      int Hkv, int D, const long long* q_strides,
                                      const long long* k_strides,
                                      const long long* v_strides, int kv_len,
                                      int causal, int window, float softcap,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || kv_len <= 0 || kv_len > S)
    return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_d<float>(D, q, k, v, out, lse, B, S, Hq, Hkv, q_strides, k_strides,
                             v_strides, kv_len, causal, window, softcap, st);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, S, Hq, Hkv, q_strides,
                                     k_strides, v_strides, kv_len, causal, window,
                                     softcap, st);
  return kBadArgs;
}
