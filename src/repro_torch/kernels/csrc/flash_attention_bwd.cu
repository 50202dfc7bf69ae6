// K4 and K5: the flash-attention backward, recomputing the probabilities
// from the forward's per-row log-sum-exp (no S x S intermediate):
//   p  = exp(s - lse) on live (q, k) pairs, 0 elsewhere and on rows whose
//        forward saw no key (lse = NEG_INF);  s = scale * q.k, softcapped
//   ds = p * (dO.v - delta) * (1 - t^2 under softcap, t = tanh(s_raw / cap))
//   K4: dq = scale * sum_k ds * k,  plus delta = rowsum(dO * O), which it
//       writes for K5 (the TPU package computes delta in plain JAX first)
//   K5: dv = sum_q p * dO,  dk = scale * sum_q ds * q, over the rep query
//       heads of each KV head inside the block (GQA reduced in-kernel)
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_bwd_dq_kernel (K4)
// and :_attn_bwd_dkv_kernel (K5), entry `flash_attention_bwd`.
//
// Bound on the H100: operations at training lengths (about 7 products of
// S^2/2 * D per head against O(S * D) bytes).  Like K3 this first version
// runs the products on the fp32 CUDA cores, not the tensor cores, so it sits
// far from that bound; its design keeps the fp32 units fed from shared
// memory and needs no atomics, so the sums are deterministic:
//   * K4: grid (q-block of 32 rows, q head, batch), the forward's k-tile
//     loop bounds; Q and dO rows are staged once, K/V stream through shared
//     memory in 32-key tiles.  A warp owns 8 query rows: a lane owns one key
//     of the tile for s and dO.v (the K/V rows padded by 4 floats so the
//     lanes' 16-byte reads do not conflict), then D/32 columns of dq.
//   * K5: grid (k-block, KV head, batch).  The block's keys and their V rows
//     stay in shared memory; it walks the rep query heads of its KV head and
//     the 32-row q tiles inside the causal/window bounds.  A warp owns 8 keys
//     (4 at head dim 256); a lane owns one q row of the tile for s and dO.v,
//     then D/32 columns of the warp's dk and dv, which stay in registers
//     across the whole walk.
//   * q/k/v/out/dO are read in the JAX layout [B, S, H, D] through strides.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 32;                 // query rows per tile
constexpr int BK = 32;                 // keys per tile (K4)

__device__ __forceinline__ bool live_pair(int qp, int kp, int kv_len, int causal,
                                          int window) {
  return kp < kv_len && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// stage rows [r0, r0 + n) of a [.., S, .., D] head into smem rows of `stride`
// floats, scaled; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* src,
                                           int64_t row_stride, int r0, int n, int S,
                                           float scale) {
  constexpr int V = Vec16<T>::N;
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < n * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * V;
    float buf[V];
    if (r0 + r < S) {
      Vec16<T>::load(src + (int64_t)(r0 + r) * row_stride + c, buf);
#pragma unroll
      for (int j = 0; j < V; ++j) buf[j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) buf[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; j += 4) Vec16<float>::store(dst + r * stride + c + j, buf + j);
  }
}

// ---------------------------------------------------------------------------
// K4: dq (and delta)
// ---------------------------------------------------------------------------
constexpr int DQ_ROWS = 8;             // query rows per warp

template <int D> struct DqSmem {
  static constexpr int KSTRIDE = D + 4;
  static constexpr size_t bytes =
      sizeof(float) * (2 * BQ * D + 2 * BK * KSTRIDE + WARPS * DQ_ROWS * BK);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta_out, int S, int Hq,
                    int Hkv, int64_t qsB, int64_t qsS, int64_t qsH, int64_t ksB,
                    int64_t ksS, int64_t ksH, int64_t vsB, int64_t vsS, int64_t vsH,
                    int64_t osB, int64_t osS, int64_t osH, int64_t dsB, int64_t dsS,
                    int64_t dsH, int kv_len, int causal, int window, float softcap,
                    float scale) {
  constexpr int KSTRIDE = DqSmem<D>::KSTRIDE;
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BQ][D]
  float* Os = Qs + BQ * D;           // [BQ][D], dO
  float* Ks = Os + BQ * D;           // [BK][KSTRIDE]
  float* Vs = Ks + BK * KSTRIDE;     // [BK][KSTRIDE]
  float* Ps = Vs + BK * KSTRIDE;     // [WARPS][DQ_ROWS][BK], ds

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kb = k + b * ksB + hk * ksH;
  const T* vb = v + b * vsB + hk * vsH;
  stage_rows<T, D>(Qs, D, q + b * qsB + h * qsH, qsS, q0, BQ, S, 1.f);
  stage_rows<T, D>(Os, D, dO + b * dsB + h * dsH, dsS, q0, BQ, S, 1.f);
  __syncthreads();

  // delta = rowsum(dO * O), lse, and the dead-row flag for the warp's rows
  const int qw0 = q0 + warp * DQ_ROWS;
  const float* Qw = Qs + warp * DQ_ROWS * D;
  const float* Ow = Os + warp * DQ_ROWS * D;
  float delta[DQ_ROWS], lse_r[DQ_ROWS];
  bool dead[DQ_ROWS];
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int qp = qw0 + r;  // warp-uniform
    float part = 0.f;
    if (qp < S) {
      const T* orow = o + b * osB + (int64_t)qp * osS + h * osH + lane * DPL;
      float ov[DPL];
      load_row<T, DPL>(orow, ov);
#pragma unroll
      for (int c = 0; c < DPL; ++c) part = fmaf(Ow[r * D + lane * DPL + c], ov[c], part);
    }
    delta[r] = warp_sum(part);
    const float l = qp < S ? lse[((int64_t)b * Hq + h) * S + qp] : NEG_INF;
    dead[r] = l <= 0.5f * NEG_INF;
    lse_r[r] = dead[r] ? 0.f : l;
    if (qp < S && lane == 0) delta_out[((int64_t)b * Hq + h) * S + qp] = delta[r];
  }

  int hi = (kv_len + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  const int lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;

  float acc[DQ_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  float* Pw = Ps + warp * DQ_ROWS * BK;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, D>(Ks, KSTRIDE, kb, ksS, k0, BK, S, 1.f);
    stage_rows<T, D>(Vs, KSTRIDE, vb, vsS, k0, BK, S, 1.f);
    __syncthreads();

    float s[DQ_ROWS], dp[DQ_ROWS];
#pragma unroll
    for (int r = 0; r < DQ_ROWS; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * KSTRIDE;
    const float* vr = Vs + lane * KSTRIDE;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
      const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
      for (int r = 0; r < DQ_ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * D + d);
        const float4 ov = *reinterpret_cast<const float4*>(Ow + r * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
        dp[r] = fmaf(ov.x, vv.x, dp[r]);
        dp[r] = fmaf(ov.y, vv.y, dp[r]);
        dp[r] = fmaf(ov.z, vv.z, dp[r]);
        dp[r] = fmaf(ov.w, vv.w, dp[r]);
      }
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < DQ_ROWS; ++r) {
      const int qp = qw0 + r;
      float sr = s[r] * scale, tt = 0.f;
      if (softcap > 0.f) {
        tt = tanhf(sr / softcap);
        sr = softcap * tt;
      }
      const bool live = qp < S && !dead[r] && live_pair(qp, kp, kv_len, causal, window);
      const float p = live ? expf(sr - lse_r[r]) : 0.f;
      float ds = p * (dp[r] - delta[r]);
      if (softcap > 0.f) ds *= 1.f - tt * tt;
      Pw[r * BK + lane] = ds;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kk[DPL];
      load_smem<DPL>(Ks + j * KSTRIDE + lane * DPL, kk);
#pragma unroll
      for (int r = 0; r < DQ_ROWS; ++r) {
        const float ds = Pw[r * BK + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(ds, kk[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int qp = qw0 + r;
    if (qp >= S) continue;
    T* out = dq + (((int64_t)b * S + qp) * Hq + h) * D + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) out[c] = from_float<T>(acc[r][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// K5: dk and dv
// ---------------------------------------------------------------------------
template <int D> struct DkvCfg {
  static constexpr int KR = D >= 256 ? 4 : 8;    // keys per warp
  static constexpr int BKV = WARPS * KR;         // keys per block
  static constexpr int STRIDE = D + 4;           // padded K/V/Q/dO rows
  static constexpr size_t bytes =
      sizeof(float) * (2 * BKV * STRIDE + 2 * BQ * STRIDE + 2 * BQ + 2 * WARPS * KR * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv,
                     int64_t qsB, int64_t qsS, int64_t qsH, int64_t ksB, int64_t ksS,
                     int64_t ksH, int64_t vsB, int64_t vsS, int64_t vsH, int64_t dsB,
                     int64_t dsS, int64_t dsH, int kv_len, int causal, int window,
                     float softcap, float scale) {
  constexpr int KR = DkvCfg<D>::KR, BKV = DkvCfg<D>::BKV, STRIDE = DkvCfg<D>::STRIDE;
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BKV][STRIDE]
  float* Vs = Ks + BKV * STRIDE;       // [BKV][STRIDE]
  float* Qs = Vs + BKV * STRIDE;       // [BQ][STRIDE]
  float* Os = Qs + BQ * STRIDE;        // [BQ][STRIDE], dO
  float* Ls = Os + BQ * STRIDE;        // [BQ] lse (0 on dead rows)
  float* Es = Ls + BQ;                 // [BQ] delta
  float* Pw_all = Es + BQ;             // [WARPS][KR][BQ], p
  float* Dw_all = Pw_all + WARPS * KR * BQ;  // [WARPS][KR][BQ], ds

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stage_rows<T, D>(Ks, STRIDE, k + b * ksB + hk * ksH, ksS, k0, BKV, S, 1.f);
  stage_rows<T, D>(Vs, STRIDE, v + b * vsB + hk * vsH, vsS, k0, BKV, S, 1.f);

  const int kw0 = k0 + warp * KR;      // the warp's first key
  const float* Kw = Ks + warp * KR * STRIDE;
  const float* Vw = Vs + warp * KR * STRIDE;
  float* Pw = Pw_all + warp * KR * BQ;
  float* Dw = Dw_all + warp * KR * BQ;

  float dk_acc[KR][DPL], dv_acc[KR][DPL];
#pragma unroll
  for (int j = 0; j < KR; ++j)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  // q-tile range: the queries that can see any key of this block
  const int nq = (S + BQ - 1) / BQ;
  const int k_last = min(k0 + BKV, S) - 1;
  const int qlo = causal ? k0 / BQ : 0;
  const int qhi = window > 0 ? min(nq, (k_last + window - 1) / BQ + 1) : nq;
  const bool any_key = k0 < kv_len;

  for (int r = 0; any_key && r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qh = q + b * qsB + h * qsH;
    const T* oh = dO + b * dsB + h * dsH;
    const float* lh = lse + ((int64_t)b * Hq + h) * S;
    const float* eh = delta + ((int64_t)b * Hq + h) * S;
    for (int t = qlo; t < qhi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile is consumed (and K/V are staged)
      stage_rows<T, D>(Qs, STRIDE, qh, qsS, q0, BQ, S, 1.f);
      stage_rows<T, D>(Os, STRIDE, oh, dsS, q0, BQ, S, 1.f);
      if (tid < BQ) {
        const int qp = q0 + tid;
        const float l = qp < S ? lh[qp] : NEG_INF;
        Ls[tid] = l;
        Es[tid] = qp < S ? eh[qp] : 0.f;
      }
      __syncthreads();

      // lane = q row of the tile; the warp's KR keys
      const int qp = q0 + lane;
      const float l = Ls[lane];
      const bool dead = l <= 0.5f * NEG_INF;
      const float lse_l = dead ? 0.f : l, delta_l = Es[lane];
      float s[KR], dp[KR];
#pragma unroll
      for (int j = 0; j < KR; ++j) s[j] = dp[j] = 0.f;
      const float* qr = Qs + lane * STRIDE;
      const float* orow = Os + lane * STRIDE;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
        const float4 ov = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
        for (int j = 0; j < KR; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(Kw + j * STRIDE + d);
          const float4 vv = *reinterpret_cast<const float4*>(Vw + j * STRIDE + d);
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
          dp[j] = fmaf(ov.x, vv.x, dp[j]);
          dp[j] = fmaf(ov.y, vv.y, dp[j]);
          dp[j] = fmaf(ov.z, vv.z, dp[j]);
          dp[j] = fmaf(ov.w, vv.w, dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        const int kp = kw0 + j;
        float sr = s[j] * scale, tt = 0.f;
        if (softcap > 0.f) {
          tt = tanhf(sr / softcap);
          sr = softcap * tt;
        }
        const bool live = qp < S && kp < S && !dead &&
                          live_pair(qp, kp, kv_len, causal, window);
        const float p = live ? expf(sr - lse_l) : 0.f;
        float ds = p * (dp[j] - delta_l);
        if (softcap > 0.f) ds *= 1.f - tt * tt;
        Pw[j * BQ + lane] = p;
        Dw[j * BQ + lane] = ds;
      }
      __syncwarp();

      // dv += p^T dO, dk += ds^T q: this lane's DPL columns
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float ov[DPL], qv[DPL];
        load_smem<DPL>(Os + i * STRIDE + lane * DPL, ov);
        load_smem<DPL>(Qs + i * STRIDE + lane * DPL, qv);
#pragma unroll
        for (int j = 0; j < KR; ++j) {
          const float p = Pw[j * BQ + i], ds = Dw[j * BQ + i];
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            dv_acc[j][c] = fmaf(p, ov[c], dv_acc[j][c]);
            dk_acc[j][c] = fmaf(ds, qv[c], dk_acc[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int kp = kw0 + j;
    if (kp >= S) continue;
    const int64_t off = (((int64_t)b * S + kp) * Hkv + hk) * D + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dk[off + c] = from_float<T>(dk_acc[j][c] * scale);
      dv[off + c] = from_float<T>(dv_acc[j][c]);
    }
  }
}

struct Strides {
  const long long *q, *k, *v, *o, *dO;
};

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const void* lse, void* dq, void* delta, int B, int S, int Hq, int Hkv,
              Strides st_, int kv_len, int causal, int window, float softcap,
              cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dO), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), S, Hq, Hkv, st_.q[0], st_.q[1],
      st_.q[2], st_.k[0], st_.k[1], st_.k[2], st_.v[0], st_.v[1], st_.v[2], st_.o[0],
      st_.o[1], st_.o[2], st_.dO[0], st_.dO[1], st_.dO[2], kv_len, causal, window,
      softcap, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B, int S,
               int Hq, int Hkv, Strides st_, int kv_len, int causal, int window,
               float softcap, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = DkvCfg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + DkvCfg<D>::BKV - 1) / DkvCfg<D>::BKV, Hkv, B);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, Hq,
      Hkv, st_.q[0], st_.q[1], st_.q[2], st_.k[0], st_.k[1], st_.k[2], st_.v[0],
      st_.v[1], st_.v[2], st_.dO[0], st_.dO[1], st_.dO[2], kv_len, causal, window,
      softcap, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int B, int S, int Hq, int Hkv, int kv_len) {
  return B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || kv_len <= 0 || kv_len > S;
}

}  // namespace

// q/k/v/out/dO strides are (batch, seq, head) in elements; the last dim is
// dense.  lse and delta are dense fp32 [B, Hq, S]; dq is a dense [B, S, Hq,
// D] tensor of q's dtype.  delta is written here for K5.
extern "C" int rt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dO,
    const void* lse, void* dq, void* delta, int B, int S, int Hq, int Hkv, int D,
    const long long* q_strides, const long long* k_strides, const long long* v_strides,
    const long long* o_strides, const long long* do_strides, int kv_len, int causal,
    int window, float softcap, int dtype, void* stream) {
  if (bad_args(B, S, Hq, Hkv, kv_len)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{q_strides, k_strides, v_strides, o_strides, do_strides};
#define RT_DQ(T_, D_) \
  launch_dq<T_, D_>(q, k, v, o, dO, lse, dq, delta, B, S, Hq, Hkv, s, kv_len, causal, \
                    window, softcap, st)
  if (dtype == kFloat32) {
    if (D == 64) return RT_DQ(float, 64);
    if (D == 128) return RT_DQ(float, 128);
    if (D == 256) return RT_DQ(float, 256);
  } else if (dtype == kBFloat16) {
    if (D == 64) return RT_DQ(__nv_bfloat16, 64);
    if (D == 128) return RT_DQ(__nv_bfloat16, 128);
    if (D == 256) return RT_DQ(__nv_bfloat16, 256);
  }
#undef RT_DQ
  return kBadArgs;
}

// as above; dk and dv are dense [B, S, Hkv, D] tensors of k's dtype, and
// delta is K4's output.
extern "C" int rt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dk, void* dv, int B, int S, int Hq, int Hkv, int D,
    const long long* q_strides, const long long* k_strides, const long long* v_strides,
    const long long* do_strides, int kv_len, int causal, int window, float softcap,
    int dtype, void* stream) {
  if (bad_args(B, S, Hq, Hkv, kv_len)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{q_strides, k_strides, v_strides, nullptr, do_strides};
#define RT_DKV(T_, D_) \
  launch_dkv<T_, D_>(q, k, v, dO, lse, delta, dk, dv, B, S, Hq, Hkv, s, kv_len, causal, \
                     window, softcap, st)
  if (dtype == kFloat32) {
    if (D == 64) return RT_DKV(float, 64);
    if (D == 128) return RT_DKV(float, 128);
    if (D == 256) return RT_DKV(float, 256);
  } else if (dtype == kBFloat16) {
    if (D == 64) return RT_DKV(__nv_bfloat16, 64);
    if (D == 128) return RT_DKV(__nv_bfloat16, 128);
    if (D == 256) return RT_DKV(__nv_bfloat16, 256);
  }
#undef RT_DKV
  return kBadArgs;
}
