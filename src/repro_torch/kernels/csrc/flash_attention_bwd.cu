// K4 and K5: the flash-attention backward, recomputing the probabilities
// from the forward's per-row log-sum-exp (no S x S intermediate):
//   p  = exp(s - lse) on live (q, k) pairs, 0 elsewhere and on rows whose
//        forward saw no key (lse <= NEG_INF / 2);  s = scale * q.k, softcapped
//   ds = p * (dO.v - delta) * (1 - t^2 under softcap, t = tanh(s_raw / cap))
//   K4: dq = scale * sum_k ds * k,  plus delta = rowsum(dO * O), which it
//       writes for K5 (the TPU package computes delta in plain JAX first)
//   K5: dv = sum_q p * dO,  dk = scale * sum_q ds * q, over the rep query
//       heads of each KV head inside the block (GQA reduced in-kernel)
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_bwd_dq_kernel (K4)
// and :_attn_bwd_dkv_kernel (K5), entry `flash_attention_bwd`.
//
// Bound on the H100: operations at training lengths: K4 three and K5 four
// products of (live pairs) x D multiply-adds per head, against O(S * D)
// bytes.  Two instances:
//
// bf16 at every head dim (64, 112, 128: the training path, Yi-6B at hd 128;
// 256: gemma) runs every product on the tensor cores, bf16 operands with
// fp32 accumulators, tiles of 64 rows kept bf16 in shared memory in wgmma's
// 128-byte-swizzled layout (wgmma.cuh), one consumer warpgroup (128 threads)
// a block in K4 below head dim 256 and two otherwise:
//   * K4, flash_bwd_dq_kernel_tc: a block owns 64 query rows of one q head;
//     its Q and dO tiles are loaded once.  K/V tiles of 64 keys stream
//     through a two-stage cp.async ring (the next tile's copy is in flight
//     while the current one is multiplied).  S = Q K^T and dP = dO V^T are
//     wgmma m64n64k16 with both operands from shared memory; ds is formed in
//     the accumulator registers (p from lse, the mask, softcap's (1 - t^2),
//     delta), rounded to bf16 in pairs and fed back as the register A
//     operand of dQ += dS K: wgmma m64n{D}k16, the K tile read MN-major
//     (the transpose bit), so it is never transposed in memory.
//   * K5, flash_bwd_dkv_kernel_tc: a block owns 64 keys of one KV head, K
//     and V resident in shared memory, and walks the rep query heads and the
//     q tiles inside the causal/window bounds.  Keys are the M dimension:
//     S^T = K Q^T and dP^T = V dO^T (m64n64k16, shared-memory operands)
//     leave P^T and dS^T in the accumulator already in the register-A layout
//     of dV += P^T dO and dK += dS^T Q (m64n{D}k16, Q/dO tiles read
//     MN-major); lse and delta are indexed by column.  Two consumer
//     warpgroups split the walk (even and odd steps), each with its own
//     two-stage cp.async ring of Q/dO tiles and lse/delta rows and its dK and
//     dV accumulators in registers throughout; at the end each adds the
//     other's partial of one output through shared memory.  So the GQA sum
//     stays in the block, in a fixed order, with no atomics (deterministic).
//     Where the key tiles give fewer blocks than SMs (MQA: granite-20b's one
//     KV head at 2 x 2048, 64 tiles for 132 SMs, each walking 48 query
//     heads), a KV head's query heads are split over G blocks, as at head
//     dim 256 below; elsewhere G is 1 and the block stores its sums itself;
//   * Causal balance: blocks are numbered so that the heaviest launch first
//     (K4: the last q tiles, which see the most keys; K5: the first key
//     tiles, which see the most queries).  At the training shape K5 has
//     only 256 key tiles for 132 SMs, and under causal the first walks 32
//     times as many q tiles as the last; with one warpgroup a block all 256
//     were resident at once and the heaviest set the time.  Two warpgroups
//     a block (one block an SM: 163 KB of shared memory at hd 128) halve the
//     longest walk, and the heaviest-first order fills the SMs that the
//     light blocks free, with no second pass over partial sums.
//   * K4 at head dim 256, flash_bwd_dq_kernel_tc_split: dQ of 64 rows is 128
//     fp32 registers a thread in one warpgroup, beside S and dP (it spilled),
//     so two warpgroups split the head dim (128 columns, 64 registers each)
//     and both form S and dP, which contract over the whole head dim;
//   * K5 at head dim 256, flash_bwd_dkv_kernel_tc_split: dK + dV of 64 keys
//     are 256 fp32 registers a thread in one warpgroup, so the two
//     warpgroups split the head dim instead of the walk (128 each), and both
//     form the products that contract over the whole head dim.  Under MQA a
//     KV head has few key tiles (gemma-2b: 64 for 132 SMs), so its query
//     heads are split over several blocks, which sum fp32 partials from a
//     workspace in a fixed order (see the kernel);
//   * p and ds enter their products rounded to bf16 (the plain version keeps
//     them fp32), so the outputs agree to bf16 rounding of the sums' terms.
//
// fp32 keeps the first version on the fp32 CUDA cores, flash_bwd_dq_kernel /
// flash_bwd_dkv_kernel:
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
//   * fp32 stays off the tensor cores: TF32 would break the full-width fp32
//     card-vs-CPU train parity.
// Both instances read q/k/v/out/dO in the JAX layout [B, S, H, D] through
// strides.  Head dim 112 (Zamba2-7B's shared attention) runs D = 128
// instances compiled with the true head dim DT = 112: columns 112-127 of every
// tile are zeros (cp.async's src-size form, or skipped loads on the CUDA
// cores), the stores and the delta row sums skip them, and the scale is
// 112^-0.5.  Nothing is padded in memory; at DT = D every such test folds away
// at compile time, so the other head dims run exactly the code they ran
// before.
#include <algorithm>

#include "common.cuh"
#include "wgmma.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 32;                 // query rows per tile
constexpr int BK = 32;                 // keys per tile (K4)

// stage rows [r0, r0 + n) of a [.., S, .., DT] head into smem rows of `stride`
// floats, scaled; rows past S and columns past DT (<= D) are zero
template <typename T, int D, int DT = D>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* src,
                                           int64_t row_stride, int r0, int n, int S,
                                           float scale) {
  constexpr int V = Vec16<T>::N;
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < n * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * V;
    float buf[V];
    if (r0 + r < S && (DT == D || c < DT)) {
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

template <typename T, int D, int DT = D>
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
  stage_rows<T, D, DT>(Qs, D, q + b * qsB + h * qsH, qsS, q0, BQ, S, 1.f);
  stage_rows<T, D, DT>(Os, D, dO + b * dsB + h * dsH, dsS, q0, BQ, S, 1.f);
  __syncthreads();

  // delta = rowsum(dO * O) and lse for the warp's rows; a row whose forward
  // saw no key takes lse = +inf, so that its p = exp(s - lse) is exactly 0
  // with no flag held beside it (with 8 such flags a thread, the fp32
  // head-dim-64 instance spilled 8 bytes)
  const int qw0 = q0 + warp * DQ_ROWS;
  const float* Qw = Qs + warp * DQ_ROWS * D;
  const float* Ow = Os + warp * DQ_ROWS * D;
  float delta[DQ_ROWS], lse_r[DQ_ROWS];
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int qp = qw0 + r;  // warp-uniform
    float part = 0.f;
    if (qp < S && (DT == D || lane * DPL < DT)) {
      const T* orow = o + b * osB + (int64_t)qp * osS + h * osH + lane * DPL;
      float ov[DPL];
      load_row<T, DPL>(orow, ov);
#pragma unroll
      for (int c = 0; c < DPL; ++c) part = fmaf(Ow[r * D + lane * DPL + c], ov[c], part);
    }
    delta[r] = warp_sum(part);
    const float l = qp < S ? lse[((int64_t)b * Hq + h) * S + qp] : NEG_INF;
    lse_r[r] = l <= 0.5f * NEG_INF ? INFINITY : l;
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
    stage_rows<T, D, DT>(Ks, KSTRIDE, kb, ksS, k0, BK, S, 1.f);
    stage_rows<T, D, DT>(Vs, KSTRIDE, vb, vsS, k0, BK, S, 1.f);
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
      const bool live = qp < S && live_pair(qp, kp, kv_len, causal, window);
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
    if (qp >= S || (DT < D && lane * DPL >= DT)) continue;
    T* out = dq + (((int64_t)b * S + qp) * Hq + h) * DT + lane * DPL;
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

template <typename T, int D, int DT = D>
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
  stage_rows<T, D, DT>(Ks, STRIDE, k + b * ksB + hk * ksH, ksS, k0, BKV, S, 1.f);
  stage_rows<T, D, DT>(Vs, STRIDE, v + b * vsB + hk * vsH, vsS, k0, BKV, S, 1.f);

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
      stage_rows<T, D, DT>(Qs, STRIDE, qh, qsS, q0, BQ, S, 1.f);
      stage_rows<T, D, DT>(Os, STRIDE, oh, dsS, q0, BQ, S, 1.f);
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
    if (kp >= S || (DT < D && lane * DPL >= DT)) continue;
    const int64_t off = (((int64_t)b * S + kp) * Hkv + hk) * DT + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dk[off + c] = from_float<T>(dk_acc[j][c] * scale);
      dv[off + c] = from_float<T>(dv_acc[j][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (head dim 64, 112 and 128; K4 at 256 too)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;        // one warpgroup
constexpr int TT = tc::TILE_ROWS;      // rows of every tile: q rows or keys

template <int D> struct DqTc {
  static constexpr uint32_t TILE = TT * D * sizeof(bf16);
  // Q, dO and two stages of (K, V); delta of 64 rows; 1 KB to align the
  // tiles for the swizzle
  static constexpr size_t bytes = 6 * TILE + TT * sizeof(float) + 1024;
};

template <int D> struct DkvTc {
  static constexpr uint32_t TILE = TT * D * sizeof(bf16);
  // K, V, and for each of two warpgroups two stages of (Q, dO) tiles and of
  // (lse, delta) rows; 1 KB to align
  static constexpr size_t bytes = 10 * TILE + 2 * 2 * 2 * TT * sizeof(float) + 1024;
};

// p and ds of one accumulator element: s_raw = q.k unscaled, dp = dO.v
__device__ __forceinline__ void p_ds(float s_raw, float dp, float lse2, float delta,
                                     bool live, float scale, float softcap, float& p,
                                     float& ds) {
  float sr = s_raw * scale, t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(sr / softcap);
    sr = softcap * t;
  }
  p = live ? exp2f(fmaf(sr, tc::LOG2E, -lse2)) : 0.f;
  ds = p * (dp - delta);
  if (softcap > 0.f) ds *= 1.f - t * t;
}

// K4 on the tensor cores.  Grid: one block per (q tile, q head, batch),
// numbered so that the q tiles with the most keys come first under causal.
// WG consumer warpgroups a block split dQ's head dim: warpgroup w keeps
// columns [w D / WG, (w + 1) D / WG) in registers.  S = Q K^T and dP = dO V^T
// contract over the whole head dim, so every warpgroup forms both.
template <int D, int DT, int WG>
__device__ __forceinline__ void dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                                      const bf16* __restrict__ dO,
                                      const float* __restrict__ lse, bf16* __restrict__ dq,
                                      float* __restrict__ delta_out, int B, int S, int Hq,
                                      int Hkv, int64_t qsB, int64_t qsS, int64_t qsH,
                                      int64_t ksB, int64_t ksS, int64_t ksH, int64_t vsB,
                                      int64_t vsS, int64_t vsH, int64_t osB, int64_t osS,
                                      int64_t osH, int64_t dsB, int64_t dsS, int64_t dsH,
                                      int kv_len, int causal, int window, float softcap,
                                      float scale) {
  static_assert(WG == 1 || DT == D, "a split head dim has no zero columns");
  constexpr uint32_t TILE = DqTc<D>::TILE;
  constexpr int N = D / WG;                // dq columns of a warpgroup
  constexpr int NT = WG * TC_THREADS;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t s0 = tc::smem_addr(smem_tc);
  const uint32_t sQ = (s0 + 1023u) & ~1023u, sO = sQ + TILE, sKV = sQ + 2 * TILE;
  float* delta_s = reinterpret_cast<float*>(smem_tc + (sQ - s0) + 6 * TILE);

  const int nq = (S + TT - 1) / TT;
  const int id = blockIdx.x, per_tile = Hq * B;
  const int q0 = (nq - 1 - id / per_tile) * TT;
  const int h = id % per_tile % Hq, b = id % per_tile / Hq;
  const int hk = h / (Hq / Hkv);
  const int wg = threadIdx.x / TC_THREADS, tid = threadIdx.x % TC_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + b * ksB + hk * ksH;
  const bf16* vb = v + b * vsB + hk * vsH;
  const bf16* dob = dO + b * dsB + h * dsH;

  int hi = (kv_len + TT - 1) / TT;
  if (causal) hi = min(hi, (min(q0 + TT, S) - 1) / TT + 1);
  const int lo = window > 0 ? max(q0 - window + 1, 0) / TT : 0;
  const int n = hi - lo;

  tc::load_tile<D, NT, DT>(sQ, q + b * qsB + h * qsH, qsS, q0, S, threadIdx.x);
  tc::load_tile<D, NT, DT>(sO, dob, dsS, q0, S, threadIdx.x);
  if (n > 0) {
    tc::load_tile<D, NT, DT>(sKV, kb, ksS, lo * TT, S, threadIdx.x);
    tc::load_tile<D, NT, DT>(sKV + TILE, vb, vsS, lo * TT, S, threadIdx.x);
  }
  tc::cp_async_commit();

  // delta = rowsum(dO * O) of the tile's rows, from global memory while the
  // tiles land: D/8 lanes a row, the block's warp w the rows RPW w ..
  // RPW w + RPW - 1
  {
    constexpr int CPR = D / 8, RPP = 32 / CPR, RPW = TT / (NT / 32);
    const int w = threadIdx.x >> 5, j = lane % CPR;
#pragma unroll
    for (int r = w * RPW + lane / CPR; r < w * RPW + RPW; r += RPP) {
      const int qp = q0 + r;
      float part = 0.f;
      if (qp < S && (DT == D || j * 8 < DT)) {
        float x[8], y[8];
        Vec16<bf16>::load(dob + (int64_t)qp * dsS + j * 8, x);
        Vec16<bf16>::load(o + b * osB + (int64_t)qp * osS + h * osH + j * 8, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(x[e], y[e], part);
      }
#pragma unroll
      for (int off = CPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (j == 0) {
        delta_s[r] = part;
        if (qp < S) delta_out[((int64_t)b * Hq + h) * S + qp] = part;
      }
    }
  }
  __syncthreads();

  // this thread's accumulator rows r0 and r0 + 8 (the same in every
  // warpgroup): lse (base 2), delta, and whether the row is a real one that
  // saw a key in the forward; its columns 8 j + c2, c2 + 1 of its warpgroup's
  const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  float lse2[2], dlt[2];
  bool row_live[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = q0 + r0 + 8 * e;
    const float l = qp < S ? lse[((int64_t)b * Hq + h) * S + qp] : NEG_INF;
    row_live[e] = l > 0.5f * NEG_INF;
    lse2[e] = row_live[e] ? l * tc::LOG2E : 0.f;
    dlt[e] = delta_s[r0 + 8 * e];
  }
  const uint32_t chunk0 = wg * (N / 64) * tc::CHUNK_BYTES;   // its columns' first chunk

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int k0 = (lo + i) * TT;
    const uint32_t sK = sKV + (i & 1) * 2 * TILE, sV = sK + TILE;
    if (i + 1 < n) {
      const uint32_t nK = sKV + ((i + 1) & 1) * 2 * TILE;
      tc::load_tile<D, NT, DT>(nK, kb, ksS, k0 + TT, S, threadIdx.x);
      tc::load_tile<D, NT, DT>(nK + TILE, vb, vsS, k0 + TT, S, threadIdx.x);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                 // this tile (and Q, dO) has landed
    tc::fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(s, tc::desc_k(sQ, ks), tc::desc_k(sK, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(dp, tc::desc_k(sO, ks), tc::desc_k(sV, ks), ks);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e, re = e >> 1;
        const int qp = q0 + r0 + 8 * re, kp = k0 + 8 * j + c2 + (e & 1);
        float p;
        p_ds(s[x], dp[x], lse2[re], dlt[re],
             row_live[re] && live_pair(qp, kp, kv_len, causal, window), scale, softcap, p,
             s[x]);
      }
    uint32_t a[4][4];
    tc::to_a(s, a);

    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::RS<N>::mma(acc, a[kk], tc::desc_mn(sK + chunk0, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    __syncthreads();                        // the stage is free for tile i + 2
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = q0 + r0 + 8 * e;
    if (qp >= S) continue;
    bf16* out = dq + (((int64_t)b * S + qp) * Hq + h) * DT + wg * N + c2;
#pragma unroll
    for (int j = 0; j < DT / WG / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          tc::pack_bf16(acc[4 * j + 2 * e] * scale, acc[4 * j + 2 * e + 1] * scale);
  }
}

#define RT_DQ_TC_PARAMS                                                                    \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,     \
      const bf16 *__restrict__ o, const bf16 *__restrict__ dO,                            \
      const float *__restrict__ lse, bf16 *__restrict__ dq, float *__restrict__ delta_out, \
      int B, int S, int Hq, int Hkv, int64_t qsB, int64_t qsS, int64_t qsH, int64_t ksB,  \
      int64_t ksS, int64_t ksH, int64_t vsB, int64_t vsS, int64_t vsH, int64_t osB,       \
      int64_t osS, int64_t osH, int64_t dsB, int64_t dsS, int64_t dsH, int kv_len,        \
      int causal, int window, float softcap, float scale
#define RT_DQ_TC_ARGS                                                                      \
  q, k, v, o, dO, lse, dq, delta_out, B, S, Hq, Hkv, qsB, qsS, qsH, ksB, ksS, ksH, vsB,  \
      vsS, vsH, osB, osS, osH, dsB, dsS, dsH, kv_len, causal, window, softcap, scale

// K4 at head dim 64, 112 and 128: one warpgroup holds all of dQ (D/2 fp32 a
// thread)
template <int D, int DT = D>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_kernel_tc(RT_DQ_TC_PARAMS) {
  dq_tc<D, DT, 1>(RT_DQ_TC_ARGS);
}

// K4 at head dim 256: two warpgroups, 128 columns of dQ each (64 fp32 a
// thread, where one warpgroup holding all 256 needs 128 beside S and dP, and
// spilled).  Both form S and dP: K5's split kernel measured that cheaper than
// forming them once and exchanging them through shared memory.  Shared
// memory is DqTc<256>: Q, dO and two stages of (K, V), 32 KB each, delta's
// 64 floats and 1 KB to align: 197,888 B, one block an SM.
template <int D>
__global__ void __launch_bounds__(2 * TC_THREADS, 1)
flash_bwd_dq_kernel_tc_split(RT_DQ_TC_PARAMS) {
  dq_tc<D, D, 2>(RT_DQ_TC_ARGS);
}
#undef RT_DQ_TC_PARAMS
#undef RT_DQ_TC_ARGS

// K5's epilogue: one warpgroup's accumulators into shared memory (thread t
// of one warpgroup holds the same elements as thread t of the other) ...
template <int N>
__device__ __forceinline__ void stash(const float (&acc)[N], float* dst, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i * TC_THREADS + t] = acc[i];
}

// ... and the other's added to them and stored: scaled, as bf16, at `out`,
// or, given a workspace slice `ws`, unscaled in fp32 there; rows r0 and r0 + 8
// (row_step further), while `rows` > 0 and > 8; the columns below DT
template <int D, int DT = D>
__device__ __forceinline__ void add_store(float (&acc)[D / 2], const float* src, int t,
                                          bf16* out, float* ws, int64_t row_step, int rows,
                                          float scale) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += src[i * TC_THREADS + t];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows <= 8 * e) continue;
#pragma unroll
    for (int j = 0; j < DT / 8; ++j) {
      const int x = 4 * j + 2 * e;
      if (ws)
        *reinterpret_cast<float2*>(ws + e * row_step + 8 * j) = make_float2(acc[x], acc[x + 1]);
      else
        *reinterpret_cast<uint32_t*>(out + e * row_step + 8 * j) =
            tc::pack_bf16(acc[x] * scale, acc[x + 1] * scale);
    }
  }
}

#define RT_DKV_TC_PARAMS                                                                  \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,    \
      const bf16 *__restrict__ dO, const float *__restrict__ lse,                        \
      const float *__restrict__ delta, bf16 *__restrict__ dk, bf16 *__restrict__ dv,     \
      float *__restrict__ ws, int G, int B, int S, int Hq, int Hkv, int64_t qsB,         \
      int64_t qsS, int64_t qsH, int64_t ksB, int64_t ksS, int64_t ksH, int64_t vsB,      \
      int64_t vsS, int64_t vsH, int64_t dsB, int64_t dsS, int64_t dsH, int kv_len,       \
      int causal, int window, float softcap, float scale
#define RT_DKV_TC_ARGS                                                                    \
  q, k, v, dO, lse, delta, dk, dv, ws, G, B, S, Hq, Hkv, qsB, qsS, qsH, ksB, ksS, ksH,   \
      vsB, vsS, vsH, dsB, dsS, dsH, kv_len, causal, window, softcap, scale

// K5 at head dim 64, 112 and 128.  Grid: one block per (key tile, KV head,
// batch, head group g of G), numbered so that the key tiles with the most
// queries come first under causal; the block walks the rep / G query heads
// of group g.  Two consumer warpgroups share the block's K and V and split
// its walk over (head, q tile) steps, even steps to the first and odd to the
// second, each with its own ring; at the end each adds the other's partial
// of one output (dk or dv) through shared memory, in a fixed order.  Without
// SPLIT, G is 1 and that sum is stored as bf16; with it (MQA with few key
// tiles: granite-20b's one KV head of 48 query heads gives 64 blocks for
// 132 SMs at 2 x 2048) in fp32 to the block's slice of the workspace [G, 2,
// B, S, Hkv, D], which dkv_sum_kernel adds in the order g = 0, 1, ...:
// deterministic, no atomics.
template <int D, int DT, bool SPLIT>
__device__ __forceinline__ void dkv_tc(RT_DKV_TC_PARAMS) {
  static_assert(!SPLIT || DT == D, "a split instance has no zero columns");
  if constexpr (!SPLIT) G = 1;
  constexpr uint32_t TILE = DkvTc<D>::TILE;
  constexpr int NACC = D / 2;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t s0 = tc::smem_addr(smem_tc);
  const uint32_t sK = (s0 + 1023u) & ~1023u, sV = sK + TILE;

  const int id = blockIdx.x, per_tile = G * Hkv * B;
  const int k0 = id / per_tile * TT;
  const int g = id % per_tile % G, hk = id % per_tile / G % Hkv, b = id % per_tile / G / Hkv;
  const int rep = Hq / Hkv, rg = rep / G;
  const int wg = threadIdx.x / TC_THREADS, tid = threadIdx.x % TC_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  // this warpgroup's ring: two stages of (Q, dO) tiles, then its lse/delta rows
  const uint32_t sQO = sK + (2 + 4 * wg) * TILE;
  const uint32_t sRows = sK + 10 * TILE + wg * 4 * TT * sizeof(float);
  const float* rows_s = reinterpret_cast<const float*>(smem_tc + (sRows - s0));

  // q tiles that can see a key of this block, for each head of the group
  const int nq = (S + TT - 1) / TT;
  const int k_last = min(k0 + TT, S) - 1;
  const int qlo = causal ? k0 / TT : 0;
  const int qhi = window > 0 ? min(nq, (k_last + window - 1) / TT + 1) : nq;
  const int nqt = max(qhi - qlo, 0);
  const int n = k0 < kv_len ? rg * nqt : 0;
  const int nw = (n - wg + 1) / 2;          // this warpgroup's steps wg, wg + 2, ..

  // step i: head g * rg + i / nqt of the group, q tile qlo + i % nqt, into
  // ring stage `st`
  auto issue = [&](int i, int st) {
    const int h = hk * rep + g * rg + i / nqt, q0 = (qlo + i % nqt) * TT;
    const uint32_t sQ = sQO + st * 2 * TILE;
    tc::load_tile<D, TC_THREADS, DT>(sQ, q + b * qsB + h * qsH, qsS, q0, S, tid);
    tc::load_tile<D, TC_THREADS, DT>(sQ + TILE, dO + b * dsB + h * dsH, dsS, q0, S, tid);
    const int r = tid & (TT - 1);
    const bool in = q0 + r < S;
    const float* src = (tid < TT ? lse : delta) + ((int64_t)b * Hq + h) * S + (in ? q0 + r : 0);
    tc::cp_async4(sRows + (st * 2 * TT + tid) * sizeof(float), src, in ? 4 : 0);
  };

  tc::load_tile<D, 2 * TC_THREADS, DT>(sK, k + b * ksB + hk * ksH, ksS, k0, S, threadIdx.x);
  tc::load_tile<D, 2 * TC_THREADS, DT>(sV, v + b * vsB + hk * vsH, vsS, k0, S, threadIdx.x);
  tc::cp_async_commit();
  if (nw > 0) issue(wg, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();                   // K and V have landed, for both warpgroups
  tc::fence_proxy_async();
  __syncthreads();

  // this thread's accumulator rows: keys k0 + r0 and k0 + r0 + 8
  const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = 0; j < nw; ++j) {
    const int st = j & 1, i = wg + 2 * j;
    if (j + 1 < nw) issue(i + 2, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                 // this step's tiles have landed
    tc::fence_proxy_async();
    tc::warpgroup_sync(1 + wg);

    const int q0 = (qlo + i % nqt) * TT;
    const uint32_t sQ = sQO + st * 2 * TILE, sO = sQ + TILE;
    const float* Ls = rows_s + st * 2 * TT;
    const float* Es = Ls + TT;

    float s[32], dp[32];                    // S^T and dP^T: keys x q rows
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(s, tc::desc_k(sK, ks), tc::desc_k(sQ, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(dp, tc::desc_k(sV, ks), tc::desc_k(sO, ks), ks);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * jj + e, col = 8 * jj + c2 + (e & 1);
        const int kp = k0 + r0 + 8 * (e >> 1), qp = q0 + col;
        const float l = Ls[col];
        const bool live = qp < S && l > 0.5f * NEG_INF &&
                          live_pair(qp, kp, kv_len, causal, window);
        p_ds(s[x], dp[x], live ? l * tc::LOG2E : 0.f, Es[col], live, scale, softcap, s[x],
             dp[x]);
      }
    uint32_t ap[4][4], ad[4][4];
    tc::to_a(s, ap);
    tc::to_a(dp, ad);

    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::RS<D>::mma(dv_acc, ap[kk], tc::desc_mn(sO, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::RS<D>::mma(dk_acc, ad[kk], tc::desc_mn(sQ, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dv_acc);
    tc::fence_regs(dk_acc);
    tc::warpgroup_sync(1 + wg);             // the stage is free for step j + 2
  }
  tc::cp_async_wait<0>();

  // the warpgroups' partials: the first keeps dk and hands over its dv, the
  // second keeps dv and hands over its dk, each through its own ring
  // (thread t of one holds the same elements as thread t of the other)
  float* mine = reinterpret_cast<float*>(smem_tc + (sQO - s0));
  const float* other = reinterpret_cast<const float*>(smem_tc + (sK + (6 - 4 * wg) * TILE - s0));
  if (wg)
    stash(dk_acc, mine, tid);
  else
    stash(dv_acc, mine, tid);
  __syncthreads();
  const int64_t row0 = (((int64_t)b * S + k0 + r0) * Hkv + hk) * DT + c2;
  const int rows = S - k0 - r0;             // rows r0 and r0 + 8 are keys if > 0, > 8
  float* w = nullptr;
  if constexpr (SPLIT) w = ws + (2 * g + wg) * ((int64_t)B * S * Hkv * DT) + row0;
  if (wg == 0)
    add_store<D, DT>(dk_acc, other, tid, dk + row0, w, (int64_t)8 * Hkv * DT, rows, scale);
  else
    add_store<D, DT>(dv_acc, other, tid, dv + row0, w, (int64_t)8 * Hkv * DT, rows, 1.f);
}

template <int D, int DT = D>
__global__ void __launch_bounds__(2 * TC_THREADS) flash_bwd_dkv_kernel_tc(RT_DKV_TC_PARAMS) {
  dkv_tc<D, DT, false>(RT_DKV_TC_ARGS);
}

// G > 1 groups of a KV head's query heads (DT = D)
template <int D>
__global__ void __launch_bounds__(2 * TC_THREADS)
flash_bwd_dkv_kernel_tc_grouped(RT_DKV_TC_PARAMS) {
  dkv_tc<D, D, true>(RT_DKV_TC_ARGS);
}
#undef RT_DKV_TC_PARAMS
#undef RT_DKV_TC_ARGS

// ---------------------------------------------------------------------------
// K5 in bf16 at head dim 256 on the tensor cores
// ---------------------------------------------------------------------------
template <int D> struct DkvSplit {
  static constexpr uint32_t TILE = TT * D * sizeof(bf16);
  // K, V, two stages of (Q, dO) shared by both warpgroups and of their
  // lse/delta rows; 1 KB to align
  static constexpr size_t bytes = 6 * TILE + 2 * 2 * TT * sizeof(float) + 1024;
};

// the query heads of a KV head that one K5 block walks: rep / G of them,
// so that a shape with few key tiles still fills the card.  Both kernels
// hold one block an SM.  At head dim 256: the smallest G at which the key
// tiles give two blocks an SM (gemma-2b's one KV head, 64 tiles: 8; gemma2-9b
// at S 8192: 1).  Below it: 1 wherever the key tiles alone give every SM a
// block (Yi-6B's training shape: 256 tiles), so those shapes run as they
// did before the split; else the smallest G at which the heaviest block,
// the first key tile's rep / G x nkt steps under causal, walks no more than
// an SM's share of all the blocks' steps, rep Hkv B nkt (nkt + 1) / 2 / sms
// (granite-20b's one KV head of 48 query heads at 2 x 2048: 4)
int dkv_split(int B, int S, int Hq, int Hkv, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nkt = (S + TT - 1) / TT, base = nkt * Hkv * B, rep = Hq / Hkv;
  if (D < 256 && base >= sms) return 1;
  for (int g = 1; g < rep; ++g) {
    const bool fills = D == 256 ? base * g >= 2 * sms
                                : (int64_t)g * Hkv * B * (nkt + 1) >= 2 * sms;
    if (rep % g == 0 && fills) return g;
  }
  return rep;
}

// K5 at head dim 256.  Grid: one block per (key tile, KV head, batch, head
// group g of G), numbered so that the key tiles with the most queries come
// first under causal; the block walks the rep / G query heads of group g
// and their q tiles inside the causal/window bounds.  Two consumer
// warpgroups split the head dim: warpgroup w keeps dK and dV of columns
// [128 w, 128 w + 128) in registers (64 + 64 fp32 a thread, where one
// warpgroup holding all 256 columns would need 256).  S^T = K Q^T and
// dP^T = V dO^T contract over the whole head dim, so both warpgroups form
// both: six 64 x 64 x 256 products a step where four are needed.  Forming
// each once (warpgroup 0 S^T, warpgroup 1 dP^T, handed over in fp32 through
// shared memory, P^T and dS^T stored back as bf16 A tiles) was measured 7%
// slower on the H100 at both gemma shapes (PERF.md): the products are not
// what bounds a step.  One two-stage cp.async ring of Q/dO tiles feeds
// both.  With G = 1 each warpgroup stores its columns of dk and dv;
// with G > 1 it stores them in fp32 to the block's slice of the workspace
// [G, 2, B, S, Hkv, D], which dkv_sum_kernel adds in the order g = 0, 1,
// ...: the GQA sum stays deterministic, with no atomics.
template <int D>
__global__ void __launch_bounds__(2 * TC_THREADS, 1)
flash_bwd_dkv_kernel_tc_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dO,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              float* __restrict__ ws, int G, int B, int S, int Hq, int Hkv,
                              int64_t qsB, int64_t qsS, int64_t qsH, int64_t ksB, int64_t ksS,
                              int64_t ksH, int64_t vsB, int64_t vsS, int64_t vsH, int64_t dsB,
                              int64_t dsS, int64_t dsH, int kv_len, int causal, int window,
                              float softcap, float scale) {
  constexpr uint32_t TILE = DkvSplit<D>::TILE;
  constexpr int HALF = D / 2;                // dk/dv columns of a warpgroup
  constexpr int NACC = HALF / 2;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t s0 = tc::smem_addr(smem_tc);
  const uint32_t sK = (s0 + 1023u) & ~1023u, sV = sK + TILE, sQO = sK + 2 * TILE;
  const uint32_t sRows = sK + 6 * TILE;
  const float* rows_s = reinterpret_cast<const float*>(smem_tc + (sRows - s0));

  const int id = blockIdx.x, per_tile = G * Hkv * B;
  const int k0 = id / per_tile * TT;
  const int g = id % per_tile % G, hk = id % per_tile / G % Hkv, b = id % per_tile / G / Hkv;
  const int rep = Hq / Hkv, rg = rep / G;
  const int wg = threadIdx.x / TC_THREADS, tid = threadIdx.x % TC_THREADS;
  const int warp = tid >> 5, lane = tid & 31;

  const int nq = (S + TT - 1) / TT;
  const int k_last = min(k0 + TT, S) - 1;
  const int qlo = causal ? k0 / TT : 0;
  const int qhi = window > 0 ? min(nq, (k_last + window - 1) / TT + 1) : nq;
  const int nqt = max(qhi - qlo, 0);
  const int n = k0 < kv_len ? rg * nqt : 0;

  // step i: head g * rg + i / nqt of the group, q tile qlo + i % nqt, into
  // ring stage `st`, by all 256 threads
  auto issue = [&](int i, int st) {
    const int h = hk * rep + g * rg + i / nqt, q0 = (qlo + i % nqt) * TT;
    const uint32_t sQ = sQO + st * 2 * TILE;
    tc::load_tile<D, 2 * TC_THREADS>(sQ, q + b * qsB + h * qsH, qsS, q0, S, threadIdx.x);
    tc::load_tile<D, 2 * TC_THREADS>(sQ + TILE, dO + b * dsB + h * dsH, dsS, q0, S,
                                     threadIdx.x);
    if (threadIdx.x < 2 * TT) {
      const int r = threadIdx.x & (TT - 1);
      const bool in = q0 + r < S;
      const float* src = (threadIdx.x < TT ? lse : delta) + ((int64_t)b * Hq + h) * S +
                         (in ? q0 + r : 0);
      tc::cp_async4(sRows + (st * 2 * TT + threadIdx.x) * sizeof(float), src, in ? 4 : 0);
    }
  };

  tc::load_tile<D, 2 * TC_THREADS>(sK, k + b * ksB + hk * ksH, ksS, k0, S, threadIdx.x);
  tc::load_tile<D, 2 * TC_THREADS>(sV, v + b * vsB + hk * vsH, vsS, k0, S, threadIdx.x);
  tc::cp_async_commit();
  if (n > 0) issue(0, 0);
  tc::cp_async_commit();

  // this thread's accumulator rows: keys k0 + r0 and k0 + r0 + 8; its
  // columns 8 j + c2, c2 + 1 of its warpgroup's half
  const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  const uint32_t half = wg * (HALF / 64) * tc::CHUNK_BYTES;   // the half's first chunk
  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    if (i + 1 < n) issue(i + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                 // this step's tiles (and K, V) have landed
    tc::fence_proxy_async();
    __syncthreads();

    const int q0 = (qlo + i % nqt) * TT;
    const uint32_t sQ = sQO + st * 2 * TILE, sO = sQ + TILE;
    const float* Ls = rows_s + st * 2 * TT;
    const float* Es = Ls + TT;
    float s[32], dp[32];                    // S^T and dP^T: keys x q rows
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(s, tc::desc_k(sK, ks), tc::desc_k(sQ, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(dp, tc::desc_k(sV, ks), tc::desc_k(sO, ks), ks);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = 8 * (x >> 2) + c2 + (x & 1);
      const int kp = k0 + r0 + 8 * ((x >> 1) & 1), qp = q0 + col;
      const bool live = qp < S && Ls[col] > 0.5f * NEG_INF &&
                        live_pair(qp, kp, kv_len, causal, window);
      p_ds(s[x], dp[x], live ? Ls[col] * tc::LOG2E : 0.f, Es[col], live, scale, softcap, s[x],
           dp[x]);
    }
    uint32_t ap[4][4], ad[4][4];
    tc::to_a(s, ap);
    tc::to_a(dp, ad);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::RS<HALF>::mma(dv_acc, ap[kk], tc::desc_mn(sO + half, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::RS<HALF>::mma(dk_acc, ad[kk], tc::desc_mn(sQ + half, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dv_acc);
    tc::fence_regs(dk_acc);
    __syncthreads();                        // the stage is free for step i + 2
  }
  tc::cp_async_wait<0>();

  // rows r0 and r0 + 8 are keys if `rows` > 0 and > 8
  const int rows = S - k0 - r0;
  const int64_t row0 = (((int64_t)b * S + k0 + r0) * Hkv + hk) * D + wg * HALF + c2;
  const int64_t row_step = (int64_t)8 * Hkv * D;
  if (G == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (rows <= 8 * e) continue;
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int x = 4 * j + 2 * e;
        *reinterpret_cast<uint32_t*>(dk + row0 + e * row_step + 8 * j) =
            tc::pack_bf16(dk_acc[x] * scale, dk_acc[x + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row0 + e * row_step + 8 * j) =
            tc::pack_bf16(dv_acc[x], dv_acc[x + 1]);
      }
    }
  } else {
    const int64_t n_out = (int64_t)B * S * Hkv * D;
    float* wk = ws + 2 * g * n_out + row0;
    float* wv = wk + n_out;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (rows <= 8 * e) continue;
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int x = 4 * j + 2 * e;
        *reinterpret_cast<float2*>(wk + e * row_step + 8 * j) =
            make_float2(dk_acc[x], dk_acc[x + 1]);
        *reinterpret_cast<float2*>(wv + e * row_step + 8 * j) =
            make_float2(dv_acc[x], dv_acc[x + 1]);
      }
    }
  }
}

// dk = scale * sum_g ws[g, 0], dv = sum_g ws[g, 1], g = 0, 1, .. in order;
// n (a multiple of 4) elements each
__global__ void dkv_sum_kernel(const float* __restrict__ ws, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int G, int64_t n, float scale) {
  for (int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (int64_t)gridDim.x * blockDim.x) {
    float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < G; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(ws + 2 * g * n + i);
      const float4 y = *reinterpret_cast<const float4*>(ws + (2 * g + 1) * n + i);
      a[0] += x.x; a[1] += x.y; a[2] += x.z; a[3] += x.w;
      c[0] += y.x; c[1] += y.y; c[2] += y.z; c[3] += y.w;
    }
    *reinterpret_cast<uint2*>(dk + i) = make_uint2(tc::pack_bf16(a[0] * scale, a[1] * scale),
                                                   tc::pack_bf16(a[2] * scale, a[3] * scale));
    *reinterpret_cast<uint2*>(dv + i) =
        make_uint2(tc::pack_bf16(c[0], c[1]), tc::pack_bf16(c[2], c[3]));
  }
}

struct Strides {
  const long long *q, *k, *v, *o, *dO;
};

template <typename T, int D, int DT = D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const void* lse, void* dq, void* delta, int B, int S, int Hq, int Hkv,
              Strides st_, int kv_len, int causal, int window, float softcap,
              cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, D, DT>;
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
      softcap, 1.f / sqrtf(static_cast<float>(DT)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int DT = D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B, int S,
               int Hq, int Hkv, Strides st_, int kv_len, int causal, int window,
               float softcap, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<T, D, DT>;
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
      softcap, 1.f / sqrtf(static_cast<float>(DT)));
  return static_cast<int>(cudaGetLastError());
}

// K4's tensor-core kernel at head dim D on WG warpgroups: at 256 two, which
// split dQ's head dim, else one
template <int D, int DT = D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* o, const void* dO,
                 const void* lse, void* dq, void* delta, int B, int S, int Hq, int Hkv,
                 Strides st_, int kv_len, int causal, int window, float softcap,
                 cudaStream_t st) {
  constexpr int WG = D == 256 ? 2 : 1;
  auto kern = [] {
    if constexpr (WG == 2)
      return flash_bwd_dq_kernel_tc_split<D>;
    else
      return flash_bwd_dq_kernel_tc<D, DT>;
  }();
  const size_t smem = DqTc<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + TT - 1) / TT * Hq * B;
  kern<<<blocks, WG * TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta), B,
      S, Hq, Hkv, st_.q[0], st_.q[1], st_.q[2], st_.k[0], st_.k[1], st_.k[2], st_.v[0],
      st_.v[1], st_.v[2], st_.o[0], st_.o[1], st_.o[2], st_.dO[0], st_.dO[1], st_.dO[2],
      kv_len, causal, window, softcap, 1.f / sqrtf(static_cast<float>(DT)));
  return static_cast<int>(cudaGetLastError());
}

// K5's tensor-core kernel at head dim D over G head groups (at 256 the
// kernel that splits the head dim between its warpgroups; below it the
// grouped instance where G > 1), then, with G > 1, the sum of the groups'
// fp32 partials in `ws`
template <int D, int DT = D>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* delta, void* dk, void* dv, void* ws, int G,
                  int B, int S, int Hq, int Hkv, Strides st_, int kv_len, int causal,
                  int window, float softcap, cudaStream_t st) {
  auto kern = [G] {
    if constexpr (D == 256)
      return flash_bwd_dkv_kernel_tc_split<D>;
    else
      return G > 1 ? flash_bwd_dkv_kernel_tc_grouped<D> : flash_bwd_dkv_kernel_tc<D, DT>;
  }();
  const size_t smem = D == 256 ? DkvSplit<D>::bytes : DkvTc<D>::bytes;
  if (G < 1 || (Hq / Hkv) % G != 0 || (G > 1 && (ws == nullptr || DT != D))) return kBadArgs;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(DT));
  const int blocks = (S + TT - 1) / TT * Hkv * B * G;
  kern<<<blocks, 2 * TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(ws), G, B, S, Hq, Hkv, st_.q[0], st_.q[1], st_.q[2], st_.k[0],
      st_.k[1], st_.k[2], st_.v[0], st_.v[1], st_.v[2], st_.dO[0], st_.dO[1], st_.dO[2], kv_len,
      causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const int64_t n = (int64_t)B * S * Hkv * DT;
  const int sum_blocks = static_cast<int>(std::min<int64_t>((n / 4 + 255) / 256, 1056));
  dkv_sum_kernel<<<sum_blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                            static_cast<bf16*>(dk), static_cast<bf16*>(dv), G,
                                            n, scale);
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
#define RT_DQ(T_, D_, DT_) \
  launch_dq<T_, D_, DT_>(q, k, v, o, dO, lse, dq, delta, B, S, Hq, Hkv, s, kv_len, causal, \
                         window, softcap, st)
#define RT_DQ_TC(D_, DT_) \
  launch_dq_tc<D_, DT_>(q, k, v, o, dO, lse, dq, delta, B, S, Hq, Hkv, s, kv_len, causal, \
                        window, softcap, st)
  if (dtype == kFloat32) {
    if (D == 64) return RT_DQ(float, 64, 64);
    if (D == 112) return RT_DQ(float, 128, 112);
    if (D == 128) return RT_DQ(float, 128, 128);
    if (D == 256) return RT_DQ(float, 256, 256);
  } else if (dtype == kBFloat16) {
    if (D == 64) return RT_DQ_TC(64, 64);
    if (D == 112) return RT_DQ_TC(128, 112);
    if (D == 128) return RT_DQ_TC(128, 128);
    if (D == 256) return RT_DQ_TC(256, 256);
  }
#undef RT_DQ
#undef RT_DQ_TC
  return kBadArgs;
}

// the K5 instances that split a KV head's query heads over blocks: bf16 at
// head dims 64, 128 and 256 (not fp32, and not 112, whose tiles are wider
// than its rows)
static bool splits(int D, int dtype) {
  return dtype == kBFloat16 && (D == 64 || D == 128 || D == 256);
}

// How many blocks share each key tile's query heads in K5 (dkv_split's G):
// 1 for an instance that does not split.  Above 1 the caller passes K5 an
// fp32 workspace of 2 G B S Hkv D elements.
extern "C" int rt_flash_attention_bwd_dkv_split(int B, int S, int Hq, int Hkv, int D,
                                                int dtype) {
  if (bad_args(B, S, Hq, Hkv, S)) return kBadArgs;
  return splits(D, dtype) ? dkv_split(B, S, Hq, Hkv, D) : 1;
}

// as above; dk and dv are dense [B, S, Hkv, D] tensors of k's dtype, and
// delta is K4's output; split is the G that rt_flash_attention_bwd_dkv_split
// chose and ws the fp32 workspace of 2 G B S Hkv D elements it asks for
// (null when G is 1).  A G that does not divide Hq / Hkv, or above 1 for an
// instance that does not split, is refused.
extern "C" int rt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dk, void* dv, void* ws, int split, int B, int S, int Hq,
    int Hkv, int D, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* do_strides, int kv_len, int causal,
    int window, float softcap, int dtype, void* stream) {
  if (bad_args(B, S, Hq, Hkv, kv_len)) return kBadArgs;
  if (split != 1 && !splits(D, dtype)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{q_strides, k_strides, v_strides, nullptr, do_strides};
#define RT_DKV(T_, D_, DT_) \
  launch_dkv<T_, D_, DT_>(q, k, v, dO, lse, delta, dk, dv, B, S, Hq, Hkv, s, kv_len, causal, \
                          window, softcap, st)
#define RT_DKV_TC(D_, DT_) \
  launch_dkv_tc<D_, DT_>(q, k, v, dO, lse, delta, dk, dv, ws, split, B, S, Hq, Hkv, s, kv_len, \
                         causal, window, softcap, st)
  if (dtype == kFloat32) {
    if (D == 64) return RT_DKV(float, 64, 64);
    if (D == 112) return RT_DKV(float, 128, 112);
    if (D == 128) return RT_DKV(float, 128, 128);
    if (D == 256) return RT_DKV(float, 256, 256);
  } else if (dtype == kBFloat16) {
    if (D == 64) return RT_DKV_TC(64, 64);
    if (D == 112) return RT_DKV_TC(128, 112);
    if (D == 128) return RT_DKV_TC(128, 128);
    if (D == 256) return RT_DKV_TC(256, 256);
  }
#undef RT_DKV
#undef RT_DKV_TC
  return kBadArgs;
}
