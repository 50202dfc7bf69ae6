// K3: flash-attention forward.  Causal/windowed GQA attention with logit
// softcap and kv_len masking, online fp32 softmax, emitting out (in q's
// dtype) and the per-row log-sum-exp (fp32, natural log) that K4 and K5
// read.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_fwd_kernel (entry
// `flash_attention_fwd`).
//
// Bound on the H100: operations once S passes about 600 (causal: ~2*S^2*D
// flops per head against ~4*S*D bytes of q and out, and the card needs ~295
// flops per byte); below that, as at the serving path's S <= 512, the bytes
// of q and out.  Two instances, chosen by dtype and head dim in the C entry:
//
// bf16 at head dim 64, 112, 128 and 256 (the training path and serving
// prefill: Yi-6B, hd 128; Zamba2-7B's shared attention, hd 112, in D = 128
// tiles with zero columns past 112: the instance flash_fwd_kernel_tc<128,
// 112>; both gemma configs, hd 256), flash_fwd_kernel_tc, runs both products
// on the tensor cores
// (wgmma, bf16 operands, fp32 accumulators) over tiles of 64 rows kept bf16
// in shared memory in wgmma's 128-byte-swizzled layout (wgmma.cuh):
//   * a block owns the same 64 query rows of two q heads of one GQA group,
//     one consumer warpgroup (128 threads) each; each Q tile is loaded
//     once.  K/V tiles of 64 keys stream through a two-stage ring shared by
//     both warpgroups, so one copy of K/V feeds twice the products, and the
//     two heads have the same loop bounds.  One thread asks the tensor
//     memory accelerator (TMA) for the next tile while the current one is
//     multiplied; the boxes land already swizzled (and zero past S), and a
//     stage's mbarrier counts their bytes: four copy instructions a tile
//     from one thread, where cp.async had every thread compute addresses;
//   * S = Q K^T is wgmma m64n64k16 with both operands K-major from shared
//     memory; the online softmax runs in the accumulator registers (a
//     thread holds two rows, each reduced over its quad of 4 lanes), in
//     base 2 (logits times scale * log2(e), exp2 on the special-function
//     unit), row max and sum in fp32, p zeroed explicitly on dead pairs so
//     the finite NEG_INF never reaches the sum.  Softcap and the mask are
//     uniform branches around their own loops: the common tile (no softcap,
//     off the diagonal) runs neither tanh nor the mask test;
//   * p is rounded to bf16 in pairs straight into the register A operand of
//     O += P V, wgmma m64n{D}k16 with the V tile read MN-major (the
//     transpose bit), so nothing is transposed in memory.  The row sum l
//     keeps the unrounded fp32 p (as SDPA does);
//   * at head dim 256, O is 128 fp32 registers a thread beside S's 32 and
//     P's 16: a block of two warpgroups (256 threads) may give each thread
//     255 registers, so each warpgroup still owns one head and its whole
//     64 x 256 O, with no producer warp and no setmaxnreg.  Two Q tiles and
//     the two-stage K/V ring take 192 KB of the 227 KB of shared memory, so
//     one block runs on an SM and the ring's prefetch is what hides the
//     copies;
//   * the TPU kernel's causal/window loop bounds on 64-key tiles, the mask
//     evaluated only on tiles that cross the diagonal, the window edge or
//     kv_len; blocks are numbered heaviest first under causal (the last q
//     tiles see the most keys).
//
// fp32 (TF32 would break the fp32 card-vs-CPU parity) runs flash_fwd_kernel
// on the fp32 CUDA cores:
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
#include <cudaTypedefs.h>

#include "common.cuh"
#include "wgmma.cuh"

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

template <typename T, int D, int DT = D>
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
    if (q0 + r < S && (DT == D || c < DT)) {
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
      if (k0 + r < S && (DT == D || c < DT)) {
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
    T* o = out + (((int64_t)b * S + qp) * Hq + h) * DT + lane * DPL;
    if (DT == D || lane * DPL < DT) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[c] = from_float<T>(acc[r][c] / lt);
    }
    if (lane == 0) lse[((int64_t)b * Hq + h) * S + qp] = m[r] + logf(lt);
  }
}

template <typename T, int D, int DT = D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
           int S, int Hq, int Hkv, const long long* qs, const long long* ks,
           const long long* vs, int kv_len, int causal, int window, float softcap,
           cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D, DT>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), S, Hq, Hkv, qs[0], qs[1], qs[2],
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], kv_len, causal, window, softcap,
      1.f / sqrtf(static_cast<float>(DT)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (head dim 64, 112, 128 and 256)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;        // one warpgroup
constexpr int TT = tc::TILE_ROWS;      // query rows and keys of a tile
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int WGS = 2;                 // consumer warpgroups (q heads) a block

template <int D> struct FwdTc {
  static constexpr uint32_t TILE = TT * D * sizeof(bf16);
  // one Q tile per warpgroup, two stages of (K, V) and their two mbarriers;
  // 1 KB to align the tiles for the swizzle
  static constexpr size_t bytes = (WGS + 4) * TILE + 2 * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory at `dst`, counted on the mbarrier `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
        "r"(bar)
      : "memory");
}

// Grid: one block per (q tile, pair of q heads of one KV head, batch),
// numbered so that the q tiles with the most keys come first under causal.
// Warpgroup w serves q head 2 * pair + w of its GQA group; when the group
// has an odd number of heads the second warpgroup of the last pair repeats
// the group's last head and stores nothing.
template <int D, int DT = D>
__global__ void __launch_bounds__(WGS * TC_THREADS)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV, bf16* __restrict__ out,
                    float* __restrict__ lse, int B, int S, int Hq, int Hkv, int64_t qsB,
                    int64_t qsS, int64_t qsH, int kv_len, int causal, int window,
                    float softcap, float scale) {
  constexpr uint32_t TILE = FwdTc<D>::TILE;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t s0 = tc::smem_addr(smem_tc);
  const uint32_t base = (s0 + 1023u) & ~1023u, sKV = base + WGS * TILE;
  const uint32_t sBar = sKV + 4 * TILE;     // the stages' "tile landed" mbarriers

  const int rep = Hq / Hkv, pairs = (rep + WGS - 1) / WGS;
  const int nq = (S + TT - 1) / TT;
  const int id = blockIdx.x, per_tile = Hkv * pairs * B;
  const int q0 = (nq - 1 - id / per_tile) * TT;
  const int pr = id % per_tile % (Hkv * pairs), b = id % per_tile / (Hkv * pairs);
  const int hk = pr / pairs;
  const int wg = threadIdx.x / TC_THREADS, tid = threadIdx.x % TC_THREADS;
  const int hr = WGS * (pr % pairs) + wg;     // this warpgroup's head in the group
  const bool stores = hr < rep;
  const int h = hk * rep + (stores ? hr : rep - 1);
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t sQ = base + wg * TILE;

  // k-tile range: the TPU kernel's pruning, on 64-key tiles
  int hi = (kv_len + TT - 1) / TT;
  if (causal) hi = min(hi, (min(q0 + TT, S) - 1) / TT + 1);
  const int lo = window > 0 ? max(q0 - window + 1, 0) / TT : 0;
  const int n = max(hi - lo, 0);

  // tile t of the walk (keys (lo + t) * 64 ..) into stage t % 2: one thread
  // asks the tensor memory accelerator for its K and V boxes (64 rows x 64
  // columns each, 128-byte swizzled: the layout wgmma reads; rows past S
  // arrive as zeros) and the stage's mbarrier counts their bytes
  auto load_kv = [&](int t) {
    if (threadIdx.x != 0) return;
    const uint32_t bar = sBar + (t & 1) * sizeof(uint64_t);
    const uint32_t dK = sKV + (t & 1) * 2 * TILE, dV = dK + TILE;
    mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(dK + c * tc::CHUNK_BYTES, &tmK, 64 * c, hk, (lo + t) * TT, b, bar);
      tma_load_4d(dV + c * tc::CHUNK_BYTES, &tmV, 64 * c, hk, (lo + t) * TT, b, bar);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(sBar, 1);
    mbar_init(sBar + sizeof(uint64_t), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n > 0) load_kv(0);
  tc::load_tile<D, TC_THREADS, DT>(sQ, q + b * qsB + h * qsH, qsS, q0, S, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();                          // Q has landed for every thread

  // this thread's accumulator rows r0 and r0 + 8, and its columns c2, c2 + 1
  // of every 8-column block; m in base 2 (of scale * log2e * s), l its own
  // columns' share of the row sum until the end
  const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  const float scale2 = scale * tc::LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int k0 = (lo + i) * TT;
    const uint32_t sK = sKV + (i & 1) * 2 * TILE, sV = sK + TILE;
    if (i + 1 < n) load_kv(i + 1);          // into the stage tile i - 1 left
    mbar_wait(sBar + (i & 1) * sizeof(uint64_t), (i >> 1) & 1);   // tile i has landed

    float s[32];
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::wgmma_ss_n64(s, tc::desc_k(sQ, ks), tc::desc_k(sK, ks), ks);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);

    // logits in base 2, the mask on tiles that need it, the row max
    const bool full = k0 + TT <= kv_len && (!causal || k0 + TT - 1 <= q0) &&
                      (window <= 0 || q0 + TT - 1 - k0 < window);
    // (two uniform branches, so the common tile runs neither tanh nor the mask)
    if (softcap > 0.f) {
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = softcap * tc::LOG2E * tanhf(s[x] * scale / softcap);
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] *= scale2;
    }
    uint32_t live = 0xffffffffu;            // bit x: element x is a live pair
    if (!full) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int j = x >> 2, e = x & 3;
        if (!live_pair(q0 + r0 + 8 * (e >> 1), k0 + 8 * j + c2 + (e & 1), kv_len, causal,
                       window)) {
          live &= ~(1u << x);
          s[x] = NEG_INF;
        }
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e]);
      alpha[e] = fast_exp2(m[e] - m_new);
      m[e] = m_new;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int re = (x >> 1) & 1;
      const float p = (live >> x) & 1u ? fast_exp2(s[x] - m[re]) : 0.f;
      l[re] += p;
      s[x] = p;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    uint32_t a[4][4];
    tc::to_a(s, a);

    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::RS<D>::mma(acc, a[kk], tc::desc_mn(sV, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    __syncthreads();                        // the stage is free for tile i + 2
  }
  if (!stores) return;

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const int qp = q0 + r0 + 8 * e;
    if (qp >= S) continue;
    const float inv = l[e] > 0.f ? 1.f / l[e] : 0.f;   // no live key: out 0
    bf16* o = out + (((int64_t)b * S + qp) * Hq + h) * DT + c2;
#pragma unroll
    for (int j = 0; j < DT / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          tc::pack_bf16(acc[4 * j + 2 * e] * inv, acc[4 * j + 2 * e + 1] * inv);
    if (c2 == 0)
      lse[((int64_t)b * Hq + h) * S + qp] = l[e] > 0.f ? m[e] * LN2 + logf(l[e]) : NEG_INF;
  }
}

// A 4-d tensor map over K or V [B, S, Hkv, D] (strides in elements, the head
// dim dense) whose box is one 64-row by 64-column chunk of a tile, 128-byte
// swizzled.  At D = 112 the second chunk's columns 112-127 lie outside the
// tensor and the copy fills them with zeros (load_tile zeroes the Q tile's),
// so a D = 128 tile serves with no padded copy in memory.
// cuTensorMapEncodeTiled is looked up through the runtime
// (CUDA 12.5 or later), so the library links against nothing more.
int encode_kv_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                  const long long* strides) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000, cudaEnableDefault,
        nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (encode == nullptr) return kBadArgs;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * sizeof(bf16),
                               (cuuint64_t)strides[1] * sizeof(bf16),
                               (cuuint64_t)strides[0] * sizeof(bf16)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)TT, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, bytes, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kBadArgs;
}

template <int D, int DT = D>
int launch_tc(const void* q, const void* k, const void* v, void* out, void* lse, int B,
              int S, int Hq, int Hkv, const long long* qs, const long long* ks,
              const long long* vs, int kv_len, int causal, int window, float softcap,
              cudaStream_t st) {
  CUtensorMap tmK, tmV;
  int status = encode_kv_map(&tmK, k, B, S, Hkv, DT, ks);
  if (status == 0) status = encode_kv_map(&tmV, v, B, S, Hkv, DT, vs);
  if (status != 0) return status;
  auto kern = flash_fwd_kernel_tc<D, DT>;
  const size_t smem = FwdTc<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = (Hq / Hkv + WGS - 1) / WGS;
  const int blocks = (S + TT - 1) / TT * Hkv * pairs * B;
  kern<<<blocks, WGS * TC_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), tmK, tmV, static_cast<bf16*>(out),
      static_cast<float*>(lse), B, S, Hq, Hkv, qs[0], qs[1], qs[2], kv_len, causal, window,
      softcap, 1.f / sqrtf(static_cast<float>(DT)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v strides are (batch, seq, head) in elements; the last dim is dense.
// out is a dense [B, S, Hq, D] tensor of q's dtype, lse a dense fp32 [B, Hq, S].
// bf16 runs on the tensor cores, fp32 on the CUDA cores.  Head dim 112
// (Zamba2-7B's shared attention) runs D = 128 instances compiled with the
// true head dim DT = 112: the tiles' columns 112-127 are zeros, stores skip
// them, and the scale is 112^-0.5; at DT = D every such test folds away at
// compile time, so the other head dims run exactly the code they ran before.
// Any other dtype or head dim is refused.
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
#define RT_FWD(T_, D_, DT_) \
  launch<T_, D_, DT_>(q, k, v, out, lse, B, S, Hq, Hkv, q_strides, k_strides, v_strides, \
                      kv_len, causal, window, softcap, st)
#define RT_FWD_TC(D_, DT_) \
  launch_tc<D_, DT_>(q, k, v, out, lse, B, S, Hq, Hkv, q_strides, k_strides, v_strides, \
                     kv_len, causal, window, softcap, st)
  if (dtype == kFloat32) {
    if (D == 64) return RT_FWD(float, 64, 64);
    if (D == 112) return RT_FWD(float, 128, 112);
    if (D == 128) return RT_FWD(float, 128, 128);
    if (D == 256) return RT_FWD(float, 256, 256);
  } else if (dtype == kBFloat16) {
    if (D == 64) return RT_FWD_TC(64, 64);
    if (D == 112) return RT_FWD_TC(128, 112);
    if (D == 128) return RT_FWD_TC(128, 128);
    if (D == 256) return RT_FWD_TC(256, 256);
  }
#undef RT_FWD
#undef RT_FWD_TC
  return kBadArgs;
}
