// K7: paged-attention decode.  One query token per request against K/V
// gathered from a block pool through the request's block table, with the
// sliding window, logit softcap and an online fp32 softmax; ctx == 0 gives
// zeros (idle serving slots).
//
// Replaces: src/repro/kernels/paged_attention.py:_paged_decode_kernel (entry
// `paged_attention_decode`).
//
// Bound on the H100: bytes.  Each live key costs 2*D elements of K/V and
// 4*D*rep flops, a few flops per byte.  Design:
//   * one block per (request, KV head, group of up to 8 query heads): every
//     query head of a GQA group is served from one read of its K/V rows
//     (the TPU kernel's (request, q-head) grid would read each row rep times);
//   * the block loads its own block-table row; its 4 warps take 32-key
//     chunks of the live range [lo, ctx) in turn, a lane owning one key for
//     the scores (each K element reused for all the group's heads, q read as
//     shared-memory broadcasts) and D/32 output columns for P*V;
//   * key position kp lives at (table[kp / bs], kp % bs), so any block size
//     works; the window sets the lower bound lo = max(ctx - window, 0) and the
//     tail mask is kp <= ctx - 1;
//   * each warp keeps its own (max, sum, acc) and the four are merged once in
//     shared memory at the end.
// Known limit of this first version: only R * Hkv blocks run (32 for a batch
// of 8 on Yi-6B), too few to draw the card's full memory rate; splitting the
// key range across blocks is the next step.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HG = 8;  // query heads per block

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ tables,
                    const int* __restrict__ ctx_lens, T* __restrict__ out, int Hq,
                    int Hkv, int n_pool, int bs, int maxb, int window, float softcap,
                    float scale) {
  constexpr int V = Vec16<T>::N;
  constexpr int DPL = D / 32;
  __shared__ __align__(16) float Qs[HG][D];
  __shared__ __align__(16) float Ps[WARPS][32][HG];
  __shared__ float Ms[WARPS][HG], Ls[WARPS][HG];
  __shared__ __align__(16) float As[WARPS][HG][D];

  const int r = blockIdx.x, g = blockIdx.y;
  const int rep = Hq / Hkv;
  const int h0 = g * rep + blockIdx.z * HG;  // first query head served here
  const int nh = min(HG, rep - blockIdx.z * HG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ctx = ctx_lens[r];
  T* o = out + ((int64_t)r * Hq + h0) * D;

  if (ctx <= 0) {
    for (int i = tid; i < nh * D; i += THREADS) o[i] = from_float<T>(0.f);
    return;
  }
  const T* qr = q + ((int64_t)r * Hq + h0) * D;
  for (int i = tid; i < HG * D; i += THREADS)
    Qs[i / D][i % D] = i < nh * D ? to_float(qr[i]) * scale : 0.f;
  __syncthreads();

  const int pos = ctx - 1;
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int* trow = tables + (int64_t)r * maxb;
  const int64_t head_off = (int64_t)g * bs;  // row offset of KV head g inside a block

  float acc[HG][DPL], m[HG], l[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[h][c] = 0.f;
  }

  for (int c0 = lo + warp * 32; c0 < ctx; c0 += WARPS * 32) {
    const int kp = c0 + lane;
    const bool live = kp < ctx;  // kp >= lo keeps the window
    float s[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) s[h] = 0.f;
    if (live) {
      const int bid = min(max(trow[kp / bs], 0), n_pool - 1);
      const T* krow = kpool + ((int64_t)bid * Hkv * bs + head_off + kp % bs) * D;
#pragma unroll 2
      for (int d = 0; d < D; d += V) {
        float kv[V];
        Vec16<T>::load(krow + d, kv);
#pragma unroll
        for (int h = 0; h < HG; ++h) {
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(&Qs[h][d + j]);
            s[h] = fmaf(qv.x, kv[j], s[h]);
            s[h] = fmaf(qv.y, kv[j + 1], s[h]);
            s[h] = fmaf(qv.z, kv[j + 2], s[h]);
            s[h] = fmaf(qv.w, kv[j + 3], s[h]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float sh = s[h];
      if (softcap > 0.f) sh = softcap * tanhf(sh / softcap);
      sh = live ? sh : NEG_INF;
      const float m_new = fmaxf(m[h], warp_max(sh));
      const float alpha = expf(m[h] - m_new);
      const float p = live ? expf(sh - m_new) : 0.f;
      l[h] = l[h] * alpha + p;
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[h][c] *= alpha;
      Ps[warp][lane][h] = p;
    }
    __syncwarp();

    const int nk = min(32, ctx - c0);
    for (int j = 0; j < nk; ++j) {
      const int kpj = c0 + j;
      const int bid = min(max(trow[kpj / bs], 0), n_pool - 1);
      float vv[DPL], pj[HG];
      load_row<T, DPL>(vpool + ((int64_t)bid * Hkv * bs + head_off + kpj % bs) * D +
                           lane * DPL, vv);
      load_smem<HG>(&Ps[warp][j][0], pj);
#pragma unroll
      for (int h = 0; h < HG; ++h) {
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[h][c] = fmaf(pj[h], vv[c], acc[h][c]);
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    const float lt = warp_sum(l[h]);
    if (lane == 0) {
      Ms[warp][h] = m[h];
      Ls[warp][h] = lt;
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) As[warp][h][lane * DPL + c] = acc[h][c];
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Ms[w][h]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(Ms[w][h] - M);
      L = fmaf(f, Ls[w][h], L);
      A = fmaf(f, As[w][h][d], A);
    }
    o[i] = from_float<T>(A / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* ctx, void* out, int R, int Hq, int Hkv, int n_pool, int bs,
           int maxb, int window, float softcap, cudaStream_t st) {
  const int rep = Hq / Hkv;
  const dim3 grid(R, Hkv, (rep + HG - 1) / HG);
  paged_decode_kernel<T, D><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<T*>(out), Hq, Hkv, n_pool, bs, maxb, window, softcap,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kp, const void* vp, const void* tables,
               const void* ctx, void* out, int R, int Hq, int Hkv, int n_pool, int bs,
               int maxb, int window, float softcap, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, kp, vp, tables, ctx, out, R, Hq, Hkv, n_pool, bs, maxb, window, softcap, st);
    case 128: return launch<T, 128>(q, kp, vp, tables, ctx, out, R, Hq, Hkv, n_pool, bs, maxb, window, softcap, st);
    case 256: return launch<T, 256>(q, kp, vp, tables, ctx, out, R, Hq, Hkv, n_pool, bs, maxb, window, softcap, st);
    default: return kBadArgs;
  }
}

}  // namespace

// q: dense [R, Hq, D]; pools: dense [n_pool, Hkv, bs, D]; tables: dense int32
// [R, maxb]; ctx: int32 [R]; out: dense [R, Hq, D] of q's dtype.  Table
// entries are clamped into [0, n_pool), as the JAX gather clamps.
extern "C" int rt_paged_attention_decode(const void* q, const void* k_pool,
                                         const void* v_pool, const void* tables,
                                         const void* ctx, void* out, int R, int Hq,
                                         int Hkv, int D, int n_pool, int bs, int maxb,
                                         int window, float softcap, int dtype,
                                         void* stream) {
  if (R <= 0 || Hkv <= 0 || Hq % Hkv != 0 || n_pool <= 0 || bs <= 0 || maxb <= 0)
    return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_d<float>(D, q, k_pool, v_pool, tables, ctx, out, R, Hq, Hkv, n_pool,
                             bs, maxb, window, softcap, st);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, tables, ctx, out, R, Hq, Hkv,
                                     n_pool, bs, maxb, window, softcap, st);
  return kBadArgs;
}
