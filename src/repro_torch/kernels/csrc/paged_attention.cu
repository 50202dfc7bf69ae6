// K7: paged-attention decode.  One query token per request against K/V
// gathered from a block pool through the request's block table, with the
// sliding window, logit softcap and an online fp32 softmax; ctx == 0 gives
// zeros (idle serving slots).
//
// Replaces: src/repro/kernels/paged_attention.py:_paged_decode_kernel (entry
// `paged_attention_decode`).
//
// Bound on the H100: bytes.  Each live key costs 2*D elements of K/V and
// 4*D*rep flops, a few flops per byte.  At decode batch sizes the whole
// call moves a few MB, so what sets its time is how many blocks draw on the
// memory at once and how many dependent memory round trips each makes.
// Design (split-K, "flash-decoding"):
//   * grid (key split, KV head x group of up to 8 query heads, request):
//     every query head of a GQA group is served from one read of its K/V
//     rows, and the key range is cut into splits of KPS = 64 keys, so a
//     batch of 8 on Yi-6B runs ~170 live blocks instead of 32.  A split
//     past the request's live range [lo, ctx) exits at once;
//   * a block makes two dependent round trips: it reads its 64 table
//     entries (kp lives at (table[kp / bs], kp % bs), so any block size
//     works), then copies its K and V rows into shared memory with cp.async
//     (rows outside the live range are zero-filled); then the scores (a lane
//     owns a key, K rows padded by 16 bytes so the lanes' reads do not
//     conflict), the split's softmax (a warp owns two heads) and P*V (a
//     thread owns output columns of its heads) run from shared memory;
//   * a request whose live range fits one split writes its output at once.
//     Otherwise each split writes its (max, sum, unnormalised output)
//     partial in fp32 to scratch the wrapper allocates, and the last split
//     block of the (request, head group) to finish, found by a per-group
//     counter, merges all the partials in split order (so the result does
//     not depend on which block finishes last) and resets the counter to 0
//     for the next launch.  One launch, no host work;
//   * the window sets the lower bound lo = max(ctx - window, 0); keys past
//     the table's reach (max_blocks * bs) do not exist, as in the gather of
//     the plain version; table entries are clamped into the pool.
#include "common.cuh"
#include "wgmma.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HG = 8;     // query heads per block, one warp each in the softmax
constexpr int KPS = 64;   // keys per split (paged_attention.py's KEYS_PER_SPLIT); also
                          // the merge's chunk of splits

template <typename T, int D> struct Paged {
  static constexpr int V = Vec16<T>::N;
  static constexpr int ROW = D * sizeof(T) + 16;          // padded K/V row, bytes
  static constexpr int CPR = D * sizeof(T) / 16;          // 16-byte copies per row
  static constexpr int CPT = D >= 128 ? D / 128 : 1;      // P*V columns per thread
  static constexpr int TPC = D / CPT;                     // threads over the columns
  static constexpr int HPT = HG * TPC / THREADS;          // P*V heads per thread
  static constexpr int QV = HG * D / V;                   // 16-byte pieces of q
  static constexpr int QPT = (QV + THREADS - 1) / THREADS;  // pieces per thread
  static_assert(QV % THREADS == 0 || QV < THREADS, "whole pieces");
  static_assert(KPS <= THREADS && HG == WARPS, "a table entry a thread, a warp a head");
  // K and V rows, q (scaled, fp32), scores/probabilities [key][head], the
  // split's max and sum per head, table entries, the merge ticket; the
  // merge reuses the K rows for its weights [head][split]
  static constexpr size_t bytes = 2 * KPS * ROW +
      sizeof(float) * (HG * D + KPS * HG + 2 * HG) + sizeof(int) * (KPS + 1);
  static_assert(KPS * ROW >= sizeof(float) * HG * KPS, "merge weights fit the K rows");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ tables,
                    const int* __restrict__ ctx_lens, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters, int Hq,
                    int Hkv, int n_pool, int bs, int maxb, int window, float softcap,
                    float scale) {
  using P = Paged<T, D>;
  constexpr int V = P::V, HPT = P::HPT, CPT = P::CPT;
  extern __shared__ __align__(16) uint8_t smem_pa[];
  uint8_t* Ks = smem_pa;
  uint8_t* Vs = Ks + KPS * P::ROW;
  float* Qs = reinterpret_cast<float*>(Vs + KPS * P::ROW);   // [HG][D]
  float* Ss = Qs + HG * D;                                   // [KPS][HG]
  float* Ms = Ss + KPS * HG;
  float* Ls = Ms + HG;
  int* bids = reinterpret_cast<int*>(Ls + HG);
  int* ticket = bids + KPS;
  float* W = reinterpret_cast<float*>(Ks);                   // merge: [HG][KPS]

  const int s = blockIdx.x, n_splits = gridDim.x, r = blockIdx.z;
  const int groups = gridDim.y / Hkv;                  // head groups per KV head
  const int g = blockIdx.y / groups, hg = blockIdx.y % groups;
  const int rep = Hq / Hkv;
  const int h0 = g * rep + hg * HG;                    // first query head served here
  const int nh = min(HG, rep - hg * HG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kbeg = s * KPS;

  // one round trip: the context length, this split's table entries and q,
  // all in flight together
  const int ctx = ctx_lens[r];
  const int* trow = tables + (int64_t)r * maxb;
  int bid = 0;
  if (tid < KPS && kbeg + tid < maxb * bs) bid = trow[(kbeg + tid) / bs];
  float qv[P::QPT][V];
#pragma unroll
  for (int i = 0; i < P::QPT; ++i) {
    const int piece = tid + i * THREADS;
    if (piece < P::QV && piece * V < nh * D)
      Vec16<T>::load(q + ((int64_t)r * Hq + h0) * D + piece * V, qv[i]);
  }

  // the live key range [lo, hi) and the splits it covers
  const int hi = min(ctx, maxb * bs);
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  if (hi <= lo) {                                      // no live key: zeros
    if (s == 0)
      for (int i = tid; i < nh * D; i += THREADS)
        out[((int64_t)r * Hq + h0) * D + i] = from_float<T>(0.f);
    return;
  }
  const int s_lo = lo / KPS, s_hi = (hi - 1) / KPS;
  if (s < s_lo || s > s_hi) return;
  const int jlo = max(lo - kbeg, 0), jhi = min(hi - kbeg, KPS);   // live rows
  if (tid < KPS) bids[tid] = tid >= jlo && tid < jhi ? min(max(bid, 0), n_pool - 1) : -1;
#pragma unroll
  for (int i = 0; i < P::QPT; ++i) {
    const int piece = tid + i * THREADS;
    if (piece >= P::QV) break;
#pragma unroll
    for (int e = 0; e < V; ++e) Qs[piece * V + e] = piece * V < nh * D ? qv[i][e] * scale : 0.f;
  }
  __syncthreads();

  // the second round trip: the live K and V rows into shared memory
  // (others zero-filled)
#pragma unroll
  for (int i = tid; i < 2 * KPS * P::CPR; i += THREADS) {
    const int which = i / (KPS * P::CPR), j = i / P::CPR % KPS, c = i % P::CPR;
    const int b_ = bids[j];
    const T* pool = which ? vpool : kpool;
    const T* src = b_ >= 0
        ? pool + (((int64_t)b_ * Hkv + g) * bs + (kbeg + j) % bs) * D + c * V
        : pool;
    tc::cp_async16(tc::smem_addr((which ? Vs : Ks) + j * P::ROW + c * 16), src,
                   b_ >= 0 ? 16 : 0);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // scores: warp w, lane l -> key 32 (w & 1) + l against heads 2 (w >> 1), +1
  {
    const int j = 32 * (warp & 1) + lane, hw = 2 * (warp >> 1);
    if (hw < nh) {
      float a[2][4] = {};                  // two heads, four partial sums each
      const T* krow = reinterpret_cast<const T*>(Ks + j * P::ROW);
#pragma unroll
      for (int d = 0; d < D; d += V) {
        float kv[V];
        Vec16<T>::load(krow + d, kv);
#pragma unroll
        for (int e = 0; e < V; e += 4)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 x = *reinterpret_cast<const float4*>(Qs + (hw + h) * D + d + e);
            a[h][0] = fmaf(x.x, kv[e], a[h][0]);
            a[h][1] = fmaf(x.y, kv[e + 1], a[h][1]);
            a[h][2] = fmaf(x.z, kv[e + 2], a[h][2]);
            a[h][3] = fmaf(x.w, kv[e + 3], a[h][3]);
          }
      }
      float a0 = (a[0][0] + a[0][1]) + (a[0][2] + a[0][3]);
      float a1 = (a[1][0] + a[1][1]) + (a[1][2] + a[1][3]);
      if (softcap > 0.f) {
        a0 = softcap * tanhf(a0 / softcap);
        a1 = softcap * tanhf(a1 / softcap);
      }
      const bool live = j >= jlo && j < jhi;
      Ss[j * HG + hw] = live ? a0 : NEG_INF;
      Ss[j * HG + hw + 1] = live ? a1 : NEG_INF;
    }
  }
  __syncthreads();

  // the split's softmax: warp w owns head w
  if (warp < nh) {
    const int h = warp;
    const float a = Ss[lane * HG + h], b = Ss[(lane + 32) * HG + h];
    const float m = warp_max(fmaxf(a, b));
    const float pa = lane >= jlo && lane < jhi ? expf(a - m) : 0.f;
    const float pb = lane + 32 >= jlo && lane + 32 < jhi ? expf(b - m) : 0.f;
    Ss[lane * HG + h] = pa;
    Ss[(lane + 32) * HG + h] = pb;
    const float l = warp_sum(pa + pb);
    if (lane == 0) {
      Ms[h] = m;
      Ls[h] = l;
    }
  }
  __syncthreads();

  // P * V over the live rows: columns c0 .. c0 + CPT of heads hp .. hp + HPT
  const int c0 = (tid % P::TPC) * CPT, hp = (tid / P::TPC) * HPT;
  // (rows outside [jlo, jhi) are zero in V and in p, so the walk takes
  // whole pairs of rows; two partial sums)
  float acc[HPT][CPT], acc2[HPT][CPT];
#pragma unroll
  for (int h = 0; h < HPT; ++h)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[h][c] = acc2[h][c] = 0.f;
  if (hp < nh) {
#pragma unroll 4
    for (int j = jlo & ~1; j < jhi; j += 2) {
      float v0[CPT], v1[CPT], p0[HPT], p1[HPT];
      load_row<T, CPT>(reinterpret_cast<const T*>(Vs + j * P::ROW) + c0, v0);
      load_row<T, CPT>(reinterpret_cast<const T*>(Vs + (j + 1) * P::ROW) + c0, v1);
      load_smem<HPT>(Ss + j * HG + hp, p0);
      load_smem<HPT>(Ss + (j + 1) * HG + hp, p1);
#pragma unroll
      for (int h = 0; h < HPT; ++h)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[h][c] = fmaf(p0[h], v0[c], acc[h][c]);
          acc2[h][c] = fmaf(p1[h], v1[c], acc2[h][c]);
        }
    }
#pragma unroll
    for (int h = 0; h < HPT; ++h)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[h][c] += acc2[h][c];
  }

  T* o = out + ((int64_t)r * Hq + h0) * D + c0;
  if (s_lo == s_hi) {                                  // one split: the output
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      if (hp + h >= nh) break;
      const float inv = 1.f / Ls[hp + h];
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[(hp + h) * D + c] = from_float<T>(acc[h][c] * inv);
    }
    return;
  }

  // this split's partial: part_acc [R, Hq, n_splits, D], then part_ml
  // [R, Hq, n_splits] of (max, sum)
  const int64_t head0 = (int64_t)r * Hq + h0;
  float* part_acc = part;
  float2* part_ml = reinterpret_cast<float2*>(part + (int64_t)gridDim.z * Hq * n_splits * D);
#pragma unroll
  for (int h = 0; h < HPT; ++h) {
    if (hp + h >= nh) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      part_acc[((head0 + hp + h) * n_splits + s) * D + c0 + c] = acc[h][c];
  }
  if (tid < nh) part_ml[(head0 + tid) * n_splits + s] = make_float2(Ms[tid], Ls[tid]);
  __threadfence();                                     // the partial is visible ...
  __syncthreads();
  int* counter = counters + (int64_t)r * gridDim.y + blockIdx.y;
  if (tid == 0) *ticket = atomicAdd(counter, 1);       // ... before it is counted
  __syncthreads();
  if (*ticket != s_hi - s_lo) return;                  // not the last split to finish
  __threadfence();

  // the merge, by the last split block to finish, in split order.  Warp h
  // reads head h's (max, sum) of every split (a lane per split), reduces
  // them to the head's M and L in a fixed butterfly, and turns each split's
  // max into its weight exp(m_s - M) / L; then every thread adds its
  // columns' partials, weighted, with the loads of many splits in flight.
  // Chunks of KPS splits (contexts past KPS * KPS keys take several).
  const int n_live = s_hi - s_lo + 1;
  float M = NEG_INF, L = 0.f;
  if (warp < nh) {
    const float2* ml = part_ml + (head0 + warp) * n_splits + s_lo;
    for (int t = lane; t < n_live; t += 32) {
      const float2 x = __ldcg(ml + t);
      const float m_new = fmaxf(M, x.x);
      L = L * expf(M - m_new) + x.y * expf(x.x - m_new);
      M = m_new;
      if (t < KPS) W[warp * KPS + t] = x.x;
    }
#pragma unroll
    for (int o_ = 16; o_ > 0; o_ >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, M, o_);
      const float l2 = __shfl_xor_sync(0xffffffffu, L, o_);
      const float m_new = fmaxf(M, m2);
      L = L * expf(M - m_new) + l2 * expf(m2 - m_new);
      M = m_new;
    }
  }
  float A[HPT][CPT];
#pragma unroll
  for (int h = 0; h < HPT; ++h)
#pragma unroll
    for (int c = 0; c < CPT; ++c) A[h][c] = 0.f;
  const float* pa = part_acc + (head0 + hp) * n_splits * D + c0;
  for (int t0 = 0; t0 < n_live; t0 += KPS) {
    const int nt = min(KPS, n_live - t0);
    if (warp < nh) {
      const float2* ml = part_ml + (head0 + warp) * n_splits + s_lo + t0;
      for (int t = lane; t < nt; t += 32) {
        const float m_t = t0 == 0 ? W[warp * KPS + t] : __ldcg(ml + t).x;
        W[warp * KPS + t] = expf(m_t - M) / L;
      }
    }
    __syncthreads();
    if (hp < nh) {
#pragma unroll 16
      for (int u = 0; u < nt; ++u) {
#pragma unroll
        for (int h = 0; h < HPT; ++h) {
          const bool ok = hp + h < nh;
          const float w = ok ? W[(hp + h) * KPS + u] : 0.f;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float x =
                ok ? __ldcg(pa + ((int64_t)h * n_splits + s_lo + t0 + u) * D + c) : 0.f;
            A[h][c] = fmaf(w, x, A[h][c]);
          }
        }
      }
    }
    __syncthreads();                                   // W is rewritten next chunk
  }
#pragma unroll
  for (int h = 0; h < HPT; ++h) {
    if (hp + h >= nh) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[(hp + h) * D + c] = from_float<T>(A[h][c]);
  }
  if (tid == 0) *counter = 0;                          // ready for the next launch
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* ctx, void* out, void* part, void* counters, int R, int Hq,
           int Hkv, int n_pool, int bs, int maxb, int window, float softcap,
           cudaStream_t st) {
  auto kern = paged_decode_kernel<T, D>;
  const size_t smem = Paged<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (Hq / Hkv + HG - 1) / HG;
  const dim3 grid((maxb * bs + KPS - 1) / KPS, Hkv * groups, R);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<T*>(out), static_cast<float*>(part), static_cast<int*>(counters), Hq,
      Hkv, n_pool, bs, maxb, window, softcap, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: dense [R, Hq, D]; pools: dense [n_pool, Hkv, bs, D]; tables: dense int32
// [R, maxb]; ctx: int32 [R]; out: dense [R, Hq, D] of q's dtype.  Table
// entries are clamped into [0, n_pool), as the JAX gather clamps.
// With n_splits = ceil(maxb * bs / KPS), `part` is fp32 scratch of R * Hq *
// n_splits * (D + 2) floats and `counters` at least R * Hq int32, zero
// before the first launch (each launch leaves them zero).  Calls that share
// `part` or `counters` must run one after another, on one stream.
extern "C" int rt_paged_attention_decode(const void* q, const void* k_pool,
                                         const void* v_pool, const void* tables,
                                         const void* ctx, void* out, void* part,
                                         void* counters, int R, int Hq, int Hkv, int D,
                                         int n_pool, int bs, int maxb, int window,
                                         float softcap, int dtype, void* stream) {
  if (R <= 0 || Hkv <= 0 || Hq % Hkv != 0 || n_pool <= 0 || bs <= 0 || maxb <= 0)
    return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_PAGED(T_, D_) \
  launch<T_, D_>(q, k_pool, v_pool, tables, ctx, out, part, counters, R, Hq, Hkv, n_pool, \
                 bs, maxb, window, softcap, st)
  if (dtype == kFloat32) {
    if (D == 64) return RT_PAGED(float, 64);
    if (D == 128) return RT_PAGED(float, 128);
    if (D == 256) return RT_PAGED(float, 256);
  } else if (dtype == kBFloat16) {
    if (D == 64) return RT_PAGED(__nv_bfloat16, 64);
    if (D == 128) return RT_PAGED(__nv_bfloat16, 128);
    if (D == 256) return RT_PAGED(__nv_bfloat16, 256);
  }
#undef RT_PAGED
  return kBadArgs;
}
