// Selective attention (RcLLM §III-C2b) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// `repro/kernels/selective_attention/kernel.py` (`_sel_kernel` /
// `selective_attention`, wrapper `ops.py:selective_mha`).
//
// R recomputed queries at arbitrary absolute positions attend over S
// assembled keys.  Key k is live for a query at position p iff k < S,
// p >= k, and (p - k < window or hh[k] != 0).  Serving calls it with
// window 0 and hh = key validity: causal attention over valid keys.
// Layout: q (B, R, Hq, D), k/v (B, S, Hkv, D), out (B, R, Hq, D);
// q_pos (NB, R) int32 (-1 = pad row), hh (NB, S) uint8, and the host's
// block-liveness map live (NB, nq, nk) int32 over (live_qb x live_kb)
// tiles.  Flattened head row b*Hq+h reads mask row (b*Hq+h)*NB/(B*Hq).
// GQA by index: query head h reads kv head h / (Hq / Hkv).
//
// Three routes, chosen by the wrapper (`ops.py:_route`) from dtypes and
// shapes alone:
//
// * small heads (`rt_selective_attention_small`, D <= 32, q, k and v each
//   fp32 or bf16, any G, any NB | B*Hq: the tiny card == CPU models and the
//   planted ranker's evaluation, q (3, 320, 4, 16) over k (3, 448, 2, 16)
//   fp32).  The forward of `attn_small.cuh` with this file's mask: (query,
//   head) rows of one kv group per block, a row's keys split over the 4
//   quarters of 4 warps (few rows over many keys, as here) or 1 warp, the
//   splits merged once at the end; 64-key K/V tiles through a 3-stage
//   cp.async ring sized to the padded D.  A key tile is loaded only if
//   the liveness map marks it live for some mask row and liveness row the
//   block's rows touch (an OR over them, so any tile sizes work, and a row
//   reads its own mask row: NB need not divide B*Hkv); each key is then
//   masked per row, and a pad row (q_pos = -1) takes the plain version's
//   uniform softmax over every key.  Bound on the card at the tiny call:
//   operations, 4 D flops per live (query, head, key), 0.0007 ms at the
//   67 TFLOP/s of fp32.  What holds it far above that is moving every
//   key's K and V rows from shared memory into each row's registers, and
//   latency (few rows, a serial chain of 7 tiles a block): the design
//   makes those loads broadcasts, spreads a row over 16 threads so the
//   card holds ~15 warps an SM, and skips dead tiles; the SIMT kernel it
//   replaced there sized every block for D 128, reloaded each K/V tile
//   for each of a group's heads and paid two barriers and a warp-wide max
//   and sum per row for every 32 keys.
// * tensor cores (`rt_selective_attention_tc`, the served bf16 call):
//   bf16 q and v, bf16 or fp32 k, D in {64, 128}, G = Hq / Hkv in
//   {1, 2, 4, 8}, NB dividing B*Hkv (so the G heads of a kv group share
//   one mask row).  The tile routine of `attn_tile.cuh`: one warpgroup
//   per 64 rows = 64/G queries x G heads, wgmma for Q K^T and P V, 64-key
//   K/V tiles through a 2-stage TMA + mbarrier ring, and a skip of
//   every 64-key tile whose liveness entry is 0 (the block-sparse pattern
//   that is the point of the TPU kernel; live_qb must be a multiple of
//   64/G and live_kb of 64).  fp32 keys (the served call's, from the
//   block gather's rotation) are split into bf16 hi + lo planes and take
//   two products, so the scores stay near the fp32 product the plain
//   version takes.  Bound on the card at the served call (q (5, 320, 32,
//   128) bf16, k (5, 448, 8, 128) fp32): bytes, ~40 MB over 3.35 TB/s =
//   0.012 ms; the live pairs' products, hi/lo split included, take less
//   at the bf16 tensor-core peak.
// * SIMT (`rt_selective_attention`, the CUDA-core kernel, everything else:
//   fp32 or mixed dtypes at 32 < D <= 128, such as the served call cast to
//   fp32, held to 1e-5 that one bf16 product cannot meet): 4 warps x 4
//   query rows, 32-key tiles in shared memory, CUDA-core FMAs, the same
//   liveness skip (live_qb a multiple of 16, live_kb of 32).
#include "../attn_common.cuh"
#include "../attn_small.cuh"
#include "../attn_tile.cuh"

namespace {

constexpr int kBQ = 16;
constexpr int kBK = 32;
constexpr int kWarps = 4;
constexpr int kRPW = kBQ / kWarps;
constexpr int kDMax = 128;
constexpr int kDPL = kDMax / 32;

template <typename TQ, typename TK, typename TV>
__global__ void __launch_bounds__(kWarps * 32)
selective_fwd_kernel(const TQ* __restrict__ q, const int* __restrict__ q_pos,
                     const TK* __restrict__ k, const TV* __restrict__ v,
                     const uint8_t* __restrict__ hh, const int* __restrict__ live,
                     TQ* __restrict__ o, int R, int S, int Hq, int Hkv, int D,
                     int NB, int total_rows, int window, int live_qb, int live_kb,
                     int live_nq, int live_nk, float scale) {
  __shared__ float q_s[kBQ][kDMax];
  __shared__ float k_s[kBK][kDMax + 1];
  __shared__ float v_s[kBK][kDMax];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long mrow = (long long)(b * Hq + h) * NB / total_rows;
  const int* pos_row = q_pos + mrow * R;
  const uint8_t* hh_row = hh + mrow * S;
  const int* live_row = live + (mrow * live_nq + q0 / live_qb) * live_nk;

  for (int e = tid; e < kBQ * D; e += blockDim.x) {
    const int r = e / D, d = e % D, qi = q0 + r;
    q_s[r][d] = qi < R ? rt::to_f(q[(((size_t)b * R + qi) * Hq + h) * D + d]) : 0.f;
  }
  int qp[kRPW];
  float m[kRPW], l[kRPW], acc[kRPW][kDPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int qi = q0 + warp * kRPW + r;
    qp[r] = qi < R ? pos_row[qi] : -1;
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    if (live_row[k0 / live_kb] == 0) continue;  // dead tile: contributes nothing
    __syncthreads();
    for (int e = tid; e < kBK * D; e += blockDim.x) {
      const int j = e / D, d = e % D, kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < S) {
        const size_t off = (((size_t)b * S + kj) * Hkv + hk) * D + d;
        kx = rt::to_f(k[off]);
        vx = rt::to_f(v[off]);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool in_range = kj < S;
    const bool heavy = in_range && hh_row[kj] != 0;
    float p[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) p[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) p[r] = fmaf(q_s[warp * kRPW + r][d], kd, p[r]);
    }
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const bool causal = qp[r] >= kj;
      const bool ok = in_range && causal && ((qp[r] - kj < window) || heavy);
      const float s = ok ? p[r] * scale : rt::kNegInf;
      const float m_new = fmaxf(m[r], rt::warp_max(s));
      const float pr = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rt::warp_sum(pr);
      m[r] = m_new;
      p[r] = rt::round_as<TV>(pr);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= corr;
    }
    for (int j = 0; j < kBK; ++j) {
      float vj[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? v_s[j][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float pj = __shfl_sync(rt::kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int qi = q0 + warp * kRPW + r;
    if (qi >= R) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    TQ* orow = o + (((size_t)b * R + qi) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = rt::from_f<TQ>(acc[r][i] / denom);
    }
  }
}

}  // namespace

extern "C" int rt_selective_attention(const void* q, const void* q_pos,
                                      const void* k, const void* v,
                                      const void* hh, const void* live, void* o,
                                      int B, int R, int S, int Hq, int Hkv, int D,
                                      int NB, int window, int live_qb,
                                      int live_kb, int live_nq, int live_nk,
                                      float scale, int q_dtype, int k_dtype,
                                      int v_dtype, void* stream) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv != 0 || NB < 1 || B < 1 || R < 1 ||
      live_qb % kBQ != 0 || live_kb % kBK != 0 ||
      live_nq * live_qb < R || live_nk * live_kb < S)
    return cudaErrorInvalidValue;
  const dim3 grid((R + kBQ - 1) / kBQ, Hq, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(q_dtype, [&](auto tq) {
    return rt::with_dtype(k_dtype, [&](auto tk) {
      return rt::with_dtype(v_dtype, [&](auto tv) {
        using TQ = decltype(tq);
        using TK = decltype(tk);
        using TV = decltype(tv);
        selective_fwd_kernel<TQ, TK, TV><<<grid, kWarps * 32, 0, st>>>(
            static_cast<const TQ*>(q), static_cast<const int*>(q_pos),
            static_cast<const TK*>(k), static_cast<const TV*>(v),
            static_cast<const uint8_t*>(hh), static_cast<const int*>(live),
            static_cast<TQ*>(o), R, S, Hq, Hkv, D, NB, B * Hq, window, live_qb,
            live_kb, live_nq, live_nk, scale);
        return cudaGetLastError();
      });
    });
  });
}

namespace {

// Mask of the tensor-core route: liveness skip per 64-key tile, then
// causal AND (window OR heavy hitter) per key, 64 keys at a time.
struct SelectivePolicy {
  const int* q_pos;
  const uint8_t* hh;
  const int* live;
  int R, S, NB, groups, Hkv, window, live_qb, live_kb, live_nq, live_nk;
  const int* pos_row;
  const uint8_t* hh_row;
  const int* live_row;

  __device__ void init(int b, int hk, int q0) {
    const long long mrow = (long long)(b * Hkv + hk) * NB / groups;
    pos_row = q_pos + mrow * R;
    hh_row = hh + mrow * S;
    live_row = live + (mrow * live_nq + q0 / live_qb) * live_nk;
  }
  __device__ int n_tiles(int, int) const { return (S + rt::tc::kN - 1) / rt::tc::kN; }
  __device__ bool tile_live(int kt) const { return live_row[kt * rt::tc::kN / live_kb] != 0; }
  __device__ int pos(int qi) const { return pos_row[qi]; }
  __device__ uint32_t flag(int key) const { return hh_row[key]; }
  // keys k <= p, and p - k < window or heavy
  __device__ uint64_t row_mask(int p, int k0, uint64_t heavy) const {
    return rt::tc::bits_below(p - k0 + 1) & (~rt::tc::bits_below(p - window + 1 - k0) | heavy);
  }
};

}  // namespace

// The tensor-core route: q, v bf16; k bf16 or fp32 (k_dtype).
extern "C" int rt_selective_attention_tc(const void* q, const void* q_pos, const void* k,
                                         const void* v, const void* hh, const void* live,
                                         void* o, int B, int R, int S, int Hq, int Hkv, int D,
                                         int NB, int window, int live_qb, int live_kb,
                                         int live_nq, int live_nk, float scale, int k_dtype,
                                         void* stream) {
  const int log2g = Hkv < 1 || Hq % Hkv != 0 ? -1 : rt::tc::log2_group(Hq / Hkv);
  if (log2g < 0 || (D != 64 && D != 128) || NB < 1 || B < 1 || R < 1 || S < 1 ||
      (B * Hkv) % NB != 0 || live_qb % (rt::tc::kM >> log2g) != 0 ||
      live_kb % rt::tc::kN != 0 || live_nq * live_qb < R || live_nk * live_kb < S)
    return cudaErrorInvalidValue;
  const SelectivePolicy pol{static_cast<const int*>(q_pos), static_cast<const uint8_t*>(hh),
                            static_cast<const int*>(live), R, S, NB, B * Hkv, Hkv, window,
                            live_qb, live_kb, live_nq, live_nk, nullptr, nullptr, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using rt::tc::launch_tc;
  if (k_dtype == rt::kF32)
    return D == 128 ? launch_tc<SelectivePolicy, float, 128>(q, k, v, o, B, R, S, Hq, Hkv, log2g,
                                                             scale, pol, st)
                    : launch_tc<SelectivePolicy, float, 64>(q, k, v, o, B, R, S, Hq, Hkv, log2g,
                                                            scale, pol, st);
  if (k_dtype == rt::kBF16)
    return D == 128 ? launch_tc<SelectivePolicy, __nv_bfloat16, 128>(q, k, v, o, B, R, S, Hq, Hkv,
                                                                     log2g, scale, pol, st)
                    : launch_tc<SelectivePolicy, __nv_bfloat16, 64>(q, k, v, o, B, R, S, Hq, Hkv,
                                                                    log2g, scale, pol, st);
  return cudaErrorInvalidValue;
}

namespace {

// Mask of the small-head route, per (query, head) row with its own mask row
// (b*Hq+h)*NB / (B*Hq): key k is live for the row's position p iff k < S,
// p >= k and (p - k < window or hh[k]); a pad row (p = -1) sees no key.
// A key tile may be live if any liveness entry of the mask rows of the
// block's kv group, the liveness rows of its queries and the liveness
// columns of the tile's keys is set.
struct SelectiveSmallMask {
  const int* q_pos;
  const uint8_t* hh;
  const int* live;
  int NB, window, live_qb, live_kb, live_nq, live_nk;

  struct Row {
    const uint8_t* hh;
    int p;
  };
  __device__ long long mask_row(const rt::small::Args& a, int b, int h) const {
    return (long long)(b * a.Hq + h) * NB / ((long long)a.B * a.Hq);
  }
  __device__ Row row(const rt::small::Args& a, int b, int h, int qi) const {
    const long long m = mask_row(a, b, h);
    return {hh + m * a.Skv, q_pos[m * a.Sq + qi]};
  }
  __device__ bool all_keys(const Row& r) const { return r.p < 0; }
  __device__ unsigned flag(const rt::small::Args&, const Row& r, int kj) const {
    return r.hh[kj];
  }
  __device__ bool ok(const rt::small::Args&, const Row& r, int kj, unsigned flag) const {
    return r.p >= kj && (r.p - kj < window || flag != 0);
  }
  __device__ int key_end(const rt::small::Args& a, int) const { return a.Skv; }
  __device__ bool tile_live(const rt::small::Args& a, int b, int hk, int q_first, int q_last,
                            int k0, int k1) const {
    const int G = a.Hq / a.Hkv;
    for (long long m = mask_row(a, b, hk * G); m <= mask_row(a, b, hk * G + G - 1); ++m)
      for (int lq = q_first / live_qb; lq <= q_last / live_qb; ++lq)
        for (int c = k0 / live_kb; c <= k1 / live_kb; ++c)
          if (live[(m * live_nq + lq) * live_nk + c] != 0) return true;
    return false;
  }
};

}  // namespace

// The small-head route: D <= 32, q, k and v each fp32 or bf16 (dtype codes);
// liveness tiles of any size.
extern "C" int rt_selective_attention_small(const void* q, const void* q_pos, const void* k,
                                            const void* v, const void* hh, const void* live,
                                            void* o, int B, int R, int S, int Hq, int Hkv, int D,
                                            int NB, int window, int live_qb, int live_kb,
                                            int live_nq, int live_nk, float scale, int q_dtype,
                                            int k_dtype, int v_dtype, void* stream) {
  if (D < 1 || D > 32 || Hkv < 1 || Hq % Hkv != 0 || NB < 1 || B < 1 || R < 1 || S < 1 ||
      (B * Hq) % NB != 0 || live_qb < 1 || live_kb < 1 || live_nq * live_qb < R ||
      live_nk * live_kb < S || (q_dtype != rt::kF32 && q_dtype != rt::kBF16))
    return cudaErrorInvalidValue;
  const rt::small::Args a{q, k, v, o, B, R, S, Hq, Hkv, D, q_dtype == rt::kBF16, 0,
                          scale * rt::small::kLog2e};
  const SelectiveSmallMask mask{static_cast<const int*>(q_pos), static_cast<const uint8_t*>(hh),
                                static_cast<const int*>(live), NB, window, live_qb, live_kb,
                                live_nq, live_nk};
  return rt::small::launch(a, mask, k_dtype, v_dtype, static_cast<cudaStream_t>(stream));
}
