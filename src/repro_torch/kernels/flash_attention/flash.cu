// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention/kernel.py`
// (`_flash_kernel` / `flash_attention`, wrapper `ops.py:mha_flash`).
//
// Computes, per query row, softmax(q.k / sqrt(D)) v over the keys that are
// live: key index < Skv, the row's `kv_valid` entry set (when given), and
// key index <= query index when causal.  Layout is the wrapper's own:
// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), out (B, Sq, Hq, D).  GQA by
// index: query head h reads kv head h / (Hq / Hkv), nothing is repeated.
// `kv_valid` has NB rows; flattened head row b*Hq+h reads row
// (b*Hq+h)*NB / (B*Hq), as in the TPU kernel's BlockSpec.
//
// Three routes, chosen by the wrapper (`ops.py:_route`) from dtypes and
// shapes alone:
//
// * small heads (`rt_flash_attention_small`, D <= 32, q, k and v each fp32
//   or bf16, any G, any NB | B*Hq: the tiny card == CPU models and the
//   planted ranker's evaluation, q (64, 64, 4, 16) fp32).  The forward of
//   `attn_small.cuh` with this file's mask: (query, head) rows of one kv
//   group per block, a row's keys split over the 4 quarters of 1 warp
//   (many rows, as here) or 4 warps (few rows), the splits merged once at
//   the end; 64-key K/V tiles through a 3-stage cp.async ring sized to the
//   padded D; causal blocks stop at the block's last query.  Bound on the
//   card at the tiny call: bytes, 3.1 MB of Q, K, V and O, 0.0009 ms.  What
//   holds it far above that is moving every key's K and V rows from shared
//   memory into each row's registers (a CUDA-core product has no other
//   way): the design makes those loads broadcasts (a quarter-warp's 8 rows
//   read one key row, the 4 quarters adjacent rows) and keeps the ~2-cycle
//   load; the SIMT kernel it replaced there sized every block for D 128
//   and reloaded each K/V tile for each of a group's heads.
// * tensor cores (`rt_flash_attention_tc`): bf16 q, k, v, D in {64, 128},
//   G = Hq / Hkv in {1, 2, 4, 8}, NB dividing B*Hkv.  The tile routine of
//   `attn_tile.cuh`: one warpgroup per 64 rows = 64/G queries x G heads,
//   so each K/V tile read serves the G heads of its kv group; wgmma for
//   Q K^T and P V; 64-key tiles through a 2-stage TMA + mbarrier
//   ring (one stage when Skv <= 64, as in the offline build: four blocks
//   per SM); causal blocks stop at the diagonal tile.  Bound on the card at
//   the offline build (q (64, 64, 32, 128), k/v (64, 64, 8, 128) bf16):
//   bytes, Q, K, V and O read or written once, 0.025 ms; the packing of G
//   heads is what lets a block read K and V once for all of them.
// * SIMT (`rt_flash_attention`, the CUDA-core kernel, everything else:
//   fp32 or mixed dtypes at 32 < D <= 128, such as the served call cast to
//   fp32, held to 1e-5 that one bf16 product cannot meet): one block of 4
//   warps per (16-row query tile, head, batch row), each warp carrying 4
//   rows' running (m, l, acc) in registers while 32-key K/V tiles stream
//   through shared memory in fp32; CUDA-core FMAs.
#include "../attn_common.cuh"
#include "../attn_small.cuh"
#include "../attn_tile.cuh"

namespace {

constexpr int kBQ = 16;     // query rows per block
constexpr int kBK = 32;     // keys per tile (one per lane in the score pass)
constexpr int kWarps = 4;
constexpr int kRPW = kBQ / kWarps;
constexpr int kDMax = 128;
constexpr int kDPL = kDMax / 32;

template <typename TQ, typename TK, typename TV>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                 const TV* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 TQ* __restrict__ o, int Sq, int Skv, int Hq, int Hkv, int D,
                 int NB, int total_rows, int causal, float scale) {
  __shared__ float q_s[kBQ][kDMax];
  __shared__ float k_s[kBK][kDMax + 1];
  __shared__ float v_s[kBK][kDMax];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint8_t* valid_row = nullptr;
  if (kv_valid != nullptr) {
    const long long row = (long long)(b * Hq + h) * NB / total_rows;
    valid_row = kv_valid + row * Skv;
  }

  for (int e = tid; e < kBQ * D; e += blockDim.x) {
    const int r = e / D, d = e % D, qi = q0 + r;
    q_s[r][d] = qi < Sq ? rt::to_f(q[(((size_t)b * Sq + qi) * Hq + h) * D + d]) : 0.f;
  }

  float m[kRPW], l[kRPW], acc[kRPW][kDPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  int k_end = Skv;
  if (causal) k_end = min(Skv, min(Sq, q0 + kBQ));
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q tile loaded / previous tile consumed
    for (int e = tid; e < kBK * D; e += blockDim.x) {
      const int j = e / D, d = e % D, kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * Hkv + hk) * D + d;
        kx = rt::to_f(k[off]);
        vx = rt::to_f(v[off]);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool key_ok = kj < Skv && (valid_row == nullptr || valid_row[kj] != 0);
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
      const int qi = q0 + warp * kRPW + r;
      const bool ok = key_ok && (!causal || qi >= kj);
      const float s = ok ? p[r] * scale : rt::kNegInf;
      const float m_new = fmaxf(m[r], rt::warp_max(s));
      const float pr = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rt::warp_sum(pr);
      m[r] = m_new;
      p[r] = rt::round_as<TV>(pr);  // probabilities in the value dtype
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
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    TQ* orow = o + (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = rt::from_f<TQ>(acc[r][i] / denom);
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* kv_valid, void* o, int B, int Sq,
                                  int Skv, int Hq, int Hkv, int D, int NB,
                                  int causal, float scale, int q_dtype,
                                  int k_dtype, int v_dtype, void* stream) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv != 0 || NB < 1 || B < 1 || Sq < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(q_dtype, [&](auto tq) {
    return rt::with_dtype(k_dtype, [&](auto tk) {
      return rt::with_dtype(v_dtype, [&](auto tv) {
        using TQ = decltype(tq);
        using TK = decltype(tk);
        using TV = decltype(tv);
        flash_fwd_kernel<TQ, TK, TV><<<grid, kWarps * 32, 0, st>>>(
            static_cast<const TQ*>(q), static_cast<const TK*>(k),
            static_cast<const TV*>(v), static_cast<const uint8_t*>(kv_valid),
            static_cast<TQ*>(o), Sq, Skv, Hq, Hkv, D, NB, B * Hq, causal, scale);
        return cudaGetLastError();
      });
    });
  });
}

namespace {

// Mask of the tensor-core route: keys below Skv with their kv_valid bit,
// and at most the query index when causal.
struct FlashPolicy {
  const uint8_t* kv_valid;
  int Skv, NB, groups, Hkv, causal;
  const uint8_t* valid_row;

  __device__ void init(int b, int hk, int) {
    valid_row = kv_valid == nullptr
                    ? nullptr
                    : kv_valid + (long long)(b * Hkv + hk) * NB / groups * Skv;
  }
  __device__ int n_tiles(int q0, int qr) const {
    const int end = causal ? min(Skv, q0 + qr) : Skv;
    return (end + rt::tc::kN - 1) / rt::tc::kN;
  }
  __device__ bool tile_live(int) const { return true; }
  __device__ int pos(int qi) const { return qi; }
  __device__ uint32_t flag(int key) const { return valid_row == nullptr ? 1u : valid_row[key]; }
  // valid keys, at most the query index when causal
  __device__ uint64_t row_mask(int p, int k0, uint64_t valid) const {
    return causal ? valid & rt::tc::bits_below(p - k0 + 1) : valid;
  }
};

}  // namespace

// The tensor-core route: q, k, v bf16.
extern "C" int rt_flash_attention_tc(const void* q, const void* k, const void* v,
                                     const void* kv_valid, void* o, int B, int Sq, int Skv,
                                     int Hq, int Hkv, int D, int NB, int causal, float scale,
                                     void* stream) {
  const int log2g = Hkv < 1 || Hq % Hkv != 0 ? -1 : rt::tc::log2_group(Hq / Hkv);
  if (log2g < 0 || (D != 64 && D != 128) || NB < 1 || B < 1 || Sq < 1 || Skv < 1 ||
      (B * Hkv) % NB != 0)
    return cudaErrorInvalidValue;
  const FlashPolicy pol{static_cast<const uint8_t*>(kv_valid), Skv, NB, B * Hkv, Hkv, causal,
                        nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using rt::tc::launch_tc;
  return D == 128 ? launch_tc<FlashPolicy, __nv_bfloat16, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                                               log2g, scale, pol, st)
                  : launch_tc<FlashPolicy, __nv_bfloat16, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                                              log2g, scale, pol, st);
}

namespace {

// Mask of the small-head route, per (query, head) row: keys below Skv with
// the row's own kv_valid bit (row (b*Hq+h)*NB / (B*Hq)), at most the query
// index when causal.
struct FlashSmallMask {
  const uint8_t* kv_valid;
  int NB, causal;

  struct Row {
    const uint8_t* valid;
    int qi;
  };
  __device__ Row row(const rt::small::Args& a, int b, int h, int qi) const {
    if (kv_valid == nullptr) return {nullptr, qi};
    const long long mrow = (long long)(b * a.Hq + h) * NB / ((long long)a.B * a.Hq);
    return {kv_valid + mrow * a.Skv, qi};
  }
  __device__ bool all_keys(const Row&) const { return false; }
  __device__ unsigned flag(const rt::small::Args&, const Row& r, int kj) const {
    return r.valid == nullptr ? 1u : r.valid[kj];
  }
  __device__ bool ok(const rt::small::Args&, const Row& r, int kj, unsigned flag) const {
    return (!causal || r.qi >= kj) && flag != 0;
  }
  __device__ int key_end(const rt::small::Args& a, int q_last) const {
    return causal ? min(a.Skv, q_last + 1) : a.Skv;
  }
  __device__ bool tile_live(const rt::small::Args&, int, int, int, int, int, int) const {
    return true;
  }
};

}  // namespace

// The small-head route: D <= 32, q, k and v each fp32 or bf16 (dtype codes).
extern "C" int rt_flash_attention_small(const void* q, const void* k, const void* v,
                                        const void* kv_valid, void* o, int B, int Sq, int Skv,
                                        int Hq, int Hkv, int D, int NB, int causal, float scale,
                                        int q_dtype, int k_dtype, int v_dtype, void* stream) {
  if (D < 1 || D > 32 || Hkv < 1 || Hq % Hkv != 0 || NB < 1 || B < 1 || Sq < 1 || Skv < 1 ||
      (B * Hq) % NB != 0 || (q_dtype != rt::kF32 && q_dtype != rt::kBF16))
    return cudaErrorInvalidValue;
  const rt::small::Args a{q, k, v, o, B, Sq, Skv, Hq, Hkv, D, q_dtype == rt::kBF16, 0,
                          scale * rt::small::kLog2e};
  const FlashSmallMask mask{static_cast<const uint8_t*>(kv_valid), NB, causal};
  return rt::small::launch(a, mask, k_dtype, v_dtype, static_cast<cudaStream_t>(stream));
}
