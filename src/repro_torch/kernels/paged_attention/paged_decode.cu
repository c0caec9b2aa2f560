// Fused paged-decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `repro/kernels/paged_attention/kernel.py`
// (`_paged_decode_kernel` / `paged_decode_attention`, wrapper
// `ops.py:paged_decode_mha`).
//
// One query token per request attends over that request's paged KV
// without any gather: page_ids (N, Pmax) names the physical pages a row
// touches and slot_pos (N, Pmax, page) the logical position each slot
// serves (-1 = no live token of this row).  The position is both the
// liveness mask and the RoPE angle: keys are stored pre-RoPE in the
// arena (P, page, L, Hkv, D) and rotated here, in fp32 (half-split
// RoPE), then rounded to the query dtype as the TPU kernel does;
// probabilities are rounded to the arena (value) dtype.  q (N, Hq, D) is
// post-RoPE; out (N, Hq, D) has q's dtype.
//
// Design: one block of 4 warps per (kv head, request).  The G = Hq / Hkv
// query heads of the group are shared by the block (GQA by index; warp w
// owns heads w, w+4, ...), so every key and value of the row is read from
// device memory once per kv head.  The block streams the flattened
// (page, slot) axis 32 slots at a time — two 16-slot pages per step at
// the default page size — and skips every 32-slot chunk with no live
// slot, so a page whose slots are all -1 contributes nothing.
//
// Bound on the card: bytes (each live K/V row is read once and used for
// G queries only).  With one block per (request, kv head) a small decode
// batch puts few blocks on 132 SMs; splitting the slot axis across
// blocks (split-K) is the next step.
#include "../attn_common.cuh"

namespace {

constexpr int kBK = 32;      // slots per step
constexpr int kWarps = 4;
constexpr int kGMax = 16;    // query heads per kv head
constexpr int kRPW = kGMax / kWarps;
constexpr int kDMax = 128;
constexpr int kDPL = kDMax / 32;

template <typename TQ, typename TA>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TA* __restrict__ ak,
                    const TA* __restrict__ av, const int* __restrict__ page_ids,
                    const int* __restrict__ slot_pos, TQ* __restrict__ o,
                    int Hq, int Hkv, int D, int page, int L, int layer, int Pmax,
                    float theta, float scale) {
  __shared__ float q_s[kGMax][kDMax];
  __shared__ float k_s[kBK][kDMax + 1];
  __shared__ float v_s[kBK][kDMax];
  __shared__ float freq_s[kDMax / 2];
  __shared__ int pos_s[kBK];

  const int hk = blockIdx.x, n = blockIdx.y;
  const int G = Hq / Hkv, half = D / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int total = Pmax * page;
  const int* pos_row = slot_pos + (size_t)n * total;
  const int* pid_row = page_ids + (size_t)n * Pmax;

  for (int i = tid; i < half; i += blockDim.x)
    freq_s[i] = 1.f / powf(theta, (float)i / (float)half);
  for (int e = tid; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    q_s[g][d] = rt::to_f(q[((size_t)n * Hq + hk * G + g) * D + d]);
  }

  float m[kRPW], l[kRPW], acc[kRPW][kDPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  for (int f0 = 0; f0 < total; f0 += kBK) {
    __syncthreads();  // q/freqs ready, previous chunk consumed
    int my_pos = -1;
    if (tid < kBK) {
      my_pos = f0 + tid < total ? pos_row[f0 + tid] : -1;
      pos_s[tid] = my_pos;
    }
    if (!__syncthreads_or(my_pos >= 0)) continue;  // no live slot in the chunk

    for (int e = tid; e < kBK * half; e += blockDim.x) {
      const int j = e / half, i = e % half;
      const int pos = pos_s[j];
      float k1 = 0.f, k2 = 0.f, v1 = 0.f, v2 = 0.f;
      if (pos >= 0) {
        const int f = f0 + j;
        const int pid = pid_row[f / page];
        const size_t base =
            ((((size_t)pid * page + f % page) * L + layer) * Hkv + hk) * D;
        const float x1 = rt::to_f(ak[base + i]);
        const float x2 = rt::to_f(ak[base + i + half]);
        v1 = rt::to_f(av[base + i]);
        v2 = rt::to_f(av[base + i + half]);
        const float ang = (float)pos * freq_s[i];
        const float c = cosf(ang), s = sinf(ang);
        k1 = rt::round_as<TQ>(x1 * c - x2 * s);  // keys in the query dtype
        k2 = rt::round_as<TQ>(x1 * s + x2 * c);
      }
      k_s[j][i] = k1;
      k_s[j][i + half] = k2;
      v_s[j][i] = v1;
      v_s[j][i + half] = v2;
    }
    __syncthreads();

    const bool live = pos_s[lane] >= 0;
    float p[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) p[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const int g = warp + kWarps * r;
        if (g < G) p[r] = fmaf(q_s[g][d], kd, p[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      if (warp + kWarps * r >= G) continue;  // warp-uniform
      const float s = live ? p[r] * scale : rt::kNegInf;
      const float m_new = fmaxf(m[r], rt::warp_max(s));
      const float pr = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rt::warp_sum(pr);
      m[r] = m_new;
      p[r] = rt::round_as<TA>(pr);
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
        if (warp + kWarps * r >= G) continue;
        const float pj = __shfl_sync(rt::kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int g = warp + kWarps * r;
    if (g >= G) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    TQ* orow = o + ((size_t)n * Hq + hk * G + g) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = rt::from_f<TQ>(acc[r][i] / denom);
    }
  }
}

}  // namespace

extern "C" int rt_paged_decode(const void* q, const void* arena_k,
                               const void* arena_v, const void* page_ids,
                               const void* slot_pos, void* o, int N, int Hq,
                               int Hkv, int D, int page, int L, int layer,
                               int Pmax, float theta, float scale, int q_dtype,
                               int arena_dtype, void* stream) {
  if (D < 2 || D > kDMax || D % 2 != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      Hq / Hkv > kGMax || N < 1 || Pmax < 1 || page < 1 || layer < 0 || layer >= L)
    return cudaErrorInvalidValue;
  const dim3 grid(Hkv, N);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(q_dtype, [&](auto tq) {
    return rt::with_dtype(arena_dtype, [&](auto ta) {
      using TQ = decltype(tq);
      using TA = decltype(ta);
      paged_decode_kernel<TQ, TA><<<grid, kWarps * 32, 0, st>>>(
          static_cast<const TQ*>(q), static_cast<const TA*>(arena_k),
          static_cast<const TA*>(arena_v), static_cast<const int*>(page_ids),
          static_cast<const int*>(slot_pos), static_cast<TQ*>(o), Hq, Hkv, D,
          page, L, layer, Pmax, theta, scale);
      return cudaGetLastError();
    });
  });
}
