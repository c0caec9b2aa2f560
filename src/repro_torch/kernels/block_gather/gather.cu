// Paged block gather with fused RoPE realignment for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `repro/kernels/block_gather/kernel.py`
// (`_gather_kernel` / `block_gather`, wrapper `ops.py:assemble_kv`): the
// "zero-copy assembly" of cached pre-RoPE KV (§III-C2a).  Logical page i
// reads physical page block_table[i] of the pools (n_pages, page, H, Dh);
// values are copied bit for bit, keys are copied or, when `rotate`,
// rotated to positions[i, slot] (half-split RoPE per head over Dh, fp32
// math, cast back to the pool dtype).  With `k_raw` set, the same launch
// also writes the gathered keys before rotation, so a caller that needs
// both the realigned keys and the pre-RoPE base reads the pool once.
//
// Two pools: the table may also address a second pool (pk2, pv2) of the
// same page shape and dtype, entries in [n_pages, n_pages + n_pages2)
// reading its page (entry - n_pages).  Its pages lie `stride2` elements
// apart, each contiguous: a layer plane of the serving arena, where the
// shared block store keeps the prefix tier's rows, so a request whose
// instruction rows are store-shared assembles them with its cached rows
// in the same launch, copied bit for bit from the store's slots.
//
// Numerics: the frequencies come from the wrapper (computed by PyTorch
// exactly as the plain version computes them), the angle is one fp32
// product, sin/cos are the accurate `sincosf` (no fast-math: positions
// reach the thousands), and the rotation uses round-to-nearest products
// and sums without FMA contraction, as the plain version's separate
// elementwise operations do.
//
// Design: one block of 128 threads per output slot row (H * Dh elements of
// K and of V).  The block computes the row's cos/sin once into shared
// memory and shares them across its H heads; threads move 16 bytes per
// load and store where the row and the pointers allow it.  A table entry
// outside [0, n_pages + n_pages2) gives an all-zero row.
//
// Bound on the card: bytes.  The gather reads each selected K and V row
// once and writes it once (plus the optional pre-RoPE key row), a few
// flops per element; nothing is reused, so the kernel can only approach
// the memory rate.
#include "../attn_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T e[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_or_zero(const T* base, size_t i, bool ok) {
  Pack<T, N> x;
  if (ok) {
    x = reinterpret_cast<const Pack<T, N>*>(base)[i];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x.e[j] = rt::from_f<T>(0.f);
  }
  return x;
}

template <typename T, int N>
__device__ __forceinline__ void copy_row(const T* src, T* dst, size_t row, bool ok) {
  for (size_t e = threadIdx.x; e < row / N; e += blockDim.x)
    reinterpret_cast<Pack<T, N>*>(dst)[e] = load_or_zero<T, N>(src, e, ok);
}

template <typename TK, typename TV, int NK, int NV>
__global__ void __launch_bounds__(kThreads)
block_gather_kernel(const TK* __restrict__ pk, const TV* __restrict__ pv,
                    const TK* __restrict__ pk2, const TV* __restrict__ pv2,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    const float* __restrict__ freqs, TK* __restrict__ ko,
                    TV* __restrict__ vo, TK* __restrict__ kraw, int n_pages,
                    int n_pages2, long long stride2, int page, int H, int Dh,
                    int rotate) {
  extern __shared__ float cs[];  // [0, half): cos, [half, Dh): sin
  const int half = Dh / 2;
  const size_t row = (size_t)H * Dh;
  const size_t r = blockIdx.x;  // output slot row
  const int lp = (int)(r / page), slot = (int)(r % page);
  const int p = table[lp];
  const bool in1 = p >= 0 && p < n_pages;
  const bool in2 = p >= n_pages && p - n_pages < n_pages2;
  const bool ok = in1 || in2;
  const size_t src = in2 ? (size_t)(p - n_pages) * (size_t)stride2 + (size_t)slot * row
                         : ((size_t)(in1 ? p : 0) * page + slot) * row;
  const TK* kb = in2 ? pk2 : pk;
  const TV* vb = in2 ? pv2 : pv;
  const size_t dst = r * row;

  copy_row<TV, NV>(vb + src, vo + dst, row, ok);
  if (!rotate) {  // uniform over the launch
    copy_row<TK, NK>(kb + src, ko + dst, row, ok);
    return;
  }
  const float fpos = (float)pos[r];
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float s, c;
    sincosf(fpos * freqs[i], &s, &c);
    cs[i] = c;
    cs[half + i] = s;
  }
  __syncthreads();

  const int per_head = half / NK;
  for (int e = threadIdx.x; e < H * per_head; e += blockDim.x) {
    const int h = e / per_head, i0 = (e % per_head) * NK;
    const size_t o1 = ((size_t)h * Dh + i0) / NK, o2 = o1 + half / NK;
    const Pack<TK, NK> x1 = load_or_zero<TK, NK>(kb + src, o1, ok);
    const Pack<TK, NK> x2 = load_or_zero<TK, NK>(kb + src, o2, ok);
    Pack<TK, NK> y1, y2;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float a = rt::to_f(x1.e[j]), b = rt::to_f(x2.e[j]);
      const float c = cs[i0 + j], s = cs[half + i0 + j];
      y1.e[j] = rt::from_f<TK>(__fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s)));
      y2.e[j] = rt::from_f<TK>(__fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c)));
    }
    Pack<TK, NK>* out = reinterpret_cast<Pack<TK, NK>*>(ko + dst);
    out[o1] = y1;
    out[o2] = y2;
    if (kraw != nullptr) {
      Pack<TK, NK>* raw = reinterpret_cast<Pack<TK, NK>*>(kraw + dst);
      raw[o1] = x1;
      raw[o2] = x2;
    }
  }
}

template <typename TK, typename TV, int NK, int NV>
cudaError_t launch(const void* pool_k, const void* pool_v, const void* pool2_k,
                   const void* pool2_v, const void* table, const void* pos,
                   const void* freqs, void* k_out, void* v_out, void* k_raw,
                   int n_pages, int n_pages2, long long stride2, int n_rows,
                   int page, int H, int Dh, int rotate, cudaStream_t st) {
  const size_t smem = rotate ? (size_t)Dh * sizeof(float) : 0;
  block_gather_kernel<TK, TV, NK, NV><<<n_rows, kThreads, smem, st>>>(
      static_cast<const TK*>(pool_k), static_cast<const TV*>(pool_v),
      static_cast<const TK*>(pool2_k), static_cast<const TV*>(pool2_v),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<const float*>(freqs), static_cast<TK*>(k_out),
      static_cast<TV*>(v_out), static_cast<TK*>(k_raw), n_pages, n_pages2,
      stride2, page, H, Dh, rotate);
  return cudaGetLastError();
}

}  // namespace

// pool_k/pool_v: (n_pages, page, H, Dh); pool2_k/pool2_v (nullable when
// n_pages2 = 0): n_pages2 pages of (page, H, Dh), `stride2` elements
// apart; table: (n_logical,) int32; pos: (n_logical, page) int32; freqs:
// (Dh/2,) fp32; k_out/v_out (and k_raw, nullable): (n_logical, page, H,
// Dh).  `vec` = 1 selects 16-byte loads (the wrapper checks the row
// widths, the second pool's stride and the pointers' alignment).
extern "C" int rt_block_gather(const void* pool_k, const void* pool_v,
                               const void* pool2_k, const void* pool2_v,
                               const void* table, const void* pos,
                               const void* freqs, void* k_out, void* v_out,
                               void* k_raw, int n_pages, int n_pages2,
                               long long stride2, int n_logical, int page,
                               int H, int Dh, int rotate, int k_dtype,
                               int v_dtype, int vec, void* stream) {
  if (Dh < 2 || Dh % 2 != 0 || Dh > 4096 || H < 1 || page < 1 ||
      n_logical < 1 || n_pages < 1 || (k_raw != nullptr && !rotate) ||
      n_pages2 < 0 || (long long)n_pages + n_pages2 > 0x7fffffffLL ||
      (n_pages2 > 0 && (pool2_k == nullptr || pool2_v == nullptr ||
                        stride2 < (long long)page * H * Dh)))
    return cudaErrorInvalidValue;
  const long long rows = (long long)n_logical * page;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(k_dtype, [&](auto tk) {
    return rt::with_dtype(v_dtype, [&](auto tv) {
      using TK = decltype(tk);
      using TV = decltype(tv);
      constexpr int NK = 16 / sizeof(TK), NV = 16 / sizeof(TV);
      if (vec)
        return launch<TK, TV, NK, NV>(pool_k, pool_v, pool2_k, pool2_v, table, pos,
                                      freqs, k_out, v_out, k_raw, n_pages, n_pages2,
                                      stride2, (int)rows, page, H, Dh, rotate, st);
      return launch<TK, TV, 1, 1>(pool_k, pool_v, pool2_k, pool2_v, table, pos, freqs,
                                  k_out, v_out, k_raw, n_pages, n_pages2, stride2,
                                  (int)rows, page, H, Dh, rotate, st);
    });
  });
}
