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
// Layers: the pools are stacks of layer planes, one layer stride apart
// (the cached-row pool's (L, n_rows, 1, Hkv, Dh), or the serving arena's
// layers, interleaved slot by slot).  One launch gathers a range of
// layers by the same table: the selective prefill's layers 1..L-1 in one
// launch per pass instead of one per layer.  The outputs are layer-major,
// (n_layers, n_logical, page, H, Dh), so each layer's rows are contiguous
// for the attention kernel that reads them.
//
// Two pools: the table may also address a second pool (pk2, pv2) of the
// same page shape and dtype, entries in [n_pages, n_pages + n_pages2)
// reading its page (entry - n_pages).  Its pages lie `page_stride2`
// elements apart, each contiguous: the serving arena, where the shared
// block store keeps the prefix tier's rows, so a request whose
// instruction rows are store-shared assembles them with its cached rows
// in the same launch, copied bit for bit from the store's slots.
//
// Numerics: the frequencies come from the wrapper (computed by PyTorch
// exactly as the plain version computes them), the angle is one fp32
// product, sin/cos are the accurate `sincosf` (no fast-math: positions
// reach the thousands), and the rotation uses round-to-nearest products
// and sums without FMA contraction, as the plain version's separate
// elementwise operations do.  A layer's outputs do not depend on which
// range it was gathered in: bitwise those of a one-layer launch.
//
// Design: one block of 128 threads per (output slot row, layer), H * Dh
// elements of K and of V.  The block computes the row's cos/sin once into
// shared memory and shares them across its H heads; threads move 16 bytes
// per load and store where the row, the strides and the pointers allow
// it.  A table entry outside [0, n_pages + n_pages2) gives an all-zero
// row.
//
// Bound on the card: bytes.  The gather reads each selected K and V row
// once and writes it once (plus the optional pre-RoPE key row), a few
// flops per element; nothing is reused, so the kernel can only approach
// the memory rate.
#include "../attn_common.cuh"

// The pools of a binding (`ops.py:PoolGather`), filled once on the host
// and passed by value; strides in elements, K and V pools alike.
struct GatherPools {
  const void* k;        // first pool at layer 0, page 0
  const void* v;
  const void* k2;       // second pool (null when n_pages2 = 0)
  const void* v2;
  const float* freqs;   // (Dh/2,) rotation frequencies (null: no rotation)
  long long layer_stride, page_stride;
  long long layer_stride2, page_stride2;
  int n_pages, n_pages2, n_layers, page, H, Dh, k_dtype, v_dtype, vec;
};

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
block_gather_kernel(const GatherPools pl, int first_layer, const int* __restrict__ table,
                    const int* __restrict__ pos, TK* __restrict__ ko, TV* __restrict__ vo,
                    TK* __restrict__ kraw, int rotate) {
  extern __shared__ float cs[];  // [0, half): cos, [half, Dh): sin
  const int Dh = pl.Dh, H = pl.H, page = pl.page;
  const int half = Dh / 2;
  const size_t row = (size_t)H * Dh;
  const size_t r = blockIdx.x;  // output slot row
  const size_t l = (size_t)first_layer + blockIdx.y;
  const int lp = (int)(r / page), slot = (int)(r % page);
  const int p = table[lp];
  const bool in1 = p >= 0 && p < pl.n_pages;
  const bool in2 = p >= pl.n_pages && p - pl.n_pages < pl.n_pages2;
  const bool ok = in1 || in2;
  const size_t src = in2 ? l * pl.layer_stride2 + (size_t)(p - pl.n_pages) * pl.page_stride2
                               + (size_t)slot * row
                         : l * pl.layer_stride + (size_t)(in1 ? p : 0) * pl.page_stride
                               + (size_t)slot * row;
  const TK* kb = static_cast<const TK*>(in2 ? pl.k2 : pl.k);
  const TV* vb = static_cast<const TV*>(in2 ? pl.v2 : pl.v);
  const float* freqs = pl.freqs;
  const size_t dst = ((size_t)blockIdx.y * gridDim.x + r) * row;

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
cudaError_t launch(const GatherPools& pl, int first_layer, int n_layers, const void* table,
                   const void* pos, void* k_out, void* v_out, void* k_raw, int n_rows,
                   int rotate, cudaStream_t st) {
  const size_t smem = rotate ? (size_t)pl.Dh * sizeof(float) : 0;
  block_gather_kernel<TK, TV, NK, NV><<<dim3(n_rows, n_layers), kThreads, smem, st>>>(
      pl, first_layer, static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<TK*>(k_out), static_cast<TV*>(v_out), static_cast<TK*>(k_raw), rotate);
  return cudaGetLastError();
}

}  // namespace

// `pools` (a GatherPools the wrapper fills once per binding) describes
// the pools; one call gathers layers [first_layer, first_layer + n_layers)
// by table (n_logical,) int32 and, when `rotate`, rotates keys to pos
// (n_logical, page) int32 (nullable otherwise).  k_out/v_out (and k_raw,
// nullable, only with `rotate`): (n_layers, n_logical, page, H, Dh),
// 16-byte aligned when `pools->vec` (the wrapper checks the pools' rows,
// strides and pointers; fresh PyTorch allocations are 512-byte aligned).
extern "C" int rt_block_gather(const GatherPools* pools, int first_layer, int n_layers,
                               const void* table, const void* pos, void* k_out, void* v_out,
                               void* k_raw, int n_logical, int rotate, void* stream) {
  if (pools == nullptr) return cudaErrorInvalidValue;
  const GatherPools& pl = *pools;
  if (pl.Dh < 2 || pl.Dh % 2 != 0 || pl.Dh > 4096 || pl.H < 1 || pl.page < 1 ||
      n_logical < 1 || pl.n_pages < 1 || (k_raw != nullptr && !rotate) ||
      (rotate && (pos == nullptr || pl.freqs == nullptr)) || pl.n_pages2 < 0 ||
      (long long)pl.n_pages + pl.n_pages2 > 0x7fffffffLL || first_layer < 0 ||
      n_layers < 1 || n_layers > 65535 || first_layer + n_layers > pl.n_layers ||
      pl.page_stride < (long long)pl.page * pl.H * pl.Dh ||
      (pl.n_pages2 > 0 && (pl.k2 == nullptr || pl.v2 == nullptr ||
                           pl.page_stride2 < (long long)pl.page * pl.H * pl.Dh)))
    return cudaErrorInvalidValue;
  const long long rows = (long long)n_logical * pl.page;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(pl.k_dtype, [&](auto tk) {
    return rt::with_dtype(pl.v_dtype, [&](auto tv) {
      using TK = decltype(tk);
      using TV = decltype(tv);
      constexpr int NK = 16 / sizeof(TK), NV = 16 / sizeof(TV);
      if (pl.vec)
        return launch<TK, TV, NK, NV>(pl, first_layer, n_layers, table, pos, k_out, v_out,
                                      k_raw, (int)rows, rotate, st);
      return launch<TK, TV, 1, 1>(pl, first_layer, n_layers, table, pos, k_out, v_out, k_raw,
                                  (int)rows, rotate, st);
    });
  });
}
