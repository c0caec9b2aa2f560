// Fixed-fanout embedding bag for Hopper, sm_90a: the forward sum (B5) and
// its gradient (K7, `rt_bag_backward` below).
//
// Replaces the Pallas TPU kernel `src/repro/kernels/embedding_bag/kernel.py:35`
// (`embedding_bag`, body `_bag_kernel` at `:18`; wrapper `ops.py:bag_sum`):
// out[b, :] = cast(sum over f = 0..F-1 of float(table[ids[b, f], :])), with
// ids (B, F) int32 global row ids into table (rows, d), fp32 or bf16, and
// out (B, d) in the table's dtype.  The serving path calls it for
// Wide&Deep's wide part: a (rows, 1) table, F = 40 fields.
//
// Design.  The TPU kernel scalar-prefetches the ids and walks a (B, F)
// grid whose f axis runs in order, pulling one (1, d) row per step into
// VMEM and accumulating in an fp32 scratch.  Hopper has no sequential
// grid, so here one thread owns (b, one vector of V columns of row b) and
// loops over f in registers: the sum is taken in fp32 in the order
// f = 0..F-1 and rounded once, to bf16 for bf16 tables.  The (b, column)
// pairs are flattened over the threads, so neighbouring threads read
// neighbouring columns of one row, and for d = 1 a thread owns a whole bag
// and no lane idles (a warp per row would idle 31 of 32).  Each thread
// loads its own ids (no scalar prefetch); threads of one bag read the same
// id, which the load broadcasts.  V = 16 bytes / element size (16-byte
// loads and stores) where d and the pointers allow, else 1, which serves
// any d, odd ones included.  Ids must lie in [0, rows): the wrapper's
// callers build them from per-field offsets; nothing checks them here.
//
// Bound on the card: bytes.  The function reads 4*B*F bytes of ids and
// B*F*d*elt bytes of rows and writes B*d*elt bytes, one add per row
// element, over 3.35 TB/s.  A row narrower than a 32-byte sector still
// costs a whole sector, so for d*elt < 32 the card moves B*F*32 row bytes
// (8x the useful bytes for d = 1 fp32).  A table that fits in the 50 MB L2
// (Wide&Deep's wide table is 35.7 MB) serves warm calls from L2.
#include "../attn_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           T* __restrict__ out, int B, int F, int d) {
  const int cols = d / V;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)B * cols) return;
  const long long b = g / cols;
  const int c = (int)(g - b * cols);
  const int* bag = ids + b * F;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 8
  for (int f = 0; f < F; ++f) {
    const size_t row = (size_t)__ldg(bag + f);
    const Pack<T, V> x = reinterpret_cast<const Pack<T, V>*>(table + row * d)[c];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += rt::to_f(x.e[j]);
  }
  Pack<T, V> y;
#pragma unroll
  for (int j = 0; j < V; ++j) y.e[j] = rt::from_f<T>(acc[j]);
  reinterpret_cast<Pack<T, V>*>(out + b * d)[c] = y;
}

template <typename T, int V>
cudaError_t launch(const void* table, const void* ids, void* out, int B, int F,
                   int d, cudaStream_t st) {
  const long long threads = (long long)B * (d / V);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bag_kernel<T, V><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<T*>(out), B, F, d);
  return cudaGetLastError();
}

}  // namespace

// table: (rows, d); ids: (B, F) int32; out: (B, d), all contiguous, table
// and out of one dtype.  `vec` = 1 selects 16-byte loads (the wrapper
// checks that d is a multiple of the vector and the pointers' alignment).
extern "C" int rt_embedding_bag(const void* table, const void* ids, void* out,
                                int B, int F, int d, int dtype, int vec,
                                void* stream) {
  if (B < 1 || F < 0 || d < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    constexpr int V = 16 / sizeof(T);
    if (!vec) return launch<T, 1>(table, ids, out, B, F, d, st);
    if (d % V != 0) return cudaErrorInvalidValue;
    return launch<T, V>(table, ids, out, B, F, d, st);
  });
}

// ---------------------------------------------------------------------------
// K7: the bag sum's gradient, d_table[ids[b, f], :] += d_out[b, :].
//
// The JAX package gets it from autodiff of Wide&Deep's `jnp.take` + sum
// (`src/repro/recsys/models.py:65-66`); its TPU kernel has no backward.
// The port's forward is B5, so its gradient is this kernel (wrapper
// `ops.py:bag_backward`, plain version `ref.py:bag_backward_ref`, a loop
// of `index_add_` over the fields).  One thread per (b, f, column):
// `atomicAdd` of d_out[b, c] into an fp32 (rows, d) gradient that the
// wrapper zeroes first; rows repeated across bags and fields collide in
// the atomics, so the order of their sums varies from run to run.  A bf16
// table's gradient is then rounded once into the bf16 output by a second
// kernel.  Ids must lie in [0, rows), as for the forward.
//
// Bound on the card: bytes.  Wide&Deep's train_batch call (ids 65,536 x
// 40 into the 8,933,376 x 1 fp32 wide table): 10.5 MB of ids, the 35.7 MB
// zero fill, and 2.6 M read-modify-writes of 4 bytes, each a whole 32-byte
// sector: ~0.014 ms of useful bytes, ~0.064 ms counting sectors.
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_bwd_kernel(const int* __restrict__ ids, const T* __restrict__ dout,
               float* __restrict__ grad, int B, int F, int d) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)B * F * d) return;
  const long long bf = g / d;
  const int c = (int)(g - bf * d);
  const long long b = bf / F;
  const size_t row = (size_t)__ldg(ids + bf);
  atomicAdd(grad + row * d + c, rt::to_f(dout[b * d + c]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round_kernel(const float* __restrict__ src, T* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) dst[i] = rt::from_f<T>(src[i]);
}

}  // namespace

// ids (B, F) int32; dout (B, d) of the table's dtype; grad (rows, d) fp32,
// zeroed by the caller; out (rows, d) of the table's dtype (for fp32, the
// same buffer as grad: nothing is rounded).  All contiguous.
extern "C" int rt_bag_backward(const void* ids, const void* dout, void* grad, void* out,
                               int B, int F, int d, long long rows, int dtype,
                               void* stream) {
  if (B < 1 || F < 0 || d < 1 || rows < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    const long long n = (long long)B * F * d;
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (blocks > 0) {
      bag_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const int*>(ids), static_cast<const T*>(dout),
          static_cast<float*>(grad), B, F, d);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (static_cast<void*>(grad) == out) return cudaSuccess;
    const long long m = rows * d;
    round_kernel<T><<<(unsigned)((m + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(grad), static_cast<T*>(out), m);
    return cudaGetLastError();
  });
}
