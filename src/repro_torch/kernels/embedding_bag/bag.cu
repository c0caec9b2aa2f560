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
// VMEM and accumulating in an fp32 scratch.  Here a block takes a tile of
// TB bags (at most 32; fewer in a small batch, so that every SM gets two
// tiles) and, for each chunk of FC fields, works in two phases:
// - gather: the block's 256 threads walk the tile's (bag, field) pairs in
//   memory order, so a warp reads 128 contiguous bytes of ids (streamed:
//   not kept in L1, first out of L2, each id is read once); each thread
//   keeps 8 row loads in flight (4 of 16-byte vectors) and parks the rows
//   in shared memory at (bag * S + field), S odd;
// - sum: thread j adds bag j's rows in field order f = 0..F-1 in fp32
//   (rounded once, to bf16 for bf16 tables), reading S apart: 32 banks.
// A row of d elements is split into V-element vectors (16 bytes where d
// and the pointers allow, else V = 1, which serves any d), and a bag's
// cols = d / V vectors over P lanes (P the power of two >= cols, at most
// 256; blockIdx.y takes the next 256 vectors of wider rows).  The wrapper
// (`ops.py:staged_geometry`) chooses TB, FC, S and P.
//
// A row window.  `table` may be one rank's block of a table split by rows
// (a recsys table over a mesh): rows `row0 .. row0 + nrows - 1` of the
// global table.  An id outside that window is skipped: its row is never
// loaded (the test is one unsigned compare of id - row0 against nrows,
// beside the row load) and a zero is parked in its slot, so the sum phase
// adds the window's rows in field order as before (+0 changes no fp32
// sum).  With row0 = 0 and the whole table every id passes and the output
// is the unwindowed kernel's, bit for bit.  Ids are global row ids; an id
// inside the window must exist, and nothing else is checked here.
//
// Bound on the card: the row lookups.  The function reads 4*B*F bytes of
// ids and B*F*d*elt bytes of rows and writes B*d*elt bytes, one add per row
// element, over 3.35 TB/s.  But each lookup of a row narrower than 32
// bytes moves a whole 32-byte sector from L2 (Wide&Deep's 35.7 MB wide
// table stays in the 50 MB L2; an L2-flushed call is ~0.006 ms slower),
// and random sector reads run at ~95-127 G/s from L2 and ~330 G/s from L1
// on the card.  At serve_bulk (262,144 x 40 lookups) the 16 fields of
// 100 K to 1 M rows alone take ~0.044 ms, the 24 small ones ~0.037.  The
// first design (a thread per bag loading its own ids, now only in
// `scripts/bag_designs.cu`) read each warp's ids from 32 sectors a load
// (32 bags' ids 160 bytes apart): 0.116 ms against 0.081.  Field-major
// threads, small fields' rows staged in shared memory, and the table read
// past L1 or under L2 evict_last measured slower or equal; cp.async
// gathers were ~3% faster for 4- and 16-byte rows only, not worth a
// second kernel (PERF.md §6; `scripts/bag_designs.py`).
#include "../attn_common.cuh"

namespace {

constexpr int kThreads = 256;
// shared memory of a block's tile of gathered rows (no attribute needed)
constexpr int kStageBytes = 48 * 1024;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

// An int read once: not allocated in L1, first out of L2.
__device__ __forceinline__ int ld_once(const int* p, uint64_t policy) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// A staged call's geometry (`ops.py:staged_geometry`).
struct Staged {
  int lgP;  // log2 of the lanes of a bag
  int TB;   // bags of a tile
  int FC;   // fields of a chunk
  int S;    // odd field stride of the tile in shared memory, S >= FC
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bag_staged_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                  T* __restrict__ out, int B, int F, int cols, int row0, int nrows,
                  Staged g) {
  using PK = Pack<T, V>;
  constexpr int kBatch = sizeof(PK) == 16 ? 4 : 8;  // row loads in flight a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PK* vals = reinterpret_cast<PK*>(smem_raw);
  const int t = threadIdx.x;
  const int P = 1 << g.lgP;
  const int c = t & (P - 1);
  const int col = (int)blockIdx.y * P + c;
  const bool live = col < cols;
  const long long b0 = (long long)blockIdx.x * g.TB;
  const int nb = (int)min((long long)g.TB, (long long)B - b0);
  const int j = t >> g.lgP;  // the bag this thread sums
  const int rps = kThreads >> g.lgP;
  const int* tile = ids + b0 * F;
  const PK* rows = reinterpret_cast<const PK*>(table);
  uint64_t stream;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(stream));
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int f0 = 0; f0 < F; f0 += g.FC) {
    const int fc = min(g.FC, F - f0);
    const int units = nb * fc;  // (bag jj, field ff) pairs, ff fastest
    const int dj = rps / fc, df = rps - dj * fc;
    int u = t >> g.lgP;
    int jj = u / fc, ff = u - jj * fc;
    for (; u < units; u += kBatch * rps) {
      int id[kBatch], at[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        at[k] = -1;
        id[k] = 0;
        if (u + k * rps < units) {
          at[k] = (jj * g.S + ff) * P + c;
          id[k] = ld_once(tile + (long long)jj * F + f0 + ff, stream) - row0;
        }
        jj += dj;
        ff += df;
        if (ff >= fc) {
          ff -= fc;
          ++jj;
        }
      }
      if (live) {
        PK x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (at[k] < 0) continue;
          if ((unsigned)id[k] < (unsigned)nrows) {
            x[k] = rows[(size_t)(unsigned)id[k] * cols + col];
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[k].e[v] = rt::from_f<T>(0.f);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (at[k] >= 0) vals[at[k]] = x[k];
      }
    }
    __syncthreads();
    if (j < nb && live) {
      const PK* mine = vals + (size_t)j * g.S * P + c;
      for (int f = 0; f < fc; ++f) {
        const PK x = mine[f * P];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += rt::to_f(x.e[v]);
      }
    }
    __syncthreads();
  }
  if (j < nb && live) {
    PK y;
#pragma unroll
    for (int v = 0; v < V; ++v) y.e[v] = rt::from_f<T>(acc[v]);
    reinterpret_cast<PK*>(out)[(b0 + j) * cols + col] = y;
  }
}

template <typename T, int V>
cudaError_t launch_staged(const void* table, const void* ids, void* out, int B, int F,
                          int d, int row0, int nrows, Staged g, cudaStream_t st) {
  const int cols = d / V;
  if (g.lgP < 0 || g.lgP > 8) return cudaErrorInvalidValue;
  const int P = 1 << g.lgP;
  const long long smem = (long long)g.TB * g.S * P * sizeof(Pack<T, V>);
  if ((P < cols && P != kThreads) || (P > 1 && P / 2 >= cols) || g.TB < 1 ||
      g.TB * P > kThreads || g.FC < 1 || g.S < g.FC || g.S % 2 == 0 || smem > kStageBytes)
    return cudaErrorInvalidValue;
  const long long tiles = ((long long)B + g.TB - 1) / g.TB;
  const int cblocks = (cols + P - 1) / P;
  if (tiles > 0x7fffffffLL || cblocks > 65535) return cudaErrorInvalidValue;
  bag_staged_kernel<T, V><<<dim3((unsigned)tiles, cblocks), kThreads, (size_t)smem, st>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids), static_cast<T*>(out),
      B, F, cols, row0, nrows, g);
  return cudaGetLastError();
}

}  // namespace

// table: (rows, d); ids: (B, F) int32; out: (B, d), all contiguous, table
// and out of one dtype.  `vec` = 1 selects 16-byte vectors (the wrapper
// checks that d is a multiple of the vector and the pointers' alignment);
// (lgP, TB, FC, S) the staged kernel's geometry (`ops.py:staged_geometry`);
// the table holds global rows row0 .. row0 + nrows - 1 (the row window).
extern "C" int rt_embedding_bag(const void* table, const void* ids, void* out,
                                int B, int F, int d, int dtype, int vec,
                                int lgP, int TB, int FC, int S, int row0, int nrows,
                                void* stream) {
  if (B < 1 || F < 0 || d < 1 || row0 < 0 || nrows < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Staged g{lgP, TB, FC, S};
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    constexpr int V = 16 / sizeof(T);
    if (vec && d % V != 0) return cudaErrorInvalidValue;
    return vec ? launch_staged<T, V>(table, ids, out, B, F, d, row0, nrows, g, st)
               : launch_staged<T, 1>(table, ids, out, B, F, d, row0, nrows, g, st);
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
// kernel.  On a row window (the forward's) an id outside rows row0 ..
// row0 + rows - 1 issues no atomic and is not used as an address; with
// row0 = 0 and the whole table nothing changes.
//
// Bound on the card: the atomics' throughput in L2.  Wide&Deep's
// train_batch call (ids 65,536 x 40 into the 8,933,376 x 1 fp32 wide
// table) needs 10.5 MB of ids, the 35.7 MB zero fill and 2.6 M
// read-modify-writes of 4 bytes: ~0.014 ms of useful bytes.  Measured on
// the card: 524 K atomics take ~0.008 ms into rows they seldom share (~69
// G/s) and ~0.015 ms into the 8 K rows of eight 1 K-row fields (~65 adds
// a row); the call's kernel ~0.040-0.043 ms, the fill 0.010 (its bound).
// Summing fields in shared memory first (float atomics there are
// compare-and-swap loops), overlapping the fill with the small fields'
// atomics, field-major thread order and a grid-stride loop all measured
// slower, so this is still the first design (PERF.md §6;
// `scripts/bag_designs.py`).
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_bwd_kernel(const int* __restrict__ ids, const T* __restrict__ dout,
               float* __restrict__ grad, int B, int F, int d, long long row0,
               long long rows) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)B * F * d) return;
  const long long bf = g / d;
  const int c = (int)(g - bf * d);
  const long long b = bf / F;
  const long long row = (long long)__ldg(ids + bf) - row0;
  if ((unsigned long long)row < (unsigned long long)rows)
    atomicAdd(grad + (size_t)row * d + c, rt::to_f(dout[b * d + c]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round_kernel(const float* __restrict__ src, T* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) dst[i] = rt::from_f<T>(src[i]);
}

}  // namespace

// ids (B, F) int32 global row ids; the window holds rows row0 .. row0 +
// rows - 1; dout (B, d) of the table's dtype; grad (rows, d) fp32,
// zeroed by the caller; out (rows, d) of the table's dtype (for fp32, the
// same buffer as grad: nothing is rounded).  All contiguous.
extern "C" int rt_bag_backward(const void* ids, const void* dout, void* grad, void* out,
                               int B, int F, int d, long long rows, long long row0,
                               int dtype, void* stream) {
  if (B < 1 || F < 0 || d < 1 || rows < 1 || row0 < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    const long long n = (long long)B * F * d;
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (blocks > 0) {
      bag_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const int*>(ids), static_cast<const T*>(dout),
          static_cast<float*>(grad), B, F, d, row0, rows);
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
