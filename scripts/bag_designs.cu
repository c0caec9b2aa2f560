// The embedding bag's (B5) and its gradient's (K7) candidate designs for
// Hopper, as measured against each other on the card: a standalone
// library for `scripts/bag_designs.py`, which builds it with nvcc and
// times every design at Wide&Deep's calls against the port's own kernels.
// The port keeps the winners in `src/repro_torch/kernels/embedding_bag/
// bag.cu` (B5's staged tiles, K7's first design), which the script times
// from the port's library; this file holds only the designs that lost
// (PERF.md §6).  The staged variants below are the port's kernel with one
// change each.
//
// B5 (`bd_bag`, `design`):
//   0 the first design: a thread per (bag, vector), its own ids, 8 loads;
//   1 staged tiles with 16 loads in flight a thread (16-byte rows: 8; the
//     port's: 8 / 4), at most `tile_cap` bags a tile;
//   5 field-major: a thread owns 8 bags 256 apart and walks the fields 8 at
//     a time (d = 1);
//   7 staged (8 loads) with the fields in the 128-bit mask (m0, m1) read
//     past L1 (ld.global.nc.L1::no_allocate);
//   10 persistent field-major blocks of 512 threads that copy the rows of
//     the `plan`'s field groups (f0, f1, lo, n) into shared memory (two
//     buffers, cp.async) and look those fields up there (d = 1);
//   11 staged (8 loads) with the rows copied by cp.async straight into the
//     tile (4-byte rows);
//   12 / 13 staged with every table load under an L2 evict_last policy,
//     allocated in L1 / not (4- and 16-byte rows).
// K7 (`bd_bwd`, `design`; the port's kernel is the first design, an
// atomic a (b, f) into a gradient the caller zeroes): 1 the `plan`'s field
// groups summed in shared memory first (float atomics there), then one
// global atomic a row, `updates` adds a row a block; 2 the `plan`'s field
// run (f0, f1, lo, hi): its rows zeroed by the caller, then one launch
// that zeroes the other rows in 2 x `updates` blocks while the rest add
// that run's updates, then the other updates; 3 grid-stride, 132 x
// `updates` blocks; 4 the ids read past L1 and first out of L2, the fill
// done by a kernel of the library with L2 evict_last stores.
#include <algorithm>
#include <cstring>

#include "attn_small.cuh"

namespace {

constexpr int kThreads = 256;
// dynamic shared memory of a staged block: a tile of gathered rows
constexpr int kStageBytes = 48 * 1024;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

// L2 policies: evict_first for data read once (the ids), evict_last for
// data read again (the table).
__device__ __forceinline__ uint64_t policy_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// An int read once: not allocated in L1, first out of L2.
__device__ __forceinline__ int ld_once(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// A 4- or 16-byte table vector under the L2 cache policy `pol`, allocated
// in L1 or not (kPast).
template <typename PK, bool kPast>
__device__ __forceinline__ PK ld_policy(const PK* p, uint64_t pol) {
  PK x;
  if constexpr (sizeof(PK) == 4) {
    unsigned v;
    if constexpr (kPast)
      asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
          : "=r"(v) : "l"(p), "l"(pol));
    else
      asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
    memcpy(&x, &v, 4);
  } else {
    static_assert(sizeof(PK) == 16, "4- or 16-byte vectors");
    uint4 v;
    if constexpr (kPast)
      asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
    else
      asm("ld.global.nc.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
    memcpy(&x, &v, 16);
  }
  return x;
}

// A table vector (2, 4, 8 or 16 bytes) not allocated in L1.
template <typename PK>
__device__ __forceinline__ PK ld_past_l1(const PK* p) {
  PK x;
#define RT_LD(OP, ...) asm("ld.global.nc.L1::no_allocate." OP : __VA_ARGS__);
    if constexpr (sizeof(PK) == 2) {
      unsigned short v;
      RT_LD("b16 %0, [%1];", "=h"(v) : "l"(p))
      memcpy(&x, &v, 2);
    } else if constexpr (sizeof(PK) == 4) {
      unsigned v;
      RT_LD("b32 %0, [%1];", "=r"(v) : "l"(p))
      memcpy(&x, &v, 4);
    } else if constexpr (sizeof(PK) == 8) {
      uint2 v;
      RT_LD("v2.b32 {%0, %1}, [%2];", "=r"(v.x), "=r"(v.y) : "l"(p))
      memcpy(&x, &v, 8);
    } else {
      uint4 v;
      RT_LD("v4.b32 {%0, %1, %2, %3}, [%4];", "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
            : "l"(p))
      memcpy(&x, &v, 16);
    }
#undef RT_LD
  return x;
}

// ---------------------------------------------------------------- first
// The first design: one thread per (bag, V-column vector), F loads each.
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

// --------------------------------------------------------------- staged
// Launch geometry of a staged call (host-chosen).
struct Staged {
  int lgP;  // log2 of the lanes of a bag (P = 1 << lgP >= cols, or kThreads)
  int TB;   // bags of a tile
  int FC;   // fields of a chunk
  int S;    // odd field stride of the value tile (S >= FC)
};

template <typename T, int V, int kBatch, int kHint>
__global__ void __launch_bounds__(kThreads)
bag_staged_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                  T* __restrict__ out, int B, int F, int cols, Staged g,
                  unsigned long long m0, unsigned long long m1) {
  using PK = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PK* vals = reinterpret_cast<PK*>(smem_raw);
  const int t = threadIdx.x;
  const int P = 1 << g.lgP;
  const int c = t & (P - 1);
  const int col = (int)blockIdx.y * P + c;
  const bool live = col < cols;
  const long long b0 = (long long)blockIdx.x * g.TB;
  const int nb = (int)min((long long)g.TB, (long long)B - b0);
  const int j = t >> g.lgP;
  const int rps = kThreads >> g.lgP;
  const int* tile = ids + b0 * F;
  const PK* rows = reinterpret_cast<const PK*>(table);
  const uint64_t pol_ids = policy_first();
  uint64_t keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int f0 = 0; f0 < F; f0 += g.FC) {
    const int fc = min(g.FC, F - f0);
    const int units = nb * fc;
    const int dj = rps / fc, df = rps - dj * fc;
    int u = t >> g.lgP;
    int jj = u / fc, ff = u - jj * fc;
    for (; u < units; u += kBatch * rps) {
      int id[kBatch], at[kBatch];
      bool str[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        at[k] = -1;
        id[k] = 0;
        str[k] = false;
        if (u + k * rps < units) {
          at[k] = (jj * g.S + ff) * P + c;
          id[k] = ld_once(tile + (long long)jj * F + f0 + ff, pol_ids);
          const int fa = f0 + ff;
          str[k] = fa < 64 ? (m0 >> fa) & 1 : fa < 128 ? (m1 >> (fa - 64)) & 1 : 0;
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
        for (int k = 0; k < kBatch; ++k)
          if (at[k] >= 0) {
            const PK* src = rows + (size_t)id[k] * cols + col;
            if constexpr (kHint >= 2) x[k] = ld_policy<PK, kHint == 3>(src, keep);
            else x[k] = (kHint && str[k]) ? ld_past_l1(src) : *src;
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

// --------------------------------------------------------------- fields
// d = 1: thread t of block blk owns the bags b0 + t + kThreads * k (k < K),
// b0 = blk * kThreads * K, and walks the fields in order, FG at a time: the
// ids of its K bags (through L1: the 8 ids of a sector serve 8 fields),
// then the K x FG rows, then the adds in field order.  A block's lookups
// of one field come together, so a small field's rows stay in L1.
template <typename T, int K, int FG>
__global__ void __launch_bounds__(kThreads)
bag_fields_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                  T* __restrict__ out, int B, int F) {
  const long long b0 = (long long)blockIdx.x * kThreads * K + threadIdx.x;
  float acc[K];
  int nk = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = 0.f;
    nk += b0 + (long long)k * kThreads < B;
  }
  const int* bag = ids + b0 * F;
  const long long step = (long long)kThreads * F;
  for (int f0 = 0; f0 < F; f0 += FG) {
    const int fg = min(FG, F - f0);
    int id[K][FG];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int f = 0; f < FG; ++f)
        id[k][f] = (k < nk && f < fg) ? __ldg(bag + k * step + f0 + f) : 0;
    T x[K][FG];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int f = 0; f < FG; ++f)
        if (k < nk && f < fg) x[k][f] = table[id[k][f]];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int f = 0; f < FG; ++f)
        if (k < nk && f < fg) acc[k] += rt::to_f(x[k][f]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < nk) out[b0 + (long long)k * kThreads] = rt::from_f<T>(acc[k]);
}

template <typename T, int K, int FG>
cudaError_t launch_fields(const void* table, const void* ids, void* out, int B, int F,
                          cudaStream_t st) {
  const long long blocks = ((long long)B + kThreads * K - 1) / (kThreads * K);
  bag_fields_kernel<T, K, FG><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids), static_cast<T*>(out), B, F);
  return cudaGetLastError();
}

// ------------------------------------------------------------ persistent
constexpr int kPThreads = 512;
constexpr int kPMaxGroups = 16;

// Field groups whose rows a block copies to shared memory: fields [f0, f1)
// read rows [lo, lo + n) (lo 16-byte aligned).
struct StagePlan {
  int groups;
  int f0[kPMaxGroups], f1[kPMaxGroups], n[kPMaxGroups];
  long long lo[kPMaxGroups];
};

template <typename T, int K>
__global__ void __launch_bounds__(kPThreads, 1)
bag_persist_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                   T* __restrict__ out, int B, int F, int per_block, int buf_elems,
                   StagePlan sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = (int)min((long long)per_block, (long long)B - b0);
  float acc[K];
  bool live[K];
  const int* bag[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t + k * kPThreads;
    live[k] = j < nb;
    bag[k] = ids + (b0 + (live[k] ? j : 0)) * F;
    acc[k] = 0.f;
  }
  constexpr int E = 16 / sizeof(T);
  auto stage = [&](int i) {
    T* dst = bufs + (i & 1) * buf_elems;
    const T* src = table + sp.lo[i];
    const int n = sp.n[i], n16 = n / E;
    for (int c = t; c < n16; c += kPThreads) rt::cp16(dst + c * E, src + c * E);
    for (int e = n16 * E + t; e < n; e += kPThreads) dst[e] = src[e];
    rt::commit();
  };
  int gi = 0;
  if (sp.groups > 0) stage(0);
  int f = 0;
  while (f < F) {
    const bool staged = gi < sp.groups && f == sp.f0[gi];
    int fend = gi < sp.groups ? sp.f0[gi] : F;
    if (staged) {
      fend = sp.f1[gi];
      if (gi + 1 < sp.groups) {
        stage(gi + 1);
        rt::wait_pending<1>();
      } else {
        rt::wait_pending<0>();
      }
      __syncthreads();
    }
    const T* tab_s = bufs + (gi & 1) * buf_elems;
    const long long lo = staged ? sp.lo[gi] : 0;
    const int n = staged ? sp.n[gi] : 0;
    for (int c0 = f; c0 < fend; c0 += 8) {
      const int fc = min(8, fend - c0);
      int id[K][8];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int q = 0; q < 8; ++q) id[k][q] = (live[k] && q < fc) ? __ldg(bag[k] + c0 + q) : 0;
      float x[K][8];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          x[k][q] = 0.f;
          if (live[k] && q < fc) {
            const long long r = (long long)id[k][q] - lo;
            x[k][q] = rt::to_f((staged && r >= 0 && r < n) ? tab_s[r] : table[id[k][q]]);
          }
        }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (live[k] && q < fc) acc[k] += x[k][q];
    }
    if (staged) {
      __syncthreads();
      ++gi;
    }
    f = fend;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live[k]) out[b0 + t + k * kPThreads] = rt::from_f<T>(acc[k]);
}

template <typename T>
cudaError_t launch_persist(const void* table, const void* ids, void* out, int B, int F,
                           int sms, int groups, const long long* plan, cudaStream_t st) {
  constexpr int K = 4;
  StagePlan sp;
  sp.groups = groups;
  int buf = 0;
  for (int i = 0; i < groups; ++i) {
    sp.f0[i] = (int)plan[4 * i];
    sp.f1[i] = (int)plan[4 * i + 1];
    sp.lo[i] = plan[4 * i + 2];
    sp.n[i] = (int)plan[4 * i + 3];
    if (sp.f0[i] < (i ? sp.f1[i - 1] : 0) || sp.f1[i] <= sp.f0[i] || sp.f1[i] > F ||
        sp.n[i] < 1 || (long long)sp.n[i] * sizeof(T) > kStageBytes ||
        sp.lo[i] % (16 / sizeof(T)))
      return cudaErrorInvalidValue;
    buf = std::max(buf, (sp.n[i] + 7) / 8 * 8);
  }
  const long long per = std::max<long long>(((long long)B + sms - 1) / sms, 1);
  const int per_block = (int)std::min<long long>(per, (long long)K * kPThreads);
  const long long blocks = ((long long)B + per_block - 1) / per_block;
  const int smem = 2 * buf * (int)sizeof(T);
  auto kern = bag_persist_kernel<T, K>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)blocks, kPThreads, smem, st>>>(static_cast<const T*>(table),
                                                 static_cast<const int*>(ids),
                                                 static_cast<T*>(out), B, F, per_block, buf, sp);
  return cudaGetLastError();
}

// staged, the rows copied by cp.async straight into the tile (4- or
// 16-byte rows)
template <typename T, int V, int kBatch>
__global__ void __launch_bounds__(kThreads)
bag_async_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                 T* __restrict__ out, int B, int F, int cols, Staged g) {
  using PK = Pack<T, V>;
  static_assert(sizeof(PK) == 4 || sizeof(PK) == 16, "4- or 16-byte rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PK* vals = reinterpret_cast<PK*>(smem_raw);
  const int t = threadIdx.x;
  const int P = 1 << g.lgP;
  const int c = t & (P - 1);
  const int col = (int)blockIdx.y * P + c;
  const bool live = col < cols;
  const long long b0 = (long long)blockIdx.x * g.TB;
  const int nb = (int)min((long long)g.TB, (long long)B - b0);
  const int j = t >> g.lgP;
  const int rps = kThreads >> g.lgP;
  const int* tile = ids + b0 * F;
  const PK* rows = reinterpret_cast<const PK*>(table);
  const uint64_t pol_ids = policy_first();
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int f0 = 0; f0 < F; f0 += g.FC) {
    const int fc = min(g.FC, F - f0);
    const int units = nb * fc;
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
          id[k] = ld_once(tile + (long long)jj * F + f0 + ff, pol_ids);
        }
        jj += dj;
        ff += df;
        if (ff >= fc) {
          ff -= fc;
          ++jj;
        }
      }
      if (live) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (at[k] >= 0) {
            if constexpr (sizeof(PK) == 16) rt::cp16(vals + at[k], rows + (size_t)id[k] * cols + col);
            else rt::cp4(vals + at[k], rows + (size_t)id[k] * cols + col);
          }
      }
    }
    rt::commit();
    rt::wait_pending<0>();
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
cudaError_t launch_draft(const void* table, const void* ids, void* out, int B, int F,
                         int d, cudaStream_t st) {
  const long long threads = (long long)B * (d / V);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bag_kernel<T, V><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<T*>(out), B, F, d);
  return cudaGetLastError();
}

template <typename T, int V, int kBatch, int kHint = 0, int kAsync = 0>
cudaError_t launch_staged(const void* table, const void* ids, void* out, int B, int F,
                          int d, int sms, int tile_cap, cudaStream_t st,
                          unsigned long long m0 = 0, unsigned long long m1 = 0) {
  const int cols = d / V;
  const int sz = (int)sizeof(Pack<T, V>);
  Staged g;
  g.lgP = 0;
  while ((1 << g.lgP) < cols && (1 << g.lgP) < kThreads) ++g.lgP;
  const int P = 1 << g.lgP;
  int tb = kThreads / P;
  if (tile_cap > 0) tb = std::min(tb, tile_cap);
  // small batches: spread the bags so that each SM gets two tiles
  const long long spread = ((long long)B + 2LL * sms - 1) / (2LL * sms);
  g.TB = (int)std::max(1LL, std::min((long long)tb, spread));
  const int smax = kStageBytes / (g.TB * P * sz);
  g.FC = std::max(1, std::min(F, smax));
  g.S = g.FC | 1;
  if (g.S > smax) {
    --g.FC;
    g.S = g.FC | 1;
  }
  const int smem = g.TB * g.S * P * sz;
  const long long tiles = ((long long)B + g.TB - 1) / g.TB;
  const int cblocks = (cols + P - 1) / P;
  if (tiles > 0x7fffffffLL || cblocks > 65535) return cudaErrorInvalidValue;
  if constexpr (kAsync) {
    bag_async_kernel<T, V, kBatch><<<dim3((unsigned)tiles, cblocks), kThreads, smem, st>>>(
        static_cast<const T*>(table), static_cast<const int*>(ids), static_cast<T*>(out),
        B, F, cols, g);
  } else {
    bag_staged_kernel<T, V, kBatch, kHint>
        <<<dim3((unsigned)tiles, cblocks), kThreads, smem, st>>>(
            static_cast<const T*>(table), static_cast<const int*>(ids), static_cast<T*>(out),
            B, F, cols, g, m0, m1);
  }
  return cudaGetLastError();
}

}  // namespace

// table: (rows, d); ids: (B, F) int32; out: (B, d), all contiguous, table
// and out of one dtype.  `vec` = 1 selects 16-byte vectors.  `design` as
// in the head comment; `sms` the card's SMs; `tile_cap` at most this many
// bags a tile (0: 256 / lanes); (m0, m1) design 7's fields; `groups` x 4
// numbers of `plan` design 10's field groups.
extern "C" int bd_bag(const void* table, const void* ids, void* out, int B, int F, int d,
                      int dtype, int vec, int design, int sms, int tile_cap,
                      unsigned long long m0, unsigned long long m1, int groups,
                      const long long* plan, void* stream) {
  if (B < 1 || F < 0 || d < 1 || sms < 1 || ((design == 5 || design == 10) && d != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(dtype, [&](auto t) -> cudaError_t {
    using T = decltype(t);
    constexpr int V = 16 / sizeof(T);
    if (vec && d % V != 0) return cudaErrorInvalidValue;
    switch (design) {
      case 0:
        return vec ? launch_draft<T, V>(table, ids, out, B, F, d, st)
                   : launch_draft<T, 1>(table, ids, out, B, F, d, st);
      case 1:
        return vec ? launch_staged<T, V, 8>(table, ids, out, B, F, d, sms, tile_cap, st)
                   : launch_staged<T, 1, 16>(table, ids, out, B, F, d, sms, tile_cap, st);
      case 5:
        return launch_fields<T, 8, 8>(table, ids, out, B, F, st);
      case 7:
        return vec ? launch_staged<T, V, 4, 1>(table, ids, out, B, F, d, sms, tile_cap, st, m0, m1)
                   : launch_staged<T, 1, 8, 1>(table, ids, out, B, F, d, sms, tile_cap, st, m0, m1);
      case 10:
        return launch_persist<T>(table, ids, out, B, F, sms, groups, plan, st);
      case 11:
        if constexpr (sizeof(T) != 4) {
          return cudaErrorInvalidValue;
        } else {
          if (vec) return cudaErrorInvalidValue;
          return launch_staged<T, 1, 8, 0, 1>(table, ids, out, B, F, d, sms, tile_cap, st);
        }
      case 12:
      case 13:
        if constexpr (sizeof(T) != 4) {
          return cudaErrorInvalidValue;
        } else if (design == 12) {
          return vec ? launch_staged<T, V, 4, 2>(table, ids, out, B, F, d, sms, tile_cap, st)
                     : launch_staged<T, 1, 8, 2>(table, ids, out, B, F, d, sms, tile_cap, st);
        } else {
          return vec ? launch_staged<T, V, 4, 3>(table, ids, out, B, F, d, sms, tile_cap, st)
                     : launch_staged<T, 1, 8, 3>(table, ids, out, B, F, d, sms, tile_cap, st);
        }
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// ---------------------------------------------------------------------------
// K7: the bag sum's gradient, d_table[ids[b, f], :] += d_out[b, :].
//
// The JAX package gets it from autodiff of Wide&Deep's `jnp.take` + sum
// (`src/repro/recsys/models.py:65-66`); its TPU kernel has no backward.
namespace {

// Design 4: the ids read past L1 and first out of L2; the gradient zeroed
// before by `zero_last_kernel`, its lines kept in L2 last.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_bwd_hinted_kernel(const int* __restrict__ ids, const T* __restrict__ dout,
                      float* __restrict__ grad, int B, int F, int d) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)B * F * d) return;
  const long long bf = g / d;
  const int c = (int)(g - bf * d);
  const long long b = bf / F;
  const size_t row = (size_t)ld_once(ids + bf, policy_first());
  atomicAdd(grad + row * d + c, rt::to_f(dout[b * d + c]));
}

__global__ void __launch_bounds__(kThreads)
zero_last_kernel(float* __restrict__ p, long long n) {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride)
    asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;"
                 ::"l"(p + 4 * i), "r"(0), "r"(0), "r"(0), "r"(0), "l"(pol) : "memory");
  for (long long i = 4 * n4 + (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    p[i] = 0.f;
}

// Grid-stride form: a thread takes (b, f, column) items g, g + stride, ..
template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_bwd_gs_kernel(const int* __restrict__ ids, const T* __restrict__ dout,
                  float* __restrict__ grad, int B, int F, int d) {
  const long long n = (long long)B * F * d;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < n; g += stride) {
    const long long bf = g / d;
    const int c = (int)(g - bf * d);
    const long long b = bf / F;
    const size_t row = (size_t)__ldg(ids + bf);
    atomicAdd(grad + row * d + c, rt::to_f(dout[b * d + c]));
  }
}

constexpr int kMaxGroups = 8;

// Field groups whose updates a block sums in shared memory first: fields
// [f0, f1) of group i read rows [lo, lo + rows) (the wrapper's plan); a
// block takes `chunk` bags of one group.  Blocks [first[i], first[i + 1])
// serve group i, the blocks from first[groups] on every other field.
struct Plan {
  int groups;
  int f0[kMaxGroups], f1[kMaxGroups], rows[kMaxGroups], chunk[kMaxGroups];
  long long lo[kMaxGroups];
  int first[kMaxGroups + 1];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_bwd_priv_kernel(const int* __restrict__ ids, const T* __restrict__ dout,
                    float* __restrict__ grad, int B, int F, int d, Plan p) {
  extern __shared__ float sum_s[];
  const int blk = (int)blockIdx.x;
  const uint64_t pol = policy_first();
  if (blk < p.first[p.groups]) {
    int gi = 0;
    while (blk >= p.first[gi + 1]) ++gi;
    const int f0 = p.f0[gi], nf = p.f1[gi] - f0, n = p.rows[gi];
    const long long lo = p.lo[gi];
    for (int i = threadIdx.x; i < n * d; i += kThreads) sum_s[i] = 0.f;
    __syncthreads();
    const long long b0 = (long long)(blk - p.first[gi]) * p.chunk[gi];
    const int units = (int)min((long long)p.chunk[gi], (long long)B - b0) * nf;
    const int dj = kThreads / nf, df = kThreads - dj * nf;
    int j = threadIdx.x / nf, ff = threadIdx.x - j * nf;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const long long b = b0 + j;
      const long long r = (long long)ld_once(ids + b * F + f0 + ff, pol) - lo;
      for (int c = 0; c < d; ++c) {
        const float v = rt::to_f(dout[b * d + c]);
        if (r >= 0 && r < n) atomicAdd(sum_s + r * d + c, v);
        else atomicAdd(grad + (lo + r) * d + c, v);
      }
      j += dj;
      ff += df;
      if (ff >= nf) {
        ff -= nf;
        ++j;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * d; i += kThreads) {
      const float v = sum_s[i];
      if (v != 0.f) atomicAdd(grad + lo * d + i, v);
    }
    return;
  }
  const long long g = (long long)(blk - p.first[p.groups]) * kThreads + threadIdx.x;
  if (g >= (long long)B * F * d) return;
  const long long bf = g / d;
  const int c = (int)(g - bf * d);
  const long long b = bf / F;
  const int f = (int)(bf - b * F);
  for (int i = 0; i < p.groups; ++i)
    if (f >= p.f0[i] && f < p.f1[i]) return;
  const size_t row = (size_t)ld_once(ids + bf, pol);
  atomicAdd(grad + row * d + c, rt::to_f(dout[b * d + c]));
}

// Split design: the fields [fb0, fb1) read rows in [lo, hi), which the
// caller zeroes first.  Pass 1: blocks [0, nfill) zero every other row
// while the rest add the updates of fields [fb0, fb1) that land in
// [lo, hi).  Pass 2 adds every other update.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_bwd_split_kernel(const int* __restrict__ ids, const T* __restrict__ dout,
                     float* __restrict__ grad, int B, int F, int d, long long rows,
                     int fb0, int fb1, long long lo, long long hi, int nfill, int pass) {
  if (pass == 1 && (int)blockIdx.x < nfill) {
    // rows [0, lo) and [hi, rows): 16-byte stores where aligned
    const long long stride = (long long)nfill * kThreads;
    const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
    for (int piece = 0; piece < 2; ++piece) {
      const long long a = piece ? hi * d : 0, b = piece ? rows * d : lo * d;
      const long long a4 = min(b, (a + 3) / 4 * 4), b4 = max(a4, b / 4 * 4);
      for (long long j = a + tid; j < a4; j += stride) grad[j] = 0.f;
      for (long long j = b4 + tid; j < b; j += stride) grad[j] = 0.f;
      for (long long j = a4 / 4 + tid; j < b4 / 4; j += stride)
        reinterpret_cast<float4*>(grad)[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int nf = pass == 1 ? fb1 - fb0 : F;
  const long long g = (long long)((int)blockIdx.x - (pass == 1 ? nfill : 0)) * kThreads +
                      threadIdx.x;
  if (g >= (long long)B * nf * d) return;
  const long long bf = g / d;
  const int c = (int)(g - bf * d);
  const long long b = bf / nf;
  const int f = (int)(bf - b * nf) + (pass == 1 ? fb0 : 0);
  const long long row = ld_once(ids + b * F + f, policy_first());
  const bool early = f >= fb0 && f < fb1 && row >= lo && row < hi;
  if (early == (pass == 1)) atomicAdd(grad + row * d + c, rt::to_f(dout[b * d + c]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round_kernel(const float* __restrict__ src, T* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) dst[i] = rt::from_f<T>(src[i]);
}

}  // namespace

// ids (B, F) int32; dout (B, d) of the table's dtype; grad (rows, d) fp32
// (zeroed by the caller in designs 1 and 3; design 2: its run's rows;
// design 4: not at all, 16-byte aligned); out (rows, d) of the table's
// dtype (for fp32, the same buffer as grad: nothing is rounded).  All
// contiguous.  `groups` x 4 numbers of `plan`: design 1's field groups
// (first field, end field, first row, rows), design 2's run (first field,
// end field, first row, end row).  `updates`: design 1's adds a row from
// a block; design 2's fill blocks / 2; design 3's blocks / 132.
extern "C" int bd_bwd(const void* ids, const void* dout, void* grad, void* out, int B, int F,
                      int d, long long rows, int dtype, int design, int groups,
                      const long long* plan, int updates, void* stream) {
  if (B < 1 || F < 0 || d < 1 || rows < 1 || design < 1 || design > 4 || groups < 0 ||
      groups > kMaxGroups || (design != 1 && design != 2 && groups) || updates < 1 ||
      (design == 2 && groups != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    const long long m = rows * d;
    const long long n = (long long)B * F * d;
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL / 2) return cudaErrorInvalidValue;
    if (design == 4) {
      zero_last_kernel<<<132 * 8, kThreads, 0, st>>>(static_cast<float*>(grad), m);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      if (blocks > 0)
        bag_bwd_hinted_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
            static_cast<const int*>(ids), static_cast<const T*>(dout),
            static_cast<float*>(grad), B, F, d);
    } else if (design == 3 && blocks > 0) {
      bag_bwd_gs_kernel<T><<<(unsigned)std::min<long long>(blocks, 132LL * updates), kThreads,
                             0, st>>>(static_cast<const int*>(ids), static_cast<const T*>(dout),
                                      static_cast<float*>(grad), B, F, d);
    } else if (design == 2 && blocks > 0) {
      const int fb0 = (int)plan[0], fb1 = (int)plan[1];
      const long long lo = plan[2], hi = plan[3];
      if (fb0 < 0 || fb1 <= fb0 || fb1 > F || lo < 0 || hi <= lo || hi > rows)
        return cudaErrorInvalidValue;
      const int nfill = 2 * updates;  // blocks that zero the other rows
      const long long nb1 = ((long long)B * (fb1 - fb0) * d + kThreads - 1) / kThreads;
      bag_bwd_split_kernel<T><<<(unsigned)(nfill + nb1), kThreads, 0, st>>>(
          static_cast<const int*>(ids), static_cast<const T*>(dout), static_cast<float*>(grad),
          B, F, d, rows, fb0, fb1, lo, hi, nfill, 1);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      bag_bwd_split_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const int*>(ids), static_cast<const T*>(dout), static_cast<float*>(grad),
          B, F, d, rows, fb0, fb1, lo, hi, 0, 2);
    } else if (blocks > 0) {
      Plan p;
      p.groups = groups;
      p.first[0] = 0;
      int smem = 0;
      for (int i = 0; i < groups; ++i) {
        p.f0[i] = (int)plan[4 * i];
        p.f1[i] = (int)plan[4 * i + 1];
        p.lo[i] = plan[4 * i + 2];
        p.rows[i] = (int)plan[4 * i + 3];
        const int nf = p.f1[i] - p.f0[i];
        if (nf < 1 || p.f0[i] < 0 || p.f1[i] > F || p.rows[i] < 1 || p.lo[i] < 0 ||
            p.lo[i] + p.rows[i] > rows || (long long)p.rows[i] * d * 4 > kStageBytes ||
            (i > 0 && p.f0[i] < p.f1[i - 1]))
          return cudaErrorInvalidValue;
        // bags a block takes: each row of the group gets `updates` adds
        // from the block on average
        const long long chunk = ((long long)updates * p.rows[i] + nf - 1) / nf;
        p.chunk[i] = (int)std::min<long long>(chunk, B);
        p.first[i + 1] = p.first[i] + (int)((B + p.chunk[i] - 1) / p.chunk[i]);
        smem = std::max(smem, p.rows[i] * d * 4);
      }
      bag_bwd_priv_kernel<T><<<(unsigned)(p.first[groups] + blocks), kThreads, smem, st>>>(
          static_cast<const int*>(ids), static_cast<const T*>(dout),
          static_cast<float*>(grad), B, F, d, p);
    }
    if (blocks > 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (static_cast<void*>(grad) == out) return cudaSuccess;
    round_kernel<T><<<(unsigned)((m + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(grad), static_cast<T*>(out), m);
    return cudaGetLastError();
  });
}
