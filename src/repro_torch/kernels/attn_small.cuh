// Small-head attention on the CUDA cores, shared by the port's attention
// kernels: the cp.async helpers and shared-memory row reads of the
// small-head routes (K6's backward in `flash_attention/flash_bwd.cu`), and
// the small-head forward kernel that B1 (`flash_attention/flash.cu`) and
// B2 (`selective_attention/selective.cu`) instantiate with their masks.
//
// The forward (`rt::small::fwd_kernel`, D <= 32, any dtype of q, k and v):
// softmax(q.k / sqrt(D)) v over a row's live keys, with the SIMT route's
// numerics (fp32 scores, probabilities rounded to the value dtype before
// the PV product, the denominator clamped at 1e-30; a row with no live
// key gets the plain version's uniform softmax over every key, the mean
// of V weighted by 1/Skv rounded to the value dtype).
//
// What bounds it on the card: at D <= 32 a (query, head) row's whole state
// (q, the running max and sum, the accumulator) fits a thread's
// registers, and the work is a few hundred thousand to a million rows x
// keys of 2 D FMAs each.  Every such pair also reads the key's K and V rows
// from shared memory into registers, so the call is bound by shared-memory
// loads (a warp's 16-byte load costs ~2 cycles of an SM when each quarter
// of the warp reads one address, 4 when they are all distinct) and, for
// few rows over many keys, by latency.  The design:
// - a block's rows are (query, head) pairs of one kv head of one batch row,
//   the G heads of a kv group packed together (row r: query r / G, head
//   hk G + r % G), so each K/V tile in shared memory serves all G heads;
// - a warp holds 8 rows x 4 quarters, a row's threads being the 4 quarters
//   of W warps (S = 4 W splits, split s taking keys s, s + S, .. of every
//   tile): the 8 lanes of a quarter read the same K/V row (a broadcast) and
//   the 4 quarters 4 consecutive rows (different banks: rows padded to an
//   odd number of 16-byte chunks), the ~2-cycle load.  W is 4 where all
//   rows at 16 threads fit one wave of resident blocks (the selective call:
//   few rows, many keys), else 1;
// - a thread's keys of a tile are scored first (one max, one rescale of
//   the accumulator a tile), then accumulated; a thread with no live key
//   in the tile skips it; the splits' (m, l, acc) merge once at the end in
//   a fixed order (the quarters by shuffles, the warps through shared
//   memory): no per-tile reductions, no atomics, so two calls are bitwise
//   equal;
// - 64-key K/V tiles stream through a 3-stage cp.async ring sized to the
//   padded D (8, 16 or 32), 16-byte copies where rows are whole 16-byte
//   chunks and 4-byte copies otherwise; the rows' mask bytes are fetched a
//   tile ahead; tiles the mask rules out for every row of the block
//   (causal, or B2's liveness map) are never loaded;
// - rows per block are chosen at launch so that the grid puts at least one
//   block on each SM where the call has the rows for it.
#pragma once

#include <climits>

#include "attn_common.cuh"

namespace rt {

// Asynchronous copies into shared memory of 16 bytes (.cg) or 4 (.ca).
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T (4 fp32 or 8 bf16 values) as fp32, into x[0 ..).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 u, float* x) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      x[j] = __uint_as_float(w[j]);
    } else {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
}

// One row of DP elements of T in shared memory (16-byte aligned) as fp32,
// read with 16-byte loads.
template <typename T, int DP>
__device__ __forceinline__ void row_f(const T* src, float (&x)[DP]) {
  constexpr int kE = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < DP / kE; ++c) unpack16<T>(reinterpret_cast<const uint4*>(src)[c], x + kE * c);
}

namespace small {

constexpr int kKeys = 64;        // keys of a tile
constexpr int kStages = 3;       // tiles in flight: the one computed, two landing
constexpr int kRowsPerWarp = 8;  // a warp: 8 rows x 4 quarters, lane = quarter * 8 + row
constexpr int kMaxThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// A dead key's score: -inf, so its exp2 is exactly 0 whatever the running
// max (which starts at the finite kNegInf)
__device__ __forceinline__ float dead_score() { return __int_as_float(0xff800000); }

// A call: q (B, Sq, Hq, D) of q_dtype, k / v (B, Skv, Hkv, D), out like q.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Hq, Hkv, D;
  int q_bf16;  // q and out are bf16 (else fp32)
  int copy;    // K/V tile copies: 2 = 16-byte, 1 = 4-byte cp.async, 0 = element loads
  float scale2;  // 1 / sqrt(D) * log2(e)
};

// Bytes of a tile row of DP elements of T in shared memory: whole 16-byte
// chunks, an odd number of them, so that the 4 consecutive rows a warp's
// quarters read at once fall in different groups of 4 banks (a 16-byte
// load then costs the card's minimum of ~2 cycles a warp, every lane of a
// quarter reading one address; 4 when the quarters collide).
template <typename T, int DP>
__host__ __device__ constexpr int row_bytes() {
  constexpr int u = DP * (int)sizeof(T) / 16;
  return (u % 2 ? u : u + 1) * 16;
}

template <typename TK, typename TV, int DP>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kKeys * (row_bytes<TK, DP>() + row_bytes<TV, DP>());
}

// Rows [r0, r0 + 64) of a (.., H, D) tensor (rows `stride` elements apart,
// the first at `base`) into a tile of 64 rows of row_bytes<T, DP>() by the
// block's threads; rows at or past n are zeros.  Columns D..DP-1 are never
// written (the kernel zeroes them once).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(unsigned char* tile, const T* base, size_t stride,
                                          int r0, int n, int D, int mode) {
  constexpr int kRB = row_bytes<T, DP>();
  if (mode == 2) {
    constexpr int kC = DP * (int)sizeof(T) / 16;   // 16-byte chunks of a row's DP elements
    const int real = D * (int)sizeof(T) / 16;
    for (int e = threadIdx.x; e < kKeys * kC; e += blockDim.x) {
      const int r = e / kC, c = e % kC;
      if (c >= real) continue;
      unsigned char* dst = tile + r * kRB + 16 * c;
      if (r0 + r < n)
        cp16(dst, reinterpret_cast<const char*>(base + (size_t)(r0 + r) * stride) + 16 * c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else if (mode == 1) {
    constexpr int kW = DP * (int)sizeof(T) / 4;    // 4-byte words of a row's DP elements
    const int real = D * (int)sizeof(T) / 4;
    for (int e = threadIdx.x; e < kKeys * kW; e += blockDim.x) {
      const int r = e / kW, w = e % kW;
      if (w >= real) continue;
      unsigned char* dst = tile + r * kRB + 4 * w;
      if (r0 + r < n)
        cp4(dst, reinterpret_cast<const char*>(base + (size_t)(r0 + r) * stride) + 4 * w);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0u;
    }
  } else {
    for (int e = threadIdx.x; e < kKeys * DP; e += blockDim.x) {
      const int r = e / DP, d = e % DP;
      if (d >= D) continue;
      reinterpret_cast<T*>(tile + r * kRB)[d] =
          r0 + r < n ? base[(size_t)(r0 + r) * stride + d] : from_f<T>(0.f);
    }
  }
}

// q . k over DP elements as two interleaved partial sums.
template <int DP>
__device__ __forceinline__ float dot(const float (&x)[DP], const float (&y)[DP]) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int d = 0; d < DP; d += 2) {
    a0 = fmaf(x[d], y[d], a0);
    a1 = fmaf(x[d + 1], y[d + 1], a1);
  }
  return a0 + a1;
}

// The forward over one block of rows.  A row's threads are the 4 quarters
// of each of W warps (split = warp * 4 + quarter, S = 4 W splits), split s
// taking keys s, s + S, .. of every tile; a quarter's 8 lanes are 8 rows.
// `Mask` (B1's or B2's) gives:
//   Row row(a, b, h, qi)               a row's mask state (qi < Sq)
//   bool all_keys(row)                 the row sees no key whatever the data
//                                      (B2's pad rows): it takes the uniform
//                                      softmax over every key
//   unsigned flag(a, row, kj)          the row's mask byte of key kj < Skv
//                                      (a load, fetched a tile ahead)
//   bool ok(a, row, kj, flag)          key kj (< Skv) live for the row
//   int key_end(a, q_last)             keys past it are dead for every row
//   bool tile_live(a, b, hk, qf, ql, k0, k1)  keys k0..k1 may hold a live key
//                                      for a row of queries qf..ql (a superset)
template <class Mask, typename TK, typename TV, int DP, int W>
__global__ void __launch_bounds__(kMaxThreads) fwd_kernel(Args a, Mask mask) {
  constexpr int S = 4 * W;          // threads a row
  constexpr int kPer = kKeys / S;   // a thread's keys of a tile
  constexpr int kF = (DP + 2) * kRowsPerWarp;   // a warp's (m, l, acc) of its 8 rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.Hq / a.Hkv, D = a.D;
  const int lane = threadIdx.x & 31, rr = lane % kRowsPerWarp, quarter = lane / kRowsPerWarp;
  const int warp = threadIdx.x >> 5, grp = warp / W, w = warp % W;
  const int split = w * 4 + quarter;
  const int nrows = blockDim.x / S;
  const int b = blockIdx.z, hk = blockIdx.y;
  // the last rows first: under a causal mask they see the most keys
  const int r0 = (gridDim.x - 1 - blockIdx.x) * nrows;
  const int r = r0 + grp * kRowsPerWarp + rr;
  const int qi = r / G, h = hk * G + r % G;
  const bool rok = qi < a.Sq;
  const int q_first = r0 / G, q_last = min(a.Sq - 1, (r0 + nrows - 1) / G);
  const size_t kstride = (size_t)a.Hkv * D;
  const TK* kbase = static_cast<const TK*>(a.k) + ((size_t)b * a.Skv * a.Hkv + hk) * D;
  const TV* vbase = static_cast<const TV*>(a.v) + ((size_t)b * a.Skv * a.Hkv + hk) * D;

  // stage st: K then V, 64 rows each; addresses computed from st (an
  // indexed array of stage pointers would live in local memory); then one
  // live flag a key tile
  constexpr int kRK = row_bytes<TK, DP>(), kRV = row_bytes<TV, DP>();
  constexpr size_t kStage = stage_bytes<TK, TV, DP>();
  auto ks = [&](int st) { return smem + st * kStage; };
  auto vs = [&](int st) { return smem + st * kStage + kKeys * kRK; };
  int* flags = reinterpret_cast<int*>(smem + kStages * kStage);
  if (D < DP) {   // pad columns: zero once, never written again
    for (int e = threadIdx.x; e < kStages * kKeys * (DP - D); e += blockDim.x) {
      const int row = e / (DP - D), col = D + e % (DP - D);
      reinterpret_cast<TK*>(ks(row / kKeys) + (row % kKeys) * kRK)[col] = from_f<TK>(0.f);
      reinterpret_cast<TV*>(vs(row / kKeys) + (row % kKeys) * kRV)[col] = from_f<TV>(0.f);
    }
  }

  // the row: q pre-scaled by 1/sqrt(D) log2(e), zero past D.  A row that
  // sees no key whatever the data (`all_keys`) takes every key with the
  // score 0 (q = 0): the plain version's uniform softmax over all-masked
  // scores, whose weight 1/Skv (in the value dtype) it applies at the end
  const typename Mask::Row mr = mask.row(a, b, h, rok ? qi : q_first);
  const bool all = rok && mask.all_keys(mr);
  const size_t orow = (((size_t)b * a.Sq + (rok ? qi : q_first)) * a.Hq + h) * D;
  float q[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    float x = 0.f;
    if (d < D && !all)
      x = a.q_bf16 ? to_f(static_cast<const __nv_bfloat16*>(a.q)[orow + d])
                   : static_cast<const float*>(a.q)[orow + d];
    q[d] = x * a.scale2;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int nt_mask = (mask.key_end(a, q_last) + kKeys - 1) / kKeys;
  for (int t = threadIdx.x; t < nt_mask; t += blockDim.x)
    flags[t] = mask.tile_live(a, b, hk, q_first, q_last, t * kKeys,
                              min(a.Skv, (t + 1) * kKeys) - 1);
  // a block with an all-keys row walks every key tile; others only the
  // tiles some row may see
  const bool block_all = __syncthreads_or(all);   // also: flags and pad columns written
  const int nt = block_all ? (a.Skv + kKeys - 1) / kKeys : nt_mask;
  auto next_live = [&](int t) {
    while (!block_all && t < nt && !flags[t]) ++t;
    return t;
  };
  auto load = [&](int t, int st) {   // a group per tile, empty past the last
    if (t < nt) {
      load_tile<TK, DP>(ks(st), kbase, kstride, t * kKeys, a.Skv, D, a.copy);
      load_tile<TV, DP>(vs(st), vbase, kstride, t * kKeys, a.Skv, D, a.copy);
    }
    commit();
  };
  // the row's mask bytes of the thread's keys of a tile, fetched a tile
  // ahead, 4 to a word
  unsigned fl[(kPer + 3) / 4];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < (kPer + 3) / 4; ++i) fl[i] = 0u;
    if (!rok || all || t >= nt) return;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kj = t * kKeys + split + S * i;
      if (kj < a.Skv) fl[i / 4] |= mask.flag(a, mr, kj) << (8 * (i % 4));
    }
  };
  // bit i: key k0 + split + S i live for the row
  auto live_bits = [&](int k0) {
    unsigned live = 0;
    if (!rok) return live;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kj = k0 + split + S * i;
      const bool ok = kj < a.Skv &&
                      (all || mask.ok(a, mr, kj, (fl[i / 4] >> (8 * (i % 4))) & 0xffu));
      live |= (unsigned)ok << i;
    }
    return live;
  };

  int t = next_live(0), st = 0;
  int t1 = t < nt ? next_live(t + 1) : nt;
  load(t, 0);
  load(t1, 1);
  fetch(t);
  while (t < nt) {
    wait_pending<1>();   // tile t landed (t1 may still be landing)
    __syncthreads();     // ... for every thread; all done with the last stage
    const int t2 = t1 < nt ? next_live(t1 + 1) : nt;
    load(t2, (st + 2) % kStages);
    const unsigned live = live_bits(t * kKeys);
    fetch(t1);
    // the quarters of a warp read 4 consecutive tile rows at once
    const unsigned char* K = ks(st) + split * kRK;
    const unsigned char* V = vs(st) + split * kRV;
    if (live) {
      float s[kPer];
      float mt = m;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float kr[DP];
        row_f<TK, DP>(reinterpret_cast<const TK*>(K + i * S * kRK), kr);
        s[i] = (live >> i) & 1u ? dot<DP>(q, kr) : dead_score();
        mt = fmaxf(mt, s[i]);
      }
      const float corr = exp2f(m - mt);
      m = mt;
      l *= corr;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = exp2f(s[i] - mt);   // 0 for a dead key
        l += p;
        const float pr = round_as<TV>(p);   // probabilities in the value dtype
        float vr[DP];
        row_f<TV, DP>(reinterpret_cast<const TV*>(V + i * S * kRV), vr);
#pragma unroll
        for (int d = 0; d < DP; ++d) acc[d] = fmaf(pr, vr[d], acc[d]);
      }
    }
    t = t1;
    t1 = t2;
    st = (st + 1) % kStages;
  }

  // The row's S states merged in a fixed order: the warp's 4 quarters by a
  // butterfly of shuffles (lanes 8 and 16 apart; products rounded apart, no
  // fused multiply-add, so both lanes of a pair get the same bits), then
  // the W warps' through shared memory, warp 0 first.  No atomics: two
  // calls are bitwise equal.
#pragma unroll
  for (int off = kRowsPerWarp; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, off);
    const float lo = __shfl_xor_sync(kFull, l, off);
    const float mn = fmaxf(m, mo);
    const float c1 = exp2f(m - mn), c2 = exp2f(mo - mn);
    l = __fmul_rn(l, c1) + __fmul_rn(lo, c2);
#pragma unroll
    for (int d = 0; d < DP; ++d)
      acc[d] = __fmul_rn(acc[d], c1) + __fmul_rn(__shfl_xor_sync(kFull, acc[d], off), c2);
    m = mn;
  }
  wait_pending<0>();
  __syncthreads();   // every tile consumed: the ring becomes the merge's space
  float* red = reinterpret_cast<float*>(smem);   // [group][warp][m, l, acc..][row]
  float* mine = red + (grp * W + w) * kF + rr;
  if (quarter == 0) {
    mine[0] = m;
    mine[kRowsPerWarp] = l;
#pragma unroll
    for (int d = 0; d < DP; ++d) mine[(2 + d) * kRowsPerWarp] = acc[d];
  }
  __syncthreads();
  const float* row_st = red + grp * W * kF + rr;   // warp j's state at row_st + j kF
  float mx = kNegInf, c[W];
#pragma unroll
  for (int j = 0; j < W; ++j) mx = fmaxf(mx, row_st[j * kF]);
  l = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    c[j] = exp2f(row_st[j * kF] - mx);
    l += __fmul_rn(row_st[j * kF + kRowsPerWarp], c[j]);
  }

  // Any other row with no live key (a data-dependent mask, such as a
  // kv_valid row with no key set; no served call has one): the same
  // uniform softmax, the sum of V over all Skv keys taken here by the
  // block in a fixed order (partials by column, then in order).
  const bool dead = rok && !all && l == 0.f;
  float* vm = red + (blockDim.x / S / kRowsPerWarp) * W * kF;
  if (__syncthreads_or(dead)) {
    const int P = blockDim.x / DP, col = threadIdx.x % DP, p = threadIdx.x / DP;
    float sum = 0.f;
    if (col < D)
      for (int j = p; j < a.Skv; j += P) sum += to_f(vbase[(size_t)j * kstride + col]);
    vm[DP + p * DP + col] = sum;
    __syncthreads();
    if (threadIdx.x < DP) {
      float tot = 0.f;
      for (int i = 0; i < P; ++i) tot += vm[DP + i * DP + threadIdx.x];
      vm[threadIdx.x] = tot * round_as<TV>(1.f / a.Skv);
    }
    __syncthreads();
  }
  if (!rok) return;
  // split s writes columns s, s + S, .. of the row
  const float denom = fmaxf(l, 1e-30f);
  for (int d = split; d < D; d += S) {
    float x;
    if (dead) {
      x = vm[d];
    } else {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) sum += __fmul_rn(row_st[j * kF + (2 + d) * kRowsPerWarp], c[j]);
      x = all ? sum * round_as<TV>(1.f / a.Skv) : sum / denom;
    }
    if (a.q_bf16)
      static_cast<__nv_bfloat16*>(a.o)[orow + d] = from_f<__nv_bfloat16>(x);
    else
      static_cast<float*>(a.o)[orow + d] = x;
  }
}

// The device's SM count (the device current at the first call).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <class Mask, typename TK, typename TV, int DP, int W>
cudaError_t launch_w(const Args& a, const Mask& mask, cudaStream_t st) {
  constexpr int S = 4 * W;
  // rows of a block: the most (multiples of 8, up to 256 / S threads' worth)
  // that still give one block an SM
  const long long rows = (long long)a.Sq * (a.Hq / a.Hkv);
  const long long heads = (long long)a.B * a.Hkv;
  int nrows = kMaxThreads / S;
  while (nrows > kRowsPerWarp && (rows + nrows - 1) / nrows * heads < sm_count()) nrows >>= 1;
  const long long nblk = (rows + nrows - 1) / nrows;
  const int nt = (a.Skv + kKeys - 1) / kKeys;
  const int threads = nrows * S;
  // the ring and its tile flags, or the merge's states and the dead rows'
  // partial sums, whichever is larger
  const size_t ring = kStages * stage_bytes<TK, TV, DP>() + nt * sizeof(int);
  const size_t merge = ((size_t)nrows * W * (DP + 2) + DP + threads) * sizeof(float);
  const size_t smem = ring > merge ? ring : merge;
  if (nblk > INT_MAX || a.Hkv > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  auto kernel = fwd_kernel<Mask, TK, TV, DP, W>;
  static size_t opted = 48 << 10;   // dynamic shared memory this kernel may use
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  kernel<<<dim3((unsigned)nblk, a.Hkv, a.B), threads, smem, st>>>(a, mask);
  return cudaGetLastError();
}

// Warps a row: 4 (16 threads, 4 keys each of a tile) while all rows at 16
// threads fit one wave of resident blocks (about 512 threads an SM at
// these kernels' registers), else 1 (4 threads, 16 keys each): few rows
// with many keys (the selective call) spread over more threads, many rows
// (the offline build's flash call) over fewer.
template <class Mask, typename TK, typename TV, int DP>
cudaError_t launch_dp(const Args& a, const Mask& mask, cudaStream_t st) {
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  if (rows * 16 <= 512LL * sm_count()) return launch_w<Mask, TK, TV, DP, 4>(a, mask, st);
  return launch_w<Mask, TK, TV, DP, 1>(a, mask, st);
}

// Launches the forward for k_dtype / v_dtype on `st`: 16-byte tile copies
// when K and V rows are whole 16-byte chunks and both tensors 16-byte
// aligned, 4-byte copies when whole words, element loads otherwise (bf16
// at an odd D).
template <class Mask>
cudaError_t launch(Args a, const Mask& mask, int k_dtype, int v_dtype, cudaStream_t st) {
  if (a.D < 1 || a.D > 32) return cudaErrorInvalidValue;
  return with_dtype(k_dtype, [&](auto tk) {
    return with_dtype(v_dtype, [&](auto tv) {
      using TK = decltype(tk);
      using TV = decltype(tv);
      const uintptr_t addr = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
      const int kb = a.D * (int)sizeof(TK), vb = a.D * (int)sizeof(TV);
      a.copy = kb % 16 == 0 && vb % 16 == 0 && addr % 16 == 0 ? 2
               : kb % 4 == 0 && vb % 4 == 0 && addr % 4 == 0  ? 1
                                                              : 0;
      if (a.D <= 8) return launch_dp<Mask, TK, TV, 8>(a, mask, st);
      if (a.D <= 16) return launch_dp<Mask, TK, TV, 16>(a, mask, st);
      return launch_dp<Mask, TK, TV, 32>(a, mask, st);
    });
  });
}

}  // namespace small
}  // namespace rt
