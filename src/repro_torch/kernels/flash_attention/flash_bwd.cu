// Flash-attention backward (kernel K6) for Hopper, sm_90a.
//
// The JAX package has no Pallas backward: its training path differentiates
// `_flash` (`src/repro/models/layers.py:231`) through the hand-written
// custom VJP `_flash_bwd` (`:249`), a two-pass tile recompute in jnp.
// This file computes that function (wrapper `ops.py:mha_flash_bwd`,
// plain version `ref.py:flash_bwd_ref`):
//
//   delta = rowsum(dout * out)                           (fp32)
//   p     = exp(s * scale - lse) on live (q, k) pairs, 0 elsewhere
//   dV    = sum_q  round_T(p)  * dout
//   dP    = dout . v
//   dS    = p * (dP - delta) * scale
//   dQ    = sum_k  round_T(dS) * k
//   dK    = sum_q  round_T(dS) * q
//
// q, out, dout (B, Sq, Hq, D); k, v (B, Skv, Hkv, D), all of one dtype T
// (fp32 or bf16); lse (B, Sq, Hq) fp32, the forward's log-sum-exp; int32
// positions q_pos (Sq,), kv_pos (Skv,).  A pair is live when causal
// `qpos >= kpos` and, with a window w > 0, `qpos - kpos < w` (not causal:
// `|qpos - kpos| < w`).  Sums in fp32; outputs rounded once to T.  Every
// query row must see at least one key (causal self-attention does): a row
// with none has lse = -1e30, where the reference's exp(-1e30 - lse) is 1,
// not 0; both routes give such a row p = 0.
//
// Bound on the card: operations.  Five products of 2*D per live pair and
// head (S, dP, dV, dQ, dK): at rcllm-qwen3-8b's 1 x 4,096 causal call
// (Hq 32, D 128) 343.7 GFLOP, 0.3475 ms at the 989 TFLOP/s of the bf16
// tensor cores.  Both routes below compute S and dP in each of their two
// passes, the price of writing every gradient once without atomics: 7
// products, 481 GFLOP at that call (0.49 ms).
//
// Three routes, chosen by the wrapper (`ops.py:_bwd_route`) from dtypes and
// shapes alone; one C entry point launches a route's kernels in order.
//
// * Tensor cores ("tc"): bf16 q, k, v with D in {64, 128, 256}, any G =
//   Hq / Hkv, causal or not, with or without a window.  What it does about
//   the bound: every product is a wgmma (bf16 operands, fp32 accumulators)
//   instead of CUDA-core FMAs; the operands stay bf16 in 128-byte-swizzled
//   shared memory (the layout of `attn_tile.cuh`) instead of being widened
//   to fp32; tiles arrive by TMA, counted on mbarriers, instead of thread
//   loads.  One warpgroup (128 threads) per block, 64-row tiles.
//   - prep: delta as in the SIMT route, and lse * log2(e), both as
//     (B, Hq, Sq rounded up to 64) planes that a 64-row query tile reads
//     with one bulk copy; and each 64-position tile's min and max position.
//   - dQ: one block per (64-row query tile, query head, batch row), the
//     last query tiles first (they see the most keys).  Q and dO land once;
//     64-key K/V tiles stream through a 2-stage TMA ring.  Per tile
//     S = Q K^T and dP = dO V^T (both operands K-major), P = 2^(S scale
//     log2e - lse log2e), dS = P (dP - delta) scale, dQ += bf16(dS) K (dS
//     from registers, K MN-major).  G needs no packing: the G blocks of a
//     kv head read the same K/V rows, from L2.
//   - dK/dV: one block per (64-key tile, kv head, batch row), the first
//     key tiles first, looping over the group's G heads and their live
//     64-row query tiles, Q / dO / (lse, delta) through the 2-stage ring.
//     Per tile S^T = K Q^T, P^T, dV += bf16(P^T) dO, dP^T = V dO^T, dS^T,
//     dK += bf16(dS^T) Q.  The block owns its keys for all G heads, so dK
//     and dV are written once, without atomics: deterministic.
//   - D = 256: dK and dV as two m64n256 fp32 accumulators would need
//     2 x 128 registers a thread, over the 255 limit with S and dP held.
//     The dK/dV pass runs as two launches of one template, one
//     accumulating dV (S, P) and one dK (S, P, dP, dS): +2 products of
//     S^T recomputed, at D = 256 only.  The dQ pass holds one m64n256
//     accumulator (128 registers) and runs in one launch.
//   - Tiles whose position ranges admit no live pair are skipped (`band`);
//     the exact mask is applied only to tiles that straddle the causal
//     diagonal, the window's edge or the ragged end, as bits over the
//     thread's 32 accumulator elements (B1's per-row `row_mask` assumes
//     index positions; these positions are the caller's).
//   - Numerics: S and dP are fp32 sums of exact bf16 products; p is rounded
//     to bf16 before dV and dS before dQ and dK (the A fragment of the
//     register-A wgmma); a masked pair's p is exactly 0; exp is 2^x of
//     log2(e)-scaled scores, which differs by fp32 rounding only.
// * Small heads ("small": D <= 32, fp32 and bf16; the planted ranker's
//   fp32 D 16, kimi-k2's bf16 D 16 at reduced()): CUDA cores, two
//   launches.  It stays off the tensor cores: fp32 parity with the plain
//   version (TF32 off, ROADMAP queue A) rules out TF32, and at D <= 32 a
//   row's whole state fits a thread's registers.
//   - dq (and delta): a query row per thread, holding its q, dout, dQ
//     accumulator, lse and delta (3 D + 2 values; delta from its own out
//     and dout, written for the next pass).  Block: 32 query rows x 8
//     splits (256 threads, two blocks an SM at D <= 16); 64-key K / V
//     tiles (and key positions) arrive in shared memory by 16-byte
//     cp.async, double-buffered, one barrier a tile; split s takes keys
//     8 s .. 8 s + 7 of each tile, every thread of a warp reading the same
//     key row as 16-byte broadcasts: no shuffles.  The splits' dQ are
//     summed in split order through shared memory at the end.
//   - dk/dv: a key per thread, holding k, v, dK and dV (4 D values),
//     looping over the group's G heads and their live 64-row query tiles
//     (q, dout, lse, delta, positions) through the same ring; 32 keys x 8
//     splits of the query rows, summed in split order.  The block owns its
//     keys, so the gradients are written once, without atomics:
//     deterministic.
//   - Tiles skipped by position band; the numerics are the SIMT route's
//     (p rounded to T before dV, dS before dQ and dK), with p = 2^x of
//     log2(e)-scaled scores as on the tensor cores and each dot product
//     as two interleaved partial sums: both differ by fp32 rounding only.
//   - Its cp.async copies and 16-byte shared-memory row reads (`cp16`,
//     `cp4`, `commit`, `wait_pending`, `row_f`) live in `attn_small.cuh`,
//     which B1's and B2's small-head forward route shares.
// * SIMT (fp32 at D > 32, and bf16 with any other D <= 256: kimi-k2's
//   112): the CUDA-core kernels, three launches.
//   - dq: one block of 4 warps per (16-row query tile, query head, batch
//     row); each warp carries 4 rows' dQ in registers (D/32 columns a
//     lane) while 32-key K/V tiles stream through shared memory in fp32,
//     one key per lane in the score pass.
//   - dk/dv: one block per (16-key tile, kv head, batch row), each warp
//     owning 4 keys' dK and dV, looping over the G query heads of its kv
//     group and over 32-row query tiles; written once, without atomics.
//   Both skip a tile whose position ranges admit no live pair.
#include <algorithm>
#include <climits>

#include "../attn_common.cuh"
#include "../attn_small.cuh"
#include "../attn_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16;               // dq kernel: query rows per block
constexpr int kBK = 32;               // dq kernel: keys per tile (one per lane)
constexpr int kKB = 16;               // dk/dv kernel: keys per block
constexpr int kQB = 32;               // dk/dv kernel: query rows per tile (one per lane)
constexpr int kRows = kBQ / kWarps;   // rows (dq) or keys (dk/dv) per warp
static_assert(kKB / kWarps == kRows, "both kernels give a warp 4 rows or keys");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  const int* qpos;
  const int* kpos;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv, D, causal, window;
  float scale;
};

__device__ __forceinline__ bool live(int qp, int kp, int causal, int window) {
  if (causal) return qp >= kp && (window <= 0 || qp - kp < window);
  return window <= 0 || abs(qp - kp) < window;
}

// Could any pair of a query in [qmin, qmax] and a key in [kmin, kmax] be live?
__device__ __forceinline__ bool band(int qmin, int qmax, int kmin, int kmax, int causal,
                                     int window) {
  if (qmin > qmax || kmin > kmax) return false;            // empty tile
  if (causal) return qmax >= kmin && (window <= 0 || qmin - kmax < window);
  return window <= 0 || (qmin - kmax < window && kmin - qmax < window);
}

// min and max of the first n of pos[0..31] (n >= 0), by warp 0, into
// out[0], out[1] (an empty range comes out as INT_MAX, INT_MIN).
__device__ __forceinline__ void range32(const int* pos, int n, int* out) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  int lo = lane < n ? pos[lane] : INT_MAX;
  int hi = lane < n ? pos[lane] : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(rt::kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(rt::kFull, hi, o));
  }
  if (lane == 0) {
    out[0] = lo;
    out[1] = hi;
  }
}

// delta[b, s, h] = sum_d dout * out, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Sq * a.Hq) return;
  const T* o = static_cast<const T*>(a.o) + row * a.D;
  const T* g = static_cast<const T*>(a.dout) + row * a.D;
  float acc = 0.f;
  for (int d = lane; d < a.D; d += 32) acc += rt::to_f(g[d]) * rt::to_f(o[d]);
  acc = rt::warp_sum(acc);
  if (lane == 0) a.delta[row] = acc;
}

// dQ: block (query tile, head, batch row).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ float sm[];
  const int D = a.D, Dp = D + 1;
  float* q_s = sm;                       // [kBQ][D]
  float* do_s = q_s + kBQ * D;           // [kBQ][D]
  float* k_s = do_s + kBQ * D;           // [kBK][Dp]
  float* v_s = k_s + kBK * Dp;           // [kBK][Dp]
  __shared__ int qpos_s[kBQ], kpos_s[kBK], qr[2], kr[2];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = min(kBQ, a.Sq - q0);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const size_t off = (((size_t)b * a.Sq + q0 + r) * a.Hq + h) * D + d;
    q_s[e] = r < nq ? rt::to_f(q[off]) : 0.f;
    do_s[e] = r < nq ? rt::to_f(g[off]) : 0.f;
  }
  if (tid < kBQ) qpos_s[tid] = tid < nq ? a.qpos[q0 + tid] : 0;
  __syncthreads();
  range32(qpos_s, nq, qr);

  float lse_r[kRows], dl_r[kRows], acc[kRows][DPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    const size_t row = ((size_t)b * a.Sq + q0 + r) * a.Hq + h;
    lse_r[i] = r < nq ? a.lse[row] : 0.f;
    dl_r[i] = r < nq ? a.delta[row] : 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  for (int k0 = 0; k0 < a.Skv; k0 += kBK) {
    const int nk = min(kBK, a.Skv - k0);
    __syncthreads();                       // previous tile consumed
    if (tid < kBK) kpos_s[tid] = tid < nk ? a.kpos[k0 + tid] : 0;
    __syncthreads();
    range32(kpos_s, nk, kr);
    __syncthreads();
    if (!band(qr[0], qr[1], kr[0], kr[1], a.causal, a.window)) continue;
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const size_t off = (((size_t)b * a.Skv + k0 + j) * a.Hkv + hk) * D + d;
      k_s[j * Dp + d] = j < nk ? rt::to_f(k[off]) : 0.f;
      v_s[j * Dp + d] = j < nk ? rt::to_f(v[off]) : 0.f;
    }
    __syncthreads();
    // this warp's kRows rows against the tile's keys (one per lane): each
    // K / V element read once for all the rows
    const int r0 = warp * kRows;
    float s[kRows], dp[kRows], ds[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane * Dp + d], vd = v_s[lane * Dp + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i] += q_s[(r0 + i) * D + d] * kd;
        dp[i] += do_s[(r0 + i) * D + d] * vd;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      const bool ok = r < nq && lane < nk && live(qpos_s[r], kpos_s[lane], a.causal, a.window);
      const float p = ok ? expf(s[i] * a.scale - lse_r[i]) : 0.f;
      ds[i] = rt::round_as<T>(p * (dp[i] - dl_r[i]) * a.scale);
    }
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float dsj[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsj[i] = __shfl_sync(rt::kFull, ds[i], j);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          const float kd = k_s[j * Dp + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][t] += dsj[i] * kd;
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    if (r >= nq) break;
    const size_t base = (((size_t)b * a.Sq + q0 + r) * a.Hq + h) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) dq[base + d] = rt::from_f<T>(acc[i][t]);
    }
  }
}

// dK and dV: block (key tile, kv head, batch row), over the group's G heads.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ float sm[];
  const int D = a.D, Dp = D + 1;
  float* k_s = sm;                       // [kKB][Dp]
  float* v_s = k_s + kKB * Dp;           // [kKB][Dp]
  float* q_s = v_s + kKB * Dp;           // [kQB][Dp]
  float* do_s = q_s + kQB * Dp;          // [kQB][Dp]
  __shared__ int qpos_s[kQB], kpos_s[kKB], qr[2], kr[2];
  __shared__ float lse_s[kQB], dl_s[kQB];

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kKB;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = min(kKB, a.Skv - k0);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);

  for (int e = tid; e < kKB * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const size_t off = (((size_t)b * a.Skv + k0 + j) * a.Hkv + hk) * D + d;
    k_s[j * Dp + d] = j < nk ? rt::to_f(k[off]) : 0.f;
    v_s[j * Dp + d] = j < nk ? rt::to_f(v[off]) : 0.f;
  }
  if (tid < kKB) kpos_s[tid] = tid < nk ? a.kpos[k0 + tid] : 0;
  __syncthreads();
  range32(kpos_s, nk, kr);

  float dk[kRows][DPL], dv[kRows][DPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int t = 0; t < DPL; ++t) dk[i][t] = dv[i][t] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    for (int q0 = 0; q0 < a.Sq; q0 += kQB) {
      const int nq = min(kQB, a.Sq - q0);
      __syncthreads();                     // previous tile consumed
      if (tid < kQB) {
        const size_t row = ((size_t)b * a.Sq + q0 + tid) * a.Hq + h;
        qpos_s[tid] = tid < nq ? a.qpos[q0 + tid] : 0;
        lse_s[tid] = tid < nq ? a.lse[row] : 0.f;
        dl_s[tid] = tid < nq ? a.delta[row] : 0.f;
      }
      __syncthreads();
      range32(qpos_s, nq, qr);
      __syncthreads();
      if (!band(qr[0], qr[1], kr[0], kr[1], a.causal, a.window)) continue;
      for (int e = tid; e < kQB * D; e += kThreads) {
        const int r = e / D, d = e % D;
        const size_t off = (((size_t)b * a.Sq + q0 + r) * a.Hq + h) * D + d;
        q_s[r * Dp + d] = r < nq ? rt::to_f(q[off]) : 0.f;
        do_s[r * Dp + d] = r < nq ? rt::to_f(g[off]) : 0.f;
      }
      __syncthreads();
      // this warp's kRows keys against the tile's rows (one per lane): each
      // Q / dO element read once for all the keys
      const int j0 = warp * kRows;
      float s[kRows], dp[kRows], pr[kRows], ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qd = q_s[lane * Dp + d], gd = do_s[lane * Dp + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i] += qd * k_s[(j0 + i) * Dp + d];
          dp[i] += gd * v_s[(j0 + i) * Dp + d];
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int j = j0 + i;
        const bool ok = lane < nq && j < nk && live(qpos_s[lane], kpos_s[j], a.causal, a.window);
        const float p = ok ? expf(s[i] * a.scale - lse_s[lane]) : 0.f;
        ds[i] = rt::round_as<T>(p * (dp[i] - dl_s[lane]) * a.scale);
        pr[i] = rt::round_as<T>(p);
      }
#pragma unroll 2
      for (int r = 0; r < kQB; ++r) {
        float pj[kRows], dsj[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pj[i] = __shfl_sync(rt::kFull, pr[i], r);
          dsj[i] = __shfl_sync(rt::kFull, ds[i], r);
        }
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < D) {
            const float gd = do_s[r * Dp + d], qd = q_s[r * Dp + d];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              dv[i][t] += pj[i] * gd;
              dk[i][t] += dsj[i] * qd;
            }
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int j = warp * kRows + i;
    if (j >= nk) break;
    const size_t base = (((size_t)b * a.Skv + k0 + j) * a.Hkv + hk) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        dkp[base + d] = rt::from_f<T>(dk[i][t]);
        dvp[base + d] = rt::from_f<T>(dv[i][t]);
      }
    }
  }
}

// ------------------------------------------------------------ SIMT route
template <typename T, int DPL>
cudaError_t launch_simt(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_q = (size_t)(2 * kBQ * a.D + 2 * kBK * (a.D + 1)) * sizeof(float);
  err = cudaFuncSetAttribute(dq_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<T, DPL><<<dim3((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B), kThreads, smem_q, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_k = (size_t)(2 * kKB + 2 * kQB) * (a.D + 1) * sizeof(float);
  err = cudaFuncSetAttribute(dkv_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_k);
  if (err != cudaSuccess) return err;
  dkv_kernel<T, DPL><<<dim3((a.Skv + kKB - 1) / kKB, a.Hkv, a.B), kThreads, smem_k, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_d(const Args& a, cudaStream_t st) {
  if (a.D <= 32) return launch_simt<T, 1>(a, st);
  if (a.D <= 64) return launch_simt<T, 2>(a, st);
  if (a.D <= 128) return launch_simt<T, 4>(a, st);
  if (a.D <= 256) return launch_simt<T, 8>(a, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------ small-head route
namespace sh {

constexpr int kRows = 32;                 // a block's own rows: queries (dq) or keys (dk/dv)
constexpr int kSplits = 8;                // threads per own row, each an eighth of every tile
constexpr int kTile = 64;                 // rows of a streamed tile: keys (dq) or queries (dk/dv)
constexpr int kThreads = kRows * kSplits;
constexpr int kPer = kTile / kSplits;     // tile rows per thread
constexpr int kStages = 3;                // tiles in flight: the one computed, two landing
constexpr float kLog2e = 1.4426950408889634f;

// Two blocks an SM where a thread's state allows it (D <= 16: at most 128
// registers), one otherwise.
template <int DP>
__host__ __device__ constexpr int min_blocks() { return DP <= 16 ? 2 : 1; }

// Tile rows a thread's loop unrolls: two at D <= 8, one above (its four
// dot-product chains already overlap).
template <int DP>
__host__ __device__ constexpr int unroll() { return DP <= 8 ? 2 : 1; }

using rt::commit;
using rt::cp16;
using rt::cp4;
using rt::row_f;
using rt::unpack16;
using rt::wait_pending;

// min and max of pos[start, start + count) below n (count 32 or 64), by
// every warp alike (an empty range comes out as INT_MAX, INT_MIN).
template <int count>
__device__ __forceinline__ void range_of(const int* pos, int start, int n, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = start + lane; i < start + count; i += 32) {
    if (i < n) {
      lo = min(lo, pos[i]);
      hi = max(hi, pos[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(rt::kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(rt::kFull, hi, o));
  }
}

// (x . y, u . w) over DP elements, each as two interleaved partial sums
// (two independent chains of fused products each).
template <int DP>
__device__ __forceinline__ float2 dots(const float (&x)[DP], const float (&y)[DP],
                                       const float (&u)[DP], const float (&w)[DP]) {
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
  for (int d = 0; d < DP; d += 2) {
    a0 += x[d] * y[d];
    a1 += x[d + 1] * y[d + 1];
    b0 += u[d] * w[d];
    b1 += u[d + 1] * w[d + 1];
  }
  return make_float2(a0 + a1, b0 + b1);
}

// A thread's own row of D elements from global memory, zero past D or
// when !ok: 16-byte loads when `vec` (D whole 16-byte chunks, the row
// aligned), element loads otherwise.
template <typename T, int DP>
__device__ __forceinline__ void own_row(const T* src, int D, bool ok, int vec, float (&x)[DP]) {
  constexpr int kE = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int c = 0; c < DP / kE; ++c) {
      if (ok && c * kE < D) {
        unpack16<T>(reinterpret_cast<const uint4*>(src)[c], x + kE * c);
      } else {
#pragma unroll
        for (int j = 0; j < kE; ++j) x[kE * c + j] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < DP; ++d) x[d] = ok && d < D ? rt::to_f(src[d]) : 0.f;
  }
}

// Rows [r0, r0 + 64) of a (.., H, D) tensor at head h (rows `row_stride`
// elements apart, the first at `base`) into a [64][DP] tile: 16-byte
// cp.async when `vec`, else element copies; rows at or past n are zeros.
// Columns D..DP-1 are never written (zeroed once by the caller).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* tile, const T* base, size_t row_stride, int r0,
                                          int n, int D, int vec) {
  if (vec) {
    const int cpr = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
    for (int e = threadIdx.x; e < kTile * cpr; e += kThreads) {
      const int r = e / cpr, c = e % cpr;
      char* dst = reinterpret_cast<char*>(tile + r * DP) + 16 * c;
      if (r0 + r < n)
        cp16(dst, reinterpret_cast<const char*>(base + (size_t)(r0 + r) * row_stride) + 16 * c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int r = e / D, d = e % D;
      tile[r * DP + d] = r0 + r < n ? base[(size_t)(r0 + r) * row_stride + d] : rt::from_f<T>(0.f);
    }
  }
}

// 64 per-row scalars (positions, lse, delta) at src[i * stride], i in
// [r0, r0 + 64), by the first 64 threads; 0 past n.
template <typename V>
__device__ __forceinline__ void load_col(V* dst, const V* src, size_t stride, int r0, int n) {
  const int i = threadIdx.x;
  if (i >= kTile) return;
  if (r0 + i < n)
    cp4(dst + i, src + (size_t)(r0 + i) * stride);
  else
    dst[i] = V(0);
}

// flags[t] = whether streamed tile t (positions pos[64 t, 64 t + 64) below
// n) may pair with the block's own rows, whose positions span [lo, hi]
// (`own_q`: the own rows are queries).  The block's warps take the tiles
// in turns, all at once, so the tile loop reads no position from global
// memory; the caller synchronises before reading the flags.
template <bool own_q>
__device__ __forceinline__ void live_flags(int* flags, const int* pos, int n, int ntiles, int lo,
                                           int hi, int causal, int window) {
  for (int t = threadIdx.x >> 5; t < ntiles; t += kThreads / 32) {
    int tlo, thi;
    range_of<kTile>(pos, t * kTile, n, tlo, thi);
    const bool ok = own_q ? band(lo, hi, tlo, thi, causal, window)
                          : band(tlo, thi, lo, hi, causal, window);
    if ((threadIdx.x & 31) == 0) flags[t] = ok;
  }
}

// Sum of the kSplits partial rows of DP fp32 values through shared memory
// `red` ((kSplits - 1) x DP x kRows floats), in split order; -> the total in
// split 0's `acc` (others unchanged).  Starts and ends with a barrier.
template <int DP>
__device__ __forceinline__ void reduce_splits(float* red, float (&acc)[DP], int split, int r) {
  __syncthreads();
  if (split > 0) {
#pragma unroll
    for (int d = 0; d < DP; ++d) red[((split - 1) * DP + d) * kRows + r] = acc[d];
  }
  __syncthreads();
  if (split == 0) {
#pragma unroll
    for (int s = 1; s < kSplits; ++s) {
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] += red[((s - 1) * DP + d) * kRows + r];
    }
  }
}

template <typename T, int DP>
__host__ __device__ constexpr size_t dq_stage_bytes() {
  return 2 * kTile * DP * sizeof(T) + kTile * sizeof(int);
}

template <typename T, int DP>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return 2 * kTile * DP * sizeof(T) + 3 * kTile * 4;
}

template <int DP>
__host__ __device__ constexpr size_t red_bytes() {
  return (size_t)(kSplits - 1) * DP * kRows * sizeof(float);
}

// Dynamic shared memory of a pass: the ring of `stage` bytes a tile, then
// one live flag a streamed tile; the splits' sum reuses it from the start.
constexpr size_t smem_bytes(size_t stage, size_t red, int ntiles) {
  return std::max(kStages * stage + ntiles * sizeof(int), red);
}

// dQ and delta: block (32-row query tile, query head, batch row), the last
// tiles first; thread (split, row).  K / V tiles of 64 keys stream through
// a 3-stage cp.async ring (two tiles landing while one is computed), one
// barrier a tile; the thread's split takes 8 of a tile's keys, each read
// from shared memory as a broadcast.  Tiles skipped by position band
// (`live_flags`); the splits' dQ summed in split order.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, min_blocks<DP>()) dq_kernel(Args a, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, G = a.Hq / a.Hkv;
  const int split = threadIdx.x / kRows, r = threadIdx.x % kRows;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / G;
  const int q0 = ((a.Sq + kRows - 1) / kRows - 1 - blockIdx.x) * kRows;
  const int qi = q0 + r;
  const bool qok = qi < a.Sq;
  const size_t qrow = ((size_t)b * a.Sq + (qok ? qi : 0)) * a.Hq + h;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.Skv * a.Hkv + hk) * D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.Skv * a.Hkv + hk) * D;
  const size_t kstride = (size_t)a.Hkv * D;

  // stage st: K [64][DP], V [64][DP], key positions [64].  Addresses are
  // computed from `st`, never read from an indexed array of pointers
  // (which would live in local memory and turn shared loads generic).
  constexpr size_t kStage = dq_stage_bytes<T, DP>();
  auto ks = [&](int st) { return reinterpret_cast<T*>(smem + st * kStage); };
  auto vs = [&](int st) { return ks(st) + kTile * DP; };
  auto ps = [&](int st) { return reinterpret_cast<int*>(vs(st) + kTile * DP); };
  int* flags = reinterpret_cast<int*>(smem + kStages * kStage);
  if (D < DP) {   // pad columns: zero once, never written again
    for (int e = threadIdx.x; e < 2 * kStages * kTile * (DP - D); e += kThreads) {
      const int col = D + e % (DP - D), row = e / (DP - D);   // row over the K, V tiles
      T* tile = row < kStages * kTile ? ks(row / kTile) : vs(row / kTile - kStages);
      tile[(row % kTile) * DP + col] = rt::from_f<T>(0.f);
    }
  }

  float q[DP], g[DP], acc[DP];
  own_row<T, DP>(static_cast<const T*>(a.q) + qrow * D, D, qok, vec, q);
  own_row<T, DP>(static_cast<const T*>(a.dout) + qrow * D, D, qok, vec, g);
  float dl = 0.f;
  {
    float o[DP];
    own_row<T, DP>(static_cast<const T*>(a.o) + qrow * D, D, qok, vec, o);
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      dl += g[d] * o[d];
      acc[d] = 0.f;
    }
  }
  if (split == 0 && qok) a.delta[qrow] = dl;
  const float lse2 = qok ? a.lse[qrow] * kLog2e : 0.f;
  const float scale2 = a.scale * kLog2e;
  const int qp = qok ? a.qpos[qi] : 0;
  int qlo, qhi;
  range_of<kRows>(a.qpos, q0, a.Sq, qlo, qhi);

  const int nkt = (a.Skv + kTile - 1) / kTile;
  constexpr int kUnroll = unroll<DP>();
  live_flags<true>(flags, a.kpos, a.Skv, nkt, qlo, qhi, a.causal, a.window);
  __syncthreads();
  auto next_live = [&](int t) {
    while (t < nkt && !flags[t]) ++t;
    return t;
  };
  auto load = [&](int t, int st) {   // a group per tile, empty past the last
    if (t < nkt) {
      load_tile<T, DP>(ks(st), k, kstride, t * kTile, a.Skv, D, vec);
      load_tile<T, DP>(vs(st), v, kstride, t * kTile, a.Skv, D, vec);
      load_col<int>(ps(st), a.kpos, 1, t * kTile, a.Skv);
    }
    commit();
  };

  int t = next_live(0), st = 0;
  int t1 = t < nkt ? next_live(t + 1) : nkt;
  load(t, 0);
  load(t1, 1);
  while (t < nkt) {
    wait_pending<1>();          // tile t landed (t1 may still be landing)
    __syncthreads();            // ... for every thread; all done with the last stage
    const int t2 = t1 < nkt ? next_live(t1 + 1) : nkt;
    load(t2, (st + 2) % kStages);
    const T* K = ks(st);
    const T* V = vs(st);
    const int* P = ps(st);
    const int k0 = t * kTile;
#pragma unroll kUnroll
    for (int jj = 0; jj < kPer; ++jj) {
      const int j = split * kPer + jj;
      float kr[DP], vr[DP];
      row_f<T, DP>(K + j * DP, kr);
      row_f<T, DP>(V + j * DP, vr);
      const float2 sd = dots<DP>(q, kr, g, vr);     // s, dp
      const bool ok = qok && k0 + j < a.Skv && live(qp, P[j], a.causal, a.window);
      const float p = ok ? exp2f(sd.x * scale2 - lse2) : 0.f;
      const float ds = rt::round_as<T>(p * (sd.y - dl) * a.scale);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] += ds * kr[d];
    }
    t = t1;
    t1 = t2;
    st = (st + 1) % kStages;
  }
  reduce_splits<DP>(reinterpret_cast<float*>(smem), acc, split, r);
  if (split == 0 && qok) {
    T* dq = static_cast<T*>(a.dq) + qrow * D;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) dq[d] = rt::from_f<T>(acc[d]);
  }
}

// dK and dV: block (32-key tile, kv head, batch row); thread (split, key).
// Over the group's G heads and their live 64-row query tiles (Q, dO, lse,
// delta and positions through the same 3-stage ring), the split taking 8
// of a tile's queries; the block owns its keys, so dK and dV are written
// once, without atomics.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, min_blocks<DP>()) dkv_kernel(Args a, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, G = a.Hq / a.Hkv;
  const int split = threadIdx.x / kRows, j = threadIdx.x % kRows;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kRows;
  const int kj = k0 + j;
  const bool kok = kj < a.Skv;
  const size_t krow = ((size_t)b * a.Skv + (kok ? kj : 0)) * a.Hkv + hk;
  const size_t qstride = (size_t)a.Hq * D;

  // stage st: Q [64][DP], dO [64][DP], lse [64], delta [64], positions [64]
  constexpr size_t kStage = dkv_stage_bytes<T, DP>();
  auto qs = [&](int st) { return reinterpret_cast<T*>(smem + st * kStage); };
  auto gs = [&](int st) { return qs(st) + kTile * DP; };
  auto ls = [&](int st) { return reinterpret_cast<float*>(gs(st) + kTile * DP); };
  auto dls = [&](int st) { return ls(st) + kTile; };
  auto ps = [&](int st) { return reinterpret_cast<int*>(dls(st) + kTile); };
  int* flags = reinterpret_cast<int*>(smem + kStages * kStage);
  if (D < DP) {
    for (int e = threadIdx.x; e < 2 * kStages * kTile * (DP - D); e += kThreads) {
      const int col = D + e % (DP - D), row = e / (DP - D);
      T* tile = row < kStages * kTile ? qs(row / kTile) : gs(row / kTile - kStages);
      tile[(row % kTile) * DP + col] = rt::from_f<T>(0.f);
    }
  }

  float kk[DP], vv[DP], dk[DP], dv[DP];
  own_row<T, DP>(static_cast<const T*>(a.k) + krow * D, D, kok, vec, kk);
  own_row<T, DP>(static_cast<const T*>(a.v) + krow * D, D, kok, vec, vv);
#pragma unroll
  for (int d = 0; d < DP; ++d) dk[d] = dv[d] = 0.f;
  const int kp = kok ? a.kpos[kj] : 0;
  const float scale2 = a.scale * kLog2e;
  int klo, khi;
  range_of<kRows>(a.kpos, k0, a.Skv, klo, khi);

  // tiles it = gi * nqt + qt: query tile qt of the group's head gi (the
  // same live set for every head)
  const int nqt = (a.Sq + kTile - 1) / kTile, n_it = G * nqt;
  constexpr int kUnroll = unroll<DP>();
  live_flags<false>(flags, a.qpos, a.Sq, nqt, klo, khi, a.causal, a.window);
  __syncthreads();
  auto next_live = [&](int it) {   // the same query tiles are live for every head
    while (it < n_it && !flags[it % nqt]) ++it;
    return it;
  };
  auto load = [&](int it, int st) {   // a group per tile, empty past the last
    if (it < n_it) {
      const int h = hk * G + it / nqt, q0 = (it % nqt) * kTile;
      const size_t off = (size_t)b * a.Sq * a.Hq + h;
      load_tile<T, DP>(qs(st), static_cast<const T*>(a.q) + off * D, qstride, q0, a.Sq, D, vec);
      load_tile<T, DP>(gs(st), static_cast<const T*>(a.dout) + off * D, qstride, q0, a.Sq, D,
                       vec);
      load_col<float>(ls(st), a.lse + off, a.Hq, q0, a.Sq);
      load_col<float>(dls(st), a.delta + off, a.Hq, q0, a.Sq);
      load_col<int>(ps(st), a.qpos, 1, q0, a.Sq);
    }
    commit();
  };

  int it = next_live(0), st = 0;
  int it1 = it < n_it ? next_live(it + 1) : n_it;
  load(it, 0);
  load(it1, 1);
  while (it < n_it) {
    wait_pending<1>();
    __syncthreads();
    const int it2 = it1 < n_it ? next_live(it1 + 1) : n_it;
    load(it2, (st + 2) % kStages);
    const T* Q = qs(st);
    const T* Gd = gs(st);
    const float* LS = ls(st);
    const float* DL = dls(st);
    const int* P = ps(st);
    const int q0 = (it % nqt) * kTile;
#pragma unroll kUnroll
    for (int ii = 0; ii < kPer; ++ii) {
      const int i = split * kPer + ii;
      float qr[DP], gr[DP];
      row_f<T, DP>(Q + i * DP, qr);
      row_f<T, DP>(Gd + i * DP, gr);
      const float2 sd = dots<DP>(qr, kk, gr, vv);   // s, dp
      const bool ok = kok && q0 + i < a.Sq && live(P[i], kp, a.causal, a.window);
      const float p = ok ? exp2f(sd.x * scale2 - LS[i] * kLog2e) : 0.f;
      const float pr = rt::round_as<T>(p);
      const float ds = rt::round_as<T>(p * (sd.y - DL[i]) * a.scale);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dv[d] += pr * gr[d];
        dk[d] += ds * qr[d];
      }
    }
    it = it1;
    it1 = it2;
    st = (st + 1) % kStages;
  }
  float* red = reinterpret_cast<float*>(smem);
  reduce_splits<DP>(red, dk, split, j);
  reduce_splits<DP>(red, dv, split, j);
  if (split == 0 && kok) {
    T* dkp = static_cast<T*>(a.dk) + krow * D;
    T* dvp = static_cast<T*>(a.dv) + krow * D;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < D) {
        dkp[d] = rt::from_f<T>(dk[d]);
        dvp[d] = rt::from_f<T>(dv[d]);
      }
    }
  }
}

// dq (with delta), then dk/dv.  16-byte loads and copies when every row is
// whole 16-byte chunks and the operands are 16-byte aligned.
template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
                         reinterpret_cast<uintptr_t>(a.o);
  const int vec = (a.D * (int)sizeof(T)) % 16 == 0 && addr % 16 == 0;
  const int kv_tiles = (a.Skv + kTile - 1) / kTile, q_tiles = (a.Sq + kTile - 1) / kTile;
  const size_t smem_q = smem_bytes(dq_stage_bytes<T, DP>(), red_bytes<DP>(), kv_tiles);
  const size_t smem_k = smem_bytes(dkv_stage_bytes<T, DP>(), red_bytes<DP>(), q_tiles);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_k);
  if (err != cudaSuccess) return err;
  const unsigned nq = (unsigned)((a.Sq + kRows - 1) / kRows);
  const unsigned nk = (unsigned)((a.Skv + kRows - 1) / kRows);
  dq_kernel<T, DP><<<dim3(nq, a.Hq, a.B), kThreads, smem_q, st>>>(a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<T, DP><<<dim3(nk, a.Hkv, a.B), kThreads, smem_k, st>>>(a, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t st) {
  if (a.D <= 8) return launch<T, 8>(a, st);
  if (a.D <= 16) return launch<T, 16>(a, st);
  if (a.D <= 24) return launch<T, 24>(a, st);
  if (a.D <= 32) return launch<T, 32>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace sh

// ------------------------------------------------------ tensor-core route
namespace tc = rt::tc;

constexpr int kT = 64;                          // rows of every tile: queries or keys
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* planes;   // (2, B, Hq, Sq64): lse * log2(e), then delta; 0 past Sq
  int* ranges;     // (nqt + nkt, 2): min and max position of each 64-row tile
  const int* qpos;
  const int* kpos;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Sq, Skv, Hq, Hkv, D, causal, window, Sq64, nqt, nkt;
  float scale;
};

template <int D> struct Tile {
  static constexpr int kBytes = kT * D * 2;        // one bf16 64 x D tile
  static constexpr int kAtoms = D / 64;            // 128-byte swizzle atom columns
  static constexpr int kChunks = D / 8;            // 16-byte chunks per row
  static constexpr int kRowsPerPass = kThreads / kChunks;
  static constexpr int kPasses = kT / kRowsPerPass;
};

// Could every pair of a query in [qmin, qmax] and a key in [kmin, kmax] be live?
__device__ __forceinline__ bool all_live(int qmin, int qmax, int kmin, int kmax, int causal,
                                         int window) {
  if (causal) return qmin >= kmax && (window <= 0 || qmax - kmin < window);
  return window <= 0 || (qmax - kmin < window && kmax - qmin < window);
}

// delta and lse * log2(e) as (B, Hq, Sq64) planes (one warp per row), then
// each 64-position tile's range (one warp per tile, query tiles first).
__global__ void __launch_bounds__(kThreads) prep_kernel(TcArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nrow = (long long)a.B * a.Hq * a.Sq64;
  const long long row_blocks = (nrow + kWarps - 1) / kWarps;
  if (blockIdx.x < row_blocks) {
    const long long row = (long long)blockIdx.x * kWarps + warp;
    if (row >= nrow) return;
    const int s = (int)(row % a.Sq64);
    const long long bh = row / a.Sq64;
    const int h = (int)(bh % a.Hq), b = (int)(bh / a.Hq);
    float acc = 0.f, l2 = 0.f;
    if (s < a.Sq) {
      const size_t r = ((size_t)b * a.Sq + s) * a.Hq + h;
      const __nv_bfloat16* o = a.o + r * a.D;
      const __nv_bfloat16* g = a.dout + r * a.D;
      for (int d = lane; d < a.D; d += 32) acc += rt::to_f(g[d]) * rt::to_f(o[d]);
      acc = rt::warp_sum(acc);
      l2 = a.lse[r] * kLog2e;
    }
    if (lane == 0) {
      a.planes[row] = l2;
      a.planes[nrow + row] = acc;
    }
    return;
  }
  const long long t = (blockIdx.x - row_blocks) * kWarps + warp;
  if (t >= a.nqt + a.nkt) return;
  const bool is_q = t < a.nqt;
  const int* pos = is_q ? a.qpos : a.kpos;
  const int n = is_q ? a.Sq : a.Skv, p0 = (int)(is_q ? t : t - a.nqt) * kT;
  int lo = INT_MAX, hi = INT_MIN;
  for (int j = lane; j < kT; j += 32) {
    if (p0 + j < n) {
      lo = min(lo, pos[p0 + j]);
      hi = max(hi, pos[p0 + j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(rt::kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(rt::kFull, hi, off));
  }
  if (lane == 0) {
    a.ranges[2 * t] = lo;
    a.ranges[2 * t + 1] = hi;
  }
}

// Element i of a thread's 64 x 64 accumulator fragment: row
// rA + 8 * ((i >> 1) & 1) (rA = warp * 16 + lane / 4), column
// (i >> 2) * 8 + (lane & 3) * 2 + (i & 1).
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// Liveness of the thread's 32 elements of a straddling tile, as bits:
// rows at positions rp (rv: row in range), columns c0 + frag_col read
// from cpos (none at or past n).  `rows_are_queries`: the dQ pass's
// orientation, else the dK/dV pass's transpose.
__device__ __forceinline__ uint32_t tile_bits(const int (&rp)[2], const bool (&rv)[2],
                                              const int* __restrict__ cpos, int c0, int n,
                                              bool rows_are_queries, int causal, int window) {
  const int lane = threadIdx.x & 31;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int i0 = (j >> 1) * 4 + (j & 1);   // the element of row rA in this column
    const int c = c0 + frag_col(i0, lane);
    if (c >= n) continue;
    const int cp = cpos[c];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = rv[r] && (rows_are_queries ? live(rp[r], cp, causal, window)
                                                 : live(cp, rp[r], causal, window));
      bits |= (uint32_t)ok << (i0 + 2 * r);
    }
  }
  return bits;
}

// wgmma descriptors of k-step ks (16 elements of the reduced dimension)
// of a 64 x D swizzled tile: K-major (the reduced dimension along the
// row) and MN-major (along the column: 16 rows of 128 B).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return tc::desc_sw128(tile + (ks >> 2) * (kT * 128) + (ks & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int ks) {
  return tc::desc_sw128(tile + ks * 16 * 128, kT * 128, 1024);
}

// acc (64 x 64) = A B^T, A and B 64 x D tiles, both K-major.
template <int D> __device__ __forceinline__ void ss_product(float (&acc)[32], uint32_t a,
                                                            uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) tc::wgmma_ss_m64n64(acc, kmajor(a, ks), kmajor(b, ks), ks > 0);
}

// acc (64 x D) += A B, A the bf16 fragments of a 64 x 64 accumulator
// (a[ks] covers its columns 16ks..16ks+15), B a 64 x D tile, MN-major.
template <int D> __device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                                            const uint32_t (&a)[4][4],
                                                            uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) tc::wgmma_pv<D>(acc, a[ks], mnmajor(b, ks));
}

// A 64 x D fp32 accumulator in bf16 into a swizzled tile at `tile`.
template <int D> __device__ __forceinline__ void stage_tile(uint8_t* tile,
                                                            const float (&acc)[D / 2]) {
  const int lane = threadIdx.x & 31, rA = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = rA + 8 * ((i >> 1) & 1), col = frag_col(i, lane);
    *reinterpret_cast<uint32_t*>(tile + tc::sw128(row, col >> 3) + (col & 7) * 2) =
        tc::pack_bf16(acc[i], acc[i + 1]);
  }
}

// Rows 0..n-1 of a swizzled tile to dst + row * stride, 16 bytes a thread.
template <int D> __device__ __forceinline__ void write_tile(const uint8_t* tile,
                                                            __nv_bfloat16* dst, int n,
                                                            size_t stride) {
  using Tl = Tile<D>;
  const int cc = threadIdx.x % Tl::kChunks, rc = threadIdx.x / Tl::kChunks;
#pragma unroll
  for (int i = 0; i < Tl::kPasses; ++i) {
    const int m = rc + Tl::kRowsPerPass * i;
    if (m < n)
      *reinterpret_cast<uint4*>(dst + m * stride + cc * 8) =
          *reinterpret_cast<const uint4*>(tile + tc::sw128(m, cc));
  }
}

// Shared memory of both passes: six 64 x D tiles at a 1024-byte boundary,
// then (dK/dV) two 512-byte (lse, delta) stages, then the two mbarriers.
template <int D> constexpr int smem_bytes(bool with_ld) {
  return 6 * Tile<D>::kBytes + (with_ld ? 1024 : 0) + 16 + 1024;
}

// dQ: block (query head, query tile from the last, batch row).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             TcArgs a) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = tc::smem_u32(smem_raw);
  const uint32_t pad = (1024 - (base0 & 1023)) & 1023;
  uint8_t* sm = smem_raw + pad;
  const uint32_t sQ = base0 + pad, sDO = sQ + kTile;
  auto sK = [&](int st) { return sQ + (2 + 2 * st) * kTile; };
  auto sV = [&](int st) { return sQ + (3 + 2 * st) * kTile; };
  auto bar = [&](int st) { return sQ + 6 * kTile + 8 * st; };

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), q0 = qt * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    tc::mbar_init(bar(0), 1);
    tc::mbar_init(bar(1), 1);
    tc::mbar_init_fence();
  }
  const int qlo = a.ranges[2 * qt], qhi = a.ranges[2 * qt + 1];
  const int* krange = a.ranges + 2 * a.nqt;
  const bool q_full = q0 + kT <= a.Sq;
  // this thread's rows rA, rA + 8: positions, lse * log2(e), delta
  const int rA = warp * 16 + (lane >> 2);
  const size_t plane = (size_t)a.B * a.Hq * a.Sq64;
  int qp[2];
  bool qv[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rA + 8 * r;
    qv[r] = qi < a.Sq;
    qp[r] = qv[r] ? a.qpos[qi] : 0;
    const size_t row = ((size_t)b * a.Hq + h) * a.Sq64 + qi;
    l2[r] = a.planes[row];
    dl[r] = a.planes[plane + row];
  }
  __syncthreads();   // barriers initialised

  auto next_k = [&](int kt) {
    while (kt < a.nkt && !band(qlo, qhi, krange[2 * kt], krange[2 * kt + 1], a.causal, a.window))
      ++kt;
    return kt;
  };
  // one thread issues a tile's copies (with `first`, also Q and dO)
  auto load = [&](int kt, int st, bool first) {
    if (tid != 0) return;
    tc::mbar_expect_tx(bar(st), (first ? 4 : 2) * kTile);
#pragma unroll
    for (int c = 0; c < Tile<D>::kAtoms; ++c) {
      const uint32_t off = c * kT * 128;
      if (first) {
        tc::tma_load_4d(sQ + off, &tq, c * 64, h, q0, b, bar(st));
        tc::tma_load_4d(sDO + off, &tdo, c * 64, h, q0, b, bar(st));
      }
      tc::tma_load_4d(sK(st) + off, &tk, c * 64, hk, kt * kT, b, bar(st));
      tc::tma_load_4d(sV(st) + off, &tv, c * 64, hk, kt * kT, b, bar(st));
    }
  };

  const float scale2 = a.scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int kt = next_k(0);
  if (kt < a.nkt) load(kt, 0, true);
  for (int it = 0; kt < a.nkt; ++it) {
    const int st = it & 1, nxt = next_k(kt + 1), k0 = kt * kT;
    if (nxt < a.nkt) load(nxt, st ^ 1, false);   // in flight while tile kt computes
    const bool full = q_full && k0 + kT <= a.Skv &&
                      all_live(qlo, qhi, krange[2 * kt], krange[2 * kt + 1], a.causal, a.window);
    const uint32_t bits =
        full ? ~0u : tile_bits(qp, qv, a.kpos, k0, a.Skv, true, a.causal, a.window);
    tc::mbar_wait(bar(st), (it >> 1) & 1);

    // ---- S = Q K^T, dP = dO V^T ----
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    ss_product<D>(s, sQ, sK(st));
    tc::wgmma_commit();
    ss_product<D>(dp, sDO, sV(st));
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    tc::fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = (bits >> i) & 1 ? tc::ex2(s[i] * scale2 - l2[(i >> 1) & 1]) : 0.f;
    tc::wgmma_wait<0>();
    tc::fence_regs(dp);
    // ---- dS in bf16 (its fragment of keys 16ks..16ks+15 is the A fragment) ----
    uint32_t da[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * ks + 2 * j;
        const float d = dl[j & 1];
        da[ks][j] = tc::pack_bf16(s[i] * (dp[i] - d) * a.scale, s[i + 1] * (dp[i + 1] - d) * a.scale);
      }
    }
    // ---- dQ += dS K (K MN-major) ----
    tc::wgmma_fence();
    rs_product<D>(acc, da, sK(st));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    __syncthreads();   // stage st may be refilled
    kt = nxt;
  }

  // ---- dQ in bf16, staged through the Q tile for 16-byte stores ----
  __syncthreads();
  stage_tile<D>(sm, acc);
  __syncthreads();
  write_tile<D>(sm, a.dq + (((size_t)b * a.Sq + q0) * a.Hq + h) * D, min(kT, a.Sq - q0),
                (size_t)a.Hq * D);
}

// dK and dV (kPart 0), dV alone (1) or dK alone (2): block (kv head, key
// tile, batch row), over the group's G heads and their live query tiles.
template <int D, int kPart>
__global__ void __launch_bounds__(kThreads, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              TcArgs a) {
  constexpr bool kDV = kPart != 2, kDK = kPart != 1;
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = tc::smem_u32(smem_raw);
  const uint32_t pad = (1024 - (base0 & 1023)) & 1023;
  uint8_t* sm = smem_raw + pad;
  const uint32_t sK = base0 + pad, sV = sK + kTile;
  auto sQ = [&](int st) { return sK + (2 + 2 * st) * kTile; };
  auto sDO = [&](int st) { return sK + (3 + 2 * st) * kTile; };
  auto sLD = [&](int st) { return sK + 6 * kTile + 512 * st; };   // lse2[64], delta[64]
  auto bar = [&](int st) { return sK + 6 * kTile + 1024 + 8 * st; };

  const int hk = blockIdx.x, kt = blockIdx.y, b = blockIdx.z, k0 = kt * kT;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    tc::mbar_init(bar(0), 1);
    tc::mbar_init(bar(1), 1);
    tc::mbar_init_fence();
  }
  const int klo = a.ranges[2 * (a.nqt + kt)], khi = a.ranges[2 * (a.nqt + kt) + 1];
  const bool k_full = k0 + kT <= a.Skv;
  // this thread's keys rA, rA + 8
  const int rA = warp * 16 + (lane >> 2);
  int kp[2];
  bool kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + rA + 8 * r;
    kv[r] = ki < a.Skv;
    kp[r] = kv[r] ? a.kpos[ki] : 0;
  }
  const size_t plane = (size_t)a.B * a.Hq * a.Sq64;
  __syncthreads();   // barriers initialised

  auto next_q = [&](int qt) {
    while (qt < a.nqt && !band(a.ranges[2 * qt], a.ranges[2 * qt + 1], klo, khi, a.causal, a.window))
      ++qt;
    return qt;
  };
  // one thread issues an item's copies: Q, dO and their (lse, delta) rows
  // (with `first`, also K, and V when dK is computed)
  auto load = [&](int gi, int qt, int st, bool first) {
    if (tid != 0) return;
    const int h = hk * G + gi;
    tc::mbar_expect_tx(bar(st), 2 * kTile + 512 + (first ? (kDK ? 2 : 1) * kTile : 0));
#pragma unroll
    for (int c = 0; c < Tile<D>::kAtoms; ++c) {
      const uint32_t off = c * kT * 128;
      if (first) {
        tc::tma_load_4d(sK + off, &tk, c * 64, hk, k0, b, bar(st));
        if (kDK) tc::tma_load_4d(sV + off, &tv, c * 64, hk, k0, b, bar(st));
      }
      tc::tma_load_4d(sQ(st) + off, &tq, c * 64, h, qt * kT, b, bar(st));
      tc::tma_load_4d(sDO(st) + off, &tdo, c * 64, h, qt * kT, b, bar(st));
    }
    const size_t row = ((size_t)b * a.Hq + h) * a.Sq64 + qt * kT;
    tc::bulk_load(sLD(st), a.planes + row, 256, bar(st));
    tc::bulk_load(sLD(st) + 256, a.planes + plane + row, 256, bar(st));
  };

  const float scale2 = a.scale * kLog2e;
  float dva[kDV ? D / 2 : 2], dka[kDK ? D / 2 : 2];
#pragma unroll
  for (int i = 0; i < (kDV ? D / 2 : 2); ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDK ? D / 2 : 2); ++i) dka[i] = 0.f;
  const int q_first = next_q(0);
  int gi = q_first < a.nqt ? 0 : G, qt = q_first;   // no live query tile: dK = dV = 0
  if (gi < G) load(0, qt, 0, true);
  for (int it = 0; gi < G; ++it) {
    const int st = it & 1;
    int ngi = gi, nq = next_q(qt + 1);
    if (nq >= a.nqt) {
      ++ngi;
      nq = q_first;
    }
    if (ngi < G) load(ngi, nq, st ^ 1, false);   // in flight while this item computes
    const int q0 = qt * kT;
    const bool full = k_full && q0 + kT <= a.Sq &&
                      all_live(a.ranges[2 * qt], a.ranges[2 * qt + 1], klo, khi, a.causal,
                               a.window);
    const uint32_t bits =
        full ? ~0u : tile_bits(kp, kv, a.qpos, q0, a.Sq, false, a.causal, a.window);
    tc::mbar_wait(bar(st), (it >> 1) & 1);

    // ---- S^T = K Q^T (and dP^T = V dO^T) ----
    float s[32], dp[kDK ? 32 : 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tc::wgmma_fence();
    ss_product<D>(s, sK, sQ(st));
    tc::wgmma_commit();
    if constexpr (kDK) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = 0.f;
      ss_product<D>(dp, sV, sDO(st));
      tc::wgmma_commit();
      tc::wgmma_wait<1>();
    } else {
      tc::wgmma_wait<0>();
    }
    tc::fence_regs(s);
    const float* ld = reinterpret_cast<const float*>(sm + (sLD(st) - sK));
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = (bits >> i) & 1 ? tc::ex2(s[i] * scale2 - ld[frag_col(i, lane)]) : 0.f;
    // ---- dV += bf16(P^T) dO (dO MN-major) ----
    uint32_t pa[4][4], da[4][4];
    if constexpr (kDV) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[ks][j] = tc::pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
      }
      tc::wgmma_fence();
      rs_product<D>(dva, pa, sDO(st));
      tc::wgmma_commit();
    }
    // ---- dS^T = P^T (dP^T - delta) scale; dK += bf16(dS^T) Q (Q MN-major) ----
    if constexpr (kDK) {
      tc::wgmma_wait<kDV ? 1 : 0>();
      tc::fence_regs(dp);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * ks + 2 * j, c = frag_col(i, lane);
          da[ks][j] = tc::pack_bf16(s[i] * (dp[i] - ld[kT + c]) * a.scale,
                                    s[i + 1] * (dp[i + 1] - ld[kT + c + 1]) * a.scale);
        }
      }
      tc::wgmma_fence();
      rs_product<D>(dka, da, sQ(st));
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
    if constexpr (kDV) tc::fence_regs(dva);
    if constexpr (kDK) tc::fence_regs(dka);
    __syncthreads();   // stage st may be refilled
    gi = ngi;
    qt = nq;
  }

  // ---- dK, dV in bf16, staged through the K and V tiles ----
  __syncthreads();
  if constexpr (kDK) stage_tile<D>(sm, dka);
  if constexpr (kDV) stage_tile<D>(sm + kTile, dva);
  __syncthreads();
  const size_t out = (((size_t)b * a.Skv + k0) * a.Hkv + hk) * D;
  const int n = min(kT, a.Skv - k0);
  if constexpr (kDK) write_tile<D>(sm, a.dk + out, n, (size_t)a.Hkv * D);
  if constexpr (kDV) write_tile<D>(sm + kTile, a.dv + out, n, (size_t)a.Hkv * D);
}

template <typename Kern>
cudaError_t run(Kern kern, dim3 grid, int smem, cudaStream_t st, const CUtensorMap (&m)[4],
                const TcArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

// prep, dQ, then dK and dV (D = 256: dV, then dK), in that order.
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const TcArgs& a,
                      cudaStream_t st) {
  CUtensorMap m[4];   // q, k, v, dout: boxes of 64 rows x 64 columns of one head
  cudaError_t err = tc::bshd_map(&m[0], q, false, a.B, a.Sq, a.Hq, D, kT, 1, 64);
  if (err == cudaSuccess) err = tc::bshd_map(&m[1], k, false, a.B, a.Skv, a.Hkv, D, kT, 1, 64);
  if (err == cudaSuccess) err = tc::bshd_map(&m[2], v, false, a.B, a.Skv, a.Hkv, D, kT, 1, 64);
  if (err == cudaSuccess) err = tc::bshd_map(&m[3], a.dout, false, a.B, a.Sq, a.Hq, D, kT, 1, 64);
  if (err != cudaSuccess) return err;
  const long long nrow = (long long)a.B * a.Hq * a.Sq64;
  const long long blocks = (nrow + kWarps - 1) / kWarps + (a.nqt + a.nkt + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  prep_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq(a.Hq, a.nqt, a.B), gk(a.Hkv, a.nkt, a.B);
  err = run(dq_tc_kernel<D>, gq, smem_bytes<D>(false), st, m, a);
  if (err != cudaSuccess) return err;
  if constexpr (D == 256) {
    err = run(dkv_tc_kernel<D, 1>, gk, smem_bytes<D>(true), st, m, a);
    if (err != cudaSuccess) return err;
    return run(dkv_tc_kernel<D, 2>, gk, smem_bytes<D>(true), st, m, a);
  } else {
    return run(dkv_tc_kernel<D, 0>, gk, smem_bytes<D>(true), st, m, a);
  }
}

}  // namespace

// The backward's kernels on one stream, in order: `route` names the route
// (0 SIMT: delta, dq, dk/dv; 1 tensor cores: prep, dq, dk/dv, at D = 256
// dv and dk; 2 small heads, D <= 32: dq with delta, dk/dv).  All tensors
// contiguous in the layouts above; `scratch` fp32: SIMT and small heads
// delta (B, Sq, Hq), tensor cores the (2, B, Hq, ceil(Sq / 64) * 64)
// planes; `ranges` int32 (ceil(Sq / 64) + ceil(Skv / 64), 2), tensor
// cores only; window <= 0 means none.
extern "C" int rt_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* scratch, void* ranges,
                            const void* qpos, const void* kpos, void* dq, void* dk, void* dv,
                            int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                            int window, float scale, int dtype, int route, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 256 ||
      Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const int nqt = (Sq + kT - 1) / kT, nkt = (Skv + kT - 1) / kT;
    if (dtype != rt::kBF16 || (D != 64 && D != 128 && D != 256) || nqt > 65535 || nkt > 65535)
      return cudaErrorInvalidValue;
    using BF = __nv_bfloat16;
    const TcArgs a{static_cast<const BF*>(o), static_cast<const BF*>(dout),
                   static_cast<const float*>(lse), static_cast<float*>(scratch),
                   static_cast<int*>(ranges), static_cast<const int*>(qpos),
                   static_cast<const int*>(kpos), static_cast<BF*>(dq), static_cast<BF*>(dk),
                   static_cast<BF*>(dv), B, Sq, Skv, Hq, Hkv, D, causal, window, nqt * kT, nqt,
                   nkt, scale};
    if (D == 64) return launch_tc<64>(q, k, v, a, st);
    if (D == 128) return launch_tc<128>(q, k, v, a, st);
    return launch_tc<256>(q, k, v, a, st);
  }
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(scratch),
         static_cast<const int*>(qpos), static_cast<const int*>(kpos), dq, dk, dv,
         B, Sq, Skv, Hq, Hkv, D, causal, window, scale};
  if (route != 0 && route != 2) return cudaErrorInvalidValue;
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return route == 2 ? sh::launch_d<T>(a, st) : launch_simt_d<T>(a, st);
  });
}
