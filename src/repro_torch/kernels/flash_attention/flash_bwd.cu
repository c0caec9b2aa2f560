// Flash-attention backward (kernel K6) for Hopper, sm_90a.
//
// The JAX package has no Pallas backward: its training path differentiates
// `_flash` (`src/repro/models/layers.py:231`) through the hand-written
// custom VJP `_flash_bwd` (`:249`), a two-pass tile recompute in jnp.
// This kernel computes that function (wrapper `ops.py:mha_flash_bwd`,
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
// `|qpos - kpos| < w`).  Sums in fp32; outputs in T.  Every query row must
// see at least one key (causal self-attention does): a row with none has
// lse = -1e30, where the reference's exp(-1e30 - lse) is 1, not 0.
//
// Design: the reference's two passes as two kernels, plus one for delta.
// * dq: one block of 4 warps per (16-row query tile, query head, batch
//   row); each warp carries 4 rows' dQ in registers (D/32 columns a lane)
//   while 32-key K/V tiles stream through shared memory in fp32, one key
//   per lane in the score pass (its 4 rows' scores at once, so each K / V
//   element is read once for the 4), dS broadcast by shuffles into the
//   dQ update (each K element read once for the 4 rows).
// * dk/dv: one block per (16-key tile, kv head, batch row), each warp
//   owning 4 keys' dK and dV in registers, looping over the G query heads
//   of its kv group and over 32-row query tiles (one row per lane in the
//   score pass; each Q / dO element read once for the warp's 4 keys).  A block owns its keys for every head of the group, so
//   dK and dV are written once, without atomics: results are
//   deterministic.
// Both skip a tile whose position ranges admit no live pair (the causal
// and window band), from the tile's min and max positions.
//
// Bound on the card: operations.  Five products of 2*D per live pair and
// head (S, dP, dV, dQ, dK): at rcllm-qwen3-8b's 1 x 4,096 causal call
// (Hq 32, D 128) 344 GFLOP, 0.35 ms on bf16 tensor cores and 5.1 ms at
// the fp32 CUDA-core rate.  This first kernel is SIMT (CUDA-core FMAs,
// S and dP recomputed in each pass): right first, the tensor-core
// redesign is later work.
#include <climits>

#include "../attn_common.cuh"

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

template <typename T, int DPL>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_smem = (size_t)(2 * kBQ * a.D + 2 * kBK * (a.D + 1)) * sizeof(float);
  err = cudaFuncSetAttribute(dq_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  dim3 gq((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  dq_kernel<T, DPL><<<gq, kThreads, dq_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t kv_smem = (size_t)(2 * kKB + 2 * kQB) * (a.D + 1) * sizeof(float);
  err = cudaFuncSetAttribute(dkv_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  dim3 gk((a.Skv + kKB - 1) / kKB, a.Hkv, a.B);
  dkv_kernel<T, DPL><<<gk, kThreads, kv_smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t st) {
  if (a.D <= 32) return launch<T, 1>(a, st);
  if (a.D <= 64) return launch<T, 2>(a, st);
  if (a.D <= 128) return launch<T, 4>(a, st);
  if (a.D <= 256) return launch<T, 8>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous in the layouts above; `delta` (B, Sq, Hq) fp32
// scratch; window <= 0 means none.
extern "C" int rt_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta,
                            const void* qpos, const void* kpos, void* dq, void* dk,
                            void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                            int causal, int window, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 1 || D > 256 ||
      Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
         static_cast<const int*>(qpos), static_cast<const int*>(kpos), dq, dk, dv,
         B, Sq, Skv, Hq, Hkv, D, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return launch_d<T>(a, st);
  });
}
