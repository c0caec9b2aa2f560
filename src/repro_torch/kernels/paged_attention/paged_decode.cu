// Paged-decode attention for Hopper, sm_90a: split-K over pages
// (flash-decoding), K/V staged by 16-byte cp.async.
//
// Replaces the Pallas TPU kernel `repro/kernels/paged_attention/kernel.py`
// (`_paged_decode_kernel`, :40, launched by `paged_decode_attention`, :112;
// wrapper `ops.py:paged_decode_mha`) and computes its function: one
// post-RoPE query token per request attends over that request's pages of
// the pre-RoPE arena (P, page, L, Hkv, D), addressed through page_ids
// (N, Pmax) and slot_pos (N, Pmax, page).  A slot's position is both its
// liveness (-1: no live token of this row) and its RoPE angle.  Keys are
// rotated in fp32 (half-split, by the wrapper's frequency table, so the
// angles are the plain version's bitwise; accurate sincosf, since angles
// reach thousands of radians; products and sums without FMA contraction)
// and rounded to q's dtype; scores are fp32; probabilities are rounded to
// the arena dtype before the PV product; the mask constant is the finite
// -1e30 and denominators are clamped at 1e-30.  GQA by index: a block
// serves the G = Hq / Hkv query heads of one kv head.
//
// Bound on the card: bytes.  Per live slot and kv head the function reads
// one K and one V row (2 x D x 4 bytes at the fp32 arena) for ~4 x G x D
// flops: ~2 FLOP/B at G = 4, an order below the fp32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B).  So the design is about bytes
// in flight; tensor cores would speed up arithmetic that is not the limit.
// (`mma.sync` on bf16 keys would start to matter only at larger G, where
// the score and PV products grow G-fold and the bytes do not.)
//
// Design, step by step against the bound:
// - Split-K over pages.  One block of 4 warps per (split, kv head,
//   request); a split is `pps` consecutive page columns of the view.  The
//   wrapper chooses pps on the host from the shapes alone
//   (`ops.split_pages`: enough splits that the grid fills the card about
//   once at four blocks per SM), never from slot_pos.  The served call
//   (N = 8, Hkv = 8, Pmax = 32) runs 8 splits of 4 pages: 512 blocks,
//   where one block per (request, kv head) gave 64 on 132 SMs.
// - Bytes in flight.  A block first stages its split's slot positions and
//   K/V row indices in shared memory (one round trip).  Each warp then
//   streams its own 4 slots of every 16-slot chunk through a 2-stage ring
//   of cp.async copies (16 bytes a thread, .cg: through L2 only) and
//   computes on them, so the ring needs no block-wide barrier; the copies
//   of chunk c + 1 are in flight while chunk c is computed.  One (layer,
//   kv head) plane of a slot is one contiguous row (512 bytes at fp32,
//   D = 128), which one warp instruction moves.  With 4 blocks on an SM
//   that is 64 KB in flight per SM (more stages were no faster).  A warp's
//   chunk without a live slot issues no copy and no arithmetic; a dead
//   slot of a live one gets zero-filled rows (cp.async with a source size
//   of 0 reads nothing).
// - Arithmetic on CUDA cores, fp32 FMAs.  Each warp owns 4 slots of a
//   chunk and keeps its own online-softmax state for the G heads.  Lanes
//   split the head dimension (rotation pairs i = lane + 32t, outputs
//   d = lane + 32t), q stays in registers, the 4 slots' rotations and dot
//   products run side by side without branches, and a reduce-scatter of
//   each slot's G partial sums leaves every lane the score of one head, so
//   the softmax needs no further shuffles.
// - Combine.  The 4 warps merge through shared memory, thread d taking
//   column d of every head.  With one split the block writes the output;
//   otherwise it writes its partial m, l (fp32 per query head) and acc
//   (fp32, D per head) to a workspace, and the last block of its (request,
//   kv head), found through an atomic ticket, merges the splits: m* = max
//   m_s, l = sum l_s e^(m_s - m*), o = sum acc_s e^(m_s - m*) / max(l,
//   1e-30), in q's dtype, one lane per split and every load in one round
//   trip, then resets the ticket for the next call.  A ticket rather than
//   a second combine kernel: decode calls this 36 times a step on a
//   host-paced path, and a second launch would add its host and device
//   overhead to each.  A split with no live slot leaves m = -1e30, l = 0,
//   acc = 0 and adds exactly nothing; a row with no live slot gives 0.
#include "../attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kW = 4;                 // slots per warp per chunk
constexpr int kBK = kWarps * kW;      // slots per chunk (one ring stage)
constexpr int kStages = 2;
constexpr int kDMax = 128;
constexpr int kT = kDMax / 64;        // rotation pairs per lane
constexpr int kDPL = kDMax / 32;      // output elements per lane
constexpr int kRowMax = kDMax * 4;    // bytes of a K or V row at fp32
constexpr int kLGMax = 4;             // G <= 16
constexpr int kMaxSplits = 32;      // the combine gives each split one lane
static_assert(kThreads >= kDMax, "the merges give each thread one column d");

struct Args {
  const void* q;
  const void* ak;
  const void* av;
  const int* page_ids;
  const int* slot_pos;
  const float* freqs;
  void* o;
  float* ws_acc;      // (N, Hkv, splits, G, D)
  float* ws_ml;       // (N, Hkv, splits, G, 2)
  int* tickets;       // (N, Hkv), zero between calls
  int Hq, Hkv, G, D, page, L, layer, Pmax, pps, splits, vec16, region;
  float scale;
};

// Asynchronous copies of 16 (.cg, L2 only) or 4 bytes into shared memory;
// `n` bytes are read from `src` (0: none) and the rest are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[0..2^LG) are per-lane partial sums of 2^LG values.  Returns the full
// sum over the warp of value (lane >> (5 - LG)); lanes with equal index
// return bitwise-equal sums.
template <int LG>
__device__ __forceinline__ float reduce_scatter(float (&v)[1 << LG], int lane) {
#pragma unroll
  for (int k = 0; k < LG; ++k) {
    const int o = 16 >> k;
    const int h = (1 << LG) >> (k + 1);   // values kept after this step
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(rt::kFull, send, o);
    }
  }
  float x = v[0];
#pragma unroll
  for (int o = 16 >> LG; o > 0; o >>= 1) x += __shfl_xor_sync(rt::kFull, x, o);
  return x;
}

template <typename TQ, typename TA, int LG>
__global__ void __launch_bounds__(kThreads, LG <= 2 ? 4 : (LG == 3 ? 3 : 2))
paged_decode_split_kernel(const Args a) {
  constexpr int G = 1 << LG;          // the group padded to a power of two
  constexpr int kSh = 5 - LG;         // lane >> kSh is the lane's head
  extern __shared__ __align__(16) unsigned char smem[];

  const int s = blockIdx.x, hk = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = a.D, half = D / 2;
  const int c0 = s * a.pps, ncols = min(a.pps, a.Pmax - c0);
  const int nslots = ncols * a.page;
  const int nchunks = (nslots + kBK - 1) / kBK;
  const int row_bytes = D * static_cast<int>(sizeof(TA));
  const int stage_bytes = 2 * kBK * row_bytes;   // K rows, then V rows

  unsigned char* ring = smem;                     // also the merge scratch
  int* row_s = reinterpret_cast<int*>(smem + a.region);   // K/V row index, or -1
  int* pos_s = row_s + a.pps * a.page;
  int* last_s = pos_s + a.pps * a.page;

  // the split's positions and K/V row indices (the wrapper checks that the
  // arena has fewer than 2^31 rows); q and the frequencies in registers;
  // all loads independent: one round trip
  const int* pos_g = a.slot_pos + ((size_t)n * a.Pmax + c0) * a.page;
  const int* pid_g = a.page_ids + (size_t)n * a.Pmax + c0;
  for (int f = tid; f < nslots; f += kThreads) {
    const int pos = pos_g[f];
    const int col = f / a.page, slot = f - col * a.page;
    pos_s[f] = pos;
    row_s[f] = pos < 0 ? -1 : ((pid_g[col] * a.page + slot) * a.L + a.layer) * a.Hkv + hk;
  }
  const TQ* qrow = static_cast<const TQ*>(a.q) + ((size_t)n * a.Hq + (size_t)hk * a.G) * D;
  float qr[G][kT][2], fr[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int i = lane + 32 * t;
    fr[t] = i < half ? a.freqs[i] : 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool ok = g < a.G && i < half;
      qr[g][t][0] = ok ? rt::to_f(qrow[g * D + i]) : 0.f;
      qr[g][t][1] = ok ? rt::to_f(qrow[g * D + i + half]) : 0.f;
    }
  }
  __syncthreads();

  // Each warp streams and computes its own kW slots of every chunk (rows
  // warp * kW .. + kW - 1 of a stage: K rows, then V rows kBK further), so
  // the ring needs no block-wide barrier.  A chunk with none of the warp's
  // slots live issues no copy; a dead slot of a live one gets zero-filled
  // rows (cp.async with a source size of 0 reads nothing).  One commit
  // group per chunk.
  auto issue = [&](int c) {
    int rows[kW];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int f = c * kBK + warp * kW + k;
      rows[k] = c < nchunks && f < nslots ? row_s[f] : -1;
      any |= rows[k] >= 0;
    }
    if (any) {                        // warp-uniform
      unsigned char* st = ring + (c % kStages) * stage_bytes + warp * kW * row_bytes;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const size_t off = (size_t)(rows[k] < 0 ? 0 : rows[k]) * row_bytes;
        const unsigned char* sk = static_cast<const unsigned char*>(a.ak) + off;
        const unsigned char* sv = static_cast<const unsigned char*>(a.av) + off;
        unsigned char* dk = st + k * row_bytes;
        unsigned char* dv = dk + kBK * row_bytes;
        if (a.vec16) {                // a row is at most 512 bytes: one copy a lane
          const int b = lane * 16, nb = rows[k] < 0 ? 0 : 16;
          if (b < row_bytes) {
            cp_async16(dk + b, sk + b, nb);
            cp_async16(dv + b, sv + b, nb);
          }
        } else {
          const int nb = rows[k] < 0 ? 0 : 4;
#pragma unroll
          for (int u = 0; u < kRowMax / (32 * 4); ++u) {
            const int b = (lane + 32 * u) * 4;
            if (b < row_bytes) {
              cp_async4(dk + b, sk + b, nb);
              cp_async4(dv + b, sv + b, nb);
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  float m = rt::kNegInf, l = 0.f;     // the lane's head: lane >> kSh
  float acc[G][kDPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int t = 0; t < kDPL; ++t) acc[g][t] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                     // chunk c landed; this warp is done with chunk c - 1
    issue(c + kStages - 1);
    const TA* ks = reinterpret_cast<const TA*>(ring + (c % kStages) * stage_bytes) +
                   warp * kW * D;     // this warp's kW slots
    const TA* vs = ks + kBK * D;

    int pos[kW];
    unsigned live = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int f = c * kBK + warp * kW + w;
      pos[w] = f < nslots ? pos_s[f] : -1;
      live |= (pos[w] >= 0 ? 1u : 0u) << w;
    }
    if (!live) continue;              // warp-uniform: none of this warp's slots live

    // scores of the kW slots, side by side (dead rows are zeros; masked below)
    float part[kW][G];
#pragma unroll
    for (int w = 0; w < kW; ++w)
#pragma unroll
      for (int g = 0; g < G; ++g) part[w][g] = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int i = lane + 32 * t;
      if (i >= half) continue;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float x1 = rt::to_f(ks[w * D + i]);
        const float x2 = rt::to_f(ks[w * D + i + half]);
        float sn, cs;
        sincosf((float)pos[w] * fr[t], &sn, &cs);
        const float k1 = rt::round_as<TQ>(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)));
        const float k2 = rt::round_as<TQ>(__fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs)));
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[w][g] = fmaf(qr[g][t][1], k2, fmaf(qr[g][t][0], k1, part[w][g]));
      }
    }
    float sc[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float x = reduce_scatter<LG>(part[w], lane) * a.scale;
      sc[w] = (live >> w) & 1u ? x : rt::kNegInf;
    }

    float mc = sc[0];
#pragma unroll
    for (int w = 1; w < kW; ++w) mc = fmaxf(mc, sc[w]);
    const float m_new = fmaxf(m, mc);
    const float corr = expf(m - m_new);
    float pr[kW], psum = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float p = (live >> w) & 1u ? expf(sc[w] - m_new) : 0.f;
      psum += p;
      pr[w] = rt::round_as<TA>(p);
    }
    l = l * corr + psum;
    m = m_new;

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float cg = __shfl_sync(rt::kFull, corr, g << kSh);
#pragma unroll
      for (int t = 0; t < kDPL; ++t) acc[g][t] *= cg;
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) {    // a dead slot: p = 0 and a zero row
      float vv[kDPL];
#pragma unroll
      for (int t = 0; t < kDPL; ++t) {
        const int d = lane + 32 * t;
        vv[t] = d < D ? rt::to_f(vs[w * D + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = __shfl_sync(rt::kFull, pr[w], g << kSh);
#pragma unroll
        for (int t = 0; t < kDPL; ++t) acc[g][t] = fmaf(pg, vv[t], acc[g][t]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: merge the warps

  float* mw = reinterpret_cast<float*>(ring);     // [kWarps][G] running maxima
  float* lw = mw + kWarps * G;                    // [kWarps][G] sums
  float* aw = lw + kWarps * G;                    // [kWarps][G][D]
  if ((lane & ((1 << kSh) - 1)) == 0) {
    mw[warp * G + (lane >> kSh)] = m;
    lw[warp * G + (lane >> kSh)] = l;
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int t = 0; t < kDPL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) aw[(warp * G + g) * D + d] = acc[g][t];
    }
  __syncthreads();

  // thread d merges column d of every head over the warps, then writes the
  // output (one split) or its split's partials
  TQ* orow = static_cast<TQ*>(a.o) + ((size_t)n * a.Hq + (size_t)hk * a.G) * D;
  const size_t stride = (size_t)a.G * D;          // from one split's acc to the next
  const size_t part0 = ((size_t)n * a.Hkv + hk) * a.splits;   // split 0 of this group
  const int d = tid;
  if (d < D) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= a.G) break;
      float mx = rt::kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * G + g]);
      float lt = 0.f, at = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(mw[w * G + g] - mx);
        lt = fmaf(lw[w * G + g], f, lt);
        at = fmaf(aw[(w * G + g) * D + d], f, at);
      }
      if (a.splits == 1) {
        orow[g * D + d] = rt::from_f<TQ>(at / fmaxf(lt, 1e-30f));
      } else {
        a.ws_acc[(part0 + s) * stride + g * D + d] = at;
        if (d == 0) {
          a.ws_ml[((part0 + s) * a.G + g) * 2] = mx;
          a.ws_ml[((part0 + s) * a.G + g) * 2 + 1] = lt;
        }
      }
    }
  }
  if (a.splits == 1) return;

  // the last block of this (request, kv head) merges the splits
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)n * a.Hkv + hk;
  if (tid == 0) *last_s = atomicAdd(ticket, 1) == a.splits - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // warp w merges heads w, w + 4, ...: lane j holds split j's (m, l), and
  // the lane's columns d = lane + 32t of eight splits at a time are loaded
  // in the same round trip
  for (int g = warp; g < a.G; g += kWarps) {
    const float* ml = a.ws_ml + (part0 * a.G + g) * 2;        // split p: + 2p G
    const float* ac = a.ws_acc + part0 * stride + g * D;      // split p: + p stride
    const bool ok = lane < a.splits;
    const float mj = ok ? __ldcg(ml + (size_t)lane * a.G * 2) : rt::kNegInf;
    const float lj = ok ? __ldcg(ml + (size_t)lane * a.G * 2 + 1) : 0.f;
    float av[8][kDPL];
    auto load = [&](int p0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < kDPL; ++t) {
          const int dd = lane + 32 * t;
          av[j][t] = p0 + j < a.splits && dd < D ? __ldcg(ac + (p0 + j) * stride + dd) : 0.f;
        }
    };
    load(0);
    const float mx = rt::warp_max(mj);
    const float wj = expf(mj - mx);                 // 0 for a dead or missing split
    const float lt = rt::warp_sum(lj * wj);
    float at[kDPL];
#pragma unroll
    for (int t = 0; t < kDPL; ++t) at[t] = 0.f;
    for (int p0 = 0;;) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = __shfl_sync(rt::kFull, wj, (p0 + j) & 31);
#pragma unroll
        for (int t = 0; t < kDPL; ++t) at[t] = fmaf(av[j][t], w, at[t]);
      }
      p0 += 8;
      if (p0 >= a.splits) break;
      load(p0);
    }
#pragma unroll
    for (int t = 0; t < kDPL; ++t) {
      const int dd = lane + 32 * t;
      if (dd < D) orow[g * D + dd] = rt::from_f<TQ>(at[t] / fmaxf(lt, 1e-30f));
    }
  }
  if (tid == 0) *ticket = 0;
}

template <typename TQ, typename TA, int LG>
cudaError_t launch(Args a, int N, cudaStream_t st) {
  constexpr int G = 1 << LG;
  const int stage = kStages * 2 * kBK * a.D * static_cast<int>(sizeof(TA));
  const int merge = kWarps * G * (a.D + 2) * static_cast<int>(sizeof(float));
  a.region = ((stage > merge ? stage : merge) + 15) / 16 * 16;
  const int slots = a.pps * a.page;
  const size_t bytes = a.region + sizeof(int) * (2 * slots + 1);
  auto kern = paged_decode_split_kernel<TQ, TA, LG>;
  static size_t configured = 0;     // per instantiation: the largest size allowed so far
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err == cudaSuccess && configured == 0)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  kern<<<dim3(a.splits, a.Hkv, N), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TA>
cudaError_t launch_g(const Args& a, int N, cudaStream_t st) {
  int lg = 0;
  while ((1 << lg) < a.G) ++lg;
  switch (lg) {
    case 0: return launch<TQ, TA, 0>(a, N, st);
    case 1: return launch<TQ, TA, 1>(a, N, st);
    case 2: return launch<TQ, TA, 2>(a, N, st);
    case 3: return launch<TQ, TA, 3>(a, N, st);
    case 4: return launch<TQ, TA, 4>(a, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (N, Hq, D); arena_k/arena_v (P, page, L, Hkv, D); page_ids (N, Pmax)
// and slot_pos (N, Pmax, page) int32; freqs (D/2,) fp32; o like q.  The
// view's page columns run in `splits` splits of `pps` columns (splits =
// ceil(Pmax / pps)); with splits > 1, ws_acc (N*Hq*splits*D floats),
// ws_ml (N*Hq*splits*2 floats) and tickets (N*Hkv ints, all 0, left 0)
// are the workspace.  `vec16` = 1 selects 16-byte copies (the wrapper
// checks the row width and the arenas' alignment).
extern "C" int rt_paged_decode(const void* q, const void* arena_k, const void* arena_v,
                               const void* page_ids, const void* slot_pos, const void* freqs,
                               void* o, void* ws_acc, void* ws_ml, void* tickets, int N, int Hq,
                               int Hkv, int D, int page, int L, int layer, int Pmax, int pps,
                               int splits, float scale, int q_dtype, int arena_dtype, int vec16,
                               void* stream) {
  if (D < 2 || D > kDMax || D % 2 != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      Hq / Hkv > (1 << kLGMax) || N < 1 || N > 65535 || Hkv > 65535 || Pmax < 1 ||
      page < 1 || layer < 0 || layer >= L || pps < 1 || splits < 1 || splits > kMaxSplits ||
      splits != (Pmax + pps - 1) / pps ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  Args a{q, arena_k, arena_v, static_cast<const int*>(page_ids),
         static_cast<const int*>(slot_pos), static_cast<const float*>(freqs), o,
         static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), static_cast<int*>(tickets),
         Hq, Hkv, Hq / Hkv, D, page, L, layer, Pmax, pps, splits, vec16, 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::with_dtype(q_dtype, [&](auto tq) {
    return rt::with_dtype(arena_dtype, [&](auto ta) {
      return launch_g<decltype(tq), decltype(ta)>(a, N, st);
    });
  });
}
