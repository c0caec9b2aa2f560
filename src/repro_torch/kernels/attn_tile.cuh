// Tensor-core attention tile for Hopper (sm_90a), shared by the flash
// (B1) and selective (B2) kernels' bf16 routes.
//
// One warpgroup (128 threads) owns a 64-row M tile of queries.  The G
// query heads that share one kv head are packed into it as 64/G query
// rows x G heads (row m = query (m / G), head (m % G) of the group), so
// each K/V tile read from memory serves G heads.  Per 64-key tile:
//   S = Q K^T   wgmma m64n64k16, Q and K both K-major in shared memory
//               (128-byte swizzle), fp32 accumulators; fp32 keys are split
//               as they land into k_hi = bf16(k) and k_lo = bf16(k - k_hi)
//               and S = Q k_hi^T + Q k_lo^T (Q is bf16, so the product
//               keeps ~2^-17 of |q||k| per term: near the fp32 product);
//   mask + online softmax on the accumulator fragments (each thread holds
//               rows r and r + 8 of its warp's 16, four threads per row);
//   O += P V    wgmma m64nDk16 with P rounded to bf16 in registers (the
//               S fragment is the A fragment of the register form) and V
//               read MN-major from shared memory (descriptor transpose).
// K/V tiles stream through a 2-stage ring: one thread issues the TMA
// copies (cp.async.bulk.tensor) of tile j+1, counted against that stage's
// mbarrier, before tile j is computed; bf16 tiles land in the swizzled
// operand layout, fp32 keys in a raw tile that the threads split.
// Numerics are the SIMT kernels' (attn_common.cuh): finite -1e30 mask,
// fp32 scores and sums, probabilities in bf16 before PV, denominator
// clamped at 1e-30, output rounded once to bf16; the exponentials are
// 2^x of log2(e)-scaled scores and the division a reciprocal per row,
// which differ from them by fp32 rounding only.
// Blocks run the last query tiles (the ones that see the most keys)
// first.  Two blocks fit on an SM (shared memory: five bf16 tiles, 80 KB
// at D = 128, seven with fp32 keys, 113 KB; four blocks for one-tile
// calls, 48 KB), and they hide each other's latency; the products and the
// softmax of one warpgroup do not overlap.
//
// A kernel supplies a Policy with
//   init(b, hk, q0)      per-block mask rows;
//   n_tiles(q0, qr)      64-key tiles to consider;
//   tile_live(kt)        false: skip the tile (no load, no compute);
//   pos(qi)              query qi's position (qi < Sq);
//   flag(key)            per-key flag, nonzero = set (heavy hitter /
//                        kv_valid), key < Skv;
//   row_mask(pos, k0, f) the keys k0..k0+63 a query at `pos` attends, as
//                        bits, given the keys' flags f (the kernel adds
//                        key < Skv).
#pragma once

#include <cuda.h>

#include <type_traits>

#include "attn_common.cuh"

namespace rt {
namespace tc {

constexpr int kM = 64;         // query rows (x heads) per warpgroup tile
constexpr int kN = 64;         // keys per K/V tile
constexpr int kThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a 64-row bf16 tile stored as
// D/64 columns of 128-byte-swizzled atoms (8 rows x 128 B each): the
// canonical layout of a wgmma operand, K-major or MN-major alike.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// One TMA copy of a box of a 4-D tensor map into shared memory, counted
// against `bar`'s transaction bytes; coordinates past the tensor's edge
// read zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, counted against `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive on `bar` and expect `bytes` more transaction bytes in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// Generic-proxy writes to shared memory (the split's st.shared) made
// visible to wgmma's async proxy; each writer fences before the barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending (groups
// complete in the order they were committed).
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across the async wgmma.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x (MUFU.EX2; 2^-huge = 0, 2^0 = 1 exactly)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The n lowest bits set (none for n <= 0, all for n >= 64).
__device__ __forceinline__ uint64_t bits_below(int n) {
  return n <= 0 ? 0ull : n >= 64 ? ~0ull : (1ull << n) - 1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A B with A (64 x 16) and B (16 x N) from shared-memory descriptors,
// both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D = A B with A (64 x 16) bf16 from registers (four .b32 per thread) and
// B (16 x N) MN-major in shared memory (transposed by the descriptor).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The N = 256 form, for the attention backward's dQ at D = 256.
__device__ __forceinline__ void wgmma_rs_m64n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// O += A B, N = D columns: the register-A form of the width D.
template <int D> __device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                                          uint64_t db) {
  if constexpr (D == 256) wgmma_rs_m64n256_tb(o, a, db, 1);
  else if constexpr (D == 128) wgmma_rs_m64n128_tb(o, a, db, 1);
  else wgmma_rs_m64n64_tb(o, a, db, 1);
}

// Shared memory, in bf16 64 x D tiles aligned to the 1024-byte swizzle
// atom: Q, then stage 0 (K, V) and stage 1 (K, V) of the ring (the fp32
// route's hi / lo planes are the two K tiles), then the fp32 route's raw
// key tile (two more), and two mbarriers in the alignment slack.  With
// bf16 keys and at most one key tile (Skv <= 64, the offline build's
// documents) the ring never reaches stage 1, and the block takes only Q
// and stage 0: four blocks then fit on an SM instead of two.
template <bool kSplit> __host__ __device__ constexpr int smem_tiles(int Skv) {
  return kSplit ? 7 : Skv <= kN ? 3 : 5;
}

template <class Policy, typename TK, int D>
__global__ void __launch_bounds__(kThreads)
attn_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Sq,
               int Skv, int Hq, int Hkv, int log2g, float scale, Policy pol) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  constexpr bool kSplit = std::is_same<TK, float>::value;
  constexpr int kTile = kM * D * 2;              // bytes of one bf16 64 x D tile
  constexpr int kChunks = D / 8;                 // 16-byte bf16 chunks per row
  constexpr int kRowsPerPass = kThreads / kChunks;
  constexpr int kPasses = kM / kRowsPerPass;     // passes over a 64-row tile
  constexpr int kAtoms = D / 64;                 // 128-byte swizzle atom columns
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base0 = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (base0 & 1023)) & 1023;
  uint8_t* sm = smem_raw + pad;
  const uint32_t sQ = base0 + pad;
  auto sK = [&](int st) { return sQ + (1 + 2 * st) * kTile; };
  auto sV = [&](int st) { return sQ + (2 + 2 * st) * kTile; };
  const uint32_t sRaw = sQ + 5 * kTile;
  // the barriers live in the alignment slack, before or after the tiles
  const uint32_t bar0 = pad >= 16 ? base0 : sQ + smem_tiles<kSplit>(Skv) * kTile;
  auto bar = [&](int st) { return bar0 + 8 * st; };

  const int G = 1 << log2g, QR = kM >> log2g;
  // the last query tiles see the most keys: start them first
  const int b = blockIdx.z, hk = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * QR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a thread copies 16-byte chunk cc of rows rc, rc + kRowsPerPass, ...
  const int cc = tid % kChunks, rc = tid / kChunks;
  pol.init(b, hk, q0);
  if (tid == 0) {
    mbar_init(bar(0), 1);   // one arrival (with the bytes) per phase
    mbar_init(bar(1), 1);
    mbar_init_fence();
  }
  // mask reads, consumed once the first copies are in flight
  const int nkt = pol.n_tiles(q0, QR);
  const bool live_lo = lane < nkt && pol.tile_live(lane);
  const bool live_hi = lane + 32 < nkt && pol.tile_live(lane + 32);
  const int rA = warp * 16 + (lane >> 2);   // this thread's rows: rA, rA + 8
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + ((rA + 8 * r) >> log2g);
    pos[r] = qi < Sq ? pol.pos(qi) : -1;
  }
  __syncthreads();   // barriers initialised

  // One thread issues a tile's copies: V (and bf16 K) as 64 keys x 64
  // columns boxes that land swizzled in their atom columns, fp32 K as one
  // unswizzled 64 x D box; with `with_q` also the Q tile, whose box of 64/G
  // queries x G heads x 64 columns lands as rows m = query * G + head.
  // Keys and queries past the edges read zeros.
  auto load_tile = [&](int kt, int st, bool with_q) {
    if (tid != 0) return;
    constexpr uint32_t kBytes = kN * D * (sizeof(TK) + 2);
    mbar_expect_tx(bar(st), kBytes + (with_q ? kTile : 0));
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      if (with_q) tma_load_4d(sQ + a * 64 * 128, &tq, a * 64, hk * G, q0, b, bar(st));
      tma_load_4d(sV(st) + a * 64 * 128, &tv, a * 64, hk, kt * kN, b, bar(st));
      if constexpr (!kSplit) tma_load_4d(sK(st) + a * 64 * 128, &tk, a * 64, hk, kt * kN, b, bar(st));
    }
    if constexpr (kSplit) tma_load_4d(sRaw, &tk, 0, hk, kt * kN, b, bar(st));
  };
  // fp32 keys -> bf16 hi and lo planes, swizzled; loads of half the
  // passes are issued before any conversion
  auto split_keys = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 x[kPasses / 2][2];
#pragma unroll
      for (int i = 0; i < kPasses / 2; ++i) {
        const int j = rc + kRowsPerPass * (h * kPasses / 2 + i);
        const float4* src = reinterpret_cast<const float4*>(sm + (sRaw - sQ) + (j * D + cc * 8) * 4);
        x[i][0] = src[0];
        x[i][1] = src[1];
      }
#pragma unroll
      for (int i = 0; i < kPasses / 2; ++i) {
        const int j = rc + kRowsPerPass * (h * kPasses / 2 + i);
        const float f[8] = {x[i][0].x, x[i][0].y, x[i][0].z, x[i][0].w,
                            x[i][1].x, x[i][1].y, x[i][1].z, x[i][1].w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          hi[p] = pack_bf16(f[2 * p], f[2 * p + 1]);
          lo[p] = pack_bf16(f[2 * p] - __uint_as_float(hi[p] << 16),
                            f[2 * p + 1] - __uint_as_float(hi[p] & 0xffff0000u));
        }
        *reinterpret_cast<uint4*>(sm + (sK(0) - sQ) + sw128(j, cc)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(sm + (sK(1) - sQ) + sw128(j, cc)) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  // scores in log2 units: exp(x - m) = 2^(x log2e - m log2e)
  const float scale2 = scale * 1.4426950408889634f;

  // liveness of the first 64 tiles as one bit mask (live_bits, below);
  // later tiles ask the policy
  uint64_t live_bits = 0;
  auto next_live = [&](int kt) {
    while (kt < nkt && !(kt < 64 ? (live_bits >> kt) & 1 : pol.tile_live(kt))) ++kt;
    return kt;
  };
  // tile 0 is nearly always live: its copies (with Q's) start before the
  // liveness ballot; a dead tile 0 is drained and the ring starts at stage 1
  if (nkt > 0) load_tile(0, 0, true);
  live_bits =
      (uint64_t)__ballot_sync(kFull, live_lo) | ((uint64_t)__ballot_sync(kFull, live_hi) << 32);
  int kt = next_live(0), it0 = 0;
  if (nkt > 0 && kt != 0) {
    mbar_wait(bar(0), 0);
    it0 = 1;
    if (kt < nkt) load_tile(kt, 1, false);
  }
  for (int it = it0; kt < nkt; ++it) {
    const int st = it & 1;
    const int nxt = next_live(kt + 1);
    // the tile's key flags (lane l reads keys k0 + l and k0 + 32 + l), read
    // now and first used after the score product, so that the loads fly
    // during the wait and the product
    const int k0 = kt * kN;
    const uint32_t f_lo = k0 + lane < Skv ? pol.flag(k0 + lane) : 0u;
    const uint32_t f_hi = k0 + 32 + lane < Skv ? pol.flag(k0 + 32 + lane) : 0u;
    if constexpr (!kSplit) {
      if (nxt < nkt) load_tile(nxt, st ^ 1, false);   // in flight while tile kt computes
    }
    mbar_wait(bar(st), (it >> 1) & 1);
    if constexpr (kSplit) split_keys();
    fence_async_smem();
    __syncthreads();

    // ---- S = Q K^T (fp32 keys: Q k_hi^T + Q k_lo^T) ----
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t kb = sK(kSplit ? 0 : st);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks >> 2) * (64 * 128) + (ks & 3) * 32;
      wgmma_ss_m64n64(s, desc_sw128(sQ + off, 16, 1024), desc_sw128(kb + off, 16, 1024), ks > 0);
    }
    if constexpr (kSplit) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks >> 2) * (64 * 128) + (ks & 3) * 32;
        wgmma_ss_m64n64(s, desc_sw128(sQ + off, 16, 1024), desc_sw128(sK(1) + off, 16, 1024), 1);
      }
    }
    wgmma_commit();
    if constexpr (kSplit) {
      if (nxt < nkt) load_tile(nxt, st ^ 1, false);   // the raw tile was split: refill it
    }
    wgmma_wait_all();
    fence_regs(s);

    // ---- mask + online softmax; s[i] is row rA + 8 * ((i >> 1) & 1),
    //      key k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1).  Each row's
    //      attended keys of the tile as a 64-bit mask, shifted to this
    //      thread's columns ----
    const uint64_t flags = (uint64_t)__ballot_sync(kFull, f_lo != 0) |
                           ((uint64_t)__ballot_sync(kFull, f_hi != 0) << 32);
    const uint64_t in_range = bits_below(Skv - k0);
    uint64_t rm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rm[r] = (pol.row_mask(pos[r], k0, flags) & in_range) >> ((lane & 3) * 2);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const bool ok = (rm[r] >> ((i >> 2) * 8 + (i & 1))) & 1;
      s[i] = ok ? s[i] * scale2 : kNegInf;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = ex2(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(s[i] - mx[r]);
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l_run[r] = l_run[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    // P in bf16: the S fragment of keys 16ks..16ks+15 is the A fragment
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[ks][j] = pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);
    }

    // ---- O += P V (V MN-major: 8-key groups 1024 B apart, 64-column
    //      atoms kN * 128 B apart) ----
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_pv<D>(oacc, pa[ks], desc_sw128(sV(st) + ks * 16 * 128, kN * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
    __syncthreads();   // stage st (and the hi/lo planes) may be refilled
    kt = nxt;
  }

  // ---- epilogue: O / max(l, 1e-30) in bf16, staged through the Q tile
  //      for 16-byte stores ----
  __syncthreads();
  const float inv[2] = {1.f / fmaxf(l_run[0], 1e-30f), 1.f / fmaxf(l_run[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1, row = rA + 8 * r, col = (i >> 2) * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(sm + sw128(row, col >> 3) + (col & 7) * 2) =
        pack_bf16(oacc[i] * inv[r], oacc[i + 1] * inv[r]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int m = rc + kRowsPerPass * i, qi = q0 + (m >> log2g);
    if (qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * Hq + hk * G + (m & (G - 1));
    *reinterpret_cast<uint4*>(o + row * D + cc * 8) =
        *reinterpret_cast<const uint4*>(sm + sw128(m, cc));
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, S, H, D) tensor of bf16 or fp32 elements
// with boxes of (box_s, box_h, box_d) elements, 128-byte swizzled when the
// box row is 128 bytes (the wgmma operand layout) and plain otherwise.
inline cudaError_t bshd_map(CUtensorMap* map, const void* ptr, bool fp32, int B, int S, int H,
                            int D, int box_s, int box_h, int box_d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t es = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * es, (cuuint64_t)H * D * es, (cuuint64_t)S * H * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, (cuuint32_t)box_h, (cuuint32_t)box_s, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_d * es == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches attn_tc_kernel over (ceil(Sq / (64 / G)), Hkv, B) blocks on
// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q.
template <class Policy, typename TK, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int Hq, int Hkv, int log2g, float scale, const Policy& pol,
                      cudaStream_t st) {
  constexpr bool kSplit = std::is_same<TK, float>::value;
  constexpr int kTile = kM * D * 2;
  const int bytes = smem_tiles<kSplit>(Skv) * kTile + 1024;
  auto kern = attn_tc_kernel<Policy, TK, D>;
  static bool configured = false;   // once per instantiation, for the larger size
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_tiles<kSplit>(kN + 1) * kTile + 1024);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int qr = kM >> log2g;
  CUtensorMap tq, tk, tv;
  cudaError_t err = bshd_map(&tq, q, false, B, Sq, Hq, D, qr, 1 << log2g, 64);
  if (err == cudaSuccess) err = bshd_map(&tk, k, kSplit, B, Skv, Hkv, D, kN, 1, kSplit ? D : 64);
  if (err == cudaSuccess) err = bshd_map(&tv, v, false, B, Skv, Hkv, D, kN, 1, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + qr - 1) / qr, Hkv, B);
  kern<<<grid, kThreads, bytes, st>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq,
                                      Hkv, log2g, scale, pol);
  return cudaGetLastError();
}

// log2(G) for G in {1, 2, 4, 8}, else -1.
inline int log2_group(int g) {
  return g == 1 ? 0 : g == 2 ? 1 : g == 4 ? 2 : g == 8 ? 3 : -1;
}

}  // namespace tc
}  // namespace rt
