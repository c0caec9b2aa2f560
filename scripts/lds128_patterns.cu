// Shared-memory 16-byte loads (LDS.128) by address pattern: an SM's cycles
// per warp-instruction, from clock64 around 3,200 loads a warp, one block
// of 8 or 16 warps on each SM, rows of 80 bytes (5 chunks of 16).  Which
// patterns cost the minimum decides the layout of the small-head forward
// (`src/repro_torch/kernels/attn_small.cuh`).  On a card:
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o lds128 scripts/lds128_patterns.cu
//   ./lds128
#include <cstdio>
#include <cuda_runtime.h>
__global__ void k(int pattern, int iters, int zero, float* out, long long* cyc) {
  __shared__ __align__(16) float s[64 * 40];
  for (int i = threadIdx.x; i < 64 * 40; i += blockDim.x) s[i] = i * 0.5f;
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int row;
  switch (pattern) {
    case 0: row = 0; break;                 // all lanes one address
    case 1: row = lane / 8; break;          // 4 addresses, one per quarter (rows 0..3)
    case 2: row = (lane / 8) * 16; break;   // 4 addresses, rows 16 apart (stride 80 B rows)
    case 3: row = lane % 8; break;          // 8 per quarter, the same 8 in every quarter
    case 4: row = lane; break;              // 32 distinct rows
    default: row = lane % 2; break;         // 2 addresses
  }
  row += w;   // warps apart a little
  const float4* p = reinterpret_cast<const float4*>(s) + row * 5;   // 80-byte rows
  float4 acc = make_float4(0, 0, 0, 0);
  __syncthreads();
  long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float4 x = p[(j & 3) + (it * 16 + j) * zero];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
  }
  long long c1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = c1 - c0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}
int main() {
  float* out; long long* cyc;
  cudaMalloc(&out, 132 * 1024 * 4); cudaMalloc(&cyc, 132 * 8);
  const char* names[] = {"one address", "4 addr (1 per quarter, adjacent rows)", "4 addr (1 per quarter, rows 16 apart)",
                         "8 per quarter (same 8 each quarter)", "32 distinct rows", "2 addr"};
  for (int warps : {8, 16}) for (int pat = 0; pat < 6; ++pat) {
    const int iters = 200;
    k<<<132, warps * 32>>>(pat, iters, 0, out, cyc);
    cudaDeviceSynchronize();
    long long h[132]; cudaMemcpy(h, cyc, sizeof h, cudaMemcpyDeviceToHost);
    double n = (double)iters * 16 * warps;   // warp-instructions of LDS.128 per SM
    printf("%2d warps, %-40s %.2f cycles per LDS.128 warp-instruction\n", warps, names[pat], h[0] / n);
  }
  return 0;
}
