// Shared by the InfoNCE kernels (csrc/infonce_dual_fwd.cu,
// csrc/infonce_grad.cuh): the register-blocked fp32 product of one 64 x 64
// tile of s = a . b^T, a (n_a, D) and b (n_b, D), over D in 32-wide slices
// staged in shared memory.
//
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of the tile. A slice is staged as fp32 with row
// stride 33, so both the coalesced staging stores (consecutive k) and the
// reads (rows ty + 16 i: two addresses a warp; rows tx + 16 j: sixteen
// banks) are free of bank conflicts. bf16 inputs are widened as they are
// staged: their products are exact in fp32. Plain fp32 FMA, no TF32. Each
// entry sums over k in the same order whichever operand is a, so s and
// s^T are bitwise transposes of each other.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace infonce {

constexpr int kTile = 64;      // rows per CTA, columns per tile
constexpr int kSlice = 32;     // depth of one staged slice of D
constexpr int kLd = kSlice + 1;
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 entries of s each
constexpr int kMaxD = 512;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

// Rows row0 .. row0 + 63, columns k0 .. k0 + 31 of src (n x d) as fp32,
// row stride kLd; zero outside src.
template <typename T>
__device__ void stage_slice(float* dst, const T* src, int row0, int n, int d,
                            int k0) {
  for (int e = threadIdx.x; e < kTile * kSlice; e += kThreads) {
    const int r = e / kSlice;
    const int k = e % kSlice;
    const int gr = row0 + r;
    const int gk = k0 + k;
    dst[r * kLd + k] =
        (gr < n && gk < d) ? to_float(src[size_t(gr) * d + gk]) : 0.f;
  }
}

// acc[i][j] = a_{row0 + ty + 16 i} . b_{col0 + tx + 16 j} (unscaled fp32);
// rows past n_a of a and past n_b of b read as zero.
template <typename T>
__device__ void tile_products(float (&acc)[4][4], float* as, float* bs,
                              const T* a, const T* b, int row0, int col0,
                              int n_a, int n_b, int d) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < d; k0 += kSlice) {
    __syncthreads();  // the previous slice's readers are done
    stage_slice(as, a, row0, n_a, d, k0);
    stage_slice(bs, b, col0, n_b, d, k0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kSlice; ++k) {  // zero padding past d adds 0
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty + 16 * i) * kLd + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * kLd + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

}  // namespace infonce
