// NT-Xent triangular symmetric backward for Hopper (sm_90a), bound to
// PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _bwd_tri_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:350, launched by _bwd_tri_call at :406,
// pallas_call at :414), the backward of ntxent_loss_fused(triangular=True).
// For stacked views z (2N, D) and the forward's lse (2N,), as that kernel
// computes:
//   s[i, j] = (z_i . z_j) * inv_t in fp32, the diagonal masked to -1e30;
//   G[i, j] = (exp(min(s - lse[i], 0)) - pos) + (exp(min(s - lse[j], 0))
//             - pos), pos = 1 iff j = (i + N) mod 2N;
//   grad    = G @ z (2N, D) fp32, before the caller's g / T scale.
// G is symmetric, so only the upper-triangle tiles (i <= j, in 64-row
// blocks) are formed, each driving grad[block i] += G_ij z_j and, for
// j > i, grad[block j] += G_ij^T z_i: 3 (2N)^2 D operations where the
// rectangular backward (#5) does 4.
//
// Design. The TPU kernel adds both products into a full-length fp32
// accumulator carried across its sequential grid. Hopper blocks run in no
// order and this port uses no atomics, so one CTA per upper tile (i, j)
// forms s once (infonce_tile.cuh's register-blocked fp32 FMA, bf16
// widened, no TF32), G into shared memory, and writes its products as
// partials: G_ij z_j to part[j][rows of block i] and, for j > i,
// G_ij^T z_i to part[i][rows of block j]; every (column block, row) slot is
// written by exactly one CTA. A second kernel sums each row's nb partials
// in column-block order. The result is repeatable. Memory of the partials,
// nb 2N D fp32 (nb = 2N / 64): 2.1 MB at 2N = 512, D = 128; 537 MB at
// 2N = 8192, D = 128 (0.7% of an 80 GB card), read once by the sum. A
// bounded design (a CTA walking a strip of tiles) would keep the partials
// per strip instead of per tile, at fewer CTAs.
//
// Bound: 3 (2N)^2 D fp32 operations against 2N D inputs, 2N lse and 2N D
// fp32 outputs. At 2N = 512, D = 128: 101 MFLOP, 1.5 us at the 67 TFLOP/s
// fp32 peak (36 tile CTAs: latency-bound); at 2N = 8192: 25.8 GFLOP,
// 385 us. The partials add 2 x 537 MB of traffic at 2N = 8192, 0.32 ms at
// 3.35 TB/s.
//
// Supported: float32 or bfloat16 z, contiguous (2N, D), 2N even >= 2,
// 1 <= D <= 512. The C entry point returns cudaGetLastError().

#include "infonce_tile.cuh"

namespace {

using namespace infonce;

constexpr int kLdG = kTile + 1;  // the G tile and one staged slice of z
constexpr int kSumThreads = 256;
static_assert(kTile * kLdG <= 2 * kTile * kLd,
              "one staged z slice must fit the operand slices' space");

__device__ __forceinline__ int pos_of(int row, int n_half) {
  return row < n_half ? row + n_half : row - n_half;
}

// Rows row0 .. row0 + 63, columns k0 .. k0 + 63 of z (n x d) as fp32 with
// row stride kLdG; zero outside z.
template <typename T>
__device__ void stage_block(float* dst, const T* z, int row0, int n, int d,
                            int k0) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;
    const int k = e % kTile;
    const int gr = row0 + r;
    const int gk = k0 + k;
    dst[r * kLdG + k] =
        (gr < n && gk < d) ? to_float(z[size_t(gr) * d + gk]) : 0.f;
  }
}

// Tile (i, j) = (blockIdx.y, blockIdx.x), j >= i; part is (nb, n, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tri_tiles_bwd_kernel(const T* __restrict__ z,
                         const float* __restrict__ lse,
                         float* __restrict__ part, int n, int d,
                         float inv_t) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bj < bi) return;  // lower triangle: the mirror of an upper tile
  // The operand slices of tile_products, then one staged 64 x 64 slice of
  // z (kTile kLdG <= 2 kTile kLd floats).
  __shared__ float ab[2 * kTile * kLd];
  __shared__ float gs[kTile * kLdG];
  float* as = ab;
  float* bs = ab + kTile * kLd;
  float* zs = ab;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int row0 = bi * kTile;
  const int col0 = bj * kTile;
  const int n_half = n / 2;

  float s[4][4];
  tile_products(s, as, bs, z, z, row0, col0, n, n, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    const float lse_r = row < n ? lse[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      float g = 0.f;
      if (row < n && col < n) {
        const float x = row == col ? kNegInf : s[i][j] * inv_t;
        const float pos = col == pos_of(row, n_half) ? 1.f : 0.f;
        g = (exp0(x - lse_r) - pos) + (exp0(x - lse[col]) - pos);
      }
      gs[(ty + 16 * i) * kLdG + tx + 16 * j] = g;
    }
  }

  const size_t slot_ij = size_t(bj) * n;  // partial of block j's columns
  const size_t slot_ji = size_t(bi) * n;  // partial of block i's columns
  for (int k0 = 0; k0 < d; k0 += kTile) {
    // G_ij z_j -> rows of block i
    __syncthreads();  // gs is written; zs's previous readers are done
    stage_block(zs, z, col0, n, d, k0);
    __syncthreads();
    float o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float gv[4], zv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = gs[(ty + 16 * i) * kLdG + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) zv[j] = zs[c * kLdG + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(gv[i], zv[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        if (row < n && k < d) part[(slot_ij + row) * d + k] = o[i][j];
      }
    }
    if (bj == bi) continue;  // the diagonal tile's transpose is itself
    // G_ij^T z_i -> rows of block j
    __syncthreads();
    stage_block(zs, z, row0, n, d, k0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    }
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      float gv[4], zv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = gs[r * kLdG + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) zv[j] = zs[r * kLdG + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(gv[i], zv[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = col0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        if (row < n && k < d) part[(slot_ji + row) * d + k] = o[i][j];
      }
    }
  }
}

// grad[e] = sum over column blocks c, in order, of part[c][e] (e < n d).
__global__ void __launch_bounds__(kSumThreads)
    tri_bwd_sum_kernel(const float* __restrict__ part,
                       float* __restrict__ grad, size_t count, int nb) {
  const size_t e = size_t(blockIdx.x) * kSumThreads + threadIdx.x;
  if (e >= count) return;
  float sum = 0.f;
  for (int c = 0; c < nb; ++c) sum += part[size_t(c) * count + e];
  grad[e] = sum;
}

template <typename T>
cudaError_t launch(const void* z, const float* lse, float* part,
                   float* grad, int n, int d, float inv_t,
                   cudaStream_t stream) {
  const int nb = (n + kTile - 1) / kTile;
  tri_tiles_bwd_kernel<T><<<dim3(nb, nb), kThreads, 0, stream>>>(
      static_cast<const T*>(z), lse, part, n, d, inv_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = size_t(n) * d;
  const unsigned sums =
      static_cast<unsigned>((count + kSumThreads - 1) / kSumThreads);
  tri_bwd_sum_kernel<<<sums, kSumThreads, 0, stream>>>(part, grad, count,
                                                       nb);
  return cudaGetLastError();
}

}  // namespace

// grad (rows, d) fp32 = G @ z from z (rows, d) and lse (rows,) fp32.
// Scratch: part holds ceil(rows / 64) * rows * d floats. dtype:
// 0 = float32, 1 = bfloat16.
extern "C" int ntx_ntxent_tri_bwd(const void* z, const void* lse,
                                  void* part, void* grad, int rows, int d,
                                  int dtype, float inv_t, int device,
                                  void* stream) {
  if (rows < 2 || rows % 2 != 0 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* p = static_cast<float*>(part);
  float* g = static_cast<float*>(grad);
  if (dtype == 0) return launch<float>(z, l, p, g, rows, d, inv_t, s);
  if (dtype == 1) return launch<__nv_bfloat16>(z, l, p, g, rows, d, inv_t, s);
  return cudaErrorInvalidValue;
}
