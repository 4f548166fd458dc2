// NT-Xent forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:130
// (_fwd_kernel, launched by _fwd_call at ntxent_pallas.py:199) on the
// symmetric path of ntxent_loss_fused, where rows and columns are the same
// stacked views z (2N, D). Per row i it computes what that kernel computes:
//   s[i, j] = (z_i . z_j) * inv_t in fp32, whatever the input dtype;
//   the self-similarity diagonal (and columns past 2N) masked to -1e30;
//   online logsumexp over column tiles: m = max, l = l * exp(m_old - m_new)
//     + sum exp(min(s - m_new, 0)) (the _exp0 clamp);
//   lse[i] = m + log(max(l, 1e-37)) (the _log_l floor);
//   the positive logit s[i, (i + N) mod 2N], unmasked;
//   loss_sum = sum_i (lse[i] - s[i, pos(i)]).
//
// Design. The TPU kernel walks a sequential (row tile, column tile) grid
// and accumulates the loss in one SMEM scalar across grid steps. Hopper
// blocks run in no order, so the column axis becomes a loop inside one
// thread block (one CTA per 32-row tile, 8 threads per row, each thread
// 8 columns of a 64-column tile), and the loss is reduced in two fixed
// orders: each CTA sums its rows in row order into partial[tile], then one
// warp of a second kernel sums the partials in a fixed strided order and
// a fixed shuffle tree. No atomics: the loss is bitwise repeatable.
//
// Arithmetic is plain fp32 FMA (no TF32: the fp32 contract of the JAX
// kernel holds); bf16 inputs are widened to fp32 as they are staged, so
// their products are exact as on the MXU.
//
// Bound at the training shape (2N = 512, D = 128, fp32): 2 * 512^2 * 128
// = 67 MFLOP, 1.0 us at the 67 TFLOP/s fp32 (non-tensor) peak; z is
// 256 KB, 0.08 us at 3.35 TB/s. The call is compute-bound on paper and
// launch-bound in practice (16 CTAs).
//
// Supported: float32 or bfloat16 z, contiguous (rows, D), rows even >= 2,
// 1 <= D <= 256. The C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace {

constexpr int kRows = 32;                       // rows per CTA
constexpr int kCols = 64;                       // columns per tile
constexpr int kThreadsPerRow = 8;
constexpr int kColsPerThread = kCols / kThreadsPerRow;
constexpr int kThreads = kRows * kThreadsPerRow;  // 256
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

// Stage `rows_valid` rows of z (row stride d) as fp32 with row stride
// d + 1 (odd: column-strided reads hit distinct banks); other rows are 0.
template <typename T>
__device__ void stage(float* dst, const T* src, int rows, int rows_valid,
                      int d) {
  const int ld = d + 1;
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d;
    const int c = e % d;
    dst[r * ld + c] = r < rows_valid ? to_float(src[size_t(r) * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ntxent_fwd_kernel(const T* __restrict__ z, float* __restrict__ lse,
                      float* __restrict__ partial, int n_rows, int d,
                      float inv_t) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* zr = smem;                  // kRows x ld
  float* zc = smem + kRows * ld;     // kCols x ld
  __shared__ float row_loss[kRows];

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;  // row within the tile
  const int g = tid % kThreadsPerRow;  // column group: g, g + 8, ...
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + r;
  const int n_half = n_rows / 2;
  const int pos_col = row < n_half ? row + n_half : row - n_half;

  stage(zr, z + size_t(row0) * d, kRows, min(kRows, n_rows - row0), d);

  float m = kNegInf;
  float l = 0.f;
  float pos = 0.f;
  const int col_tiles = (n_rows + kCols - 1) / kCols;
  for (int j = 0; j < col_tiles; ++j) {
    const int col0 = j * kCols;
    __syncthreads();  // the previous tile's readers are done with zc
    stage(zc, z + size_t(col0) * d, kCols, min(kCols, n_rows - col0), d);
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) s[c] = 0.f;
    const float* zrow = zr + r * ld;
    for (int k = 0; k < d; ++k) {
      const float a = zrow[k];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        s[c] = fmaf(a, zc[(g + c * kThreadsPerRow) * ld + k], s[c]);
      }
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = col0 + g + c * kThreadsPerRow;
      const float raw = s[c] * inv_t;
      if (col == pos_col) pos += raw;
      s[c] = (col >= n_rows || col == row) ? kNegInf : raw;
      tile_max = fmaxf(tile_max, s[c]);
    }
#pragma unroll
    for (int off = 1; off < kThreadsPerRow; off <<= 1) {
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    }
    const float m_new = fmaxf(m, tile_max);
    float tile_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) tile_sum += exp0(s[c] - m_new);
#pragma unroll
    for (int off = 1; off < kThreadsPerRow; off <<= 1) {
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
    }
    l = l * expf(m - m_new) + tile_sum;
    m = m_new;
  }
  // The positive sits in exactly one thread of the row's group.
#pragma unroll
  for (int off = 1; off < kThreadsPerRow; off <<= 1) {
    pos += __shfl_xor_sync(0xffffffffu, pos, off);
  }
  if (g == 0) {
    const float row_lse = m + logf(fmaxf(l, 1e-37f));
    if (row < n_rows) lse[row] = row_lse;
    row_loss[r] = row < n_rows ? row_lse - pos : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < kRows; ++i) sum += row_loss[i];
    partial[blockIdx.x] = sum;
  }
}

// One warp sums the per-tile partials in a fixed order.
__global__ void ntxent_loss_reduce(const float* __restrict__ partial,
                                   int count, float* __restrict__ loss) {
  float sum = 0.f;
  for (int i = threadIdx.x; i < count; i += 32) sum += partial[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (threadIdx.x == 0) loss[0] = sum;
}

template <typename T>
cudaError_t launch(const void* z, void* lse, void* partial, void* loss,
                   int n_rows, int d, float inv_t, cudaStream_t stream) {
  const size_t smem = size_t(kRows + kCols) * (d + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ntxent_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (n_rows + kRows - 1) / kRows;
  ntxent_fwd_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<float*>(lse),
      static_cast<float*>(partial), n_rows, d, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ntxent_loss_reduce<<<1, 32, 0, stream>>>(static_cast<const float*>(partial),
                                           tiles, static_cast<float*>(loss));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `partial` holds ceil(rows / 32) floats
// of scratch. Returns a cudaError_t (0 = success).
extern "C" int ntx_ntxent_fwd(const void* z, void* lse, void* partial,
                              void* loss, int n_rows, int d, int dtype,
                              float inv_t, int device, void* stream) {
  if (n_rows < 2 || n_rows % 2 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(z, lse, partial, loss, n_rows, d, inv_t, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(z, lse, partial, loss, n_rows, d, inv_t, s);
  }
  return cudaErrorInvalidValue;
}
