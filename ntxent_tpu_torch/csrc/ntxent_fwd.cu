// NT-Xent forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:130
// (_fwd_kernel, launched by _fwd_call at ntxent_pallas.py:190) in both of
// its modes:
//   * symmetric (ntx_ntxent_fwd): rows and columns are the same stacked
//     views z (2N, D), the row and column ids their indices (the path of
//     ntxent_loss_fused);
//   * general (ntx_ntxent_fwd_general): rows z_rows (R, D) with global ids
//     row_gid, columns z_cols (C, D) with global ids col_gid, or their
//     indices when col_gid is null (the path of ntxent_partial_fused, the
//     data-parallel strip loss, and of block_lse, the ring's fold).
// Per row i it computes what that kernel computes:
//   s[i, j] = (z_i . z_j) * inv_t in fp32, whatever the input dtype;
//   columns whose id is >= cols_actual or equals the row's id masked to
//     -1e30 (_masked_sim_tile); columns past C do not exist;
//   online logsumexp over column tiles: m = max, l = l * exp(m_old - m_new)
//     + sum exp(min(s - m_new, 0)) (the _exp0 clamp);
//   lse[i] = m + log(max(l, 1e-37)) (the _log_l floor);
//   the positive logit: the unmasked s[i, j] of the column whose id is
//     pos(gid_i) = gid_i + n_half if gid_i < n_half else gid_i - n_half
//     (_pos_gid);
//   loss_sum = sum over rows with gid_i < cols_actual of (lse[i] - pos_i)
//     (padding rows carry the sentinel id 2N and drop out).
//
// Design. The TPU kernel walks a sequential (row tile, column tile) grid
// and accumulates the loss in one SMEM scalar across grid steps. Hopper
// blocks run in no order, so the column axis becomes a loop inside one
// thread block (one CTA per 32-row tile, 8 threads per row, each thread
// 8 columns of a 64-column tile; the tile's column ids are staged beside
// it), and the loss is reduced in two fixed orders: each CTA sums its
// rows in row order into partial[tile], then one warp of a second kernel
// sums the partials in a fixed strided order and a fixed shuffle tree. No
// atomics: the loss is bitwise repeatable. The symmetric mode is the
// general one with z_rows = z_cols and the indices for ids, an
// instantiation that stages no ids.
//
// Arithmetic is plain fp32 FMA (no TF32: the fp32 contract of the JAX
// kernel holds); bf16 inputs are widened to fp32 as they are staged, so
// their products are exact as on the MXU.
//
// Bound. 2 R C D operations against (R + C) D inputs: at the symmetric
// training shape (2N = 512, D = 128, fp32) 67 MFLOP, 1.0 us at the 67
// TFLOP/s fp32 (non-tensor) peak, and 0.08 us of bytes at 3.35 TB/s; at
// one rank's strip of a 4-card world at global batch 4096 (R = 2048,
// C = 8192, D = 128) 4.3 GFLOP, 64 us. Compute-bound on paper; at the
// small shapes launch- and latency-bound (16 CTAs at R = 512).
//
// Supported: float32 or bfloat16 rows and columns (the same dtype),
// contiguous (rows, D), 1 <= D <= 256; the symmetric mode needs an even
// row count >= 2. int32 ids. The C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kRows = 32;                       // rows per CTA
constexpr int kCols = 64;                       // columns per tile
constexpr int kThreadsPerRow = 8;
constexpr int kColsPerThread = kCols / kThreadsPerRow;
constexpr int kThreads = kRows * kThreadsPerRow;  // 256
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr int kNoColumn = INT_MAX;  // id of a column past C: always masked

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

// kIds: rows and columns carry ids (row_gid, and col_gid unless null);
// otherwise (the symmetric mode) the ids are the indices, computed in
// registers with no staging.
template <typename T, bool kIds>
__global__ void __launch_bounds__(kThreads)
    ntxent_fwd_kernel(const T* __restrict__ z_rows,
                      const T* __restrict__ z_cols,
                      const int* __restrict__ row_gid,
                      const int* __restrict__ col_gid,
                      float* __restrict__ lse, float* __restrict__ partial,
                      int n_rows, int n_cols, int d, float inv_t,
                      int cols_actual, int n_half) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* zr = smem;                  // kRows x ld
  float* zc = smem + kRows * ld;     // kCols x ld
  __shared__ float row_loss[kRows];
  __shared__ int cid[kCols];

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;  // row within the tile
  const int g = tid % kThreadsPerRow;  // column group: g, g + 8, ...
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + r;
  const int gid =
      row < n_rows ? (kIds ? row_gid[row] : row) : cols_actual;
  const int pos_gid = gid < n_half ? gid + n_half : gid - n_half;

  stage(zr, z_rows + size_t(row0) * d, kRows, min(kRows, n_rows - row0), d);

  float m = kNegInf;
  float l = 0.f;
  float pos = 0.f;
  const int col_tiles = (n_cols + kCols - 1) / kCols;
  for (int j = 0; j < col_tiles; ++j) {
    const int col0 = j * kCols;
    __syncthreads();  // the previous tile's readers are done with zc, cid
    stage(zc, z_cols + size_t(col0) * d, kCols, min(kCols, n_cols - col0), d);
    if (kIds && tid < kCols) {
      const int col = col0 + tid;
      cid[tid] = col < n_cols ? (col_gid ? col_gid[col] : col) : kNoColumn;
    }
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
      const int id = kIds ? cid[g + c * kThreadsPerRow]
                          : (col < n_cols ? col : kNoColumn);
      const float raw = s[c] * inv_t;
      if (id == pos_gid) pos += raw;
      s[c] = (id >= cols_actual || id == gid) ? kNegInf : raw;
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
  // The positive sits in at most one thread of the row's group.
#pragma unroll
  for (int off = 1; off < kThreadsPerRow; off <<= 1) {
    pos += __shfl_xor_sync(0xffffffffu, pos, off);
  }
  if (g == 0) {
    const float row_lse = m + logf(fmaxf(l, 1e-37f));
    if (row < n_rows) lse[row] = row_lse;
    row_loss[r] = (row < n_rows && gid < cols_actual) ? row_lse - pos : 0.f;
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

template <typename T, bool kIds>
cudaError_t launch(const void* z_rows, const void* z_cols, const int* row_gid,
                   const int* col_gid, void* lse, void* partial, void* loss,
                   int n_rows, int n_cols, int d, float inv_t,
                   int cols_actual, int n_half, cudaStream_t stream) {
  const size_t smem = size_t(kRows + kCols) * (d + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ntxent_fwd_kernel<T, kIds>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (n_rows + kRows - 1) / kRows;
  ntxent_fwd_kernel<T, kIds><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(z_rows), static_cast<const T*>(z_cols), row_gid,
      col_gid, static_cast<float*>(lse), static_cast<float*>(partial),
      n_rows, n_cols, d, inv_t, cols_actual, n_half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ntxent_loss_reduce<<<1, 32, 0, stream>>>(static_cast<const float*>(partial),
                                           tiles, static_cast<float*>(loss));
  return cudaGetLastError();
}

template <bool kIds>
cudaError_t dispatch(const void* z_rows, const void* z_cols,
                     const int* row_gid, const int* col_gid, void* lse,
                     void* partial, void* loss, int n_rows, int n_cols, int d,
                     int dtype, float inv_t, int cols_actual, int n_half,
                     int device, void* stream) {
  if (n_rows < 1 || n_cols < 1 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, kIds>(z_rows, z_cols, row_gid, col_gid, lse,
                               partial, loss, n_rows, n_cols, d, inv_t,
                               cols_actual, n_half, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, kIds>(z_rows, z_cols, row_gid, col_gid,
                                       lse, partial, loss, n_rows, n_cols, d,
                                       inv_t, cols_actual, n_half, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Symmetric mode. dtype: 0 = float32, 1 = bfloat16. `partial` holds
// ceil(rows / 32) floats of scratch. Returns a cudaError_t (0 = success).
extern "C" int ntx_ntxent_fwd(const void* z, void* lse, void* partial,
                              void* loss, int n_rows, int d, int dtype,
                              float inv_t, int device, void* stream) {
  if (n_rows < 2 || n_rows % 2) return cudaErrorInvalidValue;
  return dispatch<false>(z, z, nullptr, nullptr, lse, partial, loss, n_rows,
                         n_rows, d, dtype, inv_t, n_rows, n_rows / 2, device,
                         stream);
}

// General mode: rows z_rows (n_rows, d) with int32 ids row_gid, columns
// z_cols (n_cols, d) with int32 ids col_gid (null: the column index).
// `partial` holds ceil(n_rows / 32) floats of scratch.
extern "C" int ntx_ntxent_fwd_general(const void* z_rows, const void* z_cols,
                                      const void* row_gid,
                                      const void* col_gid, void* lse,
                                      void* partial, void* loss, int n_rows,
                                      int n_cols, int d, int dtype,
                                      float inv_t, int cols_actual,
                                      int n_half, int device, void* stream) {
  if (row_gid == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(z_rows, z_cols, static_cast<const int*>(row_gid),
                        static_cast<const int*>(col_gid), lse, partial, loss,
                        n_rows, n_cols, d, dtype, inv_t, cols_actual, n_half,
                        device, stream);
}
