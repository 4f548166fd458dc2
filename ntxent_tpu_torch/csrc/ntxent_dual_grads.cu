// NT-Xent dual gradients of one shard-pair tile for Hopper (sm_90a),
// bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _dual_grads_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:1159, launched by block_grads_dual at
// :1213, pallas_call at :1253), the backward of the pair-parallel NT-Xent
// (--dp-loss pair, ntxent_tpu/parallel/pair.py:146). For rows z_rows (R, D)
// and columns z_cols (C, D) with global ids (the sentinel `total` on
// padding) and the GLOBAL logsumexp of each side, lse_rows (R,) and
// lse_cols (C,):
//   s[i, j]  = (z_rows_i . z_cols_j) * inv_t in fp32;
//   G[i, j]  = exp(min(s_row - lse_rows[i], 0)) * valid_row_i
//            + exp(min(s_col - lse_cols[j], 0)) * valid_col_j,
//   s_row masked to -1e30 where the column id is >= total or equals the
//   row id, s_col where the row id is >= total or equals the column id,
//   valid_* = id < total; no positive term (the caller differentiates the
//   positives locally);
//   grad_rows = G @ z_cols (R, D), grad_cols = G^T @ z_rows (C, D), fp32,
//   before the caller's cotangent / T scale.
//
// Design. The TPU kernel computes G once per tile and accumulates G^T z_r
// in full-length column scratch carried across its sequential grid. Here
// each output vector has one owner: the first ceil(R / 64) CTAs own 64 rows
// and walk every column tile, the rest own 64 columns and walk every row
// tile, both through the device function of infonce_grad.cuh (grad_rows;
// G is symmetric in its two terms, so the column owners form G^T with the
// operands swapped). s is formed twice (once per side) where
// the TPU formed it once; no atomics, so the result is repeatable. fp32
// FMA of widened inputs, no TF32. The accumulator lives in opt-in dynamic
// shared memory (infonce::smem_floats(d), 70 KB at D = 128).
//
// Bound: 6 R C D fp32 operations (s once, two products with G) against
// (R + C) D inputs, (R + C) ids and lse, (R + C) D fp32 outputs. At the
// self tile of a 1-card world at batch 256 (R = C = 512, D = 128): 201
// MFLOP, 3.0 us at the 67 TFLOP/s fp32 peak, 16 CTAs: latency-bound. One
// rank of 4 at global batch 4096 (R = C = 2048): 3.2 GFLOP, 48 us.
//
// Supported: float32 or bfloat16 z_rows and z_cols (the same dtype),
// contiguous, R, C >= 1, 1 <= D <= 512, int32 ids. The C entry point
// returns cudaGetLastError().

#include "infonce_grad.cuh"

namespace {

using namespace infonce;

// CTAs [0, tiles_r) own rows (grad_rows); the rest own columns (grad_cols).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ntxent_dual_grads_kernel(const T* __restrict__ z_rows,
                             const T* __restrict__ z_cols,
                             const int* __restrict__ row_gid,
                             const int* __restrict__ col_gid,
                             const float* __restrict__ lse_rows,
                             const float* __restrict__ lse_cols,
                             float* __restrict__ g_rows,
                             float* __restrict__ g_cols, int n_rows,
                             int n_cols, int d, float inv_t, int total,
                             int tiles_r) {
  extern __shared__ float smem[];
  const bool cols = static_cast<int>(blockIdx.x) >= tiles_r;
  const int row0 = (cols ? blockIdx.x - tiles_r : blockIdx.x) * kTile;
  if (cols) {
    grad_rows<T>(z_cols, z_rows, col_gid, row_gid, lse_cols, lse_rows,
                 inv_t, g_cols, n_cols, n_rows, total, d, row0, smem);
  } else {
    grad_rows<T>(z_rows, z_cols, row_gid, col_gid, lse_rows, lse_cols,
                 inv_t, g_rows, n_rows, n_cols, total, d, row0, smem);
  }
}

template <typename T>
cudaError_t launch(const void* z_rows, const void* z_cols, const int* rid,
                   const int* cid, const float* lse_rows,
                   const float* lse_cols, float* g_rows, float* g_cols,
                   int n_rows, int n_cols, int d, float inv_t, int total,
                   cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = opt_in_smem(ntxent_dual_grads_kernel<T>, d, &smem);
  if (err != cudaSuccess) return err;
  const int tiles_r = (n_rows + kTile - 1) / kTile;
  const int tiles_c = (n_cols + kTile - 1) / kTile;
  ntxent_dual_grads_kernel<T>
      <<<tiles_r + tiles_c, kThreads, smem, stream>>>(
          static_cast<const T*>(z_rows), static_cast<const T*>(z_cols), rid,
          cid, lse_rows, lse_cols, g_rows, g_cols, n_rows, n_cols, d, inv_t,
          total, tiles_r);
  return cudaGetLastError();
}

}  // namespace

// grad_rows (n_rows, d) and grad_cols (n_cols, d) fp32 of one tile;
// row_gid and col_gid int32, both required. dtype: 0 = float32,
// 1 = bfloat16.
extern "C" int ntx_ntxent_dual_grads(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* lse_rows, const void* lse_cols,
    void* grad_rows, void* grad_cols, int n_rows, int n_cols, int d,
    int dtype, float inv_t, int total, int device, void* stream) {
  if (n_rows < 1 || n_cols < 1 || d < 1 || d > kMaxD || !row_gid ||
      !col_gid) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rid = static_cast<const int*>(row_gid);
  const int* cid = static_cast<const int*>(col_gid);
  const float* lr = static_cast<const float*>(lse_rows);
  const float* lc = static_cast<const float*>(lse_cols);
  float* gr = static_cast<float*>(grad_rows);
  float* gc = static_cast<float*>(grad_cols);
  if (dtype == 0) {
    return launch<float>(z_rows, z_cols, rid, cid, lr, lc, gr, gc, n_rows,
                         n_cols, d, inv_t, total, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(z_rows, z_cols, rid, cid, lr, lc, gr, gc,
                                 n_rows, n_cols, d, inv_t, total, s);
  }
  return cudaErrorInvalidValue;
}
