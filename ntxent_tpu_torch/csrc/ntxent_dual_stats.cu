// NT-Xent dual statistics of one shard-pair tile for Hopper (sm_90a),
// bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _dual_stats_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:1037, launched by block_lse_dual at
// :1094, pallas_call at :1130), the forward of the pair-parallel NT-Xent
// (--dp-loss pair, ntxent_tpu/parallel/pair.py:116). For rows z_rows (R, D)
// with global ids row_gid and columns z_cols (C, D) with global ids
// col_gid, a padding vector carrying the sentinel id `total`:
//   s[i, j]    = (z_rows_i . z_cols_j) * inv_t in fp32;
//   lse_rows[i] = logsumexp over j of s[i, j], the entries whose column id
//                 is >= total or equals the row's id masked to -1e30;
//   lse_cols[j] = logsumexp over i of s[i, j], the entries whose ROW id is
//                 >= total or equals the column's id masked to -1e30
//                 (the row direction of the mirror tile, which the pair
//                 schedule never walks).
// Each logsumexp is online over 64-vector tiles: m = max, l = l *
// exp(m_old - m_new) + sum exp(min(s - m_new, 0)) (the _exp0 clamp), and
// lse = m + log(max(l, 1e-37)) (the _log_l floor). A row whose every entry
// is masked ends at m = -1e30, l = its count: lse = -1e30 in fp32, finite,
// as on the TPU.
//
// Design. The TPU kernel folds each s tile into full-length row AND column
// scratch carried across its sequential grid. Hopper blocks run in no
// order, so each output has one owner instead: the first ceil(R / 64)
// CTAs own 64 rows each and walk every column tile; the next ceil(C / 64)
// own 64 columns each and walk every row tile, computing s^T with the
// operands swapped. Both sides mask with the same rule, "the other side's
// id is >= total or equals mine", which is the row rule for row owners and
// the column rule for column owners. s is the register-blocked fp32 FMA
// product of infonce_tile.cuh (bf16 widened, no TF32), whose entries sum
// over k in the same order whichever operand is a, so both sides see
// bitwise the same logits. No atomics: repeatable. The matrix work is twice
// the TPU kernel's (s formed once per side) and buys a single pass with no
// merge.
//
// Bound: 2 R C D fp32 operations (s formed once) against (R + C) D inputs,
// (R + C) ids and (R + C) fp32 outputs. At one rank's self tile of a
// 1-card world at batch 256 (R = C = 512, D = 128): 67.1 MFLOP, 1.0 us at
// the 67 TFLOP/s fp32 peak, 16 CTAs: latency-bound. One rank of 4 at
// global batch 4096 (R = C = 2048): 1.07 GFLOP, 16 us.
//
// Supported: float32 or bfloat16 z_rows and z_cols (the same dtype),
// contiguous, R, C >= 1, 1 <= D <= 512, int32 ids. The C entry point
// returns cudaGetLastError().

#include "infonce_tile.cuh"

namespace {

using namespace infonce;

// One CTA: own vectors row0 .. row0 + 63 of own (n_own x d) over every
// tile of other (n_other x d); writes lse[row] for its own vectors.
template <typename T>
__device__ void dual_lse(const T* __restrict__ own,
                         const T* __restrict__ other,
                         const int* __restrict__ own_id,
                         const int* __restrict__ other_id, float inv_t,
                         float* __restrict__ lse, int n_own, int n_other,
                         int d, int total, int row0, float* as, float* bs) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float m[4], l[4];
  int id_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    id_r[i] = row < n_own ? own_id[row] : total;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int col0 = 0; col0 < n_other; col0 += kTile) {
    float acc[4][4];
    tile_products(acc, as, bs, own, other, row0, col0, n_own, n_other, d);
    int id_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      id_c[j] = col < n_other ? other_id[col] : total;  // total: masked
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = id_c[j] >= total || id_c[j] == id_r[i];
        s[j] = masked ? kNegInf : acc[i][j] * inv_t;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m[i], group_max(tile_max));
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) tile_sum += exp0(s[j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + group_sum(tile_sum);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row < n_own) lse[row] = m[i] + logf(fmaxf(l[i], 1e-37f));
    }
  }
}

// CTAs [0, tiles_r) own rows (lse_rows); the rest own columns (lse_cols).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ntxent_dual_stats_kernel(const T* __restrict__ z_rows,
                             const T* __restrict__ z_cols,
                             const int* __restrict__ row_gid,
                             const int* __restrict__ col_gid,
                             float* __restrict__ lse_rows,
                             float* __restrict__ lse_cols, int n_rows,
                             int n_cols, int d, float inv_t, int total,
                             int tiles_r) {
  __shared__ float as[kTile * kLd];
  __shared__ float bs[kTile * kLd];
  const bool cols = static_cast<int>(blockIdx.x) >= tiles_r;
  const int row0 = (cols ? blockIdx.x - tiles_r : blockIdx.x) * kTile;
  if (cols) {
    dual_lse(z_cols, z_rows, col_gid, row_gid, inv_t, lse_cols, n_cols,
             n_rows, d, total, row0, as, bs);
  } else {
    dual_lse(z_rows, z_cols, row_gid, col_gid, inv_t, lse_rows, n_rows,
             n_cols, d, total, row0, as, bs);
  }
}

template <typename T>
cudaError_t launch(const void* z_rows, const void* z_cols,
                   const int* row_gid, const int* col_gid, float* lse_rows,
                   float* lse_cols, int n_rows, int n_cols, int d,
                   float inv_t, int total, cudaStream_t stream) {
  const int tiles_r = (n_rows + kTile - 1) / kTile;
  const int tiles_c = (n_cols + kTile - 1) / kTile;
  ntxent_dual_stats_kernel<T><<<tiles_r + tiles_c, kThreads, 0, stream>>>(
      static_cast<const T*>(z_rows), static_cast<const T*>(z_cols), row_gid,
      col_gid, lse_rows, lse_cols, n_rows, n_cols, d, inv_t, total, tiles_r);
  return cudaGetLastError();
}

}  // namespace

// lse_rows (n_rows,) and lse_cols (n_cols,) fp32 of one tile; row_gid and
// col_gid int32, both required. dtype: 0 = float32, 1 = bfloat16.
extern "C" int ntx_ntxent_dual_stats(const void* z_rows, const void* z_cols,
                                     const void* row_gid,
                                     const void* col_gid, void* lse_rows,
                                     void* lse_cols, int n_rows, int n_cols,
                                     int d, int dtype, float inv_t,
                                     int total, int device, void* stream) {
  if (n_rows < 1 || n_cols < 1 || d < 1 || d > kMaxD || !row_gid ||
      !col_gid) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rid = static_cast<const int*>(row_gid);
  const int* cid = static_cast<const int*>(col_gid);
  float* lr = static_cast<float*>(lse_rows);
  float* lc = static_cast<float*>(lse_cols);
  if (dtype == 0) {
    return launch<float>(z_rows, z_cols, rid, cid, lr, lc, n_rows, n_cols, d,
                         inv_t, total, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(z_rows, z_cols, rid, cid, lr, lc, n_rows,
                                 n_cols, d, inv_t, total, s);
  }
  return cudaErrorInvalidValue;
}
