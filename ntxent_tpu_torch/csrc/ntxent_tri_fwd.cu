// NT-Xent triangular symmetric forward for Hopper (sm_90a), bound to
// PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _fwd_tri_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:237, launched by _fwd_tri_call at :308,
// pallas_call at :315), the forward of ntxent_loss_fused(triangular=True).
// For stacked views z (2N, D), as that kernel computes:
//   s[i, j]  = (z_i . z_j) * inv_t in fp32, the diagonal masked to -1e30;
//   lse[i]   = logsumexp_j s[i, j];
//   loss_sum = sum_i (lse[i] - s[i, pos(i)]), pos(i) = (i + N) mod 2N.
// s is symmetric, so only the upper-triangle tiles (i <= j, in 64-row
// blocks) are formed; each folds into row block i directly and, for
// j > i, into row block j transposed: half the products of the
// rectangular forward (#1).
//
// Design. The TPU kernel carries running (m, l, p) of every row in
// full-length scratch across its sequential grid. Hopper blocks run in no
// order, so nothing is carried: one CTA per upper tile (i, j) forms the
// 64 x 64 tile once (infonce_tile.cuh's register-blocked fp32 FMA, bf16
// widened, no TF32) into shared memory and writes one partial (m, l, p) for
// each of its 64 rows of block i (over the tile's columns: part[j][row])
// and, for j > i, one for each of its 64 rows of block j (over the tile's
// rows, s^T: part[i][row]). Every (column block, row) slot is written by
// exactly one CTA. A merge kernel then folds each row's nb partials in
// column-block order (m = max; l = l e^(m - m') + l_c e^(m_c - m')), writes
// lse = m + log(max(l, 1e-37)) and sums its 256 rows' lse - p in row order;
// one warp adds the merge CTAs' sums in a fixed order. No atomics: the loss
// is bitwise repeatable. The partials take 3 nb 2N fp32: 48 KB at 2N =
// 512, 12.6 MB at 2N = 8192 (nb = 2N / 64).
//
// Bound: (2N)^2 D fp32 operations over the upper triangle (half of #1's 2
// (2N)^2 D) against 2N D inputs and 2N + 1 fp32 outputs. At 2N = 512,
// D = 128: 33.6 MFLOP, 0.5 us at the 67 TFLOP/s fp32 peak (36 tile CTAs:
// latency-bound); at 2N = 8192: 8.6 GFLOP, 128 us.
//
// Supported: float32 or bfloat16 z, contiguous (2N, D), 2N even >= 2,
// 1 <= D <= 512. The C entry point returns cudaGetLastError().

#include "infonce_tile.cuh"

namespace {

using namespace infonce;

constexpr int kLdS = kTile + 1;    // the masked s tile in shared memory
constexpr int kMergeThreads = 256;  // rows per merge CTA

__device__ __forceinline__ int pos_of(int row, int n_half) {
  return row < n_half ? row + n_half : row - n_half;
}

// One (m, l, p) partial of a row over the 64 entries t[0], t[stride], ...
// of the masked s tile; `pos_at` is the positive's offset or -1.
__device__ __forceinline__ void row_stats(const float* t, int stride,
                                          int pos_at, float* m_out,
                                          float* l_out, float* p_out) {
  float m = kNegInf;
  for (int c = 0; c < kTile; ++c) m = fmaxf(m, t[c * stride]);
  float l = 0.f;
  for (int c = 0; c < kTile; ++c) l += exp0(t[c * stride] - m);
  *m_out = m;
  *l_out = l;
  *p_out = pos_at >= 0 ? t[pos_at * stride] : 0.f;
}

// Tile (i, j) = (blockIdx.y, blockIdx.x), j >= i; part holds three
// (nb, n) planes: m, l and the positive's logit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tri_tiles_fwd_kernel(const T* __restrict__ z, float* __restrict__ part,
                         int n, int d, float inv_t) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bj < bi) return;  // lower triangle: the mirror of an upper tile
  __shared__ float as[kTile * kLd];
  __shared__ float bs[kTile * kLd];
  __shared__ float st[kTile * kLdS];
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int row0 = bi * kTile;
  const int col0 = bj * kTile;

  float acc[4][4];
  tile_products(acc, as, bs, z, z, row0, col0, n, n, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int row = row0 + r;
      const int col = col0 + c;
      // a vector past n does not exist; the diagonal is masked. The same
      // masked tile serves both directions: a row's positive is never
      // masked (it exists and is not the row itself).
      const bool masked = row >= n || col >= n || row == col;
      st[r * kLdS + c] = masked ? kNegInf : acc[i][j] * inv_t;
    }
  }
  __syncthreads();

  const int nb = gridDim.x;
  const size_t plane = size_t(nb) * n;
  const int n_half = n / 2;
  const int t = threadIdx.x;
  if (t < kTile) {  // row t of block i over the tile's columns
    const int row = row0 + t;
    if (row < n) {
      const int pos = pos_of(row, n_half) - col0;
      float m, l, p;
      row_stats(st + t * kLdS, 1, (pos >= 0 && pos < kTile) ? pos : -1, &m,
                &l, &p);
      const size_t at = size_t(bj) * n + row;
      part[at] = m;
      part[plane + at] = l;
      part[2 * plane + at] = p;
    }
  } else if (t < 2 * kTile && bj > bi) {  // row c of block j, transposed
    const int c = t - kTile;
    const int row = col0 + c;
    if (row < n) {
      const int pos = pos_of(row, n_half) - row0;
      float m, l, p;
      row_stats(st + c, kLdS, (pos >= 0 && pos < kTile) ? pos : -1, &m, &l,
                &p);
      const size_t at = size_t(bi) * n + row;
      part[at] = m;
      part[plane + at] = l;
      part[2 * plane + at] = p;
    }
  }
}

// Row r's nb partials folded in column-block order into lse[r]; the CTA's
// sum of lse - p over its rows, in row order, into block_sum[blockIdx.x].
__global__ void __launch_bounds__(kMergeThreads)
    tri_fwd_merge_kernel(const float* __restrict__ part,
                         float* __restrict__ lse,
                         float* __restrict__ block_sum, int n, int nb) {
  __shared__ float row_loss[kMergeThreads];
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  float loss = 0.f;
  if (row < n) {
    const size_t plane = size_t(nb) * n;
    float m = kNegInf;
    float l = 0.f;
    float p = 0.f;
    for (int c = 0; c < nb; ++c) {
      const size_t at = size_t(c) * n + row;
      const float m_c = part[at];
      const float m_new = fmaxf(m, m_c);
      l = l * exp0(m - m_new) + part[plane + at] * exp0(m_c - m_new);
      m = m_new;
      p += part[2 * plane + at];
    }
    const float row_lse = m + logf(fmaxf(l, 1e-37f));
    lse[row] = row_lse;
    loss = row_lse - p;
  }
  row_loss[threadIdx.x] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int r = 0; r < kMergeThreads; ++r) sum += row_loss[r];
    block_sum[blockIdx.x] = sum;
  }
}

// One warp sums the merge CTAs' sums in a fixed order.
__global__ void tri_loss_reduce(const float* __restrict__ block_sum,
                                int count, float* __restrict__ loss) {
  float sum = 0.f;
  for (int i = threadIdx.x; i < count; i += 32) sum += block_sum[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (threadIdx.x == 0) loss[0] = sum;
}

template <typename T>
cudaError_t launch(const void* z, float* lse, float* part, float* block_sum,
                   float* loss, int n, int d, float inv_t,
                   cudaStream_t stream) {
  const int nb = (n + kTile - 1) / kTile;
  tri_tiles_fwd_kernel<T><<<dim3(nb, nb), kThreads, 0, stream>>>(
      static_cast<const T*>(z), part, n, d, inv_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merges = (n + kMergeThreads - 1) / kMergeThreads;
  tri_fwd_merge_kernel<<<merges, kMergeThreads, 0, stream>>>(
      part, lse, block_sum, n, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tri_loss_reduce<<<1, 32, 0, stream>>>(block_sum, merges, loss);
  return cudaGetLastError();
}

}  // namespace

// lse (rows,) fp32 and loss (one fp32, the loss SUM) of z (rows, d).
// Scratch: part holds 3 * ceil(rows / 64) * rows floats, block_sum
// ceil(rows / 256). dtype: 0 = float32, 1 = bfloat16.
extern "C" int ntx_ntxent_tri_fwd(const void* z, void* lse, void* part,
                                  void* block_sum, void* loss, int rows,
                                  int d, int dtype, float inv_t, int device,
                                  void* stream) {
  if (rows < 2 || rows % 2 != 0 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* p = static_cast<float*>(part);
  float* b = static_cast<float*>(block_sum);
  float* out = static_cast<float*>(loss);
  if (dtype == 0) return launch<float>(z, l, p, b, out, rows, d, inv_t, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(z, l, p, b, out, rows, d, inv_t, s);
  }
  return cudaErrorInvalidValue;
}
