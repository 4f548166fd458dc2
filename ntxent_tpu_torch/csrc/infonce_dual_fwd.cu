// Cross-modal InfoNCE (CLIP) forward for Hopper (sm_90a), bound to PyTorch
// via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/infonce_pallas.py:75
// (_dual_fwd_kernel, launched by _dual_fwd_call at infonce_pallas.py:174)
// as info_nce_fused runs it. For paired embeddings za, zb (N, D) and the
// logit scale (a device scalar, CLIP's learnable exp(logit_scale)) it
// computes what that kernel computes:
//   s[i, j]  = (za_i . zb_j) * scale in fp32, whatever the input dtype;
//   lse_a[i] = logsumexp_j s[i, j]   (the row direction, image -> text);
//   lse_b[j] = logsumexp_i s[i, j]   (the column direction, text -> image);
//   loss_sum = sum_i (lse_a[i] - s[i, i]) + sum_j (lse_b[j] - s[j, j]).
// The positive is the diagonal, which is NOT masked (za_i and zb_i are
// different modalities); only columns past N are masked to -1e30. Each
// logsumexp is online over 64-column tiles: m = max, l = l * exp(m_old -
// m_new) + sum exp(min(s - m_new, 0)) (the _exp0 clamp), and
// lse = m + log(max(l, 1e-37)) (the _log_l floor).
//
// Design. The TPU kernel folds each s tile into the row statistics and,
// transposed, into full-length column statistics carried across its
// sequential grid, and adds the loss into one SMEM scalar. Hopper blocks
// run in no order, so nothing is carried between them: the column
// direction is the row direction of s^T = scale * zb . za^T, computed by
// the same code with the two inputs swapped (blockIdx.y = 1). One launch
// covers both directions; each CTA owns 64 rows of one direction and walks
// every column tile in a loop, so each lse has one writer. The matrix work
// is twice the TPU kernel's (s is formed once per direction) and buys a
// single pass with no cross-block merge. The loss is reduced in fixed
// orders: each CTA sums its 64 rows in row order into partial[], then one
// warp of a second kernel sums the partials in a fixed strided order and
// a fixed shuffle tree. No atomics: the loss is bitwise repeatable.
//
// Each s tile is the register-blocked fp32 FMA product of
// infonce_tile.cuh (no TF32: the fp32 contract of the JAX kernel holds;
// bf16 inputs are widened, so their products are exact as on the MXU),
// over D in 32-wide slices: 17 KB of shared memory whatever D is. Both
// directions see bitwise the same logits.
//
// Bound at the training shape (N = 256, D = 512, fp32): 2 N^2 D = 67.1
// MFLOP, 1.0 us at the 67 TFLOP/s fp32 (non-tensor) peak; za and zb are
// 1 MB, 0.31 us at 3.35 TB/s. Compute-bound on paper, launch-bound in
// practice (8 CTAs).
//
// Rectangular stats-only mode (ntx_infonce_dual_fwd_rect). Replaces the
// same TPU kernel as _infonce_dual_local_fwd runs it
// (infonce_pallas.py:453-456: stats_only=True, rows_actual != cols_actual)
// in the data-parallel CLIP loss: one rank's za rows (n_a, D) against the
// gathered zb (n_b, D). It computes lse_a (n_a,), the row logsumexp over
// all n_b columns, and lse_b_part (n_b,), each column's logsumexp over
// this rank's n_a rows only (the caller merges it across ranks). No
// positives and no loss: the positives of local rows sit on the global
// diagonal, which the caller takes from a row-wise dot. Same design, one
// launch: the first ceil(n_a / 64) CTAs own rows of za and walk every
// column tile of zb; the next ceil(n_b / 64) own rows of zb and walk the
// tiles of za (s^T). Both directions see bitwise the same logits.
//
// Bound of the rectangular mode, fp32: 2 n_a n_b D operations (s formed
// once) against (n_a + n_b) (D + 1) * 4 bytes. One rank of 4 at global
// batch 256 (n_a = 64, n_b = 256, D = 512): 16.8 MFLOP, 0.25 us at the
// 67 TFLOP/s fp32 peak; at global batch 4096 (1024, 4096): 4.3 GFLOP,
// 64 us. Latency-bound at the first: 1 + 4 CTAs.
//
// Supported: float32 or bfloat16 za, zb, contiguous (n_a, D) and (n_b,
// D), n_a, n_b >= 1, 1 <= D <= 512. The C entry points return
// cudaGetLastError().

#include "infonce_tile.cuh"

namespace {

using namespace infonce;

// Sum / max over the 16 threads of a row group (lanes differ in bits 0-3).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// One CTA: rows row0 .. row0 + 63 of a (n_a x d) over every column tile of
// b (n_b x d); writes lse[row] for its rows. kLoss: also the sum over its
// rows of lse - s[row, row] (the diagonal positive) into *partial.
template <typename T, bool kLoss>
__device__ void lse_rows(const T* __restrict__ a, const T* __restrict__ b,
                         float scale, float* __restrict__ lse,
                         float* __restrict__ partial, int n_a, int n_b, int d,
                         int row0, float* as, float* bs, float* row_loss) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float m[4], l[4], pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    pos[i] = 0.f;
  }
  for (int col0 = 0; col0 < n_b; col0 += kTile) {
    float acc[4][4];
    tile_products(acc, as, bs, a, b, row0, col0, n_a, n_b, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float s[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        const float raw = acc[i][j] * scale;
        if (kLoss && col == row) pos[i] += raw;
        s[j] = col >= n_b ? kNegInf : raw;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the positive sits in exactly one thread of the row's group
    const float p = kLoss ? group_sum(pos[i]) : 0.f;
    if (tx == 0) {
      const int r = ty + 16 * i;
      const int row = row0 + r;
      const float row_lse = m[i] + logf(fmaxf(l[i], 1e-37f));
      if (row < n_a) lse[row] = row_lse;
      if (kLoss) row_loss[r] = row < n_a ? row_lse - p : 0.f;
    }
  }
  if (kLoss) {
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int r = 0; r < kTile; ++r) sum += row_loss[r];
      *partial = sum;
    }
  }
}

// Square mode. blockIdx.y = 0: rows of za over columns of zb (lse_a); 1:
// rows of zb over columns of za (lse_b).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    infonce_dual_fwd_kernel(const T* __restrict__ za,
                            const T* __restrict__ zb,
                            const float* __restrict__ scale_ptr,
                            float* __restrict__ lse_a,
                            float* __restrict__ lse_b,
                            float* __restrict__ partial, int n, int d) {
  __shared__ float as[kTile * kLd];
  __shared__ float bs[kTile * kLd];
  __shared__ float row_loss[kTile];
  const bool swap = blockIdx.y == 1;
  lse_rows<T, true>(swap ? zb : za, swap ? za : zb, *scale_ptr,
                    swap ? lse_b : lse_a,
                    partial + blockIdx.y * gridDim.x + blockIdx.x, n, n, d,
                    blockIdx.x * kTile, as, bs, row_loss);
}

// Rectangular stats-only mode: CTAs [0, tiles_a) own rows of za (n_a) over
// the columns of zb (n_b) and write lse_a; the rest own rows of zb over the
// columns of za and write lse_b (each column's lse over these n_a rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    infonce_fwd_rect_kernel(const T* __restrict__ za,
                            const T* __restrict__ zb,
                            const float* __restrict__ scale_ptr,
                            float* __restrict__ lse_a,
                            float* __restrict__ lse_b, int n_a, int n_b,
                            int d, int tiles_a) {
  __shared__ float as[kTile * kLd];
  __shared__ float bs[kTile * kLd];
  const bool swap = static_cast<int>(blockIdx.x) >= tiles_a;
  const int row0 = (swap ? blockIdx.x - tiles_a : blockIdx.x) * kTile;
  lse_rows<T, false>(swap ? zb : za, swap ? za : zb, *scale_ptr,
                     swap ? lse_b : lse_a, nullptr, swap ? n_b : n_a,
                     swap ? n_a : n_b, d, row0, as, bs, nullptr);
}

// One warp sums the per-CTA partials in a fixed order.
__global__ void infonce_loss_reduce(const float* __restrict__ partial,
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
cudaError_t launch(const void* za, const void* zb, const void* scale,
                   void* lse_a, void* lse_b, void* partial, void* loss, int n,
                   int d, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  infonce_dual_fwd_kernel<T><<<dim3(tiles, 2), kThreads, 0, stream>>>(
      static_cast<const T*>(za), static_cast<const T*>(zb),
      static_cast<const float*>(scale), static_cast<float*>(lse_a),
      static_cast<float*>(lse_b), static_cast<float*>(partial), n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  infonce_loss_reduce<<<1, 32, 0, stream>>>(
      static_cast<const float*>(partial), 2 * tiles,
      static_cast<float*>(loss));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rect(const void* za, const void* zb, const void* scale,
                        void* lse_a, void* lse_b, int n_a, int n_b, int d,
                        cudaStream_t stream) {
  const int tiles_a = (n_a + kTile - 1) / kTile;
  const int tiles_b = (n_b + kTile - 1) / kTile;
  infonce_fwd_rect_kernel<T><<<tiles_a + tiles_b, kThreads, 0, stream>>>(
      static_cast<const T*>(za), static_cast<const T*>(zb),
      static_cast<const float*>(scale), static_cast<float*>(lse_a),
      static_cast<float*>(lse_b), n_a, n_b, d, tiles_a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `scale` points to one fp32 on the
// device; `partial` holds 2 * ceil(n / 64) floats of scratch. Returns a
// cudaError_t (0 = success).
extern "C" int ntx_infonce_dual_fwd(const void* za, const void* zb,
                                    const void* scale, void* lse_a,
                                    void* lse_b, void* partial, void* loss,
                                    int n, int d, int dtype, int device,
                                    void* stream) {
  if (n < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(za, zb, scale, lse_a, lse_b, partial, loss, n, d, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(za, zb, scale, lse_a, lse_b, partial, loss,
                                 n, d, s);
  }
  return cudaErrorInvalidValue;
}

// The rectangular stats-only mode: lse_a (n_a,) and lse_b (n_b,) fp32 of
// za (n_a, d) against zb (n_b, d). dtype as above.
extern "C" int ntx_infonce_dual_fwd_rect(const void* za, const void* zb,
                                         const void* scale, void* lse_a,
                                         void* lse_b, int n_a, int n_b,
                                         int d, int dtype, int device,
                                         void* stream) {
  if (n_a < 1 || n_b < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_rect<float>(za, zb, scale, lse_a, lse_b, n_a, n_b, d, s);
  }
  if (dtype == 1) {
    return launch_rect<__nv_bfloat16>(za, zb, scale, lse_a, lse_b, n_a, n_b,
                                      d, s);
  }
  return cudaErrorInvalidValue;
}
