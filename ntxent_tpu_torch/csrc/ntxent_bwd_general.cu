// NT-Xent general backward for Hopper (sm_90a), bound to PyTorch via
// ctypes: the rows kernel and the columns kernel.
//
// Replaces _bwd_general_call (ntxent_tpu/ops/ntxent_pallas.py:648), which
// is two Pallas TPU kernels: _bwd_rows_kernel (ntxent_pallas.py:552,
// pallas_call at :658) and _bwd_cols_kernel (:580, pallas_call at :679).
// For rows z_rows (R, D) with global ids row_gid, columns z_cols (C, D)
// with global ids col_gid (null: the column index) and the forward's ROW
// logsumexp lse (R,), as those kernels do:
//   s[i, j]  = (z_rows_i . z_cols_j) * inv_t in fp32, columns whose id is
//              >= cols_actual or equals the row's id masked to -1e30;
//   P[i, j]  = exp(min(s[i, j] - lse[i], 0));
//   E[i, j]  = 1 iff the column's id is pos(row_gid_i) (_pos_gid);
//   G[i, j]  = (P - E) * valid_row_i, valid_row_i = row_gid_i < cols_actual;
//   rows:  grad_rows = G @ z_cols     (R, D);
//   cols:  grad_cols = G^T @ z_rows   (C, D);
// both fp32 and before the caller's g / T scale. Rows past R and columns
// past C do not exist (the TPU kernels' zero padding contributes nothing).
//
// Design. The TPU grid's sequential inner axis becomes a loop inside one
// CTA. One templated kernel serves both: a CTA owns 32 output vectors
// ("own": rows of z_rows for the rows kernel, of z_cols for the columns
// kernel), 8 threads each, and walks the other array in 64-vector tiles
// staged in shared memory (widened to fp32) with their ids and, for the
// columns kernel, their row lse. Each thread computes 8 entries of the
// 32 x 64 s tile, writes G to shared memory, then accumulates its own
// vector's D / 8 output columns in registers. The columns kernel computes
// s as z_cols_j . z_rows_i in the same k order as the forward, so the
// products are bitwise those of the rows kernel. Each output vector has
// one owner: no atomics, and the result is repeatable. Arithmetic is fp32
// FMA (no TF32).
//
// Bound, each kernel: 4 R C D operations (s and the product with G)
// against (R + C) D inputs, R ids and lse, and an (R or C) x D fp32
// output. At one rank's strip of a 4-card world at global batch 256
// (R = 128, C = 512, D = 128): 33.6 MFLOP, 0.5 us at the 67 TFLOP/s fp32
// peak: launch- and latency-bound (4 and 16 CTAs). At global batch 4096
// on 4 cards (R = 2048, C = 8192, D = 128): 8.6 GFLOP, 128 us.
//
// Supported: float32 or bfloat16 z_rows and z_cols (the same dtype),
// contiguous, 1 <= D <= 256, int32 ids. The C entry points return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kOwn = 32;                         // output vectors per CTA
constexpr int kOther = 64;                       // other vectors per tile
constexpr int kThreadsPerOwn = 8;
constexpr int kOtherPerThread = kOther / kThreadsPerOwn;
constexpr int kThreads = kOwn * kThreadsPerOwn;  // 256
constexpr int kMaxD = 256;
constexpr int kMaxDPerThread = kMaxD / kThreadsPerOwn;  // 32
constexpr int kLdG = kOther + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

__device__ __forceinline__ int pos_of(int gid, int n_half) {
  return gid < n_half ? gid + n_half : gid - n_half;
}

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

// kCols = false: own = rows (z_own = z_rows, own ids = row_gid, lse per
// own vector); true: own = columns (z_own = z_cols, own ids = col_gid or
// the index, lse per other vector).
template <typename T, bool kCols>
__global__ void __launch_bounds__(kThreads)
    ntxent_bwd_general_kernel(const T* __restrict__ z_own,
                              const T* __restrict__ z_other,
                              const int* __restrict__ own_gid,
                              const int* __restrict__ other_gid,
                              const float* __restrict__ lse,
                              float* __restrict__ grad, int n_own,
                              int n_other, int d, float inv_t,
                              int cols_actual, int n_half) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* za = smem;                      // kOwn x ld
  float* zb = za + kOwn * ld;            // kOther x ld
  float* g_s = zb + kOther * ld;         // kOwn x kLdG
  float* lse_b = g_s + kOwn * kLdG;      // kOther (columns kernel)
  int* id_b = reinterpret_cast<int*>(lse_b + kOther);  // kOther

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerOwn;
  const int g = tid % kThreadsPerOwn;
  const int own0 = blockIdx.x * kOwn;
  const int own = own0 + r;
  const bool own_in = own < n_own;
  // Rows kernel: own ids are row ids (row_gid is never null). Columns
  // kernel: own ids are column ids (null: the index).
  const int own_id = own_in ? (own_gid ? own_gid[own] : own) : 0;
  const float lse_own = (!kCols && own_in) ? lse[own] : 0.f;
  const bool row_valid_own = !kCols && own_in && own_id < cols_actual;
  const int pos_own = pos_of(own_id, n_half);

  stage(za, z_own + size_t(own0) * d, kOwn, min(kOwn, n_own - own0), d);

  float acc[kMaxDPerThread];
#pragma unroll
  for (int i = 0; i < kMaxDPerThread; ++i) acc[i] = 0.f;

  const int tiles = (n_other + kOther - 1) / kOther;
  for (int j = 0; j < tiles; ++j) {
    const int b0 = j * kOther;
    __syncthreads();  // the previous tile's readers are done with zb, g_s
    stage(zb, z_other + size_t(b0) * d, kOther, min(kOther, n_other - b0),
          d);
    if (tid < kOther) {
      const int b = b0 + tid;
      const bool in = b < n_other;
      // Rows kernel: other ids are column ids (null: the index), and a
      // missing column gets an id that masks it. Columns kernel: other
      // ids are row ids.
      id_b[tid] = in ? (other_gid ? other_gid[b] : b) : INT_MAX;
      lse_b[tid] = (kCols && in) ? lse[b] : 0.f;
    }
    __syncthreads();

    float s[kOtherPerThread];
#pragma unroll
    for (int c = 0; c < kOtherPerThread; ++c) s[c] = 0.f;
    const float* arow = za + r * ld;
    for (int k = 0; k < d; ++k) {
      const float a = arow[k];
#pragma unroll
      for (int c = 0; c < kOtherPerThread; ++c) {
        s[c] = kCols
                   ? fmaf(zb[(g + c * kThreadsPerOwn) * ld + k], a, s[c])
                   : fmaf(a, zb[(g + c * kThreadsPerOwn) * ld + k], s[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kOtherPerThread; ++c) {
      const int cl = g + c * kThreadsPerOwn;
      const bool other_in = b0 + cl < n_other;
      const int other_id = id_b[cl];
      int rgid, cid;
      float row_lse;
      bool row_valid;
      int pos;
      if (kCols) {
        rgid = other_id;
        cid = own_id;
        row_lse = lse_b[cl];
        row_valid = other_in && rgid < cols_actual;
        pos = pos_of(rgid, n_half);
      } else {
        rgid = own_id;
        cid = other_id;
        row_lse = lse_own;
        row_valid = row_valid_own;
        pos = pos_own;
      }
      float x = s[c] * inv_t;
      if (cid >= cols_actual || cid == rgid) x = kNegInf;
      const float e = cid == pos ? 1.f : 0.f;
      const bool exists = own_in && other_in;
      g_s[r * kLdG + cl] =
          (exists && row_valid) ? exp0(x - row_lse) - e : 0.f;
    }
    __syncthreads();

    // grad[own, g + 8i] += sum_b G[own, b] * z_other[b0 + b, g + 8i]
    const float* grow = g_s + r * kLdG;
    for (int c = 0; c < kOther; ++c) {
      const float gv = grow[c];
      const float* zcol = zb + c * ld;
#pragma unroll
      for (int i = 0; i < kMaxDPerThread; ++i) {
        const int k = g + i * kThreadsPerOwn;
        if (k < d) acc[i] = fmaf(gv, zcol[k], acc[i]);
      }
    }
  }
  if (own_in) {
    float* out = grad + size_t(own) * d;
#pragma unroll
    for (int i = 0; i < kMaxDPerThread; ++i) {
      const int k = g + i * kThreadsPerOwn;
      if (k < d) out[k] = acc[i];
    }
  }
}

template <typename T, bool kCols>
cudaError_t launch(const void* z_own, const void* z_other,
                   const int* own_gid, const int* other_gid,
                   const float* lse, float* grad, int n_own, int n_other,
                   int d, float inv_t, int cols_actual, int n_half,
                   cudaStream_t stream) {
  const size_t smem = (size_t(kOwn + kOther) * (d + 1) + kOwn * kLdG +
                       2 * kOther) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ntxent_bwd_general_kernel<T, kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (n_own + kOwn - 1) / kOwn;
  ntxent_bwd_general_kernel<T, kCols><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(z_own), static_cast<const T*>(z_other), own_gid,
      other_gid, lse, grad, n_own, n_other, d, inv_t, cols_actual, n_half);
  return cudaGetLastError();
}

template <bool kCols>
cudaError_t dispatch(const void* z_own, const void* z_other,
                     const void* own_gid, const void* other_gid,
                     const void* lse, void* grad, int n_own, int n_other,
                     int d, int dtype, float inv_t, int cols_actual,
                     int n_half, int device, void* stream) {
  if (n_own < 1 || n_other < 1 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* oid = static_cast<const int*>(own_gid);
  const int* bid = static_cast<const int*>(other_gid);
  const float* l = static_cast<const float*>(lse);
  float* out = static_cast<float*>(grad);
  if (dtype == 0) {
    return launch<float, kCols>(z_own, z_other, oid, bid, l, out, n_own,
                                n_other, d, inv_t, cols_actual, n_half, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, kCols>(z_own, z_other, oid, bid, l, out,
                                        n_own, n_other, d, inv_t,
                                        cols_actual, n_half, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// grad_rows (n_rows, d) fp32 = G @ z_cols. row_gid (int32) is required,
// col_gid (int32) may be null. dtype: 0 = float32, 1 = bfloat16.
extern "C" int ntx_ntxent_bwd_general_rows(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* lse, void* grad_rows, int n_rows,
    int n_cols, int d, int dtype, float inv_t, int cols_actual, int n_half,
    int device, void* stream) {
  if (row_gid == nullptr) return cudaErrorInvalidValue;
  return dispatch<false>(z_rows, z_cols, row_gid, col_gid, lse, grad_rows,
                         n_rows, n_cols, d, dtype, inv_t, cols_actual,
                         n_half, device, stream);
}

// grad_cols (n_cols, d) fp32 = G^T @ z_rows, from the row lse only.
extern "C" int ntx_ntxent_bwd_general_cols(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* lse, void* grad_cols, int n_rows,
    int n_cols, int d, int dtype, float inv_t, int cols_actual, int n_half,
    int device, void* stream) {
  if (row_gid == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(z_cols, z_rows, col_gid, row_gid, lse, grad_cols,
                        n_cols, n_rows, d, dtype, inv_t, cols_actual, n_half,
                        device, stream);
}
