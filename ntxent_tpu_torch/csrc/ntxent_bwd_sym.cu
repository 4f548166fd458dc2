// NT-Xent symmetric backward for Hopper (sm_90a), bound to PyTorch via
// ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:445
// (_bwd_sym_kernel, launched by _bwd_sym_call at ntxent_pallas.py:625).
// For the stacked views z (2N, D) and the forward's row logsumexp lse it
// computes, as that kernel does,
//   s[a, b]  = (z_a . z_b) * inv_t in fp32, diagonal masked to -1e30;
//   p_row    = exp(min(s[a, b] - lse[a], 0)),  p_col = exp(min(s[a, b] - lse[b], 0));
//   G[a, b]  = (p_row - pos[a, b]) + (p_col - pos[a, b]),
//              pos[a, b] = 1 iff b = (a + N) mod 2N;
//   grad[a]  = sum_b G[a, b] z_b   (fp32, before the caller's g / T scale).
// Both gradient terms of z_a (as a row and as a column of s) fold into one
// pass because s is symmetric and the positive map is an involution.
// Every row of the symmetric layout is real (no tile padding here), so
// the valid_row / valid_col factors of the TPU kernel are 1.
//
// Design. The TPU grid's sequential column axis becomes a loop inside one
// CTA per 32-row tile (8 threads per row). Each 64-column tile of z is
// staged once in shared memory (widened to fp32), s and G are computed in
// registers as in the forward, G goes to shared memory, and each thread
// accumulates its row's grad over D / 8 columns in registers. Each output
// row belongs to one CTA: no atomics, and the result is repeatable.
// Arithmetic is fp32 FMA (no TF32).
//
// Bound at the training shape (2N = 512, D = 128, fp32): two 512 x 512 x
// 128 products, 134 MFLOP, 2.0 us at the 67 TFLOP/s fp32 peak; z, lse and
// grad are 0.5 MB, 0.16 us at 3.35 TB/s. Compute-bound on paper,
// launch-bound in practice.
//
// Supported: float32 or bfloat16 z, contiguous (rows, D), rows even >= 2,
// 1 <= D <= 256. The C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace {

constexpr int kRows = 32;
constexpr int kCols = 64;
constexpr int kThreadsPerRow = 8;
constexpr int kColsPerThread = kCols / kThreadsPerRow;
constexpr int kThreads = kRows * kThreadsPerRow;  // 256
constexpr int kMaxD = 256;
constexpr int kMaxDPerThread = kMaxD / kThreadsPerRow;  // 32
constexpr int kLdG = kCols + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

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
    ntxent_bwd_sym_kernel(const T* __restrict__ z,
                          const float* __restrict__ lse,
                          float* __restrict__ grad, int n_rows, int d,
                          float inv_t) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* zr = smem;                          // kRows x ld
  float* zc = zr + kRows * ld;               // kCols x ld
  float* g_s = zc + kCols * ld;              // kRows x kLdG
  float* lse_c = g_s + kRows * kLdG;         // kCols

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;
  const int g = tid % kThreadsPerRow;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + r;
  const int n_half = n_rows / 2;
  const int pos_col = row < n_half ? row + n_half : row - n_half;
  const float lse_r = row < n_rows ? lse[row] : 0.f;

  stage(zr, z + size_t(row0) * d, kRows, min(kRows, n_rows - row0), d);

  float acc[kMaxDPerThread];
#pragma unroll
  for (int i = 0; i < kMaxDPerThread; ++i) acc[i] = 0.f;

  const int col_tiles = (n_rows + kCols - 1) / kCols;
  for (int j = 0; j < col_tiles; ++j) {
    const int col0 = j * kCols;
    __syncthreads();  // the previous tile's readers are done with zc, g_s
    stage(zc, z + size_t(col0) * d, kCols, min(kCols, n_rows - col0), d);
    if (tid < kCols) {
      lse_c[tid] = col0 + tid < n_rows ? lse[col0 + tid] : 0.f;
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
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int cl = g + c * kThreadsPerRow;
      const int col = col0 + cl;
      float x = s[c] * inv_t;
      if (col >= n_rows || col == row) x = kNegInf;
      const float pos = col == pos_col ? 1.f : 0.f;
      float gv = (exp0(x - lse_r) - pos) + (exp0(x - lse_c[cl]) - pos);
      if (col >= n_rows || row >= n_rows) gv = 0.f;
      g_s[r * kLdG + cl] = gv;
    }
    __syncthreads();

    // grad[row, g + 8i] += sum_c G[row, c] * z[col0 + c, g + 8i]
    const float* grow = g_s + r * kLdG;
    for (int c = 0; c < kCols; ++c) {
      const float gv = grow[c];
      const float* zcol = zc + c * ld;
#pragma unroll
      for (int i = 0; i < kMaxDPerThread; ++i) {
        const int k = g + i * kThreadsPerRow;
        if (k < d) acc[i] = fmaf(gv, zcol[k], acc[i]);
      }
    }
  }
  if (row < n_rows) {
    float* out = grad + size_t(row) * d;
#pragma unroll
    for (int i = 0; i < kMaxDPerThread; ++i) {
      const int k = g + i * kThreadsPerRow;
      if (k < d) out[k] = acc[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* z, const void* lse, void* grad, int n_rows,
                   int d, float inv_t, cudaStream_t stream) {
  const size_t smem =
      (size_t(kRows + kCols) * (d + 1) + kRows * kLdG + kCols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ntxent_bwd_sym_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (n_rows + kRows - 1) / kRows;
  ntxent_bwd_sym_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const float*>(lse),
      static_cast<float*>(grad), n_rows, d, inv_t);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int ntx_ntxent_bwd_sym(const void* z, const void* lse, void* grad,
                                  int n_rows, int d, int dtype, float inv_t,
                                  int device, void* stream) {
  if (n_rows < 2 || n_rows % 2 || d < 1 || d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(z, lse, grad, n_rows, d, inv_t, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(z, lse, grad, n_rows, d, inv_t, s);
  }
  return cudaErrorInvalidValue;
}
