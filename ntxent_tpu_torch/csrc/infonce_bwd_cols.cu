// Data-parallel InfoNCE (CLIP) column-side backward for Hopper (sm_90a),
// bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:479
// (_bwd_sym_cols_kernel, launched by _bwd_sym_cols_call at
// ntxent_pallas.py:528) in the cross-modal mode (diag_pos=True, a traced
// scale, separate lse_rows and lse_cols) that _infonce_dual_local_bwd runs
// for the column side of the data-parallel CLIP loss
// (infonce_pallas.py:506-507). From one rank's rows za (n_r, D) with global
// ids row_gid, the gathered zb (n_c, D), the row lse lse_a (n_r,) and the
// merged global column lse lse_b (n_c,) it computes, as that kernel does,
//   s[i, j] = (za_i . zb_j) * scale in fp32;
//   G[i, j] = (exp0(s - lse_a[i]) - pos) * valid_row_i + (exp0(s - lse_b[j]) - pos),
//   pos = 1 iff j = row_gid[i], valid_row_i = row_gid[i] < n_c;
//   o_b = G^T . za   (fp32 (n_c, D)),
// the partial gradient of the gathered zb from this rank's rows (the
// caller's all-gather sums it over ranks in its backward: a
// reduce-scatter). Rows past n_r and columns past n_c do not exist (the
// TPU kernel's zero padding contributes nothing).
//
// Design. The TPU kernel's grid is (column block, row block) with rows
// innermost, accumulating each output column block across the sequential
// row axis. Here each CTA owns 64 output columns and walks the row tiles
// in a loop (infonce_grad.cuh with the columns as "own": G is symmetric in
// its two terms, so G^T . za is the row side of the swapped problem with
// the ids on the other operand). One owner per output column, no atomics:
// the result is repeatable, and its s products are bitwise those of the
// rows kernel (csrc/infonce_dual_bwd.cu). fp32 FMA of widened inputs, no
// TF32.
//
// Bound, fp32: 4 n_r n_c D operations against (n_r + n_c) D inputs and an
// (n_c, D) output, plus ids and lse, in bytes. One rank of 4 at global
// batch 256 (n_r = 64, n_c = 256, D = 512): 33.6 MFLOP, 0.5 us at the 67
// TFLOP/s fp32 peak; at global batch 4096 (1024, 4096): 8.6 GFLOP, 128 us.
// Latency-bound at the first (4 CTAs, one row tile each).
//
// Supported: float32 or bfloat16 za, zb (the same dtype), contiguous,
// 1 <= D <= 512, int32 row ids. The C entry point returns
// cudaGetLastError().

#include "infonce_grad.cuh"

namespace {

using namespace infonce;

// o_b[j] = sum_i G[i, j] za_i: zb's columns own the output, za's rows
// (with their global ids) are walked.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    infonce_bwd_cols_kernel(const T* __restrict__ za,
                            const T* __restrict__ zb,
                            const int* __restrict__ row_gid,
                            const float* __restrict__ scale_ptr,
                            const float* __restrict__ lse_a,
                            const float* __restrict__ lse_b,
                            float* __restrict__ o_b, int n_rows, int n_cols,
                            int d) {
  extern __shared__ float smem[];
  grad_rows(zb, za, nullptr, row_gid, lse_b, lse_a, *scale_ptr, o_b, n_cols,
            n_rows, n_cols, d, blockIdx.x * kTile, smem);
}

template <typename T>
cudaError_t launch_cols(const void* za, const void* zb, const void* row_gid,
                        const void* scale, const void* lse_a,
                        const void* lse_b, void* o_b, int n_rows, int n_cols,
                        int d, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = opt_in_smem(infonce_bwd_cols_kernel<T>, d, &smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_cols + kTile - 1) / kTile;
  infonce_bwd_cols_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(za), static_cast<const T*>(zb),
      static_cast<const int*>(row_gid), static_cast<const float*>(scale),
      static_cast<const float*>(lse_a), static_cast<const float*>(lse_b),
      static_cast<float*>(o_b), n_rows, n_cols, d);
  return cudaGetLastError();
}

}  // namespace

// o_b (n_cols, d) fp32 = G^T . za. row_gid: n_rows int32 global ids
// (required); lse_a (n_rows,), lse_b (n_cols,) fp32; `scale` points to one
// fp32 on the device. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = success).
extern "C" int ntx_infonce_bwd_cols(const void* za, const void* zb,
                                    const void* row_gid, const void* scale,
                                    const void* lse_a, const void* lse_b,
                                    void* o_b, int n_rows, int n_cols, int d,
                                    int dtype, int device, void* stream) {
  if (row_gid == nullptr || n_rows < 1 || n_cols < 1 || d < 1 ||
      d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_cols<float>(za, zb, row_gid, scale, lse_a, lse_b, o_b,
                              n_rows, n_cols, d, s);
  }
  if (dtype == 1) {
    return launch_cols<__nv_bfloat16>(za, zb, row_gid, scale, lse_a, lse_b,
                                      o_b, n_rows, n_cols, d, s);
  }
  return cudaErrorInvalidValue;
}
