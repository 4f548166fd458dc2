// Cross-modal InfoNCE (CLIP) backward for Hopper (sm_90a), bound to
// PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/infonce_pallas.py:204
// (_dual_bwd_kernel, launched by _dual_bwd_call at infonce_pallas.py:274)
// as _infonce_bwd runs it. From za, zb (N, D), the logit scale (a device
// scalar) and the forward's lse_a, lse_b it computes, as that kernel does,
//   s[i, j] = (za_i . zb_j) * scale in fp32;
//   G[i, j] = (exp(min(s - lse_a[i], 0)) - I) + (exp(min(s - lse_b[j], 0)) - I)
//             (the total dL/ds before the caller's g / 2N; the diagonal I
//             is the positive and is not masked);
//   o_a = G . zb,  o_b = G^T . za   (fp32, (N, D) each).
// The TPU kernel's valid_row / valid_col factors are 1 on every real entry:
// the ragged edge is masked here by bounds instead (G = 0 past N).
//
// Design. The TPU kernel forms one s tile and one G tile and adds G . zb_j
// into a full-length row accumulator and G^T . za_i into a full-length
// column accumulator, both carried across its sequential grid. Hopper
// blocks run in no order, so each output row must have one owner: o_b is
// computed as the row side of the swapped problem, since with za <-> zb
// and lse_a <-> lse_b exchanged, G becomes G^T (blockIdx.y = 1 in the same
// launch). One launch; each CTA owns 64 output rows of one side and walks
// every 64-column tile (infonce_grad.cuh: the s tile by the
// register-blocked product of infonce_tile.cuh, G to shared memory, then
// G . b_tile into the CTA's (64, D) fp32 accumulator in shared memory).
// No atomics: the result is repeatable. The work is 8 N^2 D against the
// TPU kernel's 6 N^2 D (s is formed once per side). Arithmetic is fp32 FMA
// of widened inputs, no TF32.
//
// Bound at the training shape (N = 256, D = 512, fp32): 6 N^2 D = 201
// MFLOP, 3.0 us at the 67 TFLOP/s fp32 peak; za, zb, lse and the two
// outputs are 2 MB, 0.63 us at 3.35 TB/s. Compute-bound on paper,
// launch-bound in practice (8 CTAs).
//
// Rows kernel (ntx_infonce_bwd_rows). Replaces the Pallas TPU kernel
// ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel, launched by
// _bwd_sym_call at ntxent_pallas.py:625) in its cross-modal mode
// (diag_pos=True, z_cols, lse_cols, a traced scale), as
// _infonce_dual_local_bwd runs it for the row side of the data-parallel
// CLIP loss (infonce_pallas.py:504-505): one rank's rows za (n_r, D) with
// global ids row_gid against the gathered zb (n_c, D), the row lse lse_a
// (n_r,) and the merged global column lse lse_b (n_c,):
//   G[i, j] = (exp0(s - lse_a[i]) - pos) * valid_row_i + (exp0(s - lse_b[j]) - pos),
//   pos = 1 iff j = row_gid[i], valid_row_i = row_gid[i] < n_c;
//   o_a = G . zb   (fp32 (n_r, D)).
// It is the row side of the square kernel with ids on the rows
// (infonce_grad.cuh), one CTA per 64 rows; the column side is
// csrc/infonce_bwd_cols.cu. Bound, fp32: 4 n_r n_c D operations against
// (n_r + n_c) D inputs and an (n_r, D) output, plus ids and lse, in
// bytes. One rank of 4 at
// global batch 256 (n_r = 64, n_c = 256, D = 512): 33.6 MFLOP, 0.5 us at
// the 67 TFLOP/s fp32 peak; at global batch 4096 (1024, 4096): 8.6 GFLOP,
// 128 us. Latency-bound: one CTA per 64 rows walks all n_c columns.
//
// Supported: float32 or bfloat16 za, zb, contiguous, 1 <= D <= 512; the
// square kernel takes (N, D) each, the rows kernel (n_r, D) and (n_c, D)
// with int32 row ids. The C entry points return cudaGetLastError().

#include "infonce_grad.cuh"

namespace {

using namespace infonce;

// Square mode. blockIdx.y = 0: o_a[i] = sum_j G[i, j] zb_j; 1:
// o_b[j] = sum_i G[i, j] za_i as the row side of the swapped problem.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    infonce_dual_bwd_kernel(const T* __restrict__ za,
                            const T* __restrict__ zb,
                            const float* __restrict__ scale_ptr,
                            const float* __restrict__ lse_a,
                            const float* __restrict__ lse_b,
                            float* __restrict__ o_a, float* __restrict__ o_b,
                            int n, int d) {
  extern __shared__ float smem[];
  const bool swap = blockIdx.y == 1;
  grad_rows(swap ? zb : za, swap ? za : zb, nullptr, nullptr,
            swap ? lse_b : lse_a, swap ? lse_a : lse_b, *scale_ptr,
            swap ? o_b : o_a, n, n, n, d, blockIdx.x * kTile, smem);
}

// Rows mode: o_a[i] = sum_j G[i, j] zb_j for rows of za with global ids.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    infonce_bwd_rows_kernel(const T* __restrict__ za,
                            const T* __restrict__ zb,
                            const int* __restrict__ row_gid,
                            const float* __restrict__ scale_ptr,
                            const float* __restrict__ lse_a,
                            const float* __restrict__ lse_b,
                            float* __restrict__ o_a, int n_rows, int n_cols,
                            int d) {
  extern __shared__ float smem[];
  grad_rows(za, zb, row_gid, nullptr, lse_a, lse_b, *scale_ptr, o_a, n_rows,
            n_cols, n_cols, d, blockIdx.x * kTile, smem);
}

template <typename T>
cudaError_t launch(const void* za, const void* zb, const void* scale,
                   const void* lse_a, const void* lse_b, void* o_a, void* o_b,
                   int n, int d, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = opt_in_smem(infonce_dual_bwd_kernel<T>, d, &smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTile - 1) / kTile;
  infonce_dual_bwd_kernel<T><<<dim3(tiles, 2), kThreads, smem, stream>>>(
      static_cast<const T*>(za), static_cast<const T*>(zb),
      static_cast<const float*>(scale), static_cast<const float*>(lse_a),
      static_cast<const float*>(lse_b), static_cast<float*>(o_a),
      static_cast<float*>(o_b), n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* za, const void* zb, const void* row_gid,
                        const void* scale, const void* lse_a,
                        const void* lse_b, void* o_a, int n_rows, int n_cols,
                        int d, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = opt_in_smem(infonce_bwd_rows_kernel<T>, d, &smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_rows + kTile - 1) / kTile;
  infonce_bwd_rows_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(za), static_cast<const T*>(zb),
      static_cast<const int*>(row_gid), static_cast<const float*>(scale),
      static_cast<const float*>(lse_a), static_cast<const float*>(lse_b),
      static_cast<float*>(o_a), n_rows, n_cols, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `scale` points to one fp32 on the
// device. Returns a cudaError_t (0 = success).
extern "C" int ntx_infonce_dual_bwd(const void* za, const void* zb,
                                    const void* scale, const void* lse_a,
                                    const void* lse_b, void* o_a, void* o_b,
                                    int n, int d, int dtype, int device,
                                    void* stream) {
  if (n < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(za, zb, scale, lse_a, lse_b, o_a, o_b, n, d, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(za, zb, scale, lse_a, lse_b, o_a, o_b, n, d,
                                 s);
  }
  return cudaErrorInvalidValue;
}

// The rows kernel: o_a (n_rows, d) fp32 = G . zb. row_gid: n_rows int32
// global ids (required); lse_a (n_rows,), lse_b (n_cols,) fp32. dtype as
// above.
extern "C" int ntx_infonce_bwd_rows(const void* za, const void* zb,
                                    const void* row_gid, const void* scale,
                                    const void* lse_a, const void* lse_b,
                                    void* o_a, int n_rows, int n_cols, int d,
                                    int dtype, int device, void* stream) {
  if (row_gid == nullptr || n_rows < 1 || n_cols < 1 || d < 1 ||
      d > kMaxD) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_rows<float>(za, zb, row_gid, scale, lse_a, lse_b, o_a,
                              n_rows, n_cols, d, s);
  }
  if (dtype == 1) {
    return launch_rows<__nv_bfloat16>(za, zb, row_gid, scale, lse_a, lse_b,
                                      o_a, n_rows, n_cols, d, s);
  }
  return cudaErrorInvalidValue;
}
