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
// MFLOP, 1.2 us at the 165 TFLOP/s of fp32-accurate products (3xTF32 on
// the tensor cores); za, zb, lse and the two outputs are 2 MB, 0.63 us at
// 3.35 TB/s. Compute-bound on paper, launch-bound in practice (8 CTAs).
//
// Rows kernel (ntx_infonce_bwd_rows), on TF32 tensor cores. Replaces the
// Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel,
// launched by _bwd_sym_call at ntxent_pallas.py:612, pallas_call :625) in
// its cross-modal mode (diag_pos=True, z_cols, lse_cols, a traced scale),
// as _infonce_dual_local_bwd runs it for the row side of the data-parallel
// CLIP loss (infonce_pallas.py:504-505): one rank's rows za (n_r, D) with
// global ids row_gid against the gathered zb (n_c, D), the row lse lse_a
// (n_r,) and the merged global column lse lse_b (n_c,):
//   G[i, j] = (exp0(s - lse_a[i]) - pos) * valid_row_i + (exp0(s - lse_b[j]) - pos),
//   pos = 1 iff j = row_gid[i], valid_row_i = row_gid[i] < n_c;
//   o_a = G . zb   (fp32 (n_r, D)).
// A padding row (id = n_c) keeps its column term. Design
// (infonce_cross_bwd.cuh): the walk of ntxent_tf32.cuh (bwd_walk), as #6's
// rows kernel runs it; one CTA per (64 rows of za, split of zb's columns,
// chunk of D of at most 128) forms s by 3xTF32 wgmma (two products for
// bf16) from a TMA ring, G in the accumulator with lse_b loaded per tile
// (CrossRowsG), and adds G . zb with G as the register A operand, a fresh
// accumulator per 64-column tile; a sum kernel adds the splits in order.
// One owner per output, no atomics: repeatable bit for bit. The column
// side is csrc/infonce_bwd_cols.cu. Bound, fp32: 4 n_r n_c D operations,
// each product three TF32 passes (165 TFLOP/s for fp32-accurate
// products), against (n_r + n_c) D inputs, the ids and both lse and an
// (n_r, D) output. World 1 at batch 256 (256, 256, 512): 134 MFLOP, 0.81
// us; one rank of 4 at global batch 256 (64, 256, 512): 0.24 us by bytes
// (0.79 MB at 3.35 TB/s); at global batch 4096 (1024, 4096, 512): 8.6
// GFLOP, 52 us. At D = 512 the four chunks of D each form s again.
//
// Supported: float32 or bfloat16 za, zb, contiguous, 1 <= D <= 512; the
// square kernel takes (N, D) each, the rows kernel (n_r, D) and (n_c, D)
// with int32 row ids. The C entry points return cudaGetLastError().

#include "infonce_cross_bwd.cuh"
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

// Floats of scratch one call of the rows kernel takes: n_own = n_r (za
// owns the outputs), n_other = n_c.
extern "C" long long ntx_infonce_bwd_rows_scratch(int n_own, int n_other,
                                                  int d, int dtype,
                                                  int splits) {
  return ntx::bwd_scratch_floats(n_own, n_other, d, dtype, splits);
}

// The rows kernel: o_a (n_rows, d) fp32 = G . zb. row_gid: n_rows int32
// global ids (required); lse_a (n_rows,), lse_b (n_cols,) fp32. dtype as
// above. zb's columns are cut into `splits` runs of `split_cols` (the
// last one shorter), each non-empty; `scratch` holds
// ntx_infonce_bwd_rows_scratch(n_rows, n_cols, d, dtype, splits) floats.
extern "C" int ntx_infonce_bwd_rows(const void* za, const void* zb,
                                    const void* row_gid, const void* scale,
                                    const void* lse_a, const void* lse_b,
                                    void* o_a, void* scratch, int n_rows,
                                    int n_cols, int d, int dtype, int splits,
                                    int split_cols, int device,
                                    void* stream) {
  return infonce_cross::run<false>(za, zb, row_gid, scale, lse_a, lse_b,
                                   o_a, scratch, n_rows, n_cols, d, dtype,
                                   splits, split_cols, device, stream);
}
