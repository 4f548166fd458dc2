// Data-parallel InfoNCE (CLIP) column-side backward for Hopper (sm_90a)
// on TF32 tensor cores, bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:479
// (_bwd_sym_cols_kernel, launched by _bwd_sym_cols_call at
// ntxent_pallas.py:516, pallas_call :528) in the cross-modal mode
// (diag_pos=True, a traced scale, separate lse_rows and lse_cols) that
// _infonce_dual_local_bwd runs for the column side of the data-parallel
// CLIP loss (infonce_pallas.py:506-507). From one rank's rows za (n_r, D)
// with global ids row_gid, the gathered zb (n_c, D), the row lse lse_a
// (n_r,) and the merged global column lse lse_b (n_c,) it computes, as
// that kernel does,
//   s[i, j] = (za_i . zb_j) * scale in fp32;
//   G[i, j] = (exp0(s - lse_a[i]) - pos) * valid_row_i + (exp0(s - lse_b[j]) - pos),
//   pos = 1 iff j = row_gid[i], valid_row_i = row_gid[i] < n_c;
//   o_b = G^T . za   (fp32 (n_c, D)),
// the partial gradient of the gathered zb from this rank's rows (the
// caller's all-gather sums it over ranks in its backward: a
// reduce-scatter). A padding row (id = n_c) keeps its column term.
//
// Design (infonce_cross_bwd.cuh). The TPU kernel's grid is (column block,
// row block), rows innermost, accumulating each output column block
// across the sequential row axis. Here the walk of ntxent_tf32.cuh
// (bwd_walk) owns zb's columns: one CTA per (64 columns of zb, split of
// za's rows, chunk of D of at most 128) forms s^T = zb za^T by 3xTF32
// wgmma (two products for bf16) from a TMA ring, G^T in the accumulator
// from the rows' ids and lse_a, which come in per tile (CrossColsG, as
// #6's columns kernel takes the other side's lse), and adds G^T . za with
// G^T as the register A operand, a fresh accumulator per 64-row tile; a
// sum kernel adds the splits in order. One owner per output, no atomics:
// repeatable bit for bit.
//
// Bound, fp32: 4 n_r n_c D operations (s and G^T . za), each product
// three TF32 passes (165 TFLOP/s for fp32-accurate products), against
// (n_r + n_c) D inputs, the ids and both lse and an (n_c, D) output. World
// 1 at batch 256 (n_r = n_c = 256, D = 512): 134 MFLOP, 0.81 us; one rank
// of 4 at global batch 256 (64, 256, 512): 0.35 us by bytes (1.1 MB at
// 3.35 TB/s); at global batch 4096 (1024, 4096, 512): 8.6 GFLOP, 52 us. At
// D = 512 the four chunks of D each form s again: 2.5 times the products
// of one pass.
//
// Supported: float32 or bfloat16 za, zb (the same dtype), contiguous,
// 1 <= D <= kMaxWidth, int32 row ids. The C entry points return
// cudaGetLastError().

#include "infonce_cross_bwd.cuh"

// Floats of scratch one call takes: n_own = n_c (zb owns the outputs),
// n_other = n_r.
extern "C" long long ntx_infonce_bwd_cols_scratch(int n_own, int n_other,
                                                  int d, int dtype,
                                                  int splits) {
  return ntx::bwd_scratch_floats(n_own, n_other, d, dtype, splits);
}

// o_b (n_cols, d) fp32 = G^T . za. row_gid: n_rows int32 global ids
// (required); lse_a (n_rows,), lse_b (n_cols,) fp32; `scale` points to one
// fp32 on the device. dtype: 0 = float32, 1 = bfloat16. za's rows are cut
// into `splits` runs of `split_cols` (the last one shorter), each
// non-empty; `scratch` holds ntx_infonce_bwd_cols_scratch(n_cols, n_rows,
// d, dtype, splits) floats. Returns a cudaError_t (0 = success).
extern "C" int ntx_infonce_bwd_cols(const void* za, const void* zb,
                                    const void* row_gid, const void* scale,
                                    const void* lse_a, const void* lse_b,
                                    void* o_b, void* scratch, int n_rows,
                                    int n_cols, int d, int dtype, int splits,
                                    int split_cols, int device,
                                    void* stream) {
  return infonce_cross::run<true>(za, zb, row_gid, scale, lse_a, lse_b, o_b,
                                  scratch, n_rows, n_cols, d, dtype, splits,
                                  split_cols, device, stream);
}
