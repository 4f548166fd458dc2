// Cross-modal InfoNCE (CLIP) backward for Hopper (sm_90a) on TF32 tensor
// cores, bound to PyTorch via ctypes: the square backward (#10) and the
// data-parallel rows kernel (#5's cross-modal mode).
//
// Square (ntx_infonce_dual_bwd). Replaces the Pallas TPU kernel
// ntxent_tpu/ops/infonce_pallas.py:204 (_dual_bwd_kernel, launched by
// _dual_bwd_call at infonce_pallas.py:266, pallas_call :274) as
// _infonce_bwd runs it. From za, zb (N, D), the logit scale (a device
// scalar) and the forward's lse_a, lse_b it computes, as that kernel does,
//   s[i, j] = (za_i . zb_j) * scale in fp32;
//   G[i, j] = (exp(min(s - lse_a[i], 0)) - I) + (exp(min(s - lse_b[j], 0)) - I)
//             (the total dL/ds before the caller's g / 2N; the diagonal I
//             is the positive and is not masked);
//   o_a = G . zb,  o_b = G^T . za   (fp32, (N, D) each).
// Every id is below N, so the TPU kernel's valid_row and valid_col are 1
// and this G is the G of the data-parallel pair below with the ids 0 ..
// N - 1: o_a is the rows walk (CrossRowsG), o_b the columns walk
// (CrossColsG) of infonce_cross_bwd.cuh. (The TPU kernel shares one G per
// tile between G . zb and G^T . za; with one owner per output and no
// atomics, a CTA that owns rows of o_a cannot also own o_b's, so each side
// forms s again: 8 N^2 D operations against the TPU kernel's 6 N^2 D.)
//
// Design (dual_bwd_launch of dual_tf32.cuh, which #8 shares). Three
// launches: one operand prep writes za's and zb's TF32 hi and lo and their
// transposes (PrepPair); one walk launch covers both sides, its leading
// CTAs taking the rows policy and the rest the columns policy, each a
// bwd_walk_at over (64-row tile of its own side, split of the
// other side, chunk of D of at most 128): s by 3xTF32 wgmma (two products
// for bf16) from a TMA ring, G in the accumulator fragment, and G . z_other
// with G as the register A operand, a fresh accumulator per 64-column tile
// added into a shared-memory sum; and, with more than one split, one sum
// kernel adds the splits of both outputs in split order. Both sides take
// the plan of ops/ntxent.py's general_bwd_splits at half the SMs each, so
// the grid stays near one wave. Repeatable bit for bit.
//
// Bound at the training shape (N = 256, D = 512, fp32): 6 N^2 D = 201
// MFLOP (the TPU kernel's work), 1.2 us at the 165 TFLOP/s of
// fp32-accurate products (3xTF32 on the tensor cores); za, zb, lse and the
// two outputs are 2 MB, 0.63 us at 3.35 TB/s. N = 8192: 206 GFLOP, 1.25
// ms. At D = 512 each of the four chunks of D forms s again.
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
// chunk of D of at most 128), G with lse_b loaded per tile (CrossRowsG); a
// sum kernel adds the splits in order. The column side is
// csrc/infonce_bwd_cols.cu. Bound, fp32: 4 n_r n_c D operations against
// (n_r + n_c) D inputs, the ids and both lse and an (n_r, D) output. World
// 1 at batch 256 (256, 256, 512): 134 MFLOP, 0.81 us; one rank of 4 at
// global batch 256 (64, 256, 512): 0.24 us by bytes (0.79 MB at 3.35
// TB/s); at global batch 4096 (1024, 4096, 512): 8.6 GFLOP, 52 us.
//
// Supported: float32 or bfloat16 za, zb (the same dtype), contiguous,
// 1 <= D <= kMaxWidth; the square kernel takes (N, D) each, the rows
// kernel (n_r, D) and (n_c, D) with int32 row ids. The C entry points return
// cudaGetLastError().

#include "dual_tf32.cuh"
#include "infonce_cross_bwd.cuh"

namespace {

using namespace ntx;
using infonce_cross::CrossColsG;
using infonce_cross::CrossRowsG;
using infonce_cross::Inputs;

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    infonce_dual_bwd_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

// Both sides in one grid (dual_tf32.cuh): side a the rows side (own = za,
// o_a = G . zb), side b the columns side (own = zb, o_b = G^T . za).
// blockIdx.y: the chunk of D.
template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    infonce_dual_bwd_walk(const __grid_constant__ BwdMaps rows,
                          const __grid_constant__ BwdMaps cols, Inputs in,
                          float* __restrict__ out_a,
                          float* __restrict__ out_b, Plan p, DualGrid grid) {
  const DualCta c = dual_cta(grid);
  const float logit_scale = scaled_inv_t(1.f, in.scale);
  if (!c.b) {
    CrossRowsG g{in, logit_scale};
    bwd_walk_at<kSplit, ND>(&rows.own_h, &rows.own_l, &rows.oth_h,
                            &rows.oth_l, &rows.oth_ht, &rows.oth_lt, g,
                            out_a, p, grid.n_a, grid.n_b, grid.d,
                            grid.split_cols_a, c.tile, c.split, blockIdx.y);
  } else {
    CrossColsG g{in, logit_scale};
    bwd_walk_at<kSplit, ND>(&cols.own_h, &cols.own_l, &cols.oth_h,
                            &cols.oth_l, &cols.oth_ht, &cols.oth_lt, g,
                            out_b, p, grid.n_b, grid.n_a, grid.d,
                            grid.split_cols_b, c.tile, c.split, blockIdx.y);
  }
}

// Each entry of o_a, then of o_b: the splits' partials added in order.
__global__ void infonce_dual_bwd_sum(const float* __restrict__ part_a,
                                     const float* __restrict__ part_b,
                                     float* __restrict__ o_a,
                                     float* __restrict__ o_b, DualGrid g) {
  dual_sum(part_a, part_b, o_a, o_b, g);
}

struct Call {
  const void *za, *zb;
  Inputs in;
  float *o_a, *o_b;
  DualGrid g;
};

template <typename T, int ND>
cudaError_t launch(const Call& a, const DualBwdBuffers& b,
                   cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  return dual_bwd_launch<T, ND>(a.za, a.zb, a.g, a.o_a, a.o_b, b,
                                infonce_dual_bwd_prep<T, kSplit>,
                                infonce_dual_bwd_walk<kSplit, ND>,
                                infonce_dual_bwd_sum, a.in, stream);
}

template <typename T>
cudaError_t dispatch(const Call& a, const DualBwdBuffers& b,
                     cudaStream_t s) {
  switch (d_chunk(a.g.d)) {
    case 32:
      return launch<T, 32>(a, b, s);
    case 64:
      return launch<T, 64>(a, b, s);
    default:
      return launch<T, 128>(a, b, s);
  }
}

}  // namespace

// Floats of scratch one square call takes (dtype 0: fp32, with lo copies).
extern "C" long long ntx_infonce_dual_bwd_scratch(int n, int d, int dtype,
                                                  int splits) {
  Carver c{nullptr};
  dual_bwd_carve(c, n, n, d, dtype == 0, splits, splits);
  return static_cast<long long>(c.used);
}

// The square backward: o_a, o_b (n, d) fp32 of za, zb (n, d), lse_a and
// lse_b (n,) fp32. dtype: 0 = float32, 1 = bfloat16. `scale` points to
// one fp32 on the device. The other side of each is cut into `splits`
// runs of `split_cols` (the last one shorter), each non-empty; `scratch`
// holds ntx_infonce_dual_bwd_scratch(n, d, dtype, splits) floats. Returns
// a cudaError_t (0 = success).
extern "C" int ntx_infonce_dual_bwd(const void* za, const void* zb,
                                    const void* scale, const void* lse_a,
                                    const void* lse_b, void* o_a, void* o_b,
                                    void* scratch, int n, int d, int dtype,
                                    int splits, int split_cols, int device,
                                    void* stream) {
  if (scale == nullptr || n < 1 || !width_ok(d) ||
      !splits_cover(n, splits, split_cols) || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Inputs in{nullptr, static_cast<const float*>(lse_a),
                  static_cast<const float*>(lse_b),
                  static_cast<const float*>(scale), n, n};
  const Call a{za, zb, in, static_cast<float*>(o_a), static_cast<float*>(o_b),
               dual_grid(n, n, d, splits, split_cols, splits, split_cols)};
  Carver c{static_cast<float*>(scratch)};
  const DualBwdBuffers b =
      dual_bwd_carve(c, n, n, d, dtype == 0, splits, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, s);
  return dispatch<__nv_bfloat16>(a, b, s);
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
