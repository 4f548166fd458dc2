// NT-Xent general backward for Hopper (sm_90a) on TF32 tensor cores, bound
// to PyTorch via ctypes: the rows kernel and the columns kernel.
//
// Replaces _bwd_general_call (ntxent_tpu/ops/ntxent_pallas.py:648), which
// is two Pallas TPU kernels: _bwd_rows_kernel (ntxent_pallas.py:552,
// pallas_call at :658) and _bwd_cols_kernel (:580, pallas_call at :679).
// For rows z_rows (R, D) with global ids row_gid, columns z_cols (C, D)
// with global ids col_gid (null: the column index), the forward's ROW
// logsumexp lse (R,) and the fp32 logit scale at `scale` on the device
// (null: 1), as those kernels do:
//   s[i, j]  = (z_rows_i . z_cols_j) * (inv_t * scale) in fp32, columns
//              whose id is >= cols_actual or, without diag_pos, equals the
//              row's id masked to -1e30;
//   P[i, j]  = exp(min(s[i, j] - lse[i], 0));
//   E[i, j]  = 1 iff the column's id is pos(row_gid_i) (_pos_gid: the
//              paired view, or the diagonal with diag_pos);
//   G[i, j]  = (P - E) * valid_row_i, valid_row_i = row_gid_i < cols_actual;
//   rows:  grad_rows = G @ z_cols     (R, D);
//   cols:  grad_cols = G^T @ z_rows   (C, D);
// both fp32 and before the caller's g / T (and scale) factor. Rows past R
// and columns past C do not exist (the TPU kernels' zero padding adds
// nothing).
//
// Design. Both kernels are instances of the backward walk of
// ntxent_tf32.cuh (bwd_walk, #5's): an operand-prep pass writes the TF32
// hi and lo of the side that owns the outputs ("own") and of the other
// side, which it also writes transposed (the K-major B of G . z); one CTA
// per (64-row tile of own, column split of other, chunk of D of at most
// 128) forms s by 3xTF32 wgmma from a TMA ring, G in the accumulator
// fragment, and adds G . z_other with G as the register A operand, each
// 64-column tile in a fresh accumulator added into a shared-memory sum;
// with more than one split a sum kernel adds the splits' partials in
// order. They differ in G only:
//   rows: own = z_rows, other = z_cols. s = z_r z_c^T; G = exp0(s -
//     lse_own) - E, zero on a row whose id is >= cols_actual (RowsG);
//   cols: own = z_cols, other = z_rows. The tile is s^T = z_c z_r^T; G^T
//     = exp0(s^T - lse_other) - E, the lse and the validity taken from the
//     other side, as #5 takes its column lse (ColsG).
// One owner per output, no atomics: repeatable bit for bit. The masks are
// -1e30, as in the TPU kernel.
//
// Bound, each kernel: 4 R C D operations (s and the product with G), each
// product three TF32 passes (165 TFLOP/s for fp32-accurate products),
// against (R + C) D inputs, R ids and lse, and an (R or C) x D fp32
// output. At the data-parallel ResNet-50 strip of a world of one at batch
// 256 (R = C = 512, D = 128): 134 MFLOP, 0.81 us; one rank of 4 at batch
// 4096 (R = 2048, C = 8192, D = 128): 52 us; the ring NT-Xent's P = 4 hop
// (2048, 2048, 128): 13 us; the two-pass InfoNCE of CLIP at batch 256 on
// one card (256, 256, 512): 0.81 us, one rank of 4 at batch 4096 (1024,
// 4096, 512): 52 us. At D = 512 the four chunks of D each form s again:
// 2.5 times the products of one pass.
//
// Supported: float32 or bfloat16 z_rows and z_cols (the same dtype),
// contiguous, 1 <= D <= kMaxWidth, int32 ids. The C entry points return
// cudaGetLastError().

#include "ntxent_tf32.cuh"

namespace {

using namespace ntx;

// G of the rows kernel: own = the rows (ids, lse, validity), other = the
// columns (ids only).
struct RowsG {
  GeneralIds ids;
  const float* __restrict__ lse;
  float inv_t;
  int n_own;
  int gid[2], pos_gid[2];
  float lse_r[2];
  int cid[16];  // entry 2i + e: column col0 + 8i + 2q + e

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      gid[h] = ids.row(row);
      pos_gid[h] = ids.positive(gid[h]);
      lse_r[h] = row < n_own ? lse[row] : 0.f;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * (j / 2) + 2 * q + j % 2;
      cid[j] = col < ce ? ids.col(col) : kNoColumn;
    }
  }
  __device__ __forceinline__ float g(float s, int i, int h, int col,
                                     bool live) const {
    const int id = cid[2 * (i / 4) + i % 2];
    const float x = masked(ids, id, gid[h]) ? kNegInf : s * inv_t;
    const float e = id == pos_gid[h] ? 1.f : 0.f;
    const float out = exp0(x - lse_r[h]) - e;
    return (!live || gid[h] >= ids.cols_actual()) ? 0.f : out;
  }
};

// G^T of the columns kernel: own = the columns (ids), other = the rows
// (ids, lse, validity).
struct ColsG {
  GeneralIds ids;
  const float* __restrict__ lse;
  float inv_t;
  int n_own;
  int cid[2];
  int rid[16];  // entry 2i + e: row col0 + 8i + 2q + e of the other side
  float lse_o[16];

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = r + 8 * h;
      cid[h] = col < n_own ? ids.col(col) : kNoColumn;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int row = col0 + 8 * (j / 2) + 2 * q + j % 2;
      const bool live = row < ce;
      rid[j] = live ? ids.row(row) : ids.cols_actual();
      lse_o[j] = live ? lse[row] : 0.f;
    }
  }
  __device__ __forceinline__ float g(float s, int i, int h, int col,
                                     bool live) const {
    const int j = 2 * (i / 4) + i % 2;
    const int gid = rid[j];
    const float x = masked(ids, cid[h], gid) ? kNegInf : s * inv_t;
    const float e = cid[h] == ids.positive(gid) ? 1.f : 0.f;
    const float out = exp0(x - lse_o[j]) - e;
    return (!live || gid >= ids.cols_actual()) ? 0.f : out;
  }
};

// The kernels of each side carry its name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_bwd_general_rows_prep(const T* __restrict__ z, int n, int d,
                                 float* __restrict__ hi,
                                 float* __restrict__ lo,
                                 float* __restrict__ hi_t,
                                 float* __restrict__ lo_t) {
  prep_tile<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t);
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_bwd_general_cols_prep(const T* __restrict__ z, int n, int d,
                                 float* __restrict__ hi,
                                 float* __restrict__ lo,
                                 float* __restrict__ hi_t,
                                 float* __restrict__ lo_t) {
  prep_tile<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t);
}

// What both walks take besides the maps and the layout.
struct Args {
  GeneralIds ids;
  const float* lse;
  const float* scale;
  float inv_t;
};

template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_bwd_general_rows_walk(
        const __grid_constant__ CUtensorMap own_h,
        const __grid_constant__ CUtensorMap own_l,
        const __grid_constant__ CUtensorMap oth_h,
        const __grid_constant__ CUtensorMap oth_l,
        const __grid_constant__ CUtensorMap oth_ht,
        const __grid_constant__ CUtensorMap oth_lt, Args a,
        float* __restrict__ out, Plan p, int n_own, int n_other, int d,
        int split_cols) {
  RowsG g{a.ids, a.lse, scaled_inv_t(a.inv_t, a.scale), n_own};
  bwd_walk<kSplit, ND>(&own_h, &own_l, &oth_h, &oth_l, &oth_ht, &oth_lt, g,
                       out, p, n_own, n_other, d, split_cols);
}

template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_bwd_general_cols_walk(
        const __grid_constant__ CUtensorMap own_h,
        const __grid_constant__ CUtensorMap own_l,
        const __grid_constant__ CUtensorMap oth_h,
        const __grid_constant__ CUtensorMap oth_l,
        const __grid_constant__ CUtensorMap oth_ht,
        const __grid_constant__ CUtensorMap oth_lt, Args a,
        float* __restrict__ out, Plan p, int n_own, int n_other, int d,
        int split_cols) {
  ColsG g{a.ids, a.lse, scaled_inv_t(a.inv_t, a.scale), n_own};
  bwd_walk<kSplit, ND>(&own_h, &own_l, &oth_h, &oth_l, &oth_ht, &oth_lt, g,
                       out, p, n_own, n_other, d, split_cols);
}

__global__ void ntxent_bwd_general_rows_sum(const float* __restrict__ part,
                                            float* __restrict__ grad,
                                            size_t count, int splits) {
  split_sum(part, grad, count, splits);
}

__global__ void ntxent_bwd_general_cols_sum(const float* __restrict__ part,
                                            float* __restrict__ grad,
                                            size_t count, int splits) {
  split_sum(part, grad, count, splits);
}

struct Call {
  const void* own;
  const void* other;
  Args args;
  float* grad;
  int n_own, n_other, d, splits, split_cols;
};

template <typename T, int ND, bool kCols>
cudaError_t launch(const Call& a, const BwdBuffers& b, cudaStream_t s) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  auto prep = kCols ? ntxent_bwd_general_cols_prep<T, kSplit>
                    : ntxent_bwd_general_rows_prep<T, kSplit>;
  auto walk = kCols ? ntxent_bwd_general_cols_walk<kSplit, ND>
                    : ntxent_bwd_general_rows_walk<kSplit, ND>;
  auto sum = kCols ? ntxent_bwd_general_cols_sum
                   : ntxent_bwd_general_rows_sum;
  return bwd_launch<T, ND>(a.own, a.other, a.n_own, a.n_other, a.d, a.splits,
                           a.split_cols, a.grad, b, prep, walk, sum, a.args,
                           s);
}

template <typename T, bool kCols>
cudaError_t dispatch(const Call& a, const BwdBuffers& b, cudaStream_t s) {
  switch (d_chunk(a.d)) {
    case 32:
      return launch<T, 32, kCols>(a, b, s);
    case 64:
      return launch<T, 64, kCols>(a, b, s);
    default:
      return launch<T, 128, kCols>(a, b, s);
  }
}

template <bool kCols>
cudaError_t run(const void* z_rows, const void* z_cols, const void* row_gid,
                const void* col_gid, const void* lse, const void* scale,
                void* grad, void* scratch, int n_rows, int n_cols, int d,
                int dtype, float inv_t, int cols_actual, int n_half,
                int diag_pos, int splits, int split_cols, int device,
                void* stream) {
  const int n_own = kCols ? n_cols : n_rows;
  const int n_other = kCols ? n_rows : n_cols;
  if (row_gid == nullptr || n_rows < 1 || n_cols < 1 ||
      !width_ok(d) || !splits_cover(n_other, splits, split_cols) ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const GeneralIds ids{static_cast<const int*>(row_gid),
                       static_cast<const int*>(col_gid), n_rows, cols_actual,
                       n_half, diag_pos};
  const Call a{kCols ? z_cols : z_rows, kCols ? z_rows : z_cols,
               Args{ids, static_cast<const float*>(lse),
                    static_cast<const float*>(scale), inv_t},
               static_cast<float*>(grad), n_own, n_other, d, splits,
               split_cols};
  Carver c{static_cast<float*>(scratch)};
  const BwdBuffers b = bwd_carve(c, n_own, n_other, d, dtype == 0, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, kCols>(a, b, s);
  return dispatch<__nv_bfloat16, kCols>(a, b, s);
}

}  // namespace

// Floats of scratch one call takes: n_own rows own the outputs (R for the
// rows kernel, C for the columns kernel), n_other the other side.
extern "C" long long ntx_ntxent_bwd_general_scratch(int n_own, int n_other,
                                                    int d, int dtype,
                                                    int splits) {
  return bwd_scratch_floats(n_own, n_other, d, dtype, splits);
}

// grad_rows (n_rows, d) fp32 = G @ z_cols. row_gid (int32) is required,
// col_gid (int32) may be null, scale (fp32, on the device) may be null.
// dtype: 0 = float32, 1 = bfloat16. The columns are cut into `splits`
// runs of `split_cols` (the last one shorter), each non-empty. `scratch`
// holds ntx_ntxent_bwd_general_scratch(n_rows, n_cols, d, dtype, splits)
// floats.
extern "C" int ntx_ntxent_bwd_general_rows(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* lse, const void* scale, void* grad_rows,
    void* scratch, int n_rows, int n_cols, int d, int dtype, float inv_t,
    int cols_actual, int n_half, int diag_pos, int splits, int split_cols,
    int device, void* stream) {
  return run<false>(z_rows, z_cols, row_gid, col_gid, lse, scale, grad_rows,
                    scratch, n_rows, n_cols, d, dtype, inv_t, cols_actual,
                    n_half, diag_pos, splits, split_cols, device, stream);
}

// grad_cols (n_cols, d) fp32 = G^T @ z_rows, from the row lse only. The
// rows are cut into `splits` runs of `split_cols`; `scratch` holds
// ntx_ntxent_bwd_general_scratch(n_cols, n_rows, d, dtype, splits) floats.
extern "C" int ntx_ntxent_bwd_general_cols(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* lse, const void* scale, void* grad_cols,
    void* scratch, int n_rows, int n_cols, int d, int dtype, float inv_t,
    int cols_actual, int n_half, int diag_pos, int splits, int split_cols,
    int device, void* stream) {
  return run<true>(z_rows, z_cols, row_gid, col_gid, lse, scale, grad_cols,
                   scratch, n_rows, n_cols, d, dtype, inv_t, cols_actual,
                   n_half, diag_pos, splits, split_cols, device, stream);
}
