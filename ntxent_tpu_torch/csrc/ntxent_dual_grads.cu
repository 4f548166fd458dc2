// NT-Xent dual gradients of one shard-pair tile for Hopper (sm_90a) on
// TF32 tensor cores, bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _dual_grads_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:1159, launched by block_grads_dual at
// :1213, pallas_call at :1253), the backward of the pair-parallel NT-Xent
// (--dp-loss pair, ntxent_tpu/parallel/pair.py:146). For rows z_rows (R, D)
// and columns z_cols (C, D) with global ids (the sentinel `total` on
// padding) and the GLOBAL logsumexp of each side, lse_rows (R,) and
// lse_cols (C,):
//   s[i, j]  = (z_rows_i . z_cols_j) * inv_t in fp32;
//   G[i, j]  = exp(min(s_row - lse_rows[i], 0)) * valid_row_i
//            + exp(min(s_col - lse_cols[j], 0)) * valid_col_j,
//   s_row masked to -1e30 where the column id is >= total or equals the
//   row id, s_col where the row id is >= total or equals the column id,
//   valid_* = id < total; no positive term (the caller differentiates the
//   positives locally);
//   grad_rows = G @ z_cols (R, D), grad_cols = G^T @ z_rows (C, D), fp32,
//   before the caller's cotangent / T scale.
//
// Design. The TPU kernel computes G once per tile and accumulates G^T z_r
// in full-length column scratch carried across its sequential grid. Here
// each output vector has one owner and there are no atomics, so each side
// forms s for itself (8 R C D operations against the TPU kernel's 6 R C
// D): the backward of both sides in one grid of dual_tf32.cuh (#10's),
// three launches:
//   prep  TF32 hi and lo of z_rows and z_cols and both transposes (the
//         K-major B of grad = G . z, each 8-column group in the order 0, 2,
//         4, 6, 1, 3, 5, 7), one launch (PrepPair);
//   walk  the row owners (own = z_rows, other = z_cols) and the column
//         owners (own = z_cols, other = z_rows) in one grid, each a
//         bwd_walk_at over (64-row tile of its own side, split of the other
//         side, chunk of D of at most 128): s by 3xTF32 wgmma (two
//         products for bf16) from a TMA ring, G in the accumulator
//         fragment from PairG, and G . z_other with G as the register A
//         operand, a fresh accumulator per 64-column tile added into a
//         shared-memory sum. G is symmetric in its two terms, so one
//         policy serves both sides: the column owners form G^T with the
//         operands and the ids swapped. Each side's split plan is
//         ops/ntxent.py's general_bwd_splits at half the SMs;
//   sum   with more than one split on a side, its partials added in split
//         order (with one, the walk writes the gradient itself).
// Repeatable bit for bit. At D = 128 one chunk of D: s is formed once a
// side.
//
// Bound: 6 R C D operations (the TPU kernel's work: s once, two products
// with G), each product three TF32 passes in fp32 (165 TFLOP/s), against
// (R + C) D inputs, (R + C) ids and lse, (R + C) D fp32 outputs. At the
// self tile of a 1-card world at batch 256 (R = C = 512, D = 128): 201
// MFLOP, 1.2 us, 2 x 8 row tiles x 8 splits, 128 CTAs: latency-bound. One
// rank of 4 at global batch 4096 (R = C = 2048): 3.2 GFLOP, 19.5 us.
//
// Supported: float32 or bfloat16 z_rows and z_cols (the same dtype),
// contiguous, R, C >= 1, 1 <= D <= kMaxWidth, int32 ids. The C entry point
// returns cudaGetLastError().

#include "dual_tf32.cuh"

namespace {

using namespace ntx;

// What both sides take besides the maps and the layout.
struct PairInputs {
  const int* __restrict__ row_gid;
  const int* __restrict__ col_gid;
  const float* __restrict__ lse_rows;
  const float* __restrict__ lse_cols;
  float inv_t;
  int total;
};

// G of one side: own = the side that owns the outputs (ids, lse), other =
// the other side (ids and lse of the tile's columns).
struct PairG {
  const int* __restrict__ own_id;
  const int* __restrict__ oth_id;
  const float* __restrict__ own_lse;
  const float* __restrict__ oth_lse;
  float inv_t;
  int total, n_own;
  int id[2];
  float lse[2];
  bool real[2];
  int oid[16];  // entry 2i + e: column col0 + 8i + 2q + e of the other side
  float olse[16];

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      real[h] = row < n_own;
      id[h] = real[h] ? own_id[row] : total;
      lse[h] = real[h] ? own_lse[row] : 0.f;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * (j / 2) + 2 * q + j % 2;
      const bool live = col < ce;
      oid[j] = live ? oth_id[col] : kNoColumn;
      olse[j] = live ? oth_lse[col] : 0.f;
    }
  }
  // exp0(x_own - lse_own) valid_own + exp0(x_oth - lse_oth) valid_oth:
  // x_own masked where the other id is >= total or equals the own id,
  // x_oth where the own id is >= total or equals the other id.
  __device__ __forceinline__ float g(float s, int i, int h, int col,
                                     bool live) const {
    const int j = 2 * (i / 4) + i % 2;
    const int o = oid[j];
    const float x = s * inv_t;
    const float x_own = (o >= total || o == id[h]) ? kNegInf : x;
    const float x_oth = (id[h] >= total || id[h] == o) ? kNegInf : x;
    const float out = exp0(x_own - lse[h]) * (id[h] < total ? 1.f : 0.f) +
                      exp0(x_oth - olse[j]) * (o < total ? 1.f : 0.f);
    return (!live || !real[h]) ? 0.f : out;
  }
};

// The kernels carry the wrapper's name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_dual_grads_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

// Both sides in one grid (dual_tf32.cuh): side a the row owners (own =
// z_rows, grad_rows = G . z_cols), side b the column owners (own = z_cols,
// grad_cols = G^T . z_rows). blockIdx.y: the chunk of D.
template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_dual_grads_walk(const __grid_constant__ BwdMaps rows,
                           const __grid_constant__ BwdMaps cols,
                           PairInputs in, float* __restrict__ out_r,
                           float* __restrict__ out_c, Plan p,
                           DualGrid grid) {
  const DualCta c = dual_cta(grid);
  if (!c.b) {
    PairG g{in.row_gid, in.col_gid, in.lse_rows, in.lse_cols,
            in.inv_t,   in.total,   grid.n_a};
    bwd_walk_at<kSplit, ND>(&rows.own_h, &rows.own_l, &rows.oth_h,
                            &rows.oth_l, &rows.oth_ht, &rows.oth_lt, g,
                            out_r, p, grid.n_a, grid.n_b, grid.d,
                            grid.split_cols_a, c.tile, c.split, blockIdx.y);
  } else {
    PairG g{in.col_gid, in.row_gid, in.lse_cols, in.lse_rows,
            in.inv_t,   in.total,   grid.n_b};
    bwd_walk_at<kSplit, ND>(&cols.own_h, &cols.own_l, &cols.oth_h,
                            &cols.oth_l, &cols.oth_ht, &cols.oth_lt, g,
                            out_c, p, grid.n_b, grid.n_a, grid.d,
                            grid.split_cols_b, c.tile, c.split, blockIdx.y);
  }
}

// Each entry of grad_rows, then of grad_cols: the splits' partials added
// in order.
__global__ void ntxent_dual_grads_sum(const float* __restrict__ part_r,
                                      const float* __restrict__ part_c,
                                      float* __restrict__ grad_r,
                                      float* __restrict__ grad_c,
                                      DualGrid grid) {
  dual_sum(part_r, part_c, grad_r, grad_c, grid);
}

struct Call {
  const void *z_rows, *z_cols;
  PairInputs in;
  float *grad_rows, *grad_cols;
  DualGrid g;
};

template <typename T, int ND>
cudaError_t launch(const Call& a, const DualBwdBuffers& b,
                   cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  return dual_bwd_launch<T, ND>(a.z_rows, a.z_cols, a.g, a.grad_rows,
                                a.grad_cols, b,
                                ntxent_dual_grads_prep<T, kSplit>,
                                ntxent_dual_grads_walk<kSplit, ND>,
                                ntxent_dual_grads_sum, a.in, stream);
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

// Floats of scratch one call takes (dtype 0: fp32, with lo copies):
// splits_r splits of the row owners' other side (the columns), splits_c of
// the column owners' (the rows).
extern "C" long long ntx_ntxent_dual_grads_scratch(int n_rows, int n_cols,
                                                   int d, int dtype,
                                                   int splits_r,
                                                   int splits_c) {
  Carver c{nullptr};
  dual_bwd_carve(c, n_rows, n_cols, d, dtype == 0, splits_r, splits_c);
  return static_cast<long long>(c.used);
}

// grad_rows (n_rows, d) and grad_cols (n_cols, d) fp32 of one tile;
// row_gid and col_gid int32, both required; lse_rows (n_rows,) and
// lse_cols (n_cols,) fp32. dtype: 0 = float32, 1 = bfloat16. The row
// owners cut z_cols's rows into `splits_r` runs of `split_cols_r`, the
// column owners z_rows's into `splits_c` runs of `split_cols_c` (the last
// run shorter, each non-empty); `scratch` holds
// ntx_ntxent_dual_grads_scratch(n_rows, n_cols, d, dtype, splits_r,
// splits_c) floats.
extern "C" int ntx_ntxent_dual_grads(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* lse_rows, const void* lse_cols,
    void* grad_rows, void* grad_cols, void* scratch, int n_rows, int n_cols,
    int d, int dtype, float inv_t, int total, int splits_r,
    int split_cols_r, int splits_c, int split_cols_c, int device,
    void* stream) {
  if (n_rows < 1 || n_cols < 1 || !width_ok(d) || !row_gid ||
      !col_gid || !splits_cover(n_cols, splits_r, split_cols_r) ||
      !splits_cover(n_rows, splits_c, split_cols_c) ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const PairInputs in{static_cast<const int*>(row_gid),
                      static_cast<const int*>(col_gid),
                      static_cast<const float*>(lse_rows),
                      static_cast<const float*>(lse_cols),
                      inv_t,
                      total};
  const Call a{z_rows, z_cols, in, static_cast<float*>(grad_rows),
               static_cast<float*>(grad_cols),
               dual_grid(n_rows, n_cols, d, splits_r, split_cols_r, splits_c,
                         split_cols_c)};
  Carver c{static_cast<float*>(scratch)};
  const DualBwdBuffers b =
      dual_bwd_carve(c, n_rows, n_cols, d, dtype == 0, splits_r, splits_c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, s);
  return dispatch<__nv_bfloat16>(a, b, s);
}
