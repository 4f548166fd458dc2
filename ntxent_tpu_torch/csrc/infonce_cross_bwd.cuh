// The CLIP backward on the TF32 walk of ntxent_tf32.cuh: the data-parallel
// rows kernel (#5's cross-modal mode, csrc/infonce_dual_bwd.cu) and
// columns kernel (#4, csrc/infonce_bwd_cols.cu), each launching its own
// side, and the square #10 (csrc/infonce_dual_bwd.cu), both sides in one
// grid with the ids 0 .. N - 1 (a null row_gid).
//
// For one rank's rows za (n_r, D) with global ids row_gid, the gathered
// zb (n_c, D), the row lse lse_a (n_r,), the merged global column lse
// lse_b (n_c,) and the logit scale at `scale` (one fp32 on the device):
//   s[i, j] = (za_i . zb_j) * scale;
//   G[i, j] = (exp0(s - lse_a[i]) - pos) * valid_row_i + (exp0(s - lse_b[j]) - pos),
//   pos = 1 iff j = row_gid[i], valid_row_i = row_gid[i] < n_c;
//   rows:     o_a = G . zb     (n_r, D) fp32;
//   columns:  o_b = G^T . za   (n_c, D) fp32.
// valid_row multiplies the row term only: a padding row (id = n_c) exists
// and adds its column term to o_a and, through its za, to o_b. Rows past
// n_r and columns past n_c do not exist and add nothing.
//
// Both kernels are instances of bwd_walk, as #6's are: an operand-prep
// pass writes the TF32 hi and lo of the side that owns the outputs
// ("own") and of the other side, which it also writes transposed; one CTA
// per (64-row tile of own, split of the other side, chunk of D) forms s
// by wgmma from a TMA ring (3xTF32 for fp32 inputs, two products for bf16,
// whose lo is 0), G in the accumulator fragment from the policy below, and
// adds G . z_other with G as the register A operand, a fresh accumulator
// per 64-column tile added into a shared-memory sum; with more than one
// split a sum kernel adds the splits' partials in split order. One owner
// per output, no atomics: repeatable bit for bit. The cross-modal mode
// masks nothing (every column id is below n_c) and has 1/T = 1: the scale
// is read once a thread from the device.
//
// Kernel names carry the side (infonce_bwd_rows_*, infonce_bwd_cols_*):
// the profiler groups by them.

#pragma once

#include "ntxent_tf32.cuh"

namespace infonce_cross {

using namespace ntx;

// What both walks take besides the maps and the layout.
struct Inputs {
  const int* __restrict__ row_gid;  // (n_r,); null: the row index (#10)
  const float* __restrict__ lse_a;  // (n_r,)
  const float* __restrict__ lse_b;  // (n_c,)
  const float* __restrict__ scale;  // one fp32 on the device
  int n_r, n_c;

  __device__ __forceinline__ int id(int row) const {
    return row_gid != nullptr ? row_gid[row] : row;
  }
};

// G of the rows kernel: own = za's rows (ids, lse_a, validity), other =
// zb's columns (lse_b).
struct CrossRowsG {
  Inputs in;
  float logit_scale;  // *in.scale, read once
  int gid[2];
  float lse_r[2], valid[2];
  bool real[2];
  float lse_c[16];  // entry 2i + e: column col0 + 8i + 2q + e

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      real[h] = row < in.n_r;
      gid[h] = real[h] ? in.id(row) : -1;
      lse_r[h] = real[h] ? in.lse_a[row] : 0.f;
      valid[h] = gid[h] < in.n_c ? 1.f : 0.f;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * (j / 2) + 2 * q + j % 2;
      lse_c[j] = col < ce ? in.lse_b[col] : 0.f;
    }
  }
  __device__ __forceinline__ float g(float s, int i, int h, int col,
                                     bool live) const {
    const float x = s * logit_scale;
    const float pos = col == gid[h] ? 1.f : 0.f;
    const float out = (exp0(x - lse_r[h]) - pos) * valid[h] +
                      (exp0(x - lse_c[2 * (i / 4) + i % 2]) - pos);
    return (!live || !real[h]) ? 0.f : out;
  }
};

// G^T of the columns kernel: own = zb's columns (lse_b), other = za's
// rows, whose ids and lse_a come in per tile.
struct CrossColsG {
  Inputs in;
  float logit_scale;  // *in.scale, read once
  int col[2];
  float lse_c[2];
  int rid[16];  // entry 2i + e: row col0 + 8i + 2q + e of za
  float lse_o[16];

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      col[h] = r + 8 * h;
      lse_c[h] = col[h] < in.n_c ? in.lse_b[col[h]] : 0.f;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int row = col0 + 8 * (j / 2) + 2 * q + j % 2;
      const bool live = row < ce;
      rid[j] = live ? in.id(row) : -1;
      lse_o[j] = live ? in.lse_a[row] : 0.f;
    }
  }
  __device__ __forceinline__ float g(float s, int i, int h, int row,
                                     bool live) const {
    const int j = 2 * (i / 4) + i % 2;
    const float x = s * logit_scale;
    const float pos = rid[j] == col[h] ? 1.f : 0.f;
    const float valid = rid[j] < in.n_c ? 1.f : 0.f;
    const float out = (exp0(x - lse_o[j]) - pos) * valid +
                      (exp0(x - lse_c[h]) - pos);
    return (!live || col[h] >= in.n_c) ? 0.f : out;
  }
};

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    infonce_bwd_rows_prep(const T* __restrict__ z, int n, int d,
                          float* __restrict__ hi, float* __restrict__ lo,
                          float* __restrict__ hi_t,
                          float* __restrict__ lo_t) {
  prep_tile<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t);
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    infonce_bwd_cols_prep(const T* __restrict__ z, int n, int d,
                          float* __restrict__ hi, float* __restrict__ lo,
                          float* __restrict__ hi_t,
                          float* __restrict__ lo_t) {
  prep_tile<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t);
}

template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    infonce_bwd_rows_walk(const __grid_constant__ CUtensorMap own_h,
                          const __grid_constant__ CUtensorMap own_l,
                          const __grid_constant__ CUtensorMap oth_h,
                          const __grid_constant__ CUtensorMap oth_l,
                          const __grid_constant__ CUtensorMap oth_ht,
                          const __grid_constant__ CUtensorMap oth_lt,
                          Inputs in, float* __restrict__ out, Plan p,
                          int n_own, int n_other, int d, int split_cols) {
  CrossRowsG g{in, scaled_inv_t(1.f, in.scale)};
  bwd_walk<kSplit, ND>(&own_h, &own_l, &oth_h, &oth_l, &oth_ht, &oth_lt, g,
                       out, p, n_own, n_other, d, split_cols);
}

template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    infonce_bwd_cols_walk(const __grid_constant__ CUtensorMap own_h,
                          const __grid_constant__ CUtensorMap own_l,
                          const __grid_constant__ CUtensorMap oth_h,
                          const __grid_constant__ CUtensorMap oth_l,
                          const __grid_constant__ CUtensorMap oth_ht,
                          const __grid_constant__ CUtensorMap oth_lt,
                          Inputs in, float* __restrict__ out, Plan p,
                          int n_own, int n_other, int d, int split_cols) {
  CrossColsG g{in, scaled_inv_t(1.f, in.scale)};
  bwd_walk<kSplit, ND>(&own_h, &own_l, &oth_h, &oth_l, &oth_ht, &oth_lt, g,
                       out, p, n_own, n_other, d, split_cols);
}

__global__ void infonce_bwd_rows_sum(const float* __restrict__ part,
                                     float* __restrict__ grad, size_t count,
                                     int splits) {
  split_sum(part, grad, count, splits);
}

__global__ void infonce_bwd_cols_sum(const float* __restrict__ part,
                                     float* __restrict__ grad, size_t count,
                                     int splits) {
  split_sum(part, grad, count, splits);
}

struct Call {
  const void* own;
  const void* other;
  Inputs in;
  float* grad;
  int n_own, n_other, d, splits, split_cols;
};

// One side's kernels at one input type and chunk of D: a source
// instantiates the prep and walk templates of the side it launches only.
template <typename T, int ND, bool kCols>
cudaError_t launch(const Call& a, const BwdBuffers& b, cudaStream_t s) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  if constexpr (kCols) {
    return bwd_launch<T, ND>(a.own, a.other, a.n_own, a.n_other, a.d,
                             a.splits, a.split_cols, a.grad, b,
                             infonce_bwd_cols_prep<T, kSplit>,
                             infonce_bwd_cols_walk<kSplit, ND>,
                             infonce_bwd_cols_sum, a.in, s);
  } else {
    return bwd_launch<T, ND>(a.own, a.other, a.n_own, a.n_other, a.d,
                             a.splits, a.split_cols, a.grad, b,
                             infonce_bwd_rows_prep<T, kSplit>,
                             infonce_bwd_rows_walk<kSplit, ND>,
                             infonce_bwd_rows_sum, a.in, s);
  }
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

// One side's launch from the entry point's arguments: the other side (zb's
// columns for the rows kernel, za's rows for the columns kernel) cut into
// `splits` runs of `split_cols`, the last one shorter, each non-empty.
template <bool kCols>
cudaError_t run(const void* za, const void* zb, const void* row_gid,
                const void* scale, const void* lse_a, const void* lse_b,
                void* grad, void* scratch, int n_r, int n_c, int d,
                int dtype, int splits, int split_cols, int device,
                void* stream) {
  const int n_own = kCols ? n_c : n_r;
  const int n_other = kCols ? n_r : n_c;
  if (row_gid == nullptr || scale == nullptr || n_r < 1 || n_c < 1 ||
      !width_ok(d) || !splits_cover(n_other, splits, split_cols) ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Inputs in{static_cast<const int*>(row_gid),
                  static_cast<const float*>(lse_a),
                  static_cast<const float*>(lse_b),
                  static_cast<const float*>(scale), n_r, n_c};
  const Call a{kCols ? zb : za, kCols ? za : zb, in,
               static_cast<float*>(grad), n_own, n_other, d, splits,
               split_cols};
  Carver c{static_cast<float*>(scratch)};
  const BwdBuffers b = bwd_carve(c, n_own, n_other, d, dtype == 0, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, kCols>(a, b, s);
  return dispatch<__nv_bfloat16, kCols>(a, b, s);
}

}  // namespace infonce_cross
