// NT-Xent forward for Hopper (sm_90a) on TF32 tensor cores, bound to
// PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:130
// (_fwd_kernel, launched by _fwd_call at ntxent_pallas.py:190) in both of
// its modes:
//   * symmetric (ntx_ntxent_fwd): rows and columns are the same stacked
//     views z (2N, D), the row and column ids their indices (the path of
//     ntxent_loss_fused);
//   * general (ntx_ntxent_fwd_general): rows z_rows (R, D) with global ids
//     row_gid, columns z_cols (C, D) with global ids col_gid, or their
//     indices when col_gid is null (the path of ntxent_partial_fused, the
//     data-parallel strip loss, and of block_lse, the ring's fold), in
//     the NT-Xent mode or, with diag_pos, the InfoNCE mode of
//     info_nce_partial_fused (the two-pass data-parallel InfoNCE), with a
//     logit scale read from the device (the TPU kernel's SMEM scale).
// Per row i it computes what that kernel computes:
//   s[i, j] = (z_i . z_j) * (inv_t * scale) in fp32, whatever the input
//     dtype (scale 1 unless given);
//   columns whose id is >= cols_actual or, without diag_pos, equals the
//     row's id masked to -1e30 (_masked_sim_tile); columns past C do not
//     exist;
//   online logsumexp over column tiles: m = max, l = l * exp(m_old - m_new)
//     + sum exp(min(s - m_new, 0)) (the _exp0 clamp);
//   lse[i] = m + log(max(l, 1e-37)) (the _log_l floor);
//   the positive logit: the unmasked s[i, j] of the column whose id is
//     pos(gid_i) = gid_i + n_half if gid_i < n_half else gid_i - n_half,
//     or gid_i itself with diag_pos (_pos_gid);
//   loss_sum = sum over rows with gid_i < cols_actual of (lse[i] - pos_i)
//     (padding rows carry the sentinel id 2N and drop out).
//
// Design (ntxent_tf32.cuh holds the walk and its launcher, fwd_launch,
// which #9 shares). Four launches: the operand-prep pass (hi, lo of z; of
// the rows and the columns in the general mode); the walk, one CTA per
// (64-row tile, column split), s by wgmma
// m64n64k8 TF32 from a TMA ring (3xTF32 for fp32 z, one pass for bf16),
// the online softmax on the accumulator fragment, and one (m, l, pos)
// partial per row and split; a merge kernel that folds each row's partials
// in split order (m = max, l = l e^(m - m') + l_c e^(m_c - m'): the rule
// of ntxent_tri_fwd.cu's tri_fwd_merge_kernel), applies the 1e-37 floor,
// writes lse and sums its 256 rows' losses in row order; and one warp that
// adds those sums in a fixed order. The TPU kernel's sequential column
// axis becomes a loop inside each CTA plus the split across CTAs, which
// fills the SMs at 2N = 512 (8 row tiles x 16 splits of 32 columns). No
// atomics: the loss is bitwise repeatable.
//
// Bound. 2 R C D operations, each product three TF32 passes (the card's
// fastest fp32-accurate product: 495 / 3 = 165 TFLOP/s), against (R + C)
// D inputs: at the symmetric training shape (2N = 512, D = 128, fp32) 67
// MFLOP, 0.41 us; at 2N = 8192, 104 us; at one rank's strip of a 4-card
// world at global batch 4096 (R = 2048, C = 8192), 26 us; the two-pass
// InfoNCE of CLIP (D = 512) at batch 256 on one card (R = C = 256), 0.41
// us, and one rank of 4 at batch 4096 (R = 1024, C = 4096), 26 us. Bytes
// are far below (8192 x 128 fp32 is 4 MB, 1.3 us at 3.35 TB/s). At 2N =
// 512 the four launches and the walk's latency bound it.
//
// Supported: float32 or bfloat16 rows and columns (the same dtype),
// contiguous (rows, D), 1 <= D <= kMaxWidth (past D = 256 in fp32, 512 in
// bf16, the row tile streams through the ring, ntxent_tf32.cuh); the
// symmetric mode needs an even row count >= 2. int32 ids. The C entry
// points return cudaGetLastError().

#include "ntxent_tf32.cuh"

namespace {

using namespace ntx;

// What the walk takes besides the maps and the layout: the ids, the
// partials (three planes (m, l, pos), each (splits, n_rows)), 1/T and the
// logit scale on the device (null: 1).
template <class Ids>
struct FwdArgs {
  Ids ids;
  float* part;
  float inv_t;
  const float* scale;
};

// Rows past n_rows give no partial.
template <bool kSplit, class Ids>
__device__ __forceinline__ void fwd_walk(const CUtensorMap* tm_rh,
                                         const CUtensorMap* tm_rl,
                                         const CUtensorMap* tm_ch,
                                         const CUtensorMap* tm_cl,
                                         const FwdArgs<Ids>& a,
                                         const Plan& p, int n_rows,
                                         int n_cols, int split_cols) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = sm90::aligned_smem(raw);
  uint64_t* bars = walk_barriers(smem, p);
  Ring ring(smem, bars, p);
  const int row0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int cb = split * split_cols;
  const int ce = min(cb + split_cols, n_cols);
  const int tiles = (ce - cb + kTile - 1) / kTile;

  if (threadIdx.x >= kWarpgroup) {  // the producer warp
    if (threadIdx.x == kWarpgroup) {
      fwd_produce<kSplit>(smem, bars, p, ring, tm_rh, tm_rl, tm_ch, tm_cl,
                          row0, cb, tiles);
    }
    return;
  }

  const Ids& ids = a.ids;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  const int q = lane % 4;
  const float inv = scaled_inv_t(a.inv_t, a.scale);
  int gid[2], pos_gid[2];
  float m[2], l[2], pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gid[h] = ids.row(row0 + r + 8 * h);
    pos_gid[h] = ids.positive(gid[h]);
    m[h] = kNegInf;
    l[h] = 0.f;
    pos[h] = 0.f;
  }
  wait_rows(bars, p);
  for (int t = 0; t < tiles; ++t) {
    const int col0 = cb + t * kTile;
    int cid[16];  // entry 2i + e: column col0 + 8i + 2q + e
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * (j / 2) + 2 * q + j % 2;
      cid[j] = col < ce ? ids.col(col) : kNoColumn;
    }
    float s[32];
    s_tile<kSplit>(smem, p, ring, s);

    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // row r + 8h, column 8 (i / 4) + 2q + i % 2
      const int h = (i / 2) % 2;
      const int id = cid[2 * (i / 4) + i % 2];
      const float raw_s = s[i] * inv;
      if (id == pos_gid[h]) pos[h] += raw_s;
      s[i] = masked(ids, id, gid[h]) ? kNegInf : raw_s;
      row_max[h] = fmaxf(row_max[h], s[i]);
    }
    online_rows(s, row_max, m, l);
  }
  // The positive sits in at most one thread of the row's quad.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] += __shfl_xor_sync(0xffffffffu, pos[h], 1);
    pos[h] += __shfl_xor_sync(0xffffffffu, pos[h], 2);
    const int row = row0 + r + 8 * h;
    if (q == 0 && row < n_rows) {
      const size_t plane = size_t(gridDim.y) * n_rows;
      const size_t at = size_t(split) * n_rows + row;
      a.part[at] = m[h];
      a.part[plane + at] = l[h];
      a.part[2 * plane + at] = pos[h];
    }
  }
}

// Row r's partials folded in split order into lse[r]; the CTA's sum of
// lse - pos over its rows with ids < cols_actual, in row order, into
// block_sum[blockIdx.x].
template <class Ids>
__device__ __forceinline__ void fwd_merge(const float* __restrict__ part,
                                          float* __restrict__ lse,
                                          float* __restrict__ block_sum,
                                          const Ids& ids, int n_rows,
                                          int splits) {
  __shared__ float row_loss[kMergeThreads];
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  float loss = 0.f;
  if (row < n_rows) {
    const size_t plane = size_t(splits) * n_rows;
    float m = kNegInf;
    float l = 0.f;
    float p = 0.f;
    for (int c = 0; c < splits; ++c) {
      const size_t at = size_t(c) * n_rows + row;
      fold_partial(m, l, part[at], part[plane + at]);
      p += part[2 * plane + at];
    }
    const float row_lse = m + logf(fmaxf(l, 1e-37f));
    lse[row] = row_lse;
    if (ids.row(row) < ids.cols_actual()) loss = row_lse - p;
  }
  row_loss[threadIdx.x] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < kMergeThreads; ++i) sum += row_loss[i];
    block_sum[blockIdx.x] = sum;
  }
}

// The kernels of each mode carry its name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_fwd_sym_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_fwd_sym_walk(const __grid_constant__ CUtensorMap tm_rh,
                        const __grid_constant__ CUtensorMap tm_rl,
                        const __grid_constant__ CUtensorMap tm_ch,
                        const __grid_constant__ CUtensorMap tm_cl,
                        FwdArgs<SymIds> a, Plan p, int n_rows, int n_cols,
                        int split_cols) {
  fwd_walk<kSplit>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, a, p, n_rows, n_cols,
                   split_cols);
}

__global__ void __launch_bounds__(kMergeThreads)
    ntxent_fwd_sym_merge(const float* __restrict__ part,
                         float* __restrict__ lse,
                         float* __restrict__ block_sum, SymIds ids,
                         int splits) {
  fwd_merge(part, lse, block_sum, ids, ids.n, splits);
}

__global__ void ntxent_fwd_sym_reduce(const float* __restrict__ block_sum,
                                      int count, float* __restrict__ loss) {
  reduce_sums(block_sum, count, loss);
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_fwd_general_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_fwd_general_walk(const __grid_constant__ CUtensorMap tm_rh,
                            const __grid_constant__ CUtensorMap tm_rl,
                            const __grid_constant__ CUtensorMap tm_ch,
                            const __grid_constant__ CUtensorMap tm_cl,
                            FwdArgs<GeneralIds> a, Plan p, int n_rows,
                            int n_cols, int split_cols) {
  fwd_walk<kSplit>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, a, p, n_rows, n_cols,
                   split_cols);
}

__global__ void __launch_bounds__(kMergeThreads)
    ntxent_fwd_general_merge(const float* __restrict__ part,
                             float* __restrict__ lse,
                             float* __restrict__ block_sum, GeneralIds ids,
                             int splits) {
  fwd_merge(part, lse, block_sum, ids, ids.n_rows, splits);
}

__global__ void ntxent_fwd_general_reduce(const float* __restrict__ block_sum,
                                          int count,
                                          float* __restrict__ loss) {
  reduce_sums(block_sum, count, loss);
}

// The buffers of one launch: the operand copies (fwd_carve: the columns'
// only in the general mode, n_cols > 0), part 3 * splits * rows fp32,
// block_sum ceil(rows / 256) fp32, cut from one scratch allocation; lse
// and loss are the caller's.
struct Buffers {
  FwdBuffers ops;
  float *part, *block_sum, *lse, *loss;
};

Buffers carve(Carver& c, int n_rows, int n_cols, int d, bool split,
              int splits) {
  Buffers b{};
  b.ops = fwd_carve(c, n_rows, n_cols, d, split);
  b.part = c.take(size_t(3) * splits * n_rows);
  b.block_sum = c.take((n_rows + kMergeThreads - 1) / kMergeThreads);
  return b;
}

template <typename T>
cudaError_t launch_sym(const T* z, const Buffers& b, int n, int d,
                       float inv_t, int splits, int split_cols,
                       cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const SymIds ids{n};
  cudaError_t err = fwd_launch<T>(
      z, nullptr, n, n, d, splits, split_cols, b.ops,
      ntxent_fwd_sym_prep<T, kSplit>, ntxent_fwd_sym_walk<kSplit>,
      FwdArgs<SymIds>{ids, b.part, inv_t, nullptr}, 0, stream);
  if (err != cudaSuccess) return err;
  const int merges = (n + kMergeThreads - 1) / kMergeThreads;
  ntxent_fwd_sym_merge<<<merges, kMergeThreads, 0, stream>>>(
      b.part, b.lse, b.block_sum, ids, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ntxent_fwd_sym_reduce<<<1, 32, 0, stream>>>(b.block_sum, merges, b.loss);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_general(const T* z_rows, const T* z_cols,
                           const GeneralIds& ids, const float* scale,
                           const Buffers& b, int n_cols, int d, float inv_t,
                           int splits, int split_cols, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int n_rows = ids.n_rows;
  cudaError_t err = fwd_launch<T>(
      z_rows, z_cols, n_rows, n_cols, d, splits, split_cols, b.ops,
      ntxent_fwd_general_prep<T, kSplit>, ntxent_fwd_general_walk<kSplit>,
      FwdArgs<GeneralIds>{ids, b.part, inv_t, scale}, 0, stream);
  if (err != cudaSuccess) return err;
  const int merges = (n_rows + kMergeThreads - 1) / kMergeThreads;
  ntxent_fwd_general_merge<<<merges, kMergeThreads, 0, stream>>>(
      b.part, b.lse, b.block_sum, ids, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ntxent_fwd_general_reduce<<<1, 32, 0, stream>>>(b.block_sum, merges,
                                                   b.loss);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch one call takes: symmetric with n_cols = 0, general
// with the column count.
extern "C" long long ntx_ntxent_fwd_scratch(int n_rows, int n_cols, int d,
                                            int dtype, int splits) {
  Carver c{nullptr};
  carve(c, n_rows, n_cols, d, dtype == 0, splits);
  return static_cast<long long>(c.used);
}

// Symmetric mode. dtype: 0 = float32, 1 = bfloat16. The columns are cut
// into `splits` runs of `split_cols` (the last one shorter), each non-empty
// and together covering 0 .. rows - 1. `scratch` holds
// ntx_ntxent_fwd_scratch(rows, 0, d, dtype, splits) floats. Returns a
// cudaError_t (0 = success).
extern "C" int ntx_ntxent_fwd(const void* z, void* lse, void* loss,
                              void* scratch, int n_rows, int d, int dtype,
                              float inv_t, int splits, int split_cols,
                              int device, void* stream) {
  if (n_rows < 2 || n_rows % 2 || !width_ok(d) ||
      !splits_cover(n_rows, splits, split_cols)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<float*>(scratch)};
  Buffers b = carve(c, n_rows, 0, d, dtype == 0, splits);
  b.lse = static_cast<float*>(lse);
  b.loss = static_cast<float*>(loss);
  if (dtype == 0) {
    return launch_sym(static_cast<const float*>(z), b, n_rows, d, inv_t,
                      splits, split_cols, s);
  }
  if (dtype == 1) {
    return launch_sym(static_cast<const __nv_bfloat16*>(z), b, n_rows, d,
                      inv_t, splits, split_cols, s);
  }
  return cudaErrorInvalidValue;
}

// General mode: rows z_rows (n_rows, d) with int32 ids row_gid, columns
// z_cols (n_cols, d) with int32 ids col_gid (null: the column index), the
// fp32 logit scale at `scale` on the device (null: 1), the InfoNCE mode
// with diag_pos != 0. The columns split as in the symmetric mode.
// `scratch` holds ntx_ntxent_fwd_scratch(n_rows, n_cols, d, dtype, splits)
// floats.
extern "C" int ntx_ntxent_fwd_general(
    const void* z_rows, const void* z_cols, const void* row_gid,
    const void* col_gid, const void* scale, void* lse, void* loss,
    void* scratch, int n_rows, int n_cols, int d, int dtype, float inv_t,
    int cols_actual, int n_half, int diag_pos, int splits, int split_cols,
    int device, void* stream) {
  if (row_gid == nullptr || n_rows < 1 || n_cols < 1 || !width_ok(d) ||
      !splits_cover(n_cols, splits, split_cols)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GeneralIds ids{static_cast<const int*>(row_gid),
                       static_cast<const int*>(col_gid), n_rows, cols_actual,
                       n_half, diag_pos};
  const float* sc = static_cast<const float*>(scale);
  Carver c{static_cast<float*>(scratch)};
  Buffers b = carve(c, n_rows, n_cols, d, dtype == 0, splits);
  b.lse = static_cast<float*>(lse);
  b.loss = static_cast<float*>(loss);
  if (dtype == 0) {
    return launch_general(static_cast<const float*>(z_rows),
                          static_cast<const float*>(z_cols), ids, sc, b,
                          n_cols, d, inv_t, splits, split_cols, s);
  }
  if (dtype == 1) {
    return launch_general(static_cast<const __nv_bfloat16*>(z_rows),
                          static_cast<const __nv_bfloat16*>(z_cols), ids, sc,
                          b, n_cols, d, inv_t, splits, split_cols, s);
  }
  return cudaErrorInvalidValue;
}
