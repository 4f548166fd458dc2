// NT-Xent dual statistics of one shard-pair tile for Hopper (sm_90a) on
// TF32 tensor cores, bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _dual_stats_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:1037, launched by block_lse_dual at
// :1094, pallas_call at :1130), the forward of the pair-parallel NT-Xent
// (--dp-loss pair, ntxent_tpu/parallel/pair.py:116). For rows z_rows (R, D)
// with global ids row_gid and columns z_cols (C, D) with global ids
// col_gid, a padding vector carrying the sentinel id `total`:
//   s[i, j]    = (z_rows_i . z_cols_j) * inv_t in fp32;
//   lse_rows[i] = logsumexp over j of s[i, j], the entries whose column id
//                 is >= total or equals the row's id masked to -1e30;
//   lse_cols[j] = logsumexp over i of s[i, j], the entries whose ROW id is
//                 >= total or equals the column's id masked to -1e30
//                 (the row direction of the mirror tile, which the pair
//                 schedule never walks).
// Each is summed as exp(min(s - m, 0)) (the _exp0 clamp) and closed as m +
// log(max(l, 1e-37)) (the _log_l floor): a row or column whose every entry
// is masked ends at -1e30, finite, as on the TPU. A real row or column
// whose id is the sentinel still gets its logsumexp over the other side's
// entries; only the other direction masks it.
//
// Design. The TPU kernel forms each s tile once and folds it into the
// rows' online softmax and, transposed, the columns', both carried across
// its sequential grid. Here the dual walk of dual_tf32.cuh (#9's, on #1's
// TF32 walk of ntxent_tf32.cuh) forms each s tile once too and folds it
// both ways in the same registers. Three launches:
//   prep   TF32 hi and lo of z_rows and of z_cols, one launch (PrepPair);
//   walk   one CTA per (64-row tile of z_rows, split of z_cols's columns,
//          planned by ops/ntxent.py's column_splits); per 64-column tile
//          s = z_r . z_c^T * inv_t by wgmma m64n64k8 from a TMA ring
//          (3xTF32 for fp32, one pass for bf16, whose lo is 0); each
//          column's (max, sum exp0(s - max)) over the tile's 64 rows, then
//          the rows' online (m, l) over the split. The masks (PairMask)
//          come from ids in registers, 2 row ids and 16 column ids a
//          thread: the column direction masks an entry whose row id is
//          >= total or equals the column's, the row direction one whose
//          column id is >= total or equals the row's; s is held once and
//          turned into the row direction's entries after the column pass.
//          A column past the split or past C has no id (kNoColumn, masked
//          in the row direction and never written in the column one); a
//          row past R takes the sentinel total. The self hit follows the
//          ids, not the diagonal;
//   merge  index i: row i's split partials in split order and column i's
//          row-tile partials in tile order (fold_partial), the 1e-37 floor.
// One owner per output, no atomics: bitwise repeatable. The matrix work is
// the TPU kernel's, s formed once for both directions.
//
// Bound: 2 R C D operations (s once), each product three TF32 passes in
// fp32 (the card's fastest fp32-accurate product, 165 TFLOP/s), against
// (R + C) D inputs, (R + C) ids and (R + C) fp32 outputs. At one rank's
// self tile of a 1-card world at batch 256 (R = C = 512, D = 128): 67.1
// MFLOP, 0.41 us; 8 row tiles x 16 splits of 32 columns, 128 CTAs:
// latency-bound. One rank of 4 at global batch 4096 (R = C = 2048): 1.07
// GFLOP, 6.5 us.
//
// Supported: float32 or bfloat16 z_rows and z_cols (the same dtype),
// contiguous, R, C >= 1, 1 <= D <= kMaxWidth (past D = 256 in fp32, 512
// in bf16, the row tile streams through the ring), int32 ids. The C entry
// point returns cudaGetLastError().

#include "dual_tf32.cuh"

namespace {

using namespace ntx;

// What the walk takes besides the maps and the layout: both sides' ids,
// 1/T, the sentinel, and the partials (dual_carve, two planes a side).
struct PairArgs {
  const int* row_gid;
  const int* col_gid;
  float inv_t;
  int total;
  DualParts parts;
};

// The shard-pair masks: each direction masked by the OTHER side's id.
struct PairMask {
  const int* __restrict__ row_gid;
  const int* __restrict__ col_gid;
  int n_rows, total;
  int rid[2];
  int cid[16];  // entry j: column col0 + col_of(j, q)

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      rid[h] = row < n_rows ? row_gid[row] : total;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + col_of(j, q);
      cid[j] = col < ce ? col_gid[col] : kNoColumn;
    }
  }
  __device__ __forceinline__ bool row_in(int h, int j, int) const {
    return cid[j] < total && cid[j] != rid[h];
  }
  __device__ __forceinline__ bool col_in(int h, int j, int) const {
    return rid[h] < total && rid[h] != cid[j];
  }
};

// The kernels carry the wrapper's name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_dual_stats_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_dual_stats_walk(const __grid_constant__ CUtensorMap tm_rh,
                           const __grid_constant__ CUtensorMap tm_rl,
                           const __grid_constant__ CUtensorMap tm_ch,
                           const __grid_constant__ CUtensorMap tm_cl,
                           PairArgs a, Plan p, int n_rows, int n_cols,
                           int split_cols) {
  PairMask mask{a.row_gid, a.col_gid, n_rows, a.total};
  dual_walk<kSplit, false>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, mask, a.inv_t,
                           a.parts.part_r, a.parts.part_c, p, n_rows, n_cols,
                           dual_split(n_cols, split_cols));
}

__global__ void __launch_bounds__(kMergeThreads)
    ntxent_dual_stats_merge(const float* __restrict__ part_r,
                            const float* __restrict__ part_c,
                            float* __restrict__ lse_rows,
                            float* __restrict__ lse_cols, int n_rows,
                            int n_cols, int splits) {
  dual_merge<false>(part_r, part_c, lse_rows, lse_cols, nullptr, n_rows,
                    n_cols, splits);
}

// The scratch of one call: the operand copies (fwd_carve) and the walk's
// partials (dual_carve: part_r 2 * splits * R, part_c 2 * ceil(R / 64) *
// C fp32).
struct Buffers {
  FwdBuffers ops;
  DualParts parts;
};

Buffers carve(Carver& c, int n_rows, int n_cols, int d, bool split,
              int splits) {
  Buffers b{};
  b.ops = fwd_carve(c, n_rows, n_cols, d, split);
  b.parts = dual_carve(c, n_rows, n_cols, splits, 2);
  return b;
}

struct Call {
  const void *z_rows, *z_cols;
  const int *row_gid, *col_gid;
  float *lse_rows, *lse_cols;
  float inv_t;
  int total, n_rows, n_cols, d, splits, split_cols;
};

template <typename T>
cudaError_t launch(const Call& a, const Buffers& b, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const PairArgs args{a.row_gid, a.col_gid, a.inv_t, a.total, b.parts};
  cudaError_t err = fwd_launch<T>(
      static_cast<const T*>(a.z_rows), static_cast<const T*>(a.z_cols),
      a.n_rows, a.n_cols, a.d, a.splits, a.split_cols, b.ops,
      ntxent_dual_stats_prep<T, kSplit>, ntxent_dual_stats_walk<kSplit>,
      args, kColBytes, stream);
  if (err != cudaSuccess) return err;
  ntxent_dual_stats_merge<<<merge_blocks(a.n_rows, a.n_cols), kMergeThreads,
                            0, stream>>>(b.parts.part_r, b.parts.part_c,
                                         a.lse_rows, a.lse_cols, a.n_rows,
                                         a.n_cols, a.splits);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch one call takes (dtype 0: fp32, with lo copies).
extern "C" long long ntx_ntxent_dual_stats_scratch(int n_rows, int n_cols,
                                                   int d, int dtype,
                                                   int splits) {
  Carver c{nullptr};
  carve(c, n_rows, n_cols, d, dtype == 0, splits);
  return static_cast<long long>(c.used);
}

// lse_rows (n_rows,) and lse_cols (n_cols,) fp32 of one tile; row_gid and
// col_gid int32, both required. dtype: 0 = float32, 1 = bfloat16. z_cols's
// columns are cut into `splits` runs of `split_cols` (the last one
// shorter), each non-empty; `scratch` holds
// ntx_ntxent_dual_stats_scratch(n_rows, n_cols, d, dtype, splits) floats.
extern "C" int ntx_ntxent_dual_stats(const void* z_rows, const void* z_cols,
                                     const void* row_gid,
                                     const void* col_gid, void* lse_rows,
                                     void* lse_cols, void* scratch,
                                     int n_rows, int n_cols, int d,
                                     int dtype, float inv_t, int total,
                                     int splits, int split_cols, int device,
                                     void* stream) {
  if (n_rows < 1 || n_cols < 1 || !width_ok(d) || !row_gid ||
      !col_gid || !splits_cover(n_cols, splits, split_cols) ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Call a{z_rows,
               z_cols,
               static_cast<const int*>(row_gid),
               static_cast<const int*>(col_gid),
               static_cast<float*>(lse_rows),
               static_cast<float*>(lse_cols),
               inv_t,
               total,
               n_rows,
               n_cols,
               d,
               splits,
               split_cols};
  Carver c{static_cast<float*>(scratch)};
  const Buffers b = carve(c, n_rows, n_cols, d, dtype == 0, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, s);
  return launch<__nv_bfloat16>(a, b, s);
}
