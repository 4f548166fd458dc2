// Cross-modal InfoNCE (CLIP) forward for Hopper (sm_90a) on TF32 tensor
// cores, bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/infonce_pallas.py:75
// (_dual_fwd_kernel, launched by _dual_fwd_call at infonce_pallas.py:165,
// pallas_call :174) in both of its modes. For embeddings za (n_a, D), zb
// (n_b, D) and the logit scale (a device scalar, CLIP's learnable
// exp(logit_scale)) it computes what that kernel computes:
//   s[i, j]  = (za_i . zb_j) * scale in fp32, whatever the input dtype;
//   lse_a[i] = logsumexp_j s[i, j]   (the row direction, image -> text);
//   lse_b[j] = logsumexp_i s[i, j]   (the column direction, text -> image);
// each direction masked by its own padding (columns past n_b for lse_a,
// rows past n_a for lse_b, -1e30), summed as exp(min(s - m, 0)) (the _exp0
// clamp) and closed as m + log(max(l, 1e-37)) (the _log_l floor).
//   * square (ntx_infonce_dual_fwd, info_nce_fused): n_a = n_b = N, and
//     loss_sum = sum_i (lse_a[i] - s[i, i]) + sum_j (lse_b[j] - s[j, j]);
//     the positive is the diagonal, which is NOT masked (za_i and zb_i are
//     different modalities);
//   * rectangular stats-only (ntx_infonce_dual_fwd_rect,
//     _infonce_dual_local_fwd at infonce_pallas.py:443-456, stats_only):
//     one rank's za rows against the gathered zb; lse_a over all n_b
//     columns and lse_b_part, each column's logsumexp over these n_a rows
//     only (the caller merges it across ranks). No positives, no loss.
//
// Design. The TPU kernel forms each s tile once and folds it into both
// directions' online softmax, the columns' carried across its sequential
// grid. Here the dual walk of dual_tf32.cuh (on #1's walk of
// ntxent_tf32.cuh: operand prep, TMA ring, wgmma) forms each s tile once
// too, and folds it both ways in the same registers. Four launches (three
// in the stats-only mode):
//   prep   TF32 hi and lo of za and of zb, one launch (PrepPair);
//   walk   one CTA per (64-row tile of za, split of zb's columns, planned
//          by ops/ntxent.py's column_splits); per 64-column tile s = za .
//          zb^T * scale by wgmma m64n64k8 from the ring (3xTF32 for fp32,
//          one pass for bf16, whose lo is 0). The column direction: each
//          column's max over the tile's 64 rows and the sum of exp0(s -
//          max) against it, reduced over the row-lanes by shuffle and over
//          the warps through shared memory, one (m, l) partial per column
//          and row tile. The row direction: the online (m, l) of #1
//          (online_rows), one (m, l, pos) partial per row and split. The
//          mask (LiveMask) leaves out columns past the split or past n_b
//          and rows past n_a, in both directions alike;
//   merge  index i: row i's split partials in split order, column i's row
//          tile partials in tile order (fold_partial), the floor, lse_a[i]
//          and lse_b[i]; square: the block's (lse_a - s_ii) + (lse_b - s_ii)
//          in index order, s_ii taken from the row partials (the walk adds
//          the diagonal entry of its own split only);
//   reduce one warp adds the blocks' sums in a fixed order (square).
// One owner per output, no atomics: the loss is bitwise repeatable.
//
// Bound. 2 n_a n_b D operations (s once, for both directions), each
// product three TF32 passes in fp32 (the card's fastest fp32-accurate
// product, 165 TFLOP/s), against (n_a + n_b) D inputs and two lse vectors.
// The CLIP training shape (N = 256, D = 512): 67 MFLOP, 0.41 us; N = 8192:
// 69 GFLOP, 0.42 ms. One rank of 4 at global batch 256 (64, 256, 512):
// 0.20 us by bytes (0.66 MB); at global batch 4096 (1024, 4096, 512): 4.3
// GFLOP, 26 us. At N = 256 the launches and the walk's latency bound it.
//
// Supported: float32 or bfloat16 za and zb (the same dtype), contiguous
// (n_a, D) and (n_b, D), n_a, n_b >= 1, 1 <= D <= kMaxWidth (past D = 256
// in fp32, 512 in bf16, the row tile streams through the ring). The C
// entry points return cudaGetLastError().

#include "dual_tf32.cuh"

namespace {

using namespace ntx;

// What the walk takes besides the maps and the layout: the scale on the
// device; part_r, three planes (m, l, pos), each (splits, n_a); part_c,
// two planes (m, l), each (row tiles, n_b).
struct DualArgs {
  const float* scale;
  float* part_r;
  float* part_c;
};

// #9's mask: every entry counts in both directions but those of columns
// past the split or past n_b and of rows past n_a.
struct LiveMask {
  int n_a, ce;
  bool live[2];
  int row[2];

  __device__ __forceinline__ void rows(int r) {
    live[0] = r < n_a;
    live[1] = r + 8 < n_a;
    row[0] = r;
    row[1] = r + 8;
  }
  __device__ __forceinline__ void tile(int, int ce_, int) { ce = ce_; }
  __device__ __forceinline__ bool row_in(int h, int, int c) const {
    return c < ce && live[h];
  }
  __device__ __forceinline__ bool col_in(int h, int j, int c) const {
    return row_in(h, j, c);
  }
  // The square mode's positive: the diagonal, in the split that owns it.
  __device__ __forceinline__ bool row_pos(int h, int, int c) const {
    return c < ce && c == row[h];
  }
};

// The kernels of each mode carry its name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    infonce_dual_fwd_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    infonce_dual_fwd_walk(const __grid_constant__ CUtensorMap tm_rh,
                          const __grid_constant__ CUtensorMap tm_rl,
                          const __grid_constant__ CUtensorMap tm_ch,
                          const __grid_constant__ CUtensorMap tm_cl,
                          DualArgs a, Plan p, int n_a, int n_b,
                          int split_cols) {
  LiveMask mask{n_a};
  dual_walk<kSplit, true>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, mask,
                          __ldg(a.scale), a.part_r, a.part_c, p, n_a,
                          n_b, dual_split(n_b, split_cols));
}

__global__ void __launch_bounds__(kMergeThreads)
    infonce_dual_fwd_merge(const float* __restrict__ part_r,
                           const float* __restrict__ part_c,
                           float* __restrict__ lse_a,
                           float* __restrict__ lse_b,
                           float* __restrict__ block_sum, int n,
                           int splits) {
  dual_merge<true>(part_r, part_c, lse_a, lse_b, block_sum, n, n, splits);
}

__global__ void infonce_loss_reduce(const float* __restrict__ block_sum,
                                    int count, float* __restrict__ loss) {
  reduce_sums(block_sum, count, loss);
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    infonce_fwd_rect_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    infonce_fwd_rect_walk(const __grid_constant__ CUtensorMap tm_rh,
                          const __grid_constant__ CUtensorMap tm_rl,
                          const __grid_constant__ CUtensorMap tm_ch,
                          const __grid_constant__ CUtensorMap tm_cl,
                          DualArgs a, Plan p, int n_a, int n_b,
                          int split_cols) {
  LiveMask mask{n_a};
  dual_walk<kSplit, false>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, mask,
                           __ldg(a.scale), a.part_r, a.part_c, p, n_a,
                           n_b, dual_split(n_b, split_cols));
}

__global__ void __launch_bounds__(kMergeThreads)
    infonce_fwd_rect_merge(const float* __restrict__ part_r,
                           const float* __restrict__ part_c,
                           float* __restrict__ lse_a,
                           float* __restrict__ lse_b, int n_a, int n_b,
                           int splits) {
  dual_merge<false>(part_r, part_c, lse_a, lse_b, nullptr, n_a, n_b, splits);
}

// The scratch of one call: the operand copies (fwd_carve), the walk's
// partials (dual_carve: part_r 3 * splits * n_a, part_c 2 * ceil(n_a / 64)
// * n_b) and block_sum ceil(max(n_a, n_b) / 256) fp32.
struct Buffers {
  FwdBuffers ops;
  DualParts parts;
  float* block_sum;
};

Buffers carve(Carver& c, int n_a, int n_b, int d, bool split, int splits) {
  Buffers b{};
  b.ops = fwd_carve(c, n_a, n_b, d, split);
  b.parts = dual_carve(c, n_a, n_b, splits, 3);
  b.block_sum = c.take(merge_blocks(n_a, n_b));
  return b;
}

struct Call {
  const void *za, *zb, *scale;
  float *lse_a, *lse_b, *loss;
  int n_a, n_b, d, splits, split_cols;
};

template <typename T, bool kLoss>
cudaError_t launch(const Call& a, const Buffers& b, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const DualArgs args{static_cast<const float*>(a.scale), b.parts.part_r,
                      b.parts.part_c};
  const T* za = static_cast<const T*>(a.za);
  const T* zb = static_cast<const T*>(a.zb);
  const int merges = merge_blocks(a.n_a, a.n_b);
  cudaError_t err;
  if constexpr (kLoss) {
    err = fwd_launch<T>(za, zb, a.n_a, a.n_b, a.d, a.splits, a.split_cols,
                        b.ops, infonce_dual_fwd_prep<T, kSplit>,
                        infonce_dual_fwd_walk<kSplit>, args, kColBytes,
                        stream);
    if (err != cudaSuccess) return err;
    infonce_dual_fwd_merge<<<merges, kMergeThreads, 0, stream>>>(
        b.parts.part_r, b.parts.part_c, a.lse_a, a.lse_b, b.block_sum, a.n_a,
        a.splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    infonce_loss_reduce<<<1, 32, 0, stream>>>(b.block_sum, merges, a.loss);
  } else {
    err = fwd_launch<T>(za, zb, a.n_a, a.n_b, a.d, a.splits, a.split_cols,
                        b.ops, infonce_fwd_rect_prep<T, kSplit>,
                        infonce_fwd_rect_walk<kSplit>, args, kColBytes,
                        stream);
    if (err != cudaSuccess) return err;
    infonce_fwd_rect_merge<<<merges, kMergeThreads, 0, stream>>>(
        b.parts.part_r, b.parts.part_c, a.lse_a, a.lse_b, a.n_a, a.n_b,
        a.splits);
  }
  return cudaGetLastError();
}

template <bool kLoss>
cudaError_t run(const Call& a, void* scratch, int dtype, int device,
                void* stream) {
  if (a.scale == nullptr || a.n_a < 1 || a.n_b < 1 || !width_ok(a.d) ||
      !splits_cover(a.n_b, a.splits, a.split_cols) ||
      (kLoss && a.n_a != a.n_b) || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Carver c{static_cast<float*>(scratch)};
  const Buffers b = carve(c, a.n_a, a.n_b, a.d, dtype == 0, a.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kLoss>(a, b, s);
  return launch<__nv_bfloat16, kLoss>(a, b, s);
}

}  // namespace

// Floats of scratch one call takes (dtype 0: fp32, with lo copies); the
// square mode has n_a = n_b = N.
extern "C" long long ntx_infonce_dual_fwd_scratch(int n_a, int n_b, int d,
                                                  int dtype, int splits) {
  Carver c{nullptr};
  carve(c, n_a, n_b, d, dtype == 0, splits);
  return static_cast<long long>(c.used);
}

// The square mode: loss_sum (one fp32), lse_a and lse_b (n,) fp32 of za,
// zb (n, d). dtype: 0 = float32, 1 = bfloat16. `scale` points to one fp32
// on the device. zb's columns are cut into `splits` runs of `split_cols`
// (the last one shorter), each non-empty; `scratch` holds
// ntx_infonce_dual_fwd_scratch(n, n, d, dtype, splits) floats. Returns a
// cudaError_t (0 = success).
extern "C" int ntx_infonce_dual_fwd(const void* za, const void* zb,
                                    const void* scale, void* lse_a,
                                    void* lse_b, void* loss, void* scratch,
                                    int n, int d, int dtype, int splits,
                                    int split_cols, int device,
                                    void* stream) {
  const Call a{za, zb, scale, static_cast<float*>(lse_a),
               static_cast<float*>(lse_b), static_cast<float*>(loss), n, n,
               d, splits, split_cols};
  return run<true>(a, scratch, dtype, device, stream);
}

// The rectangular stats-only mode: lse_a (n_a,) and lse_b (n_b,) fp32 of
// za (n_a, d) against zb (n_b, d). Arguments as above; `scratch` holds
// ntx_infonce_dual_fwd_scratch(n_a, n_b, d, dtype, splits) floats.
extern "C" int ntx_infonce_dual_fwd_rect(const void* za, const void* zb,
                                         const void* scale, void* lse_a,
                                         void* lse_b, void* scratch, int n_a,
                                         int n_b, int d, int dtype,
                                         int splits, int split_cols,
                                         int device, void* stream) {
  const Call a{za, zb, scale, static_cast<float*>(lse_a),
               static_cast<float*>(lse_b), nullptr, n_a, n_b, d, splits,
               split_cols};
  return run<false>(a, scratch, dtype, device, stream);
}
