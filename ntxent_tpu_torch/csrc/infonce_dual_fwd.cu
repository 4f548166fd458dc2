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
// grid. Here one walk of ntxent_tf32.cuh (#1's: operand prep, TMA ring,
// wgmma) forms each s tile once too, and folds it both ways in the same
// registers. Four launches (three in the stats-only mode):
//   prep   TF32 hi and lo of za and of zb, one launch (PrepPair);
//   walk   one CTA per (64-row tile of za, split of zb's columns, planned
//          by ops/ntxent.py's column_splits); per 64-column tile s = za .
//          zb^T * scale by wgmma m64n64k8 from the ring (3xTF32 for fp32,
//          one pass for bf16, whose lo is 0). The row direction: the online
//          (m, l) of #1 (online_rows), one (m, l, pos) partial per row and
//          split. The column direction: each column's max over the tile's
//          64 rows and the sum of exp0(s - max) against it. A CTA visits a
//          column tile once, so this needs no rescale, only a reduction
//          over rows: a thread's two rows, the 8 row-lanes of its column
//          (shuffles over lane bits 2-4), then the 4 warps through shared
//          memory (two 2 KB buffers by tile parity, so one barrier a phase
//          suffices), summed in warp order. One (m, l) partial per column
//          and row tile;
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
// (n_a, D) and (n_b, D), n_a, n_b >= 1, 1 <= D <= 512 (past D = 256 in
// fp32 the row tile streams through the ring). The C entry points return
// cudaGetLastError().

#include "ntxent_tf32.cuh"

namespace {

using namespace ntx;

constexpr int kWarps = kWarpgroup / 32;  // the consumer warps
// The column reduction's shared memory beside the ring: per tile parity,
// the warps' column maxima, then their sums, 64 columns a warp.
constexpr int kColFloats = kWarps * kTile;
constexpr int kColBytes = 2 * 2 * kColFloats * 4;

// What the walk takes besides the maps and the layout: the scale on the
// device; part_r, three planes (m, l, pos), each (splits, n_a); part_c,
// two planes (m, l), each (row tiles, n_b).
struct DualArgs {
  const float* scale;
  float* part_r;
  float* part_c;
};

// The column index of accumulator entry j = 2g + e of lane q: 8g + 2q + e.
__device__ __forceinline__ int col_of(int j, int q) {
  return 8 * (j / 2) + 2 * q + j % 2;
}

// x[j] of this thread combined with the 8 row-lanes of its column (lane
// bits 2-4) by `op`, in a fixed shuffle order.
template <class Op>
__device__ __forceinline__ void over_row_lanes(float (&x)[16], Op op) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x[j] = op(x[j], __shfl_xor_sync(0xffffffffu, x[j], off));
    }
  }
}

template <bool kSplit, bool kLoss>
__device__ __forceinline__ void dual_walk(const CUtensorMap* tm_rh,
                                          const CUtensorMap* tm_rl,
                                          const CUtensorMap* tm_ch,
                                          const CUtensorMap* tm_cl,
                                          const DualArgs& a, const Plan& p,
                                          int n_a, int n_b, int split_cols) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = sm90::aligned_smem(raw);
  uint64_t* bars = walk_barriers(smem, p);
  Ring ring(smem, bars, p);
  const int row0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int cb = split * split_cols;
  const int ce = min(cb + split_cols, n_b);
  const int tiles = (ce - cb + kTile - 1) / kTile;

  if (threadIdx.x >= kWarpgroup) {  // the producer warp
    if (threadIdx.x == kWarpgroup) {
      fwd_produce<kSplit>(smem, bars, p, ring, tm_rh, tm_rl, tm_ch, tm_cl,
                          row0, cb, tiles);
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  const int q = lane % 4;
  const float scale = __ldg(a.scale);
  float* col_stats = reinterpret_cast<float*>(smem + p.extra);
  bool live[2];
  float m[2], l[2], pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = row0 + r + 8 * h < n_a;
    m[h] = kNegInf;
    l[h] = 0.f;
    pos[h] = 0.f;
  }
  wait_rows(bars, p);
  for (int t = 0; t < tiles; ++t) {
    const int col0 = cb + t * kTile;
    float s[32];
    s_tile<kSplit>(smem, p, ring, s);

    // Entry i: row r + 8h, column col0 + col_of(j, q). Columns past the
    // split mask the row direction, rows past n_a the column direction;
    // an entry is read only in the direction whose output it feeds.
    float row_max[2] = {kNegInf, kNegInf};
    float col[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) col[j] = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const int j = 2 * (i / 4) + i % 2;
      const int c = col0 + col_of(j, q);
      const float x = s[i] * scale;
      if (kLoss && c < ce && c == row0 + r + 8 * h) pos[h] += x;
      s[i] = (c < ce && live[h]) ? x : kNegInf;
      row_max[h] = fmaxf(row_max[h], s[i]);
      col[j] = fmaxf(col[j], s[i]);
    }

    // The column direction: each column's max over the tile's rows, then
    // the sum of exp0(s - max).
    float* maxes = col_stats + (t & 1) * 2 * kColFloats;
    float* sums = maxes + kColFloats;
    over_row_lanes(col, [](float x, float y) { return fmaxf(x, y); });
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) maxes[warp * kTile + col_of(j, q)] = col[j];
    }
    consumers_sync();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col_of(j, q);
      col[j] = fmaxf(fmaxf(maxes[c], maxes[kTile + c]),
                     fmaxf(maxes[2 * kTile + c], maxes[3 * kTile + c]));
    }
    float sum[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = 2 * (i / 4) + i % 2;
      sum[j] += exp0(s[i] - col[j]);
    }
    over_row_lanes(sum, [](float x, float y) { return x + y; });
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) sums[warp * kTile + col_of(j, q)] = sum[j];
    }
    consumers_sync();
    const int c = threadIdx.x;
    if (c < kTile && col0 + c < ce) {
      const float mc = fmaxf(fmaxf(maxes[c], maxes[kTile + c]),
                             fmaxf(maxes[2 * kTile + c], maxes[3 * kTile + c]));
      const float lc = ((sums[c] + sums[kTile + c]) + sums[2 * kTile + c]) +
                       sums[3 * kTile + c];
      const size_t at = size_t(blockIdx.x) * n_b + col0 + c;
      a.part_c[at] = mc;
      a.part_c[size_t(gridDim.x) * n_b + at] = lc;
    }

    // The row direction, as #1's walk folds it.
    online_rows(s, row_max, m, l);
  }
  // The diagonal sits in at most one thread of the row's quad.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] += __shfl_xor_sync(0xffffffffu, pos[h], 1);
    pos[h] += __shfl_xor_sync(0xffffffffu, pos[h], 2);
    const int row = row0 + r + 8 * h;
    if (q == 0 && row < n_a) {
      const size_t plane = size_t(gridDim.y) * n_a;
      const size_t at = size_t(split) * n_a + row;
      a.part_r[at] = m[h];
      a.part_r[plane + at] = l[h];
      if (kLoss) a.part_r[2 * plane + at] = pos[h];
    }
  }
}

// Index i: row i's split partials folded in split order into lse_a[i],
// column i's row-tile partials in tile order into lse_b[i]. kLoss (square,
// n_a = n_b): the block's sum of (lse_a - pos) + (lse_b - pos) over its
// indices, in index order, into block_sum[blockIdx.x].
template <bool kLoss>
__device__ __forceinline__ void dual_merge(const float* __restrict__ part_r,
                                           const float* __restrict__ part_c,
                                           float* __restrict__ lse_a,
                                           float* __restrict__ lse_b,
                                           float* __restrict__ block_sum,
                                           int n_a, int n_b, int splits) {
  __shared__ float terms[kMergeThreads];
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  float term = 0.f;
  float pos = 0.f;
  if (i < n_a) {
    const size_t plane = size_t(splits) * n_a;
    float m = kNegInf;
    float l = 0.f;
    for (int c = 0; c < splits; ++c) {
      const size_t at = size_t(c) * n_a + i;
      fold_partial(m, l, part_r[at], part_r[plane + at]);
      if (kLoss) pos += part_r[2 * plane + at];
    }
    const float lse = m + logf(fmaxf(l, 1e-37f));
    lse_a[i] = lse;
    term = lse - pos;
  }
  if (i < n_b) {
    const int row_tiles = (n_a + kTile - 1) / kTile;
    const size_t plane = size_t(row_tiles) * n_b;
    float m = kNegInf;
    float l = 0.f;
    for (int t = 0; t < row_tiles; ++t) {
      const size_t at = size_t(t) * n_b + i;
      fold_partial(m, l, part_c[at], part_c[plane + at]);
    }
    const float lse = m + logf(fmaxf(l, 1e-37f));
    lse_b[i] = lse;
    term += lse - pos;
  }
  if constexpr (kLoss) {
    terms[threadIdx.x] = term;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int k = 0; k < kMergeThreads; ++k) sum += terms[k];
      block_sum[blockIdx.x] = sum;
    }
  }
}

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
  dual_walk<kSplit, true>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, a, p, n_a, n_b,
                          split_cols);
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
  dual_walk<kSplit, false>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, a, p, n_a, n_b,
                           split_cols);
}

__global__ void __launch_bounds__(kMergeThreads)
    infonce_fwd_rect_merge(const float* __restrict__ part_r,
                           const float* __restrict__ part_c,
                           float* __restrict__ lse_a,
                           float* __restrict__ lse_b, int n_a, int n_b,
                           int splits) {
  dual_merge<false>(part_r, part_c, lse_a, lse_b, nullptr, n_a, n_b, splits);
}

// Merge blocks of one call: an index each for max(n_a, n_b) indices.
int merge_blocks(int n_a, int n_b) {
  return ((n_a > n_b ? n_a : n_b) + kMergeThreads - 1) / kMergeThreads;
}

// The scratch of one call: the operand copies (fwd_carve), part_r 3 *
// splits * n_a, part_c 2 * ceil(n_a / 64) * n_b and block_sum
// ceil(max(n_a, n_b) / 256) fp32.
struct Buffers {
  FwdBuffers ops;
  float *part_r, *part_c, *block_sum;
};

Buffers carve(Carver& c, int n_a, int n_b, int d, bool split, int splits) {
  Buffers b{};
  b.ops = fwd_carve(c, n_a, n_b, d, split);
  b.part_r = c.take(size_t(3) * splits * n_a);
  b.part_c = c.take(size_t(2) * ((n_a + kTile - 1) / kTile) * n_b);
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
  const DualArgs args{static_cast<const float*>(a.scale), b.part_r,
                      b.part_c};
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
        b.part_r, b.part_c, a.lse_a, a.lse_b, b.block_sum, a.n_a, a.splits);
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
        b.part_r, b.part_c, a.lse_a, a.lse_b, a.n_a, a.n_b, a.splits);
  }
  return cudaGetLastError();
}

template <bool kLoss>
cudaError_t run(const Call& a, void* scratch, int dtype, int device,
                void* stream) {
  if (a.scale == nullptr || a.n_a < 1 || a.n_b < 1 || a.d < 1 ||
      a.d > kMaxD || !splits_cover(a.n_b, a.splits, a.split_cols) ||
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
