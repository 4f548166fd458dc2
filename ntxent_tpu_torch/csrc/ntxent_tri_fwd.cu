// NT-Xent triangular symmetric forward for Hopper (sm_90a) on TF32 tensor
// cores, bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _fwd_tri_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:237, launched by _fwd_tri_call at :308,
// pallas_call at :315), the forward of ntxent_loss_fused(triangular=True).
// For stacked views z (2N, D), as that kernel computes:
//   s[i, j]  = (z_i . z_j) * inv_t in fp32, the diagonal masked to -1e30;
//   lse[i]   = logsumexp_j s[i, j] (exp(min(s - m, 0)), m + log(max(l,
//              1e-37)));
//   loss_sum = sum_i (lse[i] - s[i, pos(i)]), pos(i) = (i + N) mod 2N.
// s is symmetric, so only the upper tiles (i <= j, in 64-row blocks) are
// formed, each folded into row block i directly and, for j > i, into row
// block j transposed: (2N)^2 D products, half of the rectangular #1's.
//
// Design. The TPU kernel carries running (m, l, p) of every row in
// full-length scratch across its sequential grid; Hopper blocks run in no
// order, so each output has one owner and the partials are merged after.
// Three launches and a one-warp reduce:
//   prep   z's TF32 hi and lo (one copy serves as rows and columns);
//   walk   the dual walk of dual_tf32.cuh (#9's and #7's) over the plan of
//          ops/ntxent.py's tri_runs: about one CTA an SM, each walking a
//          stretch of the upper tiles in row tiles 0, nb - 1, 1, nb - 2, ..
//          order, one piece (a run of consecutive column tiles j >= i) per
//          row tile it crosses; the row tile resident, the run's column
//          tiles through the TMA ring. Each s tile is formed once by wgmma
//          m64n64k8 (3xTF32 for fp32, one pass for bf16) and folded
//          * into the rows (TriMask::row_in: the column < 2N and not the
//            row): the run's online (m, l) and the positive of its 64 rows
//            of block i, one (m, l, pos) partial per (row, run);
//          * for j > i into the columns (col_in: the row < 2N and not the
//            column): each column's (max, sum exp0(s - max)) over the
//            tile's 64 rows, one (m, l) partial per (row tile i, column).
//            The diagonal tile's row pass covers both directions: it takes
//            no column pass and writes nothing there.
//          Positives: row k's positive, column pos(k), lies in its own row
//          direction when block(pos(k)) >= block(k) (the diagonal tile
//          included); otherwise it is the entry (pos(k), k), which row
//          pos(k) folds as its own positive in its row direction. The
//          merge reads it there: the same register of the same s tile, so
//          the column direction carries no positive plane;
//   merge  index k: the row partials of block(k)'s runs in run order, then
//          the column partials of row tiles t < block(k) in tile order
//          (fold_partial), lse = m + log(max(l, 1e-37)); the positive from
//          row k's runs or row pos(k)'s (as above); the block's sum of
//          lse - pos over its 64 indices in index order;
//   reduce one warp adds the blocks' sums in a fixed order.
// No atomics: the loss is bitwise repeatable. Partials: 3 (most runs of a
// row tile) 2N + 2 nb 2N fp32 (nb = ceil(2N / 64)): 0.13 MB at 2N = 512,
// 8.5 MB at 2N = 8192 (3 runs a row tile at most).
//
// Bound: (2N)^2 D operations (s once over the upper triangle), each
// product three TF32 passes in fp32 (the card's fastest fp32-accurate
// product, 165 TFLOP/s), against 2N D inputs and 2N + 1 fp32 outputs. At
// 2N = 512, D = 128: 33.6 MFLOP, 0.20 us (36 tiles, one a CTA: the
// launches bound it); at 2N = 8192: 8.6 GFLOP, 52 us (8256 tiles, 62.5 an
// SM).
//
// Supported: float32 or bfloat16 z, contiguous (2N, D), 2N even >= 2,
// 1 <= D <= kMaxWidth (past D = 256 in fp32, 512 in bf16, the row tile
// streams through the ring). The C entry point returns cudaGetLastError().

#include "dual_tf32.cuh"

namespace {

using namespace ntx;

__device__ __forceinline__ int pos_of(int row, int n) {
  return row < n / 2 ? row + n / 2 : row - n / 2;
}

// What the walk takes besides the maps and the layout: the plan, the
// partials (part_r: three planes (m, l, pos), each (slots, n); part_c: two
// planes (m, l), each (nb, n)) and 1/T.
struct TriArgs {
  TriPlan plan;
  float* part_r;
  float* part_c;
  float inv_t;
};

// The symmetric masks: an entry counts in the row direction unless its
// column is past 2N (or the piece) or is the row, in the column direction
// unless its row is past 2N or is the column; the positive of row r is
// column pos(r).
struct TriMask {
  int n, ce;
  int row[2], pos_col[2];

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r + 8 * h;
      pos_col[h] = row[h] < n ? pos_of(row[h], n) : -1;
    }
  }
  __device__ __forceinline__ void tile(int, int ce_, int) { ce = ce_; }
  __device__ __forceinline__ bool row_in(int h, int, int c) const {
    return c < ce && c != row[h];
  }
  __device__ __forceinline__ bool col_in(int h, int, int c) const {
    return row[h] < n && c != row[h];
  }
  __device__ __forceinline__ bool row_pos(int h, int, int c) const {
    return c == pos_col[h];
  }
};

// The kernels carry the wrapper's name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_fwd_tri_prep(const PrepPair<T> a) {
  prep_pair<T, kSplit>(a);
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_fwd_tri_walk(const __grid_constant__ CUtensorMap tm_rh,
                        const __grid_constant__ CUtensorMap tm_rl,
                        const __grid_constant__ CUtensorMap tm_ch,
                        const __grid_constant__ CUtensorMap tm_cl,
                        TriArgs a, Plan p, int n, int, int) {
  TriMask mask{n};
  dual_walk<kSplit, true>(&tm_rh, &tm_rl, &tm_ch, &tm_cl, mask, a.inv_t,
                          a.part_r, a.part_c, p, n, n, TriPieces(a.plan, n));
}

// Index k as the header says; the CTA's sum of lse - pos over its indices,
// in index order, into block_sum[blockIdx.x]. A CTA takes 64 indices (one
// row tile: 2N / 64 CTAs) and loads the column partials 8 row tiles at a
// time ahead of folding them, since the fold is a chain of nb steps.
__global__ void __launch_bounds__(kTile)
    ntxent_fwd_tri_merge(const float* __restrict__ part_r,
                         const float* __restrict__ part_c,
                         float* __restrict__ lse,
                         float* __restrict__ block_sum, TriPlan plan,
                         int n) {
  constexpr int kAhead = 8;
  __shared__ float terms[kTile];
  const int k = blockIdx.x * kTile + threadIdx.x;
  float term = 0.f;
  if (k < n) {
    const size_t plane_r = size_t(plan.slots) * n;
    const size_t plane_c = size_t(plan.nb) * n;
    const int bk = k / kTile;
    float m = kNegInf;
    float l = 0.f;
    for (int s = 0; s < plan.runs_of(bk); ++s) {
      const size_t at = size_t(s) * n + k;
      fold_partial(m, l, part_r[at], part_r[plane_r + at]);
    }
    for (int t0 = 0; t0 < bk; t0 += kAhead) {
      float mc[kAhead], lc[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const size_t at = size_t(t0 + u) * n + k;
        mc[u] = t0 + u < bk ? part_c[at] : kNegInf;
        lc[u] = t0 + u < bk ? part_c[plane_c + at] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (t0 + u < bk) fold_partial(m, l, mc[u], lc[u]);
      }
    }
    const float row_lse = m + logf(fmaxf(l, 1e-37f));
    lse[k] = row_lse;
    const int pk = pos_of(k, n);
    const int owner = pk / kTile >= bk ? k : pk;  // where the positive is
    float pos = 0.f;
    for (int s = 0; s < plan.runs_of(owner / kTile); ++s) {
      pos += part_r[2 * plane_r + size_t(s) * n + owner];
    }
    term = row_lse - pos;
  }
  terms[threadIdx.x] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < kTile; ++i) sum += terms[i];
    block_sum[blockIdx.x] = sum;
  }
}

__global__ void ntxent_fwd_tri_reduce(const float* __restrict__ block_sum,
                                      int count, float* __restrict__ loss) {
  reduce_sums(block_sum, count, loss);
}

// The scratch of one call: z's hi and lo (fwd_carve), part_r 3 * slots * n,
// part_c 2 * nb * n and block_sum nb fp32 (nb = ceil(n / 64)).
struct Buffers {
  FwdBuffers ops;
  float *part_r, *part_c, *block_sum;
};

Buffers carve(Carver& c, int n, int d, bool split, int slots) {
  Buffers b{};
  b.ops = fwd_carve(c, n, 0, d, split);
  b.part_r = c.take(size_t(3) * slots * n);
  b.part_c = c.take(size_t(2) * ((n + kTile - 1) / kTile) * n);
  b.block_sum = c.take((n + kTile - 1) / kTile);
  return b;
}

template <typename T>
cudaError_t launch(const T* z, const TriPlan& plan, const Buffers& b,
                   float* lse, float* loss, int n, int d, float inv_t,
                   cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const TriArgs args{plan, b.part_r, b.part_c, inv_t};
  cudaError_t err = fwd_launch<T>(
      z, nullptr, n, n, d, 1, n, b.ops, ntxent_fwd_tri_prep<T, kSplit>,
      ntxent_fwd_tri_walk<kSplit>, args, kColBytes, stream, plan.ctas);
  if (err != cudaSuccess) return err;
  ntxent_fwd_tri_merge<<<plan.nb, kTile, 0, stream>>>(
      b.part_r, b.part_c, lse, b.block_sum, plan, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ntxent_fwd_tri_reduce<<<1, 32, 0, stream>>>(b.block_sum, plan.nb, loss);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch one call takes (dtype 0: fp32, with lo copies); slots:
// the most runs a row tile has in the plan.
extern "C" long long ntx_ntxent_tri_fwd_scratch(int rows, int d, int dtype,
                                                int slots) {
  Carver c{nullptr};
  carve(c, rows, d, dtype == 0, slots);
  return static_cast<long long>(c.used);
}

// lse (rows,) fp32 and loss (one fp32, the loss SUM) of z (rows, d).
// plan: the device int32 table of TriPlan (ops/ntxent.py's tri_runs:
// `pieces` pieces over `ctas` CTAs, `slots` runs at most a row tile);
// `scratch` holds ntx_ntxent_tri_fwd_scratch(rows, d, dtype, slots)
// floats. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int ntx_ntxent_tri_fwd(const void* z, const void* plan,
                                  void* lse, void* loss, void* scratch,
                                  int rows, int d, int dtype, float inv_t,
                                  int pieces, int ctas, int slots, int device,
                                  void* stream) {
  if (rows < 2 || rows % 2 != 0 || !width_ok(d) || plan == nullptr ||
      pieces < ctas || ctas < 1 || slots < 1 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const TriPlan tp{static_cast<const int*>(plan), pieces, ctas, slots,
                   (rows + kTile - 1) / kTile};
  Carver c{static_cast<float*>(scratch)};
  const Buffers b = carve(c, rows, d, dtype == 0, slots);
  float* l = static_cast<float*>(lse);
  float* out = static_cast<float*>(loss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(static_cast<const float*>(z), tp, b, l, out, rows, d,
                  inv_t, s);
  }
  return launch(static_cast<const __nv_bfloat16*>(z), tp, b, l, out, rows, d,
                inv_t, s);
}
