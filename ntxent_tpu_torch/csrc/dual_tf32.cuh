// The two-sided walks of one tile on the TF32 walk of ntxent_tf32.cuh:
// the dual statistics walk, which forms each s tile once and folds it
// into both directions (#9, infonce_dual_fwd.cu; #7, ntxent_dual_stats.cu;
// #2, ntxent_tri_fwd.cu, over the upper triangle), and the backward of
// both sides in one grid (#10, infonce_dual_bwd.cu; #8,
// ntxent_dual_grads.cu).
//
// Dual statistics (dual_walk, dual_merge). One CTA per (64-row tile of
// za, split of zb's columns), or per stretch of a triangular plan (its
// pieces, ntxent_tf32.cuh), forms s = za . zb^T * mul for each 64-column
// tile of its piece (s_tile: 3xTF32 wgmma for fp32, one pass for bf16)
// and folds it both ways in the same registers:
//   columns: each column's max over the tile's 64 rows and the sum of
//     exp0(s - max) against it. A CTA visits a column tile once, so this
//     needs no rescale, only a reduction over rows: a thread's two rows,
//     the 8 row-lanes of its column (shuffles over lane bits 2-4), then the
//     4 warps through shared memory (two 2 KB buffers by tile parity, so
//     one barrier a phase suffices), summed in warp order. One (m, l)
//     partial per column and row tile;
//   rows: then s turns, in place, into the row direction's entries and
//     takes #1's online fold (online_rows): one (m, l) partial per row and
//     split, and with kLoss the positive (#9's square diagonal, #2's
//     paired view).
// s is held once whatever the two directions mask. A mask policy (one per
// kernel) says which entries count in which direction:
//   rows(row0 + r): the thread's own rows r and r + 8 (h = 0, 1);
//   tile(col0, ce, q): the tile's columns col0 + col_of(j, q) (entry j),
//     those at or past ce past the split or past n_b;
//   col_in(h, j, c) / row_in(h, j, c): whether the entry of row r + 8h and
//     column c = col0 + col_of(j, q) counts in the column / row direction;
//     one that does not is -1e30 there;
//   row_pos(h, j, c) (kLoss): whether that entry is the row's positive.
// The merge folds, for index i, row i's split partials in split order and
// column i's row-tile partials in tile order (fold_partial) and closes
// each as m + log(max(l, 1e-37)): a direction whose every entry is masked
// ends at -1e30, finite, as on the TPU. One owner per output, no atomics.
//
// Both sides in one grid (dual_grid, dual_cta, dual_bwd_launch). Side a
// owns za's rows (its other side zb), side b owns zb's rows (its other
// side za); each is a bwd_walk_at over (64-row tile of its own side, split
// of its other side, chunk of D) with a G policy of the kernel's, and each
// side has its own split plan. The leading CTAs of blockIdx.x take side a
// (x = split * tiles + tile), the rest side b; blockIdx.y is the chunk of
// D. One prep writes za's and zb's TF32 hi and lo and both transposes
// (PrepPair); with more than one split on a side, one sum kernel adds the
// splits of both outputs in split order.

#pragma once

#include "ntxent_tf32.cuh"

namespace ntx {

constexpr int kWarps = kWarpgroup / 32;  // the consumer warps
// The column reduction's shared memory beside the ring: per tile parity,
// the warps' column maxima, then their sums, 64 columns a warp.
constexpr int kColFloats = kWarps * kTile;
constexpr int kColBytes = 2 * 2 * kColFloats * 4;

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

// The walk of one CTA over its pieces (Pieces of ntxent_tf32.cuh: the one
// (64-row tile of za, split) of a split grid, or the runs of a triangular
// stretch). part_r: planes (m, l) and with kLoss (pos), each (row_slots,
// n_a), a piece's at its slot; part_c: planes (m, l), each (col_slots,
// n_b), a tile's at its row tile. With Pieces::kSelf the rows are the
// columns: the diagonal tile (col0 == row0) takes no column pass (its row
// pass covers both directions) and writes no column partial; the column
// passes alternate their two buffers whatever tiles they skip. kLoss adds
// each row's positive (mask.row_pos) in its row partial.
template <bool kSplit, bool kLoss, class M, class Pieces>
__device__ __forceinline__ void dual_walk(const CUtensorMap* tm_rh,
                                          const CUtensorMap* tm_rl,
                                          const CUtensorMap* tm_ch,
                                          const CUtensorMap* tm_cl, M& mask,
                                          float mul,
                                          float* __restrict__ part_r,
                                          float* __restrict__ part_c,
                                          const Plan& p, int n_a, int n_b,
                                          const Pieces& pieces) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = sm90::aligned_smem(raw);
  uint64_t* bars = walk_barriers(smem, p);
  Ring ring(smem, bars, p);
  const int count = pieces.count();

  if (threadIdx.x >= kWarpgroup) {  // the producer warp
    if (threadIdx.x == kWarpgroup) {
      for (int k = 0; k < count; ++k) {
        const Piece pc = pieces.at(k);
        if (k > 0) wait_rows_free(bars, p, k);
        fwd_produce<kSplit>(smem, bars, p, ring, tm_rh, tm_rl, tm_ch, tm_cl,
                            pc.tile * kTile, pc.cb,
                            (pc.ce - pc.cb + kTile - 1) / kTile);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  const int q = lane % 4;
  float* col_stats = reinterpret_cast<float*>(smem + p.extra);
  int passes = 0;  // column passes so far; the parity picks the buffers
  for (int k = 0; k < count; ++k) {
    const Piece pc = pieces.at(k);
    const int row0 = pc.tile * kTile;
    const int tiles = (pc.ce - pc.cb + kTile - 1) / kTile;
    mask.rows(row0 + r);
    float m[2], l[2], pos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
      pos[h] = 0.f;
    }
    wait_rows(bars, p, k);
    for (int t = 0; t < tiles; ++t) {
      const int col0 = pc.cb + t * kTile;
      mask.tile(col0, pc.ce, q);
      float s[32];
      s_tile<kSplit>(smem, p, ring, s);
      if (t == tiles - 1) free_rows(bars, p);

      // Entry i: row r + 8h, column col0 + col_of(j, q). First the column
      // direction: each column's max over the tile's rows, then the sum of
      // exp0(s - max), its masked entries at -1e30.
      float col[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) col[j] = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        const int j = 2 * (i / 4) + i % 2;
        const int c = col0 + col_of(j, q);
        s[i] *= mul;
        if constexpr (kLoss) {
          if (mask.row_pos(h, j, c)) pos[h] += s[i];
        }
        if (mask.col_in(h, j, c)) col[j] = fmaxf(col[j], s[i]);
      }
      if (!Pieces::kSelf || col0 != row0) {  // tile-uniform
        float* maxes = col_stats + (passes++ & 1) * 2 * kColFloats;
        float* sums = maxes + kColFloats;
        over_row_lanes(col, [](float x, float y) { return fmaxf(x, y); });
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            maxes[warp * kTile + col_of(j, q)] = col[j];
          }
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
          const int h = (i / 2) % 2;
          const int j = 2 * (i / 4) + i % 2;
          const float x =
              mask.col_in(h, j, col0 + col_of(j, q)) ? s[i] : kNegInf;
          sum[j] += exp0(x - col[j]);
        }
        over_row_lanes(sum, [](float x, float y) { return x + y; });
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            sums[warp * kTile + col_of(j, q)] = sum[j];
          }
        }
        consumers_sync();
        const int c = threadIdx.x;
        if (c < kTile && col0 + c < pc.ce) {
          const float mc =
              fmaxf(fmaxf(maxes[c], maxes[kTile + c]),
                    fmaxf(maxes[2 * kTile + c], maxes[3 * kTile + c]));
          const float lc = ((sums[c] + sums[kTile + c]) + sums[2 * kTile + c]) +
                           sums[3 * kTile + c];
          const size_t at = size_t(pc.tile) * n_b + col0 + c;
          part_c[at] = mc;
          part_c[size_t(pieces.col_slots) * n_b + at] = lc;
        }
      }

      // Then the row direction, in place, as #1's walk folds it.
      float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        const int j = 2 * (i / 4) + i % 2;
        s[i] = mask.row_in(h, j, col0 + col_of(j, q)) ? s[i] : kNegInf;
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
      if (q == 0 && row < n_a) {
        const size_t plane = size_t(pieces.row_slots) * n_a;
        const size_t at = size_t(pc.slot) * n_a + row;
        part_r[at] = m[h];
        part_r[plane + at] = l[h];
        if (kLoss) part_r[2 * plane + at] = pos[h];
      }
    }
  }
}

// The one piece of CTA (blockIdx.x, blockIdx.y) of a split grid of the
// dual walk: row tile blockIdx.x of za, split blockIdx.y of zb's n_b
// columns.
__device__ __forceinline__ SplitPiece dual_split(int n_b, int split_cols) {
  return split_piece(blockIdx.x, blockIdx.y, split_cols, n_b, gridDim.y,
                     gridDim.x);
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

// Merge blocks of one call: an index each for max(n_a, n_b) indices.
inline int merge_blocks(int n_a, int n_b) {
  return ((n_a > n_b ? n_a : n_b) + kMergeThreads - 1) / kMergeThreads;
}

// The partials of a dual walk: part_r `planes` * splits * n_a (2, or 3
// with the loss's pos), part_c 2 * ceil(n_a / 64) * n_b fp32.
struct DualParts {
  float *part_r, *part_c;
};

inline DualParts dual_carve(Carver& c, int n_a, int n_b, int splits,
                            int planes) {
  DualParts b{};
  b.part_r = c.take(size_t(planes) * splits * n_a);
  b.part_c = c.take(size_t(2) * ((n_a + kTile - 1) / kTile) * n_b);
  return b;
}

// --- both sides of a backward in one grid (#10, #8) -------------------------

// The grid: side a owns za's n_a rows (its other side zb, cut into
// splits_a runs of split_cols_a), side b owns zb's n_b rows (its other side
// za, cut into splits_b runs of split_cols_b); d is the embedding width.
struct DualGrid {
  int n_a, n_b, d;
  int tiles_a, splits_a, split_cols_a;
  int tiles_b, splits_b, split_cols_b;
};

inline DualGrid dual_grid(int n_a, int n_b, int d, int splits_a,
                          int split_cols_a, int splits_b, int split_cols_b) {
  return {n_a, n_b, d,
          (n_a + kTile - 1) / kTile, splits_a, split_cols_a,
          (n_b + kTile - 1) / kTile, splits_b, split_cols_b};
}

// This CTA's side (b: false for side a) and its tile and split there.
struct DualCta {
  bool b;
  int tile, split;
};

__device__ __forceinline__ DualCta dual_cta(const DualGrid& g) {
  const int ctas_a = g.tiles_a * g.splits_a;
  const bool b = static_cast<int>(blockIdx.x) >= ctas_a;
  const int x = b ? blockIdx.x - ctas_a : blockIdx.x;
  const int tiles = b ? g.tiles_b : g.tiles_a;
  return {b, x % tiles, x / tiles};
}

// Each entry of o_a, then of o_b, of a side with more than one split: the
// splits' partials added in split order.
__device__ __forceinline__ void dual_sum(const float* __restrict__ part_a,
                                         const float* __restrict__ part_b,
                                         float* __restrict__ o_a,
                                         float* __restrict__ o_b,
                                         const DualGrid& g) {
  if (g.splits_a > 1) {
    split_sum(part_a, o_a, size_t(g.n_a) * g.d, g.splits_a);
  }
  if (g.splits_b > 1) {
    split_sum(part_b, o_b, size_t(g.n_b) * g.d, g.splits_b);
  }
}

// The scratch of a two-sided backward: za's and zb's hi and lo (n, Dp)
// and their transposes (DT, Cp) fp32 (the lo copies only for fp32), and
// each side's split partials (splits * n * D fp32 with more than one
// split). Side a reads za as own and zb as the other side, side b the
// reverse.
struct DualBwdBuffers {
  BwdBuffers a, b;
};

inline DualBwdBuffers dual_bwd_carve(Carver& c, int n_a, int n_b, int d,
                                     bool split, int splits_a,
                                     int splits_b) {
  const size_t ops_a = size_t(n_a) * padded_d(d);
  const size_t ops_b = size_t(n_b) * padded_d(d);
  const size_t ops_at = size_t(padded_dt(d)) * padded_cols(n_a);
  const size_t ops_bt = size_t(padded_dt(d)) * padded_cols(n_b);
  DualBwdBuffers x{};
  x.a.own_h = x.b.oth_h = c.take(ops_a);  // za
  x.a.own_l = x.b.oth_l = c.take(split ? ops_a : 0);
  x.b.own_h = x.a.oth_h = c.take(ops_b);  // zb
  x.b.own_l = x.a.oth_l = c.take(split ? ops_b : 0);
  x.b.oth_ht = c.take(ops_at);  // za^T
  x.b.oth_lt = c.take(split ? ops_at : 0);
  x.a.oth_ht = c.take(ops_bt);  // zb^T
  x.a.oth_lt = c.take(split ? ops_bt : 0);
  x.a.part = c.take(splits_a > 1 ? size_t(splits_a) * n_a * d : 0);
  x.b.part = c.take(splits_b > 1 ? size_t(splits_b) * n_b * d : 0);
  return x;
}

// One two-sided backward: the prep of za and zb (PrepPair, with both
// transposes), both sides' tensor maps, one walk launch over both sides
// and, with more than one split on a side, one sum. The walk kernel takes
// side a's and side b's maps, the kernel's own `args`, the two outputs
// (or partials), the plan and the grid; the sum kernel the two partials,
// the two outputs and the grid.
template <typename T, int ND, class Prep, class Walk, class Sum, class Args>
cudaError_t dual_bwd_launch(const void* za, const void* zb, const DualGrid& g,
                            float* o_a, float* o_b, const DualBwdBuffers& b,
                            Prep prep, Walk walk, Sum sum, const Args& args,
                            cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int blocks_a = padded_cols(g.n_a) / 32;
  const int blocks_b = padded_cols(g.n_b) / 32;
  const PrepPair<T> pair{
      {static_cast<const T*>(za), static_cast<const T*>(zb)},
      {g.n_a, g.n_b},
      {b.a.own_h, b.b.own_h},
      {b.a.own_l, b.b.own_l},
      {b.b.oth_ht, b.a.oth_ht},
      {b.b.oth_lt, b.a.oth_lt},
      g.d,
      blocks_a};
  prep<<<dim3(blocks_a + blocks_b, prep_grid_y(padded_dt(g.d))),
         kPrepThreads, 0,
         stream>>>(pair);
  cudaError_t err = cudaGetLastError();
  BwdMaps ma, mb;
  if (err == cudaSuccess) {
    err = bwd_maps<kSplit, ND>(&ma, b.a, g.n_a, g.n_b, g.d);
  }
  if (err == cudaSuccess) {
    err = bwd_maps<kSplit, ND>(&mb, b.b, g.n_b, g.n_a, g.d);
  }
  const Plan p = bwd_plan<ND>(g.d, kSplit);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(walk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes + 1024);
  }
  if (err != cudaSuccess) return err;
  const bool one_a = g.splits_a == 1;
  const bool one_b = g.splits_b == 1;
  walk<<<dim3(g.tiles_a * g.splits_a + g.tiles_b * g.splits_b,
              padded_dt(g.d) / ND),
         kThreads, p.bytes + 1024, stream>>>(ma, mb, args,
                                             one_a ? o_a : b.a.part,
                                             one_b ? o_b : b.b.part, p, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || (one_a && one_b)) return err;
  const size_t count_a = size_t(g.n_a) * g.d;
  const size_t count_b = size_t(g.n_b) * g.d;
  sum<<<sum_blocks(count_a > count_b ? count_a : count_b), 256, 0, stream>>>(
      b.a.part, b.b.part, o_a, o_b, g);
  return cudaGetLastError();
}

}  // namespace ntx
