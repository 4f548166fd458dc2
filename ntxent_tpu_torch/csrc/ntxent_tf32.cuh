// Hopper (sm_90a) TF32 tensor-core walk of the NT-Xent kernels #1
// (ntxent_fwd.cu: the symmetric and the general forward), #5 in its
// symmetric mode (ntxent_bwd_sym.cu), #6 (ntxent_bwd_general.cu: the
// general backward's rows and columns kernels), #5 in its cross-modal
// mode and #4 (infonce_cross_bwd.cuh: the data-parallel CLIP backward's
// rows and columns kernels), the CLIP kernels #9 (infonce_dual_fwd.cu:
// the dual forward, on #1's walk and launcher, fwd_launch) and #10
// (infonce_dual_bwd.cu: both cross-modal backward walks in one grid), and
// the shard-pair kernels #7 (ntxent_dual_stats.cu, #9's walk) and #8
// (ntxent_dual_grads.cu, #10's grid), and the triangular kernels #2
// (ntxent_tri_fwd.cu, #9's walk over the upper triangle) and #3
// (ntxent_tri_bwd.cu, #5's walk over the upper triangle with the
// transposed product); the two-sided walks of #2 and #7-#10 are
// dual_tf32.cuh's. The tensor-map encoder, TMA, the mbarriers and the
// K-major descriptor come from flash_attention_sm90.cuh.
//
// Operands. wgmma takes TF32 A and B only K-major, so an operand-prep
// kernel reads z once and writes fp32 copies laid out for TMA's 128-byte
// swizzle: hi = z rounded to TF32 (cvt.rna) and, for fp32 z, lo = z - hi
// (exact), as (rows, Dp) matrices, Dp = D rounded up to 32 (one 128-byte
// swizzle row; zeros past D, so every D takes the same boxes and no row
// stride breaks TMA's 16-byte rule). The backward also writes the other
// side transposed, (DT, Cp) with Cp = rows rounded up to
// 64 and DT = Dp rounded up to the chunk of D one CTA accumulates (32,
// 64 or 128), as the K-major B of grad = G . z. bf16 z widens exactly
// (lo = 0, not written or read).
//
// 3xTF32. A product of fp32 x and y is hi_x hi_y + (hi_x lo_y + lo_x
// hi_y), the small terms summed in an accumulator of their own and added
// last: about 22 bits, where one TF32 pass keeps 11 (2^-11 of each
// operand). lo_x lo_y (2^-22) is dropped; the tensor core reads lo's top
// 19 bits.
//
// Walk. One CTA (a consumer warpgroup and a producer warp) owns 64 rows
// and one split of the columns (ops/ntxent.py's planner, about one wave of
// the SMs); a triangular CTA walks a few such pieces one after another
// (Pieces below). The producer's lane 0 streams the split's 64-column tiles
// through a ring of stages in K boxes of 32 columns (8 KB of hi and 8 KB
// of lo a box). The row tile (hi, lo) is loaded once and kept when it
// leaves room for two stages (make_plan): fp32 up to D = 256, where it
// takes 128 KB beside 4 stages of 16 KB (the backward: 2 stages of 32 KB
// beside 32 KB of sums), and bf16 up to 512. Past that (fp32 from D =
// 288, bf16 from 544: a row tile of 144 KB or more, beyond a CTA's 227 KB
// with a ring) the row tile's K boxes come through the ring beside the
// column tile's, a stage holding both (32 KB fp32, 16 KB bf16), and are
// read again from L2 for every column tile: the products per stage stay
// those of a resident tile, and the shared memory no longer grows with D.
// So any D runs: the widths past 512 (CLIP ViT-L/14's 768, ViT-H/14's
// 1024) only add K boxes to the walk and, in a backward, chunks of D to
// the grid (each forms s again). s =
// z_r z_c^T is wgmma m64n64k8 from shared memory; each thread holds rows
// r = 16 warp + lane / 4 and r + 8, columns 8i + 2q and 8i + 2q + 1 (q =
// lane % 4) of every 8-column group.
//
// Masks (Ids: a policy; SymIds and GeneralIds): a column whose id is >=
// cols_actual or, in the NT-Xent mode, equals the row's id is -1e30; a
// column past the split or past C has no id (kNoColumn, masked); a row
// past R takes the sentinel id cols_actual and adds no loss. The positive
// of a row is the column whose id is positive(gid): the paired view
// (gid +- n_half) in the NT-Xent mode, the diagonal (gid itself) in the
// InfoNCE mode (diag_pos, _masked_sim_tile :96-112 and _pos_gid :115-123
// of ntxent_pallas.py), where the diagonal is not masked.
//
// Logit scale. The general kernels take an fp32 scale from a device
// pointer (null: 1); every consumer thread reads it once and folds it
// into 1/T (inv_t * scale, as the TPU kernel reads it from SMEM, :151),
// so a learnable scale costs no host sync.

#pragma once

#include "flash_attention_sm90.cuh"

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace ntx {

using sm90::bar_arrive;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_init_fence;
using sm90::bar_wait;
using sm90::desc_k;
using sm90::hold;
using sm90::tma_box_2d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait_all;

constexpr int kTile = 64;                     // rows of a tile
constexpr int kBoxK = 32;                     // fp32 of one 128-byte row
constexpr int kBoxBytes = kTile * kBoxK * 4;  // one 64-row K box, 8 KB
constexpr int kMaxStages = 4;
constexpr int kMaxGridY = 65535;  // the y and z dimensions of a grid
// The widest D: a backward's grid holds at most kMaxGridY chunks of D of
// 128 columns in its third dimension (the operand prep loops past its
// own grid, prep_tiles).
constexpr int kMaxWidth = kMaxGridY * 128;
constexpr int kSmemMax = 232448;  // shared memory one block may use
constexpr int kWarpgroup = sm90::kWarpgroup;
constexpr int kThreads = sm90::kThreads;  // the warpgroup + the producer
constexpr int kPrepThreads = 256;         // a 32 x 32 tile, 8 rows a pass
constexpr int kMergeThreads = 256;        // rows of one merge CTA
constexpr float kNegInf = -1e30f;
constexpr int kNoColumn = INT_MAX;  // id of a column past the split or C
constexpr int kRowsFree = 1 + 2 * kMaxStages;  // barrier: the row tile read

// --- layout, shared by the host and the kernels -------------------------

__host__ __device__ constexpr int padded_d(int d) {
  return (d + kBoxK - 1) / kBoxK * kBoxK;
}
// Columns of D one backward CTA accumulates (the N of grad's wgmma).
__host__ __device__ constexpr int d_chunk(int d) {
  return padded_d(d) <= 32 ? 32 : padded_d(d) <= 64 ? 64 : 128;
}
__host__ __device__ constexpr int padded_dt(int d) {
  return (padded_d(d) + d_chunk(d) - 1) / d_chunk(d) * d_chunk(d);
}
__host__ __device__ constexpr int padded_cols(int n) {
  return (n + kTile - 1) / kTile * kTile;
}
// An embedding width the kernels take: 1 <= D <= kMaxWidth.
inline bool width_ok(int d) { return d >= 1 && d <= kMaxWidth; }
// The prep grid's y: one block row for each 32-column K tile of `cols`
// columns, at most kMaxGridY (prep_tiles loops over the rest).
inline int prep_grid_y(int cols) {
  return cols / 32 < kMaxGridY ? cols / 32 : kMaxGridY;
}

// The dynamic shared memory of a walk: the row tile (hi, then lo: Dp / 32
// boxes each) unless it streams, `stages` ring slots, `extra` bytes of
// the kernel's own, then the barriers (the row tile's, full[kMaxStages],
// empty[kMaxStages], and the row tile's free barrier, kRowsFree). A launch
// asks 1024 bytes more to align the base to the swizzle's 1024-byte
// boundary.
struct Plan {
  int nkb;         // K boxes of a row
  int box_bytes;   // one K box of a 64-row tile: hi, then lo for fp32
  int row_bytes;   // the resident row tile; 0: its boxes stream
  int slot_bytes;  // one ring stage
  int stages;
  int extra;       // offset of the kernel's own bytes
  int bars;        // offset of the barriers
  int bytes;
  __host__ __device__ bool streams() const { return row_bytes == 0; }
};

// `other_slot`: the largest other load the kernel puts in one stage.
inline Plan make_plan(int d, bool split, int other_slot = 0,
                      int extra = 0) {
  Plan p;
  p.nkb = padded_d(d) / kBoxK;
  p.box_bytes = kBoxBytes * (split ? 2 : 1);
  p.row_bytes = p.nkb * p.box_bytes;
  const int bar_bytes = (kRowsFree + 1) * 8;
  const int room = kSmemMax - 1024 - bar_bytes - extra;
  int slot = p.box_bytes > other_slot ? p.box_bytes : other_slot;
  if (room - p.row_bytes < 2 * slot) {  // stream the row boxes too
    p.row_bytes = 0;
    slot = 2 * p.box_bytes > other_slot ? 2 * p.box_bytes : other_slot;
  }
  p.slot_bytes = slot;
  const int left = room - p.row_bytes;
  p.stages = left / slot < kMaxStages ? left / slot : kMaxStages;
  p.extra = p.row_bytes + p.stages * slot;
  p.bars = p.extra + extra;
  p.bytes = p.bars + bar_bytes;
  return p;
}

// The kernels' scratch is one fp32 allocation of the size the library's
// *_scratch entry point reports, cut into runs on 128-byte boundaries
// (TMA needs 16); with a null base it only counts.
struct Carver {
  float* base;
  size_t used = 0;
  float* take(size_t n) {
    float* at = base != nullptr && n > 0 ? base + used : nullptr;
    used += (n + 31) / 32 * 32;
    return at;
  }
};

// --- device: numbers ------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away
// from zero), as fp32 bits.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(out) : "f"(x));
  return out;
}

// exp(min(x, 0)) with the accurate expf: lse and G carry the fp32
// contract of the TPU kernel.
__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

// --- device: the operand-prep pass ----------------------------------------

// One 32 x 32 tile of z (rows c0 .., columns k0 ..): hi (and lo) into the
// (rows, Dp) copies; with hi_t, also into the transposed (DT, Cp) copies,
// whose columns are permuted within each group of 8: position p holds row
// (p & ~7) | (2 (p & 3) + (p >> 2 & 1)). That is the K order in which the
// fp32 accumulator of s, turned into G, is already a TF32 A fragment (see
// the backward).
template <typename T, bool kSplit>
__device__ __forceinline__ void prep_tile_at(const T* __restrict__ z, int n,
                                             int d, float* __restrict__ hi,
                                             float* __restrict__ lo,
                                             float* __restrict__ hi_t,
                                             float* __restrict__ lo_t, int c0,
                                             int k0) {
  __shared__ float tile[32][33];
  const int dp = padded_d(d);
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  for (int y = ty; y < 32; y += kPrepThreads / 32) {
    const int c = c0 + y;
    const int k = k0 + tx;
    const float x = (c < n && k < d) ? to_float(z[size_t(c) * d + k]) : 0.f;
    tile[y][tx] = x;
    if (c < n && k < dp) {
      const float h = __uint_as_float(tf32_bits(x));
      hi[size_t(c) * dp + k] = h;
      if constexpr (kSplit) lo[size_t(c) * dp + k] = x - h;
    }
  }
  if (hi_t == nullptr) return;
  __syncthreads();
  const int cp = padded_cols(n);
  const int src = (tx & ~7) | (2 * (tx & 3) + ((tx >> 2) & 1));
  for (int y = ty; y < 32; y += kPrepThreads / 32) {
    const float x = tile[src][y];
    const size_t at = size_t(k0 + y) * cp + c0 + tx;
    const float h = __uint_as_float(tf32_bits(x));
    hi_t[at] = h;
    if constexpr (kSplit) lo_t[at] = x - h;
  }
}

// The tiles at c0 of the K tiles k0 = 32 blockIdx.y, in strides of the
// grid's y, up to Dp (DT with a transposed copy): a grid of at most
// kMaxGridY rows covers any D (prep_grid_y).
template <typename T, bool kSplit>
__device__ __forceinline__ void prep_tiles(const T* __restrict__ z, int n,
                                           int d, float* __restrict__ hi,
                                           float* __restrict__ lo,
                                           float* __restrict__ hi_t,
                                           float* __restrict__ lo_t, int c0) {
  const int k_end = hi_t != nullptr ? padded_dt(d) : padded_d(d);
  for (int k0 = blockIdx.y * 32; k0 < k_end; k0 += gridDim.y * 32) {
    prep_tile_at<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t, c0, k0);
    __syncthreads();  // the next K tile reuses the staging tile
  }
}

// The tiles at c0 = 32 blockIdx.x.
template <typename T, bool kSplit>
__device__ __forceinline__ void prep_tile(const T* __restrict__ z, int n,
                                          int d, float* __restrict__ hi,
                                          float* __restrict__ lo,
                                          float* __restrict__ hi_t,
                                          float* __restrict__ lo_t) {
  prep_tiles<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t, blockIdx.x * 32);
}

// Two operands prepared in one launch: the first `blocks0` blocks of the
// grid's x take side 0, the rest side 1 (null hi_t: no transposed copy).
template <typename T>
struct PrepPair {
  const T* z[2];
  int n[2];
  float* hi[2];
  float* lo[2];
  float* hi_t[2];
  float* lo_t[2];
  int d, blocks0;
};

template <typename T, bool kSplit>
__device__ __forceinline__ void prep_pair(const PrepPair<T>& a) {
  const bool one = static_cast<int>(blockIdx.x) >= a.blocks0;
  const int x = one ? blockIdx.x - a.blocks0 : blockIdx.x;
  prep_tiles<T, kSplit>(one ? a.z[1] : a.z[0], one ? a.n[1] : a.n[0], a.d,
                        one ? a.hi[1] : a.hi[0], one ? a.lo[1] : a.lo[0],
                        one ? a.hi_t[1] : a.hi_t[0],
                        one ? a.lo_t[1] : a.lo_t[0], x * 32);
}

// --- device: the masking and positive policies ----------------------------

// The symmetric layout: rows and columns are the same n vectors, their ids
// their indices; the NT-Xent mode.
struct SymIds {
  int n;
  __device__ __forceinline__ int row(int r) const { return r < n ? r : n; }
  __device__ __forceinline__ int col(int c) const { return c; }
  __device__ __forceinline__ int cols_actual() const { return n; }
  __device__ __forceinline__ bool diag_pos() const { return false; }
  __device__ __forceinline__ int positive(int gid) const {
    return gid < n / 2 ? gid + n / 2 : gid - n / 2;
  }
};

// The general mode: rows with ids row_gid, columns with ids col_gid (null:
// the column index); with `diag`, the InfoNCE mode.
struct GeneralIds {
  const int* row_gid;
  const int* col_gid;
  int n_rows, actual, n_half, diag;
  __device__ __forceinline__ int row(int r) const {
    return r < n_rows ? row_gid[r] : actual;
  }
  __device__ __forceinline__ int col(int c) const {
    return col_gid ? col_gid[c] : c;
  }
  __device__ __forceinline__ int cols_actual() const { return actual; }
  __device__ __forceinline__ bool diag_pos() const { return diag != 0; }
  __device__ __forceinline__ int positive(int gid) const {
    if (diag) return gid;
    return gid < n_half ? gid + n_half : gid - n_half;
  }
};

// _masked_sim_tile's rule, whatever the ids.
template <class Ids>
__device__ __forceinline__ bool masked(const Ids& ids, int id, int gid) {
  return id >= ids.cols_actual() || (!ids.diag_pos() && id == gid);
}

// G of the symmetric backward (#5, and #3 over the upper triangle): p_row -
// pos + p_col - pos, zero on a column past the piece and on a row past n;
// a bwd_walk policy (see there). G is symmetric: G[a, b] = G[b, a].
struct SymG {
  const float* __restrict__ lse;
  int n;
  float inv_t;
  int row[2], pos_col[2];
  float lse_r[2];
  float lse_c[16];  // entry 2i + e: column col0 + 8i + 2q + e

  __device__ __forceinline__ void rows(int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r + 8 * h;
      pos_col[h] = row[h] < n / 2 ? row[h] + n / 2 : row[h] - n / 2;
      lse_r[h] = row[h] < n ? lse[row[h]] : 0.f;
    }
  }
  __device__ __forceinline__ void tile(int col0, int ce, int q) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * (j / 2) + 2 * q + j % 2;
      lse_c[j] = col < ce ? lse[col] : 0.f;
    }
  }
  __device__ __forceinline__ float g(float s, int i, int h, int col,
                                     bool live) const {
    const float x = (!live || col == row[h]) ? kNegInf : s * inv_t;
    const float pos = col == pos_col[h] ? 1.f : 0.f;
    const float out = (exp0(x - lse_r[h]) - pos) +
                      (exp0(x - lse_c[2 * (i / 4) + i % 2]) - pos);
    return (!live || row[h] >= n) ? 0.f : out;
  }
};

// 1/T times the logit scale at `scale` (null: 1/T itself).
__device__ __forceinline__ float scaled_inv_t(float inv_t,
                                              const float* scale) {
  return scale != nullptr ? inv_t * __ldg(scale) : inv_t;
}

// A partial (m_c, l_c) folded into (m, l): m = max, l = l e^(m - m') +
// l_c e^(m_c - m') (the merge rule of every split or tile partial).
__device__ __forceinline__ void fold_partial(float& m, float& l, float m_c,
                                             float l_c) {
  const float m_new = fmaxf(m, m_c);
  l = l * exp0(m - m_new) + l_c * exp0(m_c - m_new);
  m = m_new;
}

// The consumer warpgroup's own barrier (named barrier 1; the producer warp
// takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWarpgroup) : "memory");
}

// This thread's shared-memory stores made visible to the async proxy
// (wgmma's operand reads) before a barrier hands them over.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- device: the pieces a CTA walks -----------------------------------------

// One piece of a walk: the 64-row tile `tile`, the columns (a backward: the
// other side's rows) cb .. ce - 1 against it, and the slot of its row
// partials (the split, or the run of a triangular row tile).
struct Piece {
  int tile, cb, ce, slot;
};

// The one piece of a CTA of a split grid (#1, #4-#10): its row tile and
// split; row_slots splits and col_slots row tiles size the partials.
struct SplitPiece {
  static constexpr bool kSelf = false;  // rows and columns differ (TriPieces)
  Piece piece;
  int row_slots, col_slots;
  __device__ __forceinline__ int count() const { return 1; }
  __device__ __forceinline__ Piece at(int) const { return piece; }
};

__device__ __forceinline__ SplitPiece split_piece(int tile, int split,
                                                  int split_cols, int n_cols,
                                                  int splits, int tiles) {
  const int cb = split * split_cols;
  return {{tile, cb, min(cb + split_cols, n_cols), split}, splits, tiles};
}

// The triangular kernels' plan (ops/ntxent.py's tri_runs) as one int32
// table on the device: `pieces` rows of (row tile i, first column tile
// j0 >= i, tiles, slot), numbered CTA by CTA; then the first piece of each
// CTA (ctas + 1 entries); then the pieces of each of the nb row tiles. A
// row tile's pieces (its runs) take slots 0, 1, .. in column order;
// `slots` is the most any row tile has.
struct TriPlan {
  const int* table;
  int pieces, ctas, slots, nb;
  __device__ __forceinline__ int runs_of(int tile) const {
    return __ldg(table + 4 * pieces + ctas + 1 + tile);
  }
};

// The pieces of CTA blockIdx.x of a triangular walk over n vectors: the
// upper tiles (i, j), j >= i, of its stretch, each row tile's in one
// piece. kSelf: the rows are the columns, so the diagonal tile (col0 ==
// row0) is folded in the row direction only, and each tile off it is also
// its mirror (j, i).
struct TriPieces {
  static constexpr bool kSelf = true;
  const int* first;  // this CTA's first piece
  int n_pieces, n, row_slots, col_slots;

  __device__ __forceinline__ TriPieces(const TriPlan& plan, int n_)
      : n(n_), row_slots(plan.slots), col_slots(plan.nb) {
    const int* start = plan.table + 4 * plan.pieces + blockIdx.x;
    const int a = __ldg(start);
    first = plan.table + 4 * a;
    n_pieces = __ldg(start + 1) - a;
  }
  __device__ __forceinline__ int count() const { return n_pieces; }
  __device__ __forceinline__ Piece at(int k) const {
    const int* e = first + 4 * k;
    const int j0 = __ldg(e + 1);
    return {__ldg(e), j0 * kTile, min((j0 + __ldg(e + 2)) * kTile, n),
            __ldg(e + 3)};
  }
  // The slot of tile (i, j), j > i, among the nb (nb - 1) / 2 tiles above
  // the diagonal in row-major order.
  __device__ __forceinline__ int tile_slot(int i, int j) const {
    return i * col_slots - i * (i + 1) / 2 + j - i - 1;
  }
};

// --- device: TF32 wgmma ---------------------------------------------------

// d[64 x 64] (+)= A . B in TF32, A and B both K-major in shared memory
// (the only layout TF32 takes).
__device__ __forceinline__ void mma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 32] (+)= A . B in TF32, A and B both K-major in shared memory.
__device__ __forceinline__ void mma_tf32_ss_n32(float (&d)[16], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= A . B in TF32, A and B both K-major in shared memory.
__device__ __forceinline__ void mma_tf32_ss_n128(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] (+)= A . B for N = 32, 64 or 128, both from shared memory.
template <int N>
__device__ __forceinline__ void mma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int accumulate) {
  if constexpr (N == 32) {
    mma_tf32_ss_n32(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    mma_tf32_ss_n64(d, a, b, accumulate);
  } else {
    mma_tf32_ss_n128(d, a, b, accumulate);
  }
}

// d[64 x 32] (+)= A . B in TF32, A in registers (a[0..3]: rows r and
// r + 8 at K q and q + 4, q = lane % 4), B K-major in shared memory.
__device__ __forceinline__ void mma_tf32_rs_n32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[64 x 64] (+)= A . B in TF32, A in registers (a[0..3]: rows r and
// r + 8 at K q and q + 4, q = lane % 4), B K-major in shared memory.
__device__ __forceinline__ void mma_tf32_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[64 x 128] (+)= A . B in TF32, A in registers (a[0..3]: rows r and
// r + 8 at K q and q + 4, q = lane % 4), B K-major in shared memory.
__device__ __forceinline__ void mma_tf32_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[64 x N] (+)= A . B for N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void mma_tf32_rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  if constexpr (N == 32) {
    mma_tf32_rs_n32(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    mma_tf32_rs_n64(d, a, b, accumulate);
  } else {
    mma_tf32_rs_n128(d, a, b, accumulate);
  }
}

// --- device: the walk -------------------------------------------------------

// The barriers of a walk; every thread calls this before the producer and
// the consumers part.
__device__ __forceinline__ uint64_t* walk_barriers(unsigned char* smem,
                                                   const Plan& p) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bars);
  if (threadIdx.x == 0) {
    bar_init(bars, 1);
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(&bars[1 + s], 1);
      bar_init(&bars[1 + kMaxStages + s], kWarpgroup);
    }
    bar_init(&bars[kRowsFree], kWarpgroup);
    bar_init_fence();
  }
  __syncthreads();
  return bars;
}

// The ring: the it-th load or read goes to slot it % stages, its phase
// parity (it / stages) & 1.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, slot_bytes, it;

  __device__ __forceinline__ Ring(unsigned char* smem, uint64_t* bars,
                                  const Plan& p)
      : base(smem + p.row_bytes), full(bars + 1), empty(bars + 1 + kMaxStages),
        stages(p.stages), slot_bytes(p.slot_bytes), it(0) {}

  // Producer: wait until slot it is free, announce `bytes`, return it.
  __device__ __forceinline__ unsigned char* load(uint32_t bytes,
                                                 uint64_t** bar) {
    const int s = it % stages;
    if (it >= stages) bar_wait(&empty[s], (it / stages - 1) & 1);
    *bar = &full[s];
    bar_expect(*bar, bytes);
    ++it;
    return base + s * slot_bytes;
  }
  // Consumer: wait until slot it has landed.
  __device__ __forceinline__ const unsigned char* acquire() {
    const int s = it % stages;
    bar_wait(&full[s], (it / stages) & 1);
    return base + s * slot_bytes;
  }
  __device__ __forceinline__ void release() {
    bar_arrive(&empty[it % stages]);
    ++it;
  }
};

// Producer: the row tile's boxes (hi, then lo) at row0, when it stays.
template <bool kSplit>
__device__ __forceinline__ void load_rows(unsigned char* smem,
                                          uint64_t* bar, const Plan& p,
                                          const CUtensorMap* hi,
                                          const CUtensorMap* lo, int row0) {
  if (p.streams()) return;
  bar_expect(bar, p.row_bytes);
  for (int kb = 0; kb < p.nkb; ++kb) {
    tma_box_2d(smem + kb * kBoxBytes, hi, bar, kb * kBoxK, row0);
    if constexpr (kSplit) {
      tma_box_2d(smem + (p.nkb + kb) * kBoxBytes, lo, bar, kb * kBoxK, row0);
    }
  }
}

// Consumer: wait for the row tile of the CTA's piece-th piece (Pieces
// below), when it stays.
__device__ __forceinline__ void wait_rows(uint64_t* bars, const Plan& p,
                                          int piece = 0) {
  if (!p.streams()) bar_wait(bars, piece & 1);
}

// Consumer: the last s tile of a piece has read the row tile, which the
// producer may now overwrite with the next piece's.
__device__ __forceinline__ void free_rows(uint64_t* bars, const Plan& p) {
  if (!p.streams()) bar_arrive(&bars[kRowsFree]);
}

// Producer: before loading the row tile of the piece-th piece (> 0), wait
// until the consumers have read the previous one.
__device__ __forceinline__ void wait_rows_free(uint64_t* bars, const Plan& p,
                                               int piece) {
  if (!p.streams()) bar_wait(&bars[kRowsFree], (piece - 1) & 1);
}

// Producer: the K boxes (hi, lo) of the 64-column tile at col0, each in a
// stage of its own; a streaming row tile's box (at row0) beside it.
template <bool kSplit>
__device__ __forceinline__ void load_cols(Ring& ring, const Plan& p,
                                          const CUtensorMap* hi,
                                          const CUtensorMap* lo, int col0,
                                          const CUtensorMap* row_hi,
                                          const CUtensorMap* row_lo,
                                          int row0) {
  const bool rows = p.streams();
  for (int kb = 0; kb < p.nkb; ++kb) {
    uint64_t* bar;
    unsigned char* slot = ring.load(p.box_bytes * (rows ? 2 : 1), &bar);
    tma_box_2d(slot, hi, bar, kb * kBoxK, col0);
    if constexpr (kSplit) {
      tma_box_2d(slot + kBoxBytes, lo, bar, kb * kBoxK, col0);
    }
    if (rows) {
      tma_box_2d(slot + p.box_bytes, row_hi, bar, kb * kBoxK, row0);
      if constexpr (kSplit) {
        tma_box_2d(slot + p.box_bytes + kBoxBytes, row_lo, bar, kb * kBoxK,
                   row0);
      }
    }
  }
}

// Producer of a forward walk (#1, #9): the row tile, when it stays, then
// the split's `tiles` column tiles from column cb on.
template <bool kSplit>
__device__ __forceinline__ void fwd_produce(unsigned char* smem,
                                            uint64_t* bars, const Plan& p,
                                            Ring& ring,
                                            const CUtensorMap* tm_rh,
                                            const CUtensorMap* tm_rl,
                                            const CUtensorMap* tm_ch,
                                            const CUtensorMap* tm_cl,
                                            int row0, int cb, int tiles) {
  load_rows<kSplit>(smem, bars, p, tm_rh, tm_rl, row0);
  for (int t = 0; t < tiles; ++t) {
    load_cols<kSplit>(ring, p, tm_ch, tm_cl, cb + t * kTile, tm_rh, tm_rl,
                      row0);
  }
}

// Consumer: s = z_rows . z_cols^T of the row tile and the next column tile
// in the ring (fp32 accumulator fragment), 3xTF32 for fp32 z.
template <bool kSplit>
__device__ __forceinline__ void s_tile(const unsigned char* rows,
                                       const Plan& p, Ring& ring,
                                       float (&s)[32]) {
  float small[32];
  for (int kb = 0; kb < p.nkb; ++kb) {
    const unsigned char* hi = ring.acquire();
    const unsigned char* lo = hi + kBoxBytes;
    const unsigned char* a_hi =
        p.streams() ? hi + p.box_bytes : rows + kb * kBoxBytes;
    const unsigned char* a_lo =
        p.streams() ? a_hi + kBoxBytes : rows + (p.nkb + kb) * kBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int acc = kb > 0 || kk > 0;
      if constexpr (kSplit) {
        mma_tf32_ss_n64(small, desc_k(a_hi, kk), desc_k(lo, kk), acc);
        mma_tf32_ss_n64(small, desc_k(a_lo, kk), desc_k(hi, kk), 1);
      }
      mma_tf32_ss_n64(s, desc_k(a_hi, kk), desc_k(hi, kk), acc);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    if constexpr (kSplit) hold(small);
    ring.release();
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += small[i];
  }
}

// The row direction of one tile, as the forward walks (#1, #9) fold it:
// s is the masked, scaled accumulator fragment (row r + 8h, column 8 (i /
// 4) + 2q + i % 2), row_max[h] the max of the thread's entries of row r +
// 8h. The row's four lanes (q) combine by shuffle; then the online fold m'
// = max(m, tile max), l = l e^(m - m') + sum exp0(s - m').
__device__ __forceinline__ void online_rows(const float (&s)[32],
                                            float (&row_max)[2],
                                            float (&m)[2], float (&l)[2]) {
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_max[h] = fmaxf(row_max[h],
                       __shfl_xor_sync(0xffffffffu, row_max[h], 1));
    row_max[h] = fmaxf(row_max[h],
                       __shfl_xor_sync(0xffffffffu, row_max[h], 2));
    row_max[h] = fmaxf(m[h], row_max[h]);  // m'
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) % 2;
    row_sum[h] += exp0(s[i] - row_max[h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    l[h] = l[h] * expf(m[h] - row_max[h]) + row_sum[h];
    m[h] = row_max[h];
  }
}

// --- device: the backward walk ---------------------------------------------

// grad[own] = sum over a piece's columns of G[own, col] z_other[col], for
// the pieces of one CTA (Pieces: one (64-row tile of own, column split), or
// the runs of a triangular stretch) and one chunk of ND columns of D
// (`chunk`). Per 64-column tile: s = z_own z_other^T as the forward forms
// it, G in its place from the policy, G's TF32 hi and lo (G is fp32, not
// exact in TF32), and grad += G . z_other by wgmma m64nNDk8 with G as the
// register A operand and the transposed other side, two K boxes of 32
// columns, as B: three products for fp32 (G_lo z_hi, G_hi z_lo, then G_hi
// z_hi), two for bf16 (z_lo = 0).
//
// G from registers. The fp32 accumulator holds row r's columns 2q and
// 2q + 1 of each 8-column group (q = lane % 4); a TF32 A fragment holds K
// q and q + 4. So the prep pass stores the transposed z with each group's
// columns in the order (0, 2, 4, 6, 1, 3, 5, 7): K index q + 4e is column
// 2q + e, and the accumulator's registers d[4i], d[4i + 2], d[4i + 1],
// d[4i + 3] are the A fragment of k8 step i as they lie.
//
// Sums. The tensor core adds into its fp32 accumulator without rounding
// to nearest, so a long chain of products drifts (4e-5 on the gradient at
// 2N = 8192 on an H100 over a 3072-product chain). Each 64-column tile
// therefore starts a fresh accumulator, and each thread adds it to its own
// running sum in shared memory (ND / 2 floats a thread, p.extra on) with
// a rounded fp32 add: 24 products to a chain.
//
// The transposed product (Pieces::kSelf, the triangular #3: own and other
// are z, G symmetric). A tile (i, j) off the diagonal is also its mirror
// (j, i), whose G is G^T: grad[block j] += G^T . z_i. TF32 wgmma takes A
// only K-major, so G^T goes through shared memory (store_gt, 32 KB after
// the running sums) and z_i's transposed halves come through the ring
// after z_j's (L2 hits). The product starts a fresh accumulator (the
// direct one's registers, already added to the sums), runs its 64 K
// steps, 24 products to a chain, and goes to the tile's own slot of
// out_t ((nb (nb - 1) / 2, 64, d) fp32, TriPieces::tile_slot).
//
// The policy G (one per kernel) holds what G needs besides s:
//   rows(row0 + r): the thread's own rows r and r + 8 (h = 0, 1);
//   tile(col0, ce, q): the tile's columns 8i + 2q + e (entry 2i + e),
//     those at or past ce not live;
//   g(s, i, h, col, live): G of accumulator entry i (row r + 8h, column
//     col = col0 + 8 (i / 4) + 2q + i % 2) from the raw product s.
// Rows past n_own and columns past n_other come in from TMA as zeros.
// out: (slots, n_own, d) fp32, a piece's sums at its slot; with one split
// the gradient itself.
template <bool kSplit, int ND>
__device__ __forceinline__ void load_halves(Ring& ring,
                                            const CUtensorMap* ht,
                                            const CUtensorMap* lt, int col0,
                                            int d0) {
  constexpr int kHalfBytes = ND * 128;  // one K box of the transposed tile
  for (int half = 0; half < 2; ++half) {
    uint64_t* bar;
    unsigned char* slot = ring.load(kHalfBytes * (kSplit ? 2 : 1), &bar);
    tma_box_2d(slot, ht, bar, col0 + half * kBoxK, d0);
    if constexpr (kSplit) {
      tma_box_2d(slot + kHalfBytes, lt, bar, col0 + half * kBoxK, d0);
    }
  }
}

// The shared memory of G^T (store_gt): two 8 KB K boxes of hi, two of lo.
constexpr int kGtBytes = 4 * kBoxBytes;

// G's TF32 hi and lo of one tile, transposed into shared memory as the
// K-major A operand of G^T . z_own: M = the tile's 64 columns, K = its 64
// rows in the transposed copy's order (position k of each group of 8
// holds row (k & ~7) | (2 (k & 3) + (k >> 2 & 1)), prep_tile_at), in the
// 128-byte swizzle that desc_k reads (16-byte chunk c of 128-byte row m at
// chunk c ^ (m & 7)). Entry 4g + 2h + e (row r + 8h, column 8g + 2q + e)
// lies g 1024-byte row groups past the entry of column 2q + e: four
// addresses a thread. A warp's stores hit 32 distinct banks. The
// warpgroup syncs before (the last tile's product has read the buffer)
// and after (every thread's part is in), the async-proxy fence between
// the stores and wgmma's reads.
__device__ __forceinline__ void store_gt(unsigned char* gt,
                                         const uint32_t (&g_hi)[32],
                                         const uint32_t (&g_lo)[32], int r,
                                         int q) {
  consumers_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;  // K
    const int k = (row & ~7) | ((row & 1) << 2) | ((row >> 1) & 3);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 2 * q + e;  // M
      unsigned char* at = gt + (k / kBoxK) * kBoxBytes + col * 128 +
                          ((((k % kBoxK) / 4) ^ col) * 16) + (k % 4) * 4;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        *reinterpret_cast<uint32_t*>(at + g * 1024) = g_hi[4 * g + 2 * h + e];
        *reinterpret_cast<uint32_t*>(at + 2 * kBoxBytes + g * 1024) =
            g_lo[4 * g + 2 * h + e];
      }
    }
  }
  fence_async_shared();
  consumers_sync();
}

template <bool kSplit, int ND, class G, class Pieces>
__device__ __forceinline__ void bwd_walk_pieces(
    const CUtensorMap* own_h, const CUtensorMap* own_l,
    const CUtensorMap* oth_h, const CUtensorMap* oth_l,
    const CUtensorMap* oth_ht, const CUtensorMap* oth_lt, G& g,
    float* __restrict__ out, float* __restrict__ out_t, const Plan& p,
    int n_own, int d, const Pieces& pieces, int chunk) {
  constexpr bool kTrans = Pieces::kSelf;
  constexpr int kHalfBytes = ND * 128;  // one K box of the transposed tile
  extern __shared__ unsigned char raw[];
  unsigned char* smem = sm90::aligned_smem(raw);
  uint64_t* bars = walk_barriers(smem, p);
  Ring ring(smem, bars, p);
  const int d0 = chunk * ND;
  const int count = pieces.count();

  if (threadIdx.x >= kWarpgroup) {  // the producer warp
    if (threadIdx.x == kWarpgroup) {
      for (int k = 0; k < count; ++k) {
        const Piece pc = pieces.at(k);
        const int row0 = pc.tile * kTile;
        if (k > 0) wait_rows_free(bars, p, k);
        load_rows<kSplit>(smem, bars, p, own_h, own_l, row0);
        for (int col0 = pc.cb; col0 < pc.ce; col0 += kTile) {
          load_cols<kSplit>(ring, p, oth_h, oth_l, col0, own_h, own_l, row0);
          load_halves<kSplit, ND>(ring, oth_ht, oth_lt, col0, d0);
          if (kTrans && col0 != row0) {
            load_halves<kSplit, ND>(ring, oth_ht, oth_lt, row0, d0);
          }
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  const int q = lane % 4;
  float acc[ND / 2];
  // This thread's running sum of acc[j], at sum[j * kWarpgroup + tid].
  float* sum = reinterpret_cast<float*>(smem + p.extra) + threadIdx.x;
  unsigned char* gt = smem + p.extra + ND * kWarpgroup * 2;  // kTrans: G^T

  for (int k = 0; k < count; ++k) {
    const Piece pc = pieces.at(k);
    const int row0 = pc.tile * kTile;
    const int tiles = (pc.ce - pc.cb + kTile - 1) / kTile;
    g.rows(row0 + r);
#pragma unroll
    for (int j = 0; j < ND / 2; ++j) sum[j * kWarpgroup] = 0.f;

    wait_rows(bars, p, k);
    for (int t = 0; t < tiles; ++t) {
      const int col0 = pc.cb + t * kTile;
      g.tile(col0, pc.ce, q);
      float s[32];
      s_tile<kSplit>(smem, p, ring, s);
      if (t == tiles - 1) free_rows(bars, p);

      // G in place of s, split into TF32 hi and lo.
      uint32_t g_hi[32], g_lo[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // row r + 8h, column 8 (i / 4) + 2q + i % 2
        const int h = (i / 2) % 2;
        const int col = col0 + 8 * (i / 4) + 2 * q + i % 2;
        const float x = g.g(s[i], i, h, col, col < pc.ce);
        g_hi[i] = tf32_bits(x);
        g_lo[i] = __float_as_uint(x - __uint_as_float(g_hi[i]));
      }
      const bool trans = kTrans && col0 != row0;  // tile-uniform
      if (trans) store_gt(gt, g_hi, g_lo, r, q);

      for (int half = 0; half < 2; ++half) {
        const unsigned char* zt_hi = ring.acquire();
        const unsigned char* zt_lo = zt_hi + kHalfBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int i = 4 * half + kk;  // k8 step: columns 8i .. 8i + 7
          const uint32_t a_hi[4] = {g_hi[4 * i], g_hi[4 * i + 2],
                                    g_hi[4 * i + 1], g_hi[4 * i + 3]};
          const uint32_t a_lo[4] = {g_lo[4 * i], g_lo[4 * i + 2],
                                    g_lo[4 * i + 1], g_lo[4 * i + 3]};
          mma_tf32_rs<ND>(acc, a_lo, desc_k(zt_hi, kk), i > 0);
          if constexpr (kSplit) {
            mma_tf32_rs<ND>(acc, a_hi, desc_k(zt_lo, kk), 1);
          }
          mma_tf32_rs<ND>(acc, a_hi, desc_k(zt_hi, kk), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
        hold(g_hi);
        hold(g_lo);
        ring.release();
      }
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) sum[j * kWarpgroup] += acc[j];

      if constexpr (kTrans) {
        if (trans) {  // grad[block j] += G^T . z_i, rows col0 .. col0 + 63
          for (int half = 0; half < 2; ++half) {
            const unsigned char* zt_hi = ring.acquire();
            const unsigned char* zt_lo = zt_hi + kHalfBytes;
            const unsigned char* a_hi = gt + half * kBoxBytes;
            const unsigned char* a_lo = a_hi + 2 * kBoxBytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              mma_tf32_ss<ND>(acc, desc_k(a_lo, kk), desc_k(zt_hi, kk),
                              half > 0 || kk > 0);
              if constexpr (kSplit) {
                mma_tf32_ss<ND>(acc, desc_k(a_hi, kk), desc_k(zt_lo, kk), 1);
              }
              mma_tf32_ss<ND>(acc, desc_k(a_hi, kk), desc_k(zt_hi, kk), 1);
            }
            wgmma_commit();
            wgmma_wait_all();
            hold(acc);
            ring.release();
          }
          // acc[4i + 2h + e]: row col0 + r + 8h, column d0 + 8i + 2q + e;
          // with D even, the pair e = 0, 1 as one 8-byte store.
          float* o = out_t + size_t(pieces.tile_slot(pc.tile, col0 / kTile)) *
                                 kTile * d;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            if (col0 + row >= n_own) continue;
            float* dst = o + size_t(row) * d;
#pragma unroll
            for (int i = 0; i < ND / 8; ++i) {
              const int kc = d0 + 8 * i + 2 * q;
              if (d % 2 == 0) {
                if (kc < d) {
                  *reinterpret_cast<float2*>(dst + kc) =
                      make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
                }
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (kc + e < d) dst[kc + e] = acc[4 * i + 2 * h + e];
                }
              }
            }
          }
        }
      }
    }
    // sum[4i + 2h + e]: row r + 8h, column d0 + 8i + 2q + e of grad.
#pragma unroll
    for (int i = 0; i < ND / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = d0 + 8 * i + 2 * q + e;
          if (row < n_own && kc < d) {
            out[(size_t(pc.slot) * n_own + row) * d + kc] =
                sum[(4 * i + 2 * h + e) * kWarpgroup];
          }
        }
      }
    }
  }
}

// The walk of one CTA of a split grid: the 64-row tile `tile` of own
// against the columns of split `split`, one chunk of D.
template <bool kSplit, int ND, class G>
__device__ __forceinline__ void bwd_walk_at(
    const CUtensorMap* own_h, const CUtensorMap* own_l,
    const CUtensorMap* oth_h, const CUtensorMap* oth_l,
    const CUtensorMap* oth_ht, const CUtensorMap* oth_lt, G& g,
    float* __restrict__ out, const Plan& p, int n_own, int n_other, int d,
    int split_cols, int tile, int split, int chunk) {
  bwd_walk_pieces<kSplit, ND>(
      own_h, own_l, oth_h, oth_l, oth_ht, oth_lt, g, out, nullptr, p, n_own,
      d, split_piece(tile, split, split_cols, n_other, 0, 0), chunk);
}

// The CTA's tile, split and chunk from blockIdx.x, .y and .z.
template <bool kSplit, int ND, class G>
__device__ __forceinline__ void bwd_walk(const CUtensorMap* own_h,
                                         const CUtensorMap* own_l,
                                         const CUtensorMap* oth_h,
                                         const CUtensorMap* oth_l,
                                         const CUtensorMap* oth_ht,
                                         const CUtensorMap* oth_lt, G& g,
                                         float* __restrict__ out,
                                         const Plan& p, int n_own,
                                         int n_other, int d,
                                         int split_cols) {
  bwd_walk_at<kSplit, ND>(own_h, own_l, oth_h, oth_l, oth_ht, oth_lt, g, out,
                          p, n_own, n_other, d, split_cols, blockIdx.x,
                          blockIdx.y, blockIdx.z);
}

// Each gradient entry: the splits' partials added in split order.
__device__ __forceinline__ void split_sum(const float* __restrict__ part,
                                          float* __restrict__ grad,
                                          size_t count, int splits) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < count;
       i += size_t(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int s = 1; s < splits; ++s) sum += part[s * count + i];
    grad[i] = sum;
  }
}

// Blocks of 256 threads of a split sum over `count` entries.
inline int sum_blocks(size_t count) {
  const size_t blocks = (count + 255) / 256;
  return blocks < 1024 ? static_cast<int>(blocks) : 1024;
}

// The ring stage a backward takes for one half of the transposed tile,
// and the bytes of its running sums.
template <int ND>
constexpr int bwd_half_bytes(bool split) {
  return ND * 128 * (split ? 2 : 1);
}
template <int ND>
constexpr int bwd_sum_bytes() {
  return ND * kWarpgroup * 2;
}

// --- host: one general backward launch (#6, #5 cross-modal, #4) ------------

// The scratch of one launch: own's hi and lo (n_own, Dp), the other side's
// hi and lo (n_other, Dp) and their transposes (DT, Cp) fp32 (Dp = D
// rounded up to 32, DT = Dp rounded up to d_chunk(D), Cp = n_other rounded
// up to 64; the lo copies only for fp32 inputs), and with more than one
// split the partial gradients, splits * n_own * D fp32.
struct BwdBuffers {
  float *own_h, *own_l, *oth_h, *oth_l, *oth_ht, *oth_lt, *part;
};

inline BwdBuffers bwd_carve(Carver& c, int n_own, int n_other, int d,
                            bool split, int splits) {
  BwdBuffers b{};
  const size_t own = size_t(n_own) * padded_d(d);
  const size_t oth = size_t(n_other) * padded_d(d);
  const size_t oth_t = size_t(padded_dt(d)) * padded_cols(n_other);
  b.own_h = c.take(own);
  b.own_l = c.take(split ? own : 0);
  b.oth_h = c.take(oth);
  b.oth_l = c.take(split ? oth : 0);
  b.oth_ht = c.take(oth_t);
  b.oth_lt = c.take(split ? oth_t : 0);
  b.part = c.take(splits > 1 ? size_t(splits) * n_own * d : 0);
  return b;
}

// Floats of scratch one launch takes (dtype 0: fp32, with lo copies).
inline long long bwd_scratch_floats(int n_own, int n_other, int d, int dtype,
                                    int splits) {
  Carver c{nullptr};
  bwd_carve(c, n_own, n_other, d, dtype == 0, splits);
  return static_cast<long long>(c.used);
}

// n columns (a backward: the other side's rows) cut into `splits` runs of
// `split_cols`, the last one shorter, each non-empty.
inline bool splits_cover(int n, int splits, int split_cols) {
  return splits >= 1 && split_cols >= 1 &&
         static_cast<long long>(splits - 1) * split_cols < n &&
         static_cast<long long>(splits) * split_cols >= n;
}

// The hi and lo maps of a (rows, Dp) operand copy in 64-row K boxes (lo:
// hi again for bf16, whose lo is neither written nor read).
template <bool kSplit>
cudaError_t operand_maps(CUtensorMap* h, CUtensorMap* l, const float* hi,
                         const float* lo, int rows, int d) {
  cudaError_t err =
      sm90::tensor_map_f32(h, hi, padded_d(d), rows, kBoxK, kTile);
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(l, kSplit ? lo : hi, padded_d(d), rows, kBoxK,
                               kTile);
  }
  return err;
}

// The six tensor maps of a backward walk.
struct BwdMaps {
  CUtensorMap own_h, own_l, oth_h, oth_l, oth_ht, oth_lt;
};

template <bool kSplit, int ND>
cudaError_t bwd_maps(BwdMaps* m, const BwdBuffers& b, int n_own,
                     int n_other, int d) {
  const int cp = padded_cols(n_other);
  const int dt = padded_dt(d);
  cudaError_t err =
      operand_maps<kSplit>(&m->own_h, &m->own_l, b.own_h, b.own_l, n_own, d);
  if (err == cudaSuccess) {
    err = operand_maps<kSplit>(&m->oth_h, &m->oth_l, b.oth_h, b.oth_l,
                               n_other, d);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&m->oth_ht, b.oth_ht, cp, dt, kBoxK, ND);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&m->oth_lt, kSplit ? b.oth_lt : b.oth_ht, cp,
                               dt, kBoxK, ND);
  }
  return err;
}

// The plan of a backward walk at chunk ND: its ring stages hold the
// transposed halves beside the K boxes, its own bytes are the running sums.
template <int ND>
Plan bwd_plan(int d, bool split) {
  return make_plan(d, split, bwd_half_bytes<ND>(split), bwd_sum_bytes<ND>());
}

// One backward of a side: the operand prep of own and of the other side
// (also transposed), their six tensor maps, the walk over (64-row tiles of
// own, splits, chunks of D) and, with more than one split, the sum of the
// partials. The walk kernel takes the six maps, the kernel's own `args`,
// the output, the plan, n_own, n_other, d and split_cols.
template <typename T, int ND, class Prep, class Walk, class Sum, class Args>
cudaError_t bwd_launch(const void* own, const void* other, int n_own,
                       int n_other, int d, int splits, int split_cols,
                       float* grad, const BwdBuffers& b, Prep prep, Walk walk,
                       Sum sum, const Args& args, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int dp = padded_d(d);
  const int dt = padded_dt(d);
  const int cp = padded_cols(n_other);
  prep<<<dim3((n_own + 31) / 32, prep_grid_y(dp)), kPrepThreads, 0,
         stream>>>(static_cast<const T*>(own), n_own, d, b.own_h, b.own_l,
                   nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prep<<<dim3(cp / 32, prep_grid_y(dt)), kPrepThreads, 0, stream>>>(
      static_cast<const T*>(other), n_other, d, b.oth_h, b.oth_l, b.oth_ht,
      b.oth_lt);
  err = cudaGetLastError();
  BwdMaps m;
  if (err == cudaSuccess) err = bwd_maps<kSplit, ND>(&m, b, n_own, n_other, d);
  const Plan p = bwd_plan<ND>(d, kSplit);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(walk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes + 1024);
  }
  if (err != cudaSuccess) return err;
  walk<<<dim3((n_own + kTile - 1) / kTile, splits, dt / ND), kThreads,
         p.bytes + 1024, stream>>>(m.own_h, m.own_l, m.oth_h, m.oth_l,
                                   m.oth_ht, m.oth_lt, args,
                                   splits == 1 ? grad : b.part, p, n_own,
                                   n_other, d, split_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = size_t(n_own) * d;
  sum<<<sum_blocks(count), 256, 0, stream>>>(b.part, grad, count, splits);
  return cudaGetLastError();
}

// --- host: one forward walk launch (#1, #9) ---------------------------------

// The operand copies of a forward: the rows' hi and lo (n_rows, Dp) and
// the columns' (n_cols, Dp; none when the columns are the rows, n_cols =
// 0), fp32, the lo copies only for fp32 inputs.
struct FwdBuffers {
  float *hi_r, *lo_r, *hi_c, *lo_c;
};

inline FwdBuffers fwd_carve(Carver& c, int n_rows, int n_cols, int d,
                            bool split) {
  FwdBuffers b{};
  const size_t dp = padded_d(d);
  b.hi_r = c.take(n_rows * dp);
  b.lo_r = c.take(split ? n_rows * dp : 0);
  b.hi_c = c.take(n_cols * dp);
  b.lo_c = c.take(split ? n_cols * dp : 0);
  return b;
}

// One forward walk: the operand prep of the rows and, unless they are the
// rows (cols null), of the columns in one launch, their tensor maps, and
// the walk over (64-row tiles, column splits), or over `ctas` CTAs of a
// triangular plan. The prep kernel takes a PrepPair; the walk kernel the
// rows' and the columns' maps (hi, lo), the kernel's own `args`, the plan,
// n_rows, n_cols and split_cols. `extra`: the walk's own bytes of shared
// memory beside the ring.
template <typename T, class Prep, class Walk, class Args>
cudaError_t fwd_launch(const T* rows, const T* cols, int n_rows, int n_cols,
                       int d, int splits, int split_cols, const FwdBuffers& b,
                       Prep prep, Walk walk, const Args& args, int extra,
                       cudaStream_t stream, int ctas = 0) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int blocks_r = (n_rows + 31) / 32;
  const int blocks_c = cols != nullptr ? (n_cols + 31) / 32 : 0;
  const PrepPair<T> pair{{rows, cols},       {n_rows, n_cols},
                         {b.hi_r, b.hi_c},   {b.lo_r, b.lo_c},
                         {nullptr, nullptr}, {nullptr, nullptr},
                         d,                  blocks_r};
  prep<<<dim3(blocks_r + blocks_c, prep_grid_y(padded_d(d))), kPrepThreads,
         0, stream>>>(pair);
  cudaError_t err = cudaGetLastError();
  CUtensorMap rh, rl, ch, cl;
  if (err == cudaSuccess) {
    err = operand_maps<kSplit>(&rh, &rl, b.hi_r, b.lo_r, n_rows, d);
  }
  if (cols == nullptr) {
    ch = rh;
    cl = rl;
  } else if (err == cudaSuccess) {
    err = operand_maps<kSplit>(&ch, &cl, b.hi_c, b.lo_c, n_cols, d);
  }
  const Plan p = make_plan(d, kSplit, 0, extra);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(walk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes + 1024);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid = ctas > 0 ? dim3(ctas)
                             : dim3((n_rows + kTile - 1) / kTile, splits);
  walk<<<grid, kThreads, p.bytes + 1024, stream>>>(rh, rl, ch, cl, args, p,
                                                   n_rows, n_cols,
                                                   split_cols);
  return cudaGetLastError();
}

// One warp sums `count` partial sums in a fixed order.
__device__ __forceinline__ void reduce_sums(const float* __restrict__ sums,
                                            int count,
                                            float* __restrict__ out) {
  float sum = 0.f;
  for (int i = threadIdx.x; i < count; i += 32) sum += sums[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (threadIdx.x == 0) out[0] = sum;
}

}  // namespace ntx
