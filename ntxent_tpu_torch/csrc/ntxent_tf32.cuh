// Hopper (sm_90a) TF32 tensor-core walk of the NT-Xent kernels #1
// (ntxent_fwd.cu: the symmetric and the general forward) and #5 in its
// symmetric mode (ntxent_bwd_sym.cu). The tensor-map encoder, TMA, the
// mbarriers and the K-major descriptor come from flash_attention_sm90.cuh.
//
// Operands. wgmma takes TF32 A and B only K-major, so an operand-prep
// kernel reads z once and writes fp32 copies laid out for TMA's 128-byte
// swizzle: hi = z rounded to TF32 (cvt.rna) and, for fp32 z, lo = z - hi
// (exact), as (rows, Dp) matrices, Dp = D rounded up to 32 (one 128-byte
// swizzle row; zeros past D, so every D from 1 to 256 takes the same
// boxes and no row stride breaks TMA's 16-byte rule). The backward also
// writes them transposed, (DT, Cp) with Cp = rows rounded up to 64 and DT
// = Dp rounded up to the chunk of D one CTA accumulates (32, 64 or 128),
// as the K-major B of grad = G . z. bf16 z widens exactly (lo = 0, not
// written or read).
//
// 3xTF32. A product of fp32 x and y is hi_x hi_y + (hi_x lo_y + lo_x
// hi_y), the small terms summed in an accumulator of their own and added
// last: about 22 bits, where one TF32 pass keeps 11 (2^-11 of each
// operand). lo_x lo_y (2^-22) is dropped; the tensor core reads lo's top
// 19 bits.
//
// Walk. One CTA (a consumer warpgroup and a producer warp) owns 64 rows
// and one split of the columns (ops/ntxent.py's planner, about one wave of
// the SMs). The producer's lane 0 loads the row tile (hi, lo) once and
// streams the split's 64-column tiles through a ring of stages in K boxes
// of 32 columns (8 KB of hi and 8 KB of lo a stage), so every D up to 256
// fits: at D = 256 the row tile takes 128 KB and 4 stages 64 KB (the
// backward: 2 stages of 32 KB beside 32 KB of sums). s = z_r z_c^T is
// wgmma m64n64k8 from shared memory; each thread holds rows r = 16 warp +
// lane / 4 and r + 8, columns 8i + 2q and 8i + 2q + 1 (q = lane % 4) of
// every 8-column group.
//
// Masks (Ids: a policy, so that later modes add their own): a column
// whose id is >= cols_actual or equals the row's id is -1e30; a column
// past the split or past C has no id (kNoColumn, masked); a row past R
// takes the sentinel id cols_actual and adds no loss. The positive of a
// row is the column whose id is positive(gid).

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
constexpr int kMaxD = 256;
constexpr int kSmemMax = 232448;  // shared memory one block may use
constexpr int kWarpgroup = sm90::kWarpgroup;
constexpr int kThreads = sm90::kThreads;  // the warpgroup + the producer
constexpr int kPrepThreads = 256;         // a 32 x 32 tile, 8 rows a pass
constexpr int kMergeThreads = 256;        // rows of one merge CTA
constexpr float kNegInf = -1e30f;
constexpr int kNoColumn = INT_MAX;  // id of a column past the split or C

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

// The dynamic shared memory of a walk: the row tile (hi, then lo: Dp / 32
// boxes each), `stages` ring slots, `extra` bytes of the kernel's own,
// then the barriers (the row tile's, full[kMaxStages],
// empty[kMaxStages]). A launch asks 1024 bytes more to align the base to
// the swizzle's 1024-byte boundary.
struct Plan {
  int nkb;         // K boxes of a row
  int row_bytes;   // the row tile
  int slot_bytes;  // one ring stage
  int stages;
  int extra;       // offset of the kernel's own bytes
  int bars;        // offset of the barriers
  int bytes;
};

inline Plan make_plan(int d, bool split, int slot_bytes, int extra = 0) {
  Plan p;
  p.nkb = padded_d(d) / kBoxK;
  p.row_bytes = p.nkb * kBoxBytes * (split ? 2 : 1);
  p.slot_bytes = slot_bytes;
  const int bar_bytes = (1 + 2 * kMaxStages) * 8;
  const int room = kSmemMax - 1024 - bar_bytes - p.row_bytes - extra;
  p.stages = room / slot_bytes < kMaxStages ? room / slot_bytes : kMaxStages;
  p.extra = p.row_bytes + p.stages * slot_bytes;
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

// One 32 x 32 tile of z (rows c0 = 32 blockIdx.x .., columns k0 = 32
// blockIdx.y ..): hi (and lo) into the (rows, Dp) copies; with hi_t, also
// into the transposed (DT, Cp) copies, whose columns are permuted within
// each group of 8: position p holds row (p & ~7) | (2 (p & 3) + (p >> 2
// & 1)). That is the K order in which the fp32 accumulator of s, turned
// into G, is already a TF32 A fragment (see the backward).
template <typename T, bool kSplit>
__device__ __forceinline__ void prep_tile(const T* __restrict__ z, int n,
                                          int d, float* __restrict__ hi,
                                          float* __restrict__ lo,
                                          float* __restrict__ hi_t,
                                          float* __restrict__ lo_t) {
  __shared__ float tile[32][33];
  const int dp = padded_d(d);
  const int c0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
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

// --- device: the masking and positive policies ----------------------------

// The symmetric layout: rows and columns are the same n vectors, their ids
// their indices.
struct SymIds {
  int n;
  __device__ __forceinline__ int row(int r) const { return r < n ? r : n; }
  __device__ __forceinline__ int col(int c) const { return c; }
  __device__ __forceinline__ int cols_actual() const { return n; }
  __device__ __forceinline__ int positive(int gid) const {
    return gid < n / 2 ? gid + n / 2 : gid - n / 2;
  }
};

// The general mode: rows with ids row_gid, columns with ids col_gid (null:
// the column index).
struct GeneralIds {
  const int* row_gid;
  const int* col_gid;
  int n_rows, actual, n_half;
  __device__ __forceinline__ int row(int r) const {
    return r < n_rows ? row_gid[r] : actual;
  }
  __device__ __forceinline__ int col(int c) const {
    return col_gid ? col_gid[c] : c;
  }
  __device__ __forceinline__ int cols_actual() const { return actual; }
  __device__ __forceinline__ int positive(int gid) const {
    return gid < n_half ? gid + n_half : gid - n_half;
  }
};

// _masked_sim_tile's rule, whatever the ids.
template <class Ids>
__device__ __forceinline__ bool masked(const Ids& ids, int id, int gid) {
  return id >= ids.cols_actual() || id == gid;
}

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

// Producer: the row tile's boxes (hi, then lo) at row0.
template <bool kSplit>
__device__ __forceinline__ void load_rows(unsigned char* smem,
                                          uint64_t* bar, const Plan& p,
                                          const CUtensorMap* hi,
                                          const CUtensorMap* lo, int row0) {
  bar_expect(bar, p.row_bytes);
  for (int kb = 0; kb < p.nkb; ++kb) {
    tma_box_2d(smem + kb * kBoxBytes, hi, bar, kb * kBoxK, row0);
    if constexpr (kSplit) {
      tma_box_2d(smem + (p.nkb + kb) * kBoxBytes, lo, bar, kb * kBoxK, row0);
    }
  }
}

// Producer: the K boxes (hi, lo) of the 64-column tile at col0.
template <bool kSplit>
__device__ __forceinline__ void load_cols(Ring& ring, const Plan& p,
                                          const CUtensorMap* hi,
                                          const CUtensorMap* lo, int col0) {
  for (int kb = 0; kb < p.nkb; ++kb) {
    uint64_t* bar;
    unsigned char* slot = ring.load(kBoxBytes * (kSplit ? 2 : 1), &bar);
    tma_box_2d(slot, hi, bar, kb * kBoxK, col0);
    if constexpr (kSplit) {
      tma_box_2d(slot + kBoxBytes, lo, bar, kb * kBoxK, col0);
    }
  }
}

// Consumer: s = z_rows . z_cols^T of the row tile and the next column tile
// in the ring (fp32 accumulator fragment), 3xTF32 for fp32 z.
template <bool kSplit>
__device__ __forceinline__ void s_tile(const unsigned char* rows,
                                       const Plan& p, Ring& ring,
                                       float (&s)[32]) {
  const unsigned char* rows_lo = rows + p.nkb * kBoxBytes;
  float small[32];
  for (int kb = 0; kb < p.nkb; ++kb) {
    const unsigned char* hi = ring.acquire();
    const unsigned char* lo = hi + kBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * kb + kk;
      const int acc = kb > 0 || kk > 0;
      if constexpr (kSplit) {
        mma_tf32_ss_n64(small, desc_k(rows, k), desc_k(lo, kk), acc);
        mma_tf32_ss_n64(small, desc_k(rows_lo, k), desc_k(hi, kk), 1);
      }
      mma_tf32_ss_n64(s, desc_k(rows, k), desc_k(hi, kk), acc);
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
