// Flash-attention backward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Two entry points, each replacing one Pallas TPU kernel:
//   ntx_flash_attention_dq  <- ntxent_tpu/ops/attention_pallas.py:125
//     (_dq_kernel, launched by flash_dq_hop at attention_pallas.py:325);
//   ntx_flash_attention_dkv <- ntxent_tpu/ops/attention_pallas.py:166
//     (_dkv_kernel, launched by flash_dkv_hop at attention_pallas.py:368).
// On the flat (B*H, L, D) layout, from the forward's saved lse and
// delta = rowsum(dO * O) (both fp32, (B*H, Lq)), they compute what those
// kernels compute:
//   s   = (q . k^T) * scale in fp32; keys past Lk and, when causal, keys
//         after the query's global position (k_off + j > q_off + i) are
//         masked to -1e30;
//   p   = 0 where s <= -5e29, else exp(min(s - lse, 0));
//   dp  = dO . V^T in fp32;  ds = p * (dp - delta) * scale;
//   dq  = sum_j bf16/fp32(ds) . K     -- ds is cast to K's dtype first
//         (attention_pallas.py:153);
//   dv  = sum_i p^T . dO,  dk = sum_i ds^T . Q  -- in fp32, as the TPU
//         kernel computes them (attention_pallas.py:191-204).
// All three outputs are fp32 (the ring sums dk and dv across hops); the
// caller casts them to the input dtype. Tiles that lie entirely above the
// causal diagonal are skipped.
//
// dQ (#13). One CTA per (b*h, 64-row q tile) loops over the kv tiles, as
// the TPU grid's innermost axis does; 4 warps, each tile staged through
// shared memory by synchronous 16-byte loads. bf16: s = Q K^T and
// dp = dO V^T on the tensor cores (WMMA 16x16x16, fp32 accumulate; bf16
// x bf16 products are exact in fp32, so these equal the TPU kernel's fp32
// products up to summation order) through shared memory, ds rounded to
// bf16 for ds . K exactly as the TPU kernel rounds it. fp32: plain FMA
// (no TF32), a lane pair per row.
//
// dK/dV (#14). One CTA per (b*h, 64-row kv tile) loops over the live q
// tiles, from first_live_q_tile to the end.
//   bf16 (flash_dkv_kernel_tma; FlashAttention-3's shape): one consumer
//   warpgroup and one producer warp. The producer loads K and V once by
//   TMA and streams Q, dO and the q rows' lse and delta through a ring of
//   kRing shared-memory stages (TMA for the tiles, completing on an
//   mbarrier; plain loads for the fp32 rows, which TMA cannot describe).
//   The consumers compute transposed, so that accumulator rows are kv
//   rows: s^T = K Q^T and dp^T = V dO^T are wgmma m64n64k16 from shared
//   memory (both operands K-major, as stored); p^T and
//   ds^T = p^T (dp^T - delta) scale are formed in registers, lse and
//   delta broadcast along the columns. For dV and dK the TPU kernel keeps
//   p and ds in fp32; the tensor cores take bf16, so each is split into
//   hi = bf16(x) and lo = bf16(x - hi) in registers (the pair keeps ~16
//   mantissa bits, a relative error near 2^-17 per product) and both
//   halves go in as register A operands of dV += P^T dO and
//   dK += dS^T Q (wgmma m64nDk16, dO and Q as MN-major B). Nothing of s,
//   dp, p or ds touches shared memory; dk and dv leave from the
//   accumulators, one owner per row. A kv tile with no live q tile (a
//   wholly masked ring hop) loads nothing, waits on nothing and writes
//   zeros. Causal grids run tile-major across heads, so the heavy small
//   kv tiles of every head launch first. As in #11 the elementwise work
//   bounds a tile in practice: exp on the SFU (sm90::exp0), branch-free
//   masks, and each p/ds pair packed to its fragments as soon as it is
//   formed (probs_t), which keeps D = 64 within the registers of 2 CTAs
//   an SM.
//   fp32: every product is plain FMA (no TF32), a lane pair per kv row.
//
// Bound at the training shape (ViT-B/16, batch 256 x 2 views: B*H = 6144,
// L = 197, D = 64, bf16): dQ does 3 products of 2*B*H*L^2*D = 30.5 GFLOP
// each (91.6 GFLOP, 93 us at 989 TFLOP/s bf16) over 4 * 155 MB of
// q/k/v/dO plus 4.8 MB of lse/delta and a 310 MB fp32 dq (0.94 GB, 0.28
// ms at 3.35 TB/s): memory-bound. dK/dV does 4 products counted once
// (122 GFLOP, 0.12 ms) and writes two fp32 outputs (1.25 GB, 0.37 ms):
// memory-bound too, so its design reads each Q/dO tile once per kv tile
// with the next stages in flight and keeps every intermediate on chip.
// At the long-context hop (B*H = 8, L = 32768, D = 64, causal) the live
// half of the same 4 products is 2.2 TFLOP (2.2 ms): compute-bound, the
// regime wgmma is for.
//
// Supported: float32 or bfloat16, head_dim 64 or 128, contiguous inputs
// with 16-byte aligned bases. The C entry points return cudaGetLastError()
// (or the error of building a tensor map).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>

#include "flash_attention_sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int kBlock = 64;  // q rows and kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlock / kWarps;  // 16: one WMMA row strip
constexpr int kHalfCols = kBlock / 2;          // tile columns per lane
constexpr float kNegInf = -1e30f;

template <typename T>
struct TensorCore {
  static constexpr bool value = false;
};
template <>
struct TensorCore<__nv_bfloat16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

// p from a scaled, masked score and the row's lse (attention_pallas.py:146).
__device__ __forceinline__ float prob(float s, float lse) {
  return s <= kNegInf * 0.5f ? 0.f : exp0(s - lse);
}

// Row strides (elements). Rows are padded by 16 bytes against bank
// conflicts; every region is a multiple of 128 bytes, so each WMMA tile
// pointer is 32-byte aligned.
template <typename T, int D>
struct Ld {
  static constexpr int kPadT = 16 / sizeof(T);
  static constexpr int kT = D + kPadT;         // q, k, v, dO rows
  static constexpr int kP = kBlock + kPadT;    // p / ds rows (in T)
  static constexpr int kS = kBlock + 4;        // fp32 score rows
  static constexpr int kO = D + 4;             // fp32 output staging rows
  static constexpr size_t kTile = size_t(kBlock) * kT * sizeof(T);
  static constexpr size_t kScore = size_t(kBlock) * kS * sizeof(float);
  static constexpr size_t kProb = size_t(kBlock) * kP * sizeof(T);
  static constexpr size_t kProb32 = size_t(kBlock) * kS * sizeof(float);
};

// Copy `rows_valid` rows of a 64-row tile (global row stride D) into
// shared memory in 16-byte chunks; rows past the end are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int rows_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = D / kVec;
  constexpr int kChunks = kBlock * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + size_t(r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * Ld<T, D>::kT + col) = val;
  }
}

// out[16 rows of this warp][64] = a[16 rows] . b^T, b a 64-row tile.
template <int D>
__device__ __forceinline__ void wmma_abt(const __nv_bfloat16* a_s,
                                         const __nv_bfloat16* b_s,
                                         float* out_s, int warp) {
  using L = Ld<__nv_bfloat16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlock / 16];
#pragma unroll
  for (int n = 0; n < kBlock / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, a_s + warp * kRowsPerWarp * L::kT + kk, L::kT);
#pragma unroll
    for (int n = 0; n < kBlock / 16; ++n) {
      // b^T as a column-major B: element (kk + i, 16n + j) = b[16n + j][kk + i].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b;
      wmma::load_matrix_sync(b, b_s + n * 16 * L::kT + kk, L::kT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBlock / 16; ++n) {
    wmma::store_matrix_sync(out_s + warp * kRowsPerWarp * L::kS + n * 16,
                            acc[n], L::kS, wmma::mem_row_major);
  }
}

// Two fp32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): the
// pair keeps ~16 bits of each value.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0);
  const __nv_bfloat16 h1 = __float2bfloat16(x1);
  hi = sm90::pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = sm90::pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// Number of kv tiles a causal q tile [q0, q0 + 64) sees (the rest lie above
// the diagonal), as the forward kernel counts them.
__device__ __forceinline__ int live_kv_tiles(int kv_tiles, int causal,
                                             int q_off, int q0, int k_off) {
  if (!causal) return kv_tiles;
  const long long span =
      static_cast<long long>(q_off) + q0 + kBlock - 1 - k_off;
  const long long live = span < 0 ? 0 : span / kBlock + 1;
  return live < kv_tiles ? static_cast<int>(live) : kv_tiles;
}

// First q tile whose last query reaches the kv tile's first key:
// q_off + 64 i + 63 >= k_off + k0.
__device__ __forceinline__ int first_live_q_tile(int causal, int q_off,
                                                 int k_off, int k0) {
  if (!causal) return 0;
  const long long need =
      static_cast<long long>(k_off) + k0 - q_off - (kBlock - 1);
  return need <= 0 ? 0 : static_cast<int>((need + kBlock - 1) / kBlock);
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b*h, q tile), looping over kv tiles.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  using L = Ld<T, D>;
  static constexpr bool kTc = TensorCore<T>::value;
  static constexpr size_t kScores = kTc ? 2 * L::kScore : 0;  // s, dp
  static constexpr size_t kDs = kTc ? L::kProb : L::kProb32;
  static constexpr size_t kBytes = 4 * L::kTile + kScores + kDs;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int lq, int lk, int q_tiles, float scale, int causal,
                    int q_off, int k_off) {
  using L = Ld<T, D>;
  using S = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + L::kTile);
  T* k_s = reinterpret_cast<T*>(smem + 2 * L::kTile);
  T* v_s = reinterpret_cast<T*>(smem + 3 * L::kTile);
  float* s_s = reinterpret_cast<float*>(smem + 4 * L::kTile);
  float* dp_s = reinterpret_cast<float*>(smem + 4 * L::kTile + L::kScore);
  unsigned char* ds_raw = smem + 4 * L::kTile + S::kScores;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlock;
  const T* k_bh = k + size_t(bh) * lk * D;
  const T* v_bh = v + size_t(bh) * lk * D;

  load_tile<T, D>(q_s, q + (size_t(bh) * lq + q0) * D, min(kBlock, lq - q0));
  load_tile<T, D>(do_s, dout + (size_t(bh) * lq + q0) * D,
                  min(kBlock, lq - q0));

  // A lane pair owns one q row: `half` picks its 32 of the 64 columns.
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane & 1;
  const bool row_valid = q0 + row < lq;
  const int qpos = q_off + q0 + row;
  const float lse_r = row_valid ? lse[size_t(bh) * lq + q0 + row] : 0.f;
  const float delta_r = row_valid ? delta[size_t(bh) * lq + q0 + row] : 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[D / 16];
  float acc[TensorCore<T>::value ? 1 : D / 2];
  if constexpr (TensorCore<T>::value) {
#pragma unroll
    for (int t = 0; t < D / 16; ++t) wmma::fill_fragment(acc_tc[t], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  }

  const int kv_tiles =
      live_kv_tiles((lk + kBlock - 1) / kBlock, causal, q_off, q0, k_off);
  for (int j = 0; j < kv_tiles; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s
    load_tile<T, D>(k_s, k_bh + size_t(k0) * D, min(kBlock, lk - k0));
    load_tile<T, D>(v_s, v_bh + size_t(k0) * D, min(kBlock, lk - k0));
    __syncthreads();

    if constexpr (TensorCore<T>::value) {
      __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(ds_raw);
      wmma_abt<D>(q_s, k_s, s_s, warp);
      wmma_abt<D>(do_s, v_s, dp_s, warp);
      __syncwarp();
#pragma unroll 8
      for (int c = 0; c < kHalfCols; ++c) {
        const int col = half * kHalfCols + c;
        const int kcol = k0 + col;
        float s = s_s[row * L::kS + col] * scale;
        if (kcol >= lk) s = kNegInf;
        if (causal && k_off + kcol > qpos) s = kNegInf;
        const float p = prob(s, lse_r);
        const float ds = p * (dp_s[row * L::kS + col] - delta_r) * scale;
        ds_s[row * L::kP + col] = __float2bfloat16(ds);
      }
      __syncwarp();
      // acc[16 rows x D] += ds[16 x 64] . K[64 x D]
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
#pragma unroll
        for (int kk = 0; kk < kBlock; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              b;
          wmma::load_matrix_sync(a, ds_s + warp * kRowsPerWarp * L::kP + kk,
                                 L::kP);
          wmma::load_matrix_sync(b, k_s + kk * L::kT + t * 16, L::kT);
          wmma::mma_sync(acc_tc[t], a, b, acc_tc[t]);
        }
      }
    } else {
      float* ds_s = reinterpret_cast<float*>(ds_raw);
      const T* q_row = q_s + row * L::kT;
      const T* do_row = do_s + row * L::kT;
      for (int c = 0; c < kHalfCols; ++c) {
        const int col = half * kHalfCols + c;
        const int kcol = k0 + col;
        const T* k_row = k_s + col * L::kT;
        const T* v_row = v_s + col * L::kT;
        float s = 0.f;
        float dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(to_float(q_row[d]), to_float(k_row[d]), s);
          dp = fmaf(to_float(do_row[d]), to_float(v_row[d]), dp);
        }
        s *= scale;
        if (kcol >= lk) s = kNegInf;
        if (causal && k_off + kcol > qpos) s = kNegInf;
        const float p = prob(s, lse_r);
        ds_s[row * L::kS + col] = p * (dp - delta_r) * scale;
      }
      __syncwarp();
      const float* ds_row = ds_s + row * L::kS;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int d = half * (D / 2) + i;
        float a = acc[i];
#pragma unroll 16
        for (int c = 0; c < kBlock; ++c) {
          a = fmaf(ds_row[c], to_float(k_s[c * L::kT + d]), a);
        }
        acc[i] = a;
      }
    }
    __syncwarp();
  }
  __syncthreads();  // every warp is done with the tiles: reuse them below

  float* out = dq + (size_t(bh) * lq + q0) * D;
  if constexpr (TensorCore<T>::value) {
    float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      wmma::store_matrix_sync(stage + warp * kRowsPerWarp * L::kO + t * 16,
                              acc_tc[t], L::kO, wmma::mem_row_major);
    }
    __syncthreads();
    const int rows = min(kBlock, lq - q0);
    for (int e = tid; e < rows * D; e += kThreads) {
      out[e] = stage[(e / D) * L::kO + e % D];
    }
  } else if (row_valid) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      out[size_t(row) * D + half * (D / 2) + i] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV, fp32: one CTA per (b*h, kv tile), looping over q tiles (FMA).
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  using L = Ld<float, D>;
  static constexpr size_t kWork = 2 * L::kProb32;  // p^T, ds^T (fp32)
  static constexpr size_t kRowStats = 2 * kBlock * sizeof(float);
  static constexpr size_t kBytes = 4 * L::kTile + kWork + kRowStats;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int lq, int lk, int kv_tiles,
                     float scale, int causal, int q_off, int k_off) {
  using T = float;
  using L = Ld<T, D>;
  using S = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + L::kTile);
  T* q_s = reinterpret_cast<T*>(smem + 2 * L::kTile);
  T* do_s = reinterpret_cast<T*>(smem + 3 * L::kTile);
  unsigned char* work = smem + 4 * L::kTile;
  float* lse_s = reinterpret_cast<float*>(work + S::kWork);
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x / kv_tiles;
  const int k0 = (blockIdx.x % kv_tiles) * kBlock;
  const T* q_bh = q + size_t(bh) * lq * D;
  const T* do_bh = dout + size_t(bh) * lq * D;

  load_tile<T, D>(k_s, k + (size_t(bh) * lk + k0) * D, min(kBlock, lk - k0));
  load_tile<T, D>(v_s, v + (size_t(bh) * lk + k0) * D, min(kBlock, lk - k0));

  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // A lane pair owns one kv row of the transposed tile; `half` picks 32
  // of its 64 q columns.
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane & 1;

  const int q_tiles = (lq + kBlock - 1) / kBlock;
  for (int i = first_live_q_tile(causal, q_off, k_off, k0); i < q_tiles;
       ++i) {
    const int q0 = i * kBlock;
    __syncthreads();  // the previous tile's readers are done with q_s/do_s
    load_tile<T, D>(q_s, q_bh + size_t(q0) * D, min(kBlock, lq - q0));
    load_tile<T, D>(do_s, do_bh + size_t(q0) * D, min(kBlock, lq - q0));
    if (tid < kBlock) {
      const bool valid = q0 + tid < lq;
      lse_s[tid] = valid ? lse[size_t(bh) * lq + q0 + tid] : 0.f;
      delta_s[tid] = valid ? delta[size_t(bh) * lq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float* pt_s = reinterpret_cast<float*>(work);             // [kv][q]
    float* dst_s = reinterpret_cast<float*>(work + L::kProb32);
    const int kcol = k0 + row;
    const T* k_row = k_s + row * L::kT;
    const T* v_row = v_s + row * L::kT;
    for (int c = 0; c < kHalfCols; ++c) {
      const int qc = half * kHalfCols + c;
      const T* q_row = q_s + qc * L::kT;
      const T* do_row = do_s + qc * L::kT;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(to_float(q_row[d]), to_float(k_row[d]), s);
        dp = fmaf(to_float(do_row[d]), to_float(v_row[d]), dp);
      }
      s *= scale;
      if (kcol >= lk) s = kNegInf;
      if (causal && k_off + kcol > q_off + q0 + qc) s = kNegInf;
      float p = prob(s, lse_s[qc]);
      float ds = p * (dp - delta_s[qc]) * scale;
      if (q0 + qc >= lq) p = ds = 0.f;
      pt_s[row * L::kS + qc] = p;
      dst_s[row * L::kS + qc] = ds;
    }
    __syncwarp();
    const float* p_row = pt_s + row * L::kS;
    const float* ds_row = dst_s + row * L::kS;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int d = half * (D / 2) + i;
      float av = dv_acc[i];
      float ak = dk_acc[i];
#pragma unroll 16
      for (int c = 0; c < kBlock; ++c) {
        av = fmaf(p_row[c], to_float(do_s[c * L::kT + d]), av);
        ak = fmaf(ds_row[c], to_float(q_s[c * L::kT + d]), ak);
      }
      dv_acc[i] = av;
      dk_acc[i] = ak;
    }
    __syncwarp();
  }
  __syncthreads();

  const int rows = min(kBlock, lk - k0);
  float* dk_out = dk + (size_t(bh) * lk + k0) * D;
  float* dv_out = dv + (size_t(bh) * lk + k0) * D;
  if (row < rows) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_out[size_t(row) * D + half * (D / 2) + i] = dk_acc[i];
      dv_out[size_t(row) * D + half * (D / 2) + i] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV, bf16: TMA ring, producer warp, wgmma consumer warpgroup.
// ---------------------------------------------------------------------------

constexpr int kRing = 3;  // Q/dO/lse/delta ring depth

template <int D>
struct DkvTmaSmem {
  static constexpr int kTile = kBlock * D * 2;  // one 64-row bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  // stage s: Q at kQ + 2 s kTile, dO after it
  static constexpr int kQ = 2 * kTile;
  static constexpr int kStats = kQ + 2 * kRing * kTile;  // stage s: lse, delta
  static constexpr int kBars = kStats + kRing * 2 * kBlock * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kRing) * 8;
  static constexpr int kLaunch = kBytes + 1024;  // room to align to 1024
};

// p^T and ds^T of one 64 x 64 tile from s^T and dp^T, split into
// hi = bf16(x) and lo = bf16(x - hi) pairs as the register A operands of
// dV += P^T dO and dK += dS^T Q. This thread holds kv rows at positions
// kv and kv + 8 and q columns 8g + c and 8g + c + 1 of every 8-column
// group g, whose lse and delta are in st[0, 64) and st[64, 128); each
// pair is packed as soon as it is formed, so s^T and dp^T die as the
// fragments grow. The masks are branch-free and run on every tile: a
// second copy without them for interior tiles measured no faster and
// spilled at D = 64.
__device__ __forceinline__ void probs_t(
    const float (&sc)[32], const float (&dp)[32], const float* st,
    float scale, int q0, int kv, int c, int lq, int lk, int causal,
    int q_off, int k_off, uint32_t (&p_hi)[16], uint32_t (&p_lo)[16],
    uint32_t (&ds_hi)[16], uint32_t (&ds_lo)[16]) {
  // Column n = 8g + e holds query q0 + c + n: past Lq when n >= past; row
  // h's key comes after it (causal) when n < before[h].
  const int past = lq - q0 - c;
  const int before[2] = {k_off + kv - q_off - q0 - c,
                         k_off + kv + 8 - q_off - q0 - c};
  const bool row_past[2] = {kv >= lk, kv + 8 >= lk};
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float2 lse_q = *reinterpret_cast<const float2*>(st + c + 8 * g);
    const float2 delta_q =
        *reinterpret_cast<const float2*>(st + kBlock + c + 8 * g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * g + e;
        float x = sc[4 * g + 2 * h + e] * scale;
        x = (row_past[h] | (causal & (n < before[h]))) ? kNegInf : x;
        const float lse_e = e ? lse_q.y : lse_q.x;
        const float delta_e = e ? delta_q.y : delta_q.x;
        p[e] = x <= kNegInf * 0.5f ? 0.f : sm90::exp0(x - lse_e);
        ds[e] = p[e] * (dp[4 * g + 2 * h + e] - delta_e) * scale;
        p[e] = n >= past ? 0.f : p[e];
        ds[e] = n >= past ? 0.f : ds[e];
      }
      split_pack(p[0], p[1], p_hi[2 * g + h], p_lo[2 * g + h]);
      split_pack(ds[0], ds[1], ds_hi[2 * g + h], ds_lo[2 * g + h]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, D == 64 ? 2 : 1)
    flash_dkv_kernel_tma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int bh_count, int lq, int lk, int kv_tiles,
                         float scale, int causal, int q_off, int k_off) {
  using L = DkvTmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;   // a Q/dO/lse/delta stage has landed
  uint64_t* empty = full + kRing;  // the consumers are done with it

  // Causal: kv tile j walks the q tiles from about j to the end, so a small
  // j is heavy; tile-major order launches every head's heavy tiles first.
  // Otherwise head-major, so a head's CTAs share its Q and dO in L2.
  const int bh = causal ? blockIdx.x % bh_count : blockIdx.x / kv_tiles;
  const int k0 = (causal ? blockIdx.x / bh_count : blockIdx.x % kv_tiles) *
                 kBlock;
  const int first = first_live_q_tile(causal, q_off, k_off, k0);
  const int n = (lq + kBlock - 1) / kBlock - first;  // <= 0: wholly masked
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::bar_init(kv_full, 1);
    for (int s = 0; s < kRing; ++s) {
      sm90::bar_init(&full[s], 32 + 1);  // 32 lanes' copies + lane 0's TMA
      sm90::bar_init(&empty[s], sm90::kWarpgroup);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (tid >= sm90::kWarpgroup) {
    // The producer warp: lane 0 issues TMA; every lane copies its share of
    // the stage's lse and delta by cp.async (a (B*H, Lq) fp32 row is no
    // TMA tensor at Lq = 197: its 788-byte stride is not a multiple of 16)
    // and arrives when its copies land, so no lane waits on a load.
    const int lane = tid - sm90::kWarpgroup;
    if (n > 0 && lane == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_do);
      sm90::bar_expect(kv_full, 2 * L::kTile);
      sm90::tma_tile<D>(smem + L::kK, &tm_k, kv_full, k0, bh);
      sm90::tma_tile<D>(smem + L::kV, &tm_v, kv_full, k0, bh);
    }
    for (int t = 0; t < n; ++t) {
      const int s = t % kRing;
      if (t >= kRing) sm90::bar_wait(&empty[s], (t / kRing - 1) & 1);
      const int q0 = (first + t) * kBlock;
      float* st = stats + s * 2 * kBlock;
      for (int i = lane; i < kBlock; i += 32) {
        const bool valid = q0 + i < lq;
        const size_t at = valid ? size_t(bh) * lq + q0 + i : 0;
        sm90::copy_word(st + i, lse + at, valid);  // 0 past Lq
        sm90::copy_word(st + kBlock + i, delta + at, valid);
      }
      sm90::bar_arrive_copies(&full[s]);
      if (lane == 0) {
        unsigned char* q_s = smem + L::kQ + 2 * s * L::kTile;
        sm90::bar_expect(&full[s], 2 * L::kTile);
        sm90::tma_tile<D>(q_s, &tm_q, &full[s], q0, bh);
        sm90::tma_tile<D>(q_s + L::kTile, &tm_do, &full[s], q0, bh);
      }
    }
    return;
  }

  // The consumer warpgroup computes transposed, so that accumulator rows
  // are kv rows: this thread holds kv rows r and r + 8 of the tile and q
  // columns 8i + c and 8i + c + 1.
  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n > 0) sm90::bar_wait(kv_full, 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % kRing;
    sm90::bar_wait(&full[s], (t / kRing) & 1);
    const unsigned char* q_s = smem + L::kQ + 2 * s * L::kTile;
    const unsigned char* do_s = q_s + L::kTile;
    const float* st = stats + s * 2 * kBlock;
    const int q0 = (first + t) * kBlock;

    float sc[32];  // s^T = K Q^T
    float dp[32];  // dp^T = V dO^T
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::mma_ss_n64(sc, sm90::desc_k(smem + L::kK, kk),
                       sm90::desc_k(q_s, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::mma_ss_n64(dp, sm90::desc_k(smem + L::kV, kk),
                       sm90::desc_k(do_s, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::hold(sc);
    sm90::hold(dp);

    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    probs_t(sc, dp, st, scale, q0, k0 + r, c, lq, lk, causal, q_off, k_off,
            p_hi, p_lo, ds_hi, ds_lo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b_do = sm90::desc_mn(do_s, kk);
      const uint64_t b_q = sm90::desc_mn(q_s, kk);
      sm90::mma_rs<D>(dv_acc, p_hi + 4 * kk, b_do);
      sm90::mma_rs<D>(dv_acc, p_lo + 4 * kk, b_do);
      sm90::mma_rs<D>(dk_acc, ds_hi + 4 * kk, b_q);
      sm90::mma_rs<D>(dk_acc, ds_lo + 4 * kk, b_q);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::hold(dv_acc);
    sm90::hold(dk_acc);
    sm90::hold(p_hi);
    sm90::hold(p_lo);
    sm90::hold(ds_hi);
    sm90::hold(ds_lo);
    sm90::bar_arrive(&empty[s]);
  }

  // One owner per output row: fp32 dk and dv straight from the
  // accumulators (zeros for a tile with no live q tile).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kv = k0 + r + 8 * h;
    if (kv >= lk) continue;
    float* dk_row = dk + (size_t(bh) * lk + kv) * D + c;
    float* dv_row = dv + (size_t(bh) * lk + kv) * D + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(dk_row + 8 * i) =
          make_float2(dk_acc[4 * i + 2 * h], dk_acc[4 * i + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv_row + 8 * i) =
          make_float2(dv_acc[4 * i + 2 * h], dv_acc[4 * i + 2 * h + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int lq, int lk, float scale,
                      int causal, int q_off, int k_off, cudaStream_t stream) {
  constexpr size_t bytes = DqSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlock - 1) / kBlock;
  flash_dq_kernel<T, D><<<dim3(bh * q_tiles), dim3(kThreads), bytes,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), lq, lk, q_tiles, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int lq, int lk,
                       float scale, int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  constexpr size_t bytes = DkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int kv_tiles = (lk + kBlock - 1) / kBlock;
  flash_dkv_kernel<D><<<dim3(bh * kv_tiles), dim3(kThreads), bytes,
                        stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), lq, lk, kv_tiles,
      scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int lq, int lk, float scale, int causal,
                           int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = sm90::tensor_map(&tm_q, q, bh, lq, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_k, k, bh, lk, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_v, v, bh, lk, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_do, dout, bh, lq, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_dkv_kernel_tma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkvTmaSmem<D>::kLaunch);
  }
  if (err != cudaSuccess) return err;
  const int kv_tiles = (lk + kBlock - 1) / kBlock;
  flash_dkv_kernel_tma<D><<<dim3(bh * kv_tiles), dim3(sm90::kThreads),
                            DkvTmaSmem<D>::kLaunch, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), bh, lq, lk, kv_tiles, scale, causal, q_off,
      k_off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Return a cudaError_t (0 = success).
extern "C" int ntx_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int lq, int lk,
                                      int head_dim, int dtype, float scale,
                                      int causal, int q_off, int k_off,
                                      int device, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NTX_DQ(T, D)                                                        \
  return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, lq, lk, scale, \
                         causal, q_off, k_off, s)
  if (dtype == 0 && head_dim == 64) NTX_DQ(float, 64);
  if (dtype == 0 && head_dim == 128) NTX_DQ(float, 128);
  if (dtype == 1 && head_dim == 64) NTX_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) NTX_DQ(__nv_bfloat16, 128);
#undef NTX_DQ
  return cudaErrorInvalidValue;
}

extern "C" int ntx_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int lq,
                                       int lk, int head_dim, int dtype,
                                       float scale, int causal, int q_off,
                                       int k_off, int device, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NTX_DKV(launch, D)                                                 \
  return launch<D>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, scale,    \
                   causal, q_off, k_off, s)
  if (dtype == 0 && head_dim == 64) NTX_DKV(launch_dkv, 64);
  if (dtype == 0 && head_dim == 128) NTX_DKV(launch_dkv, 128);
  if (dtype == 1 && head_dim == 64) NTX_DKV(launch_dkv_tma, 64);
  if (dtype == 1 && head_dim == 128) NTX_DKV(launch_dkv_tma, 128);
#undef NTX_DKV
  return cudaErrorInvalidValue;
}
