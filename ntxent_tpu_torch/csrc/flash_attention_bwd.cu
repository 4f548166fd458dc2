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
// All three outputs are fp32; the caller casts them to the input dtype.
// Tiles that lie entirely above the causal diagonal are skipped.
//
// Design. The TPU grids walk their innermost axis sequentially with the
// accumulator in VMEM scratch. Here that axis is a loop inside one CTA:
// dQ has one CTA per (b*h, 64-row q tile) looping over kv tiles; dK/dV one
// CTA per (b*h, 64-row kv tile) looping over q tiles, as the TPU grid's
// innermost axis does. 4 warps; every tile is staged once in shared memory
// per loop step.
//   bf16: s = Q K^T and dp = dO V^T run on the tensor cores (WMMA 16x16x16,
//   fp32 accumulate; bf16 x bf16 products are exact in fp32, so these
//   equal the TPU kernel's fp32 products of widened inputs up to summation
//   order). ds is rounded to bf16 for ds . K exactly as the TPU kernel
//   rounds it. For dV and dK the TPU kernel keeps p and ds in fp32; the
//   tensor cores take bf16, so each is split into hi = bf16(x) and
//   lo = bf16(x - hi) and both halves are multiplied (p^T dO = p_hi^T dO +
//   p_lo^T dO): the operand keeps ~16 mantissa bits instead of 8, a
//   relative error near 2^-17 per product, far inside the bf16 rounding of
//   the final dk/dv.
//   fp32: every product is plain FMA (no TF32), a lane pair per row.
//
// Bound at the training shape (ViT-B/16, batch 256 x 2 views: B*H = 6144,
// L = 197, D = 64, bf16): dQ does 3 products of 2*B*H*L^2*D = 30.5 GFLOP
// each (91.6 GFLOP, 93 us at 989 TFLOP/s bf16) over 4 * 155 MB of
// q/k/v/dO plus 4.8 MB of lse/delta and a 310 MB fp32 dq (1.0 GB, 0.31 ms
// at 3.35 TB/s): memory-bound. dK/dV does 6 products with the hi/lo split
// (4 products of the same work counted once, 122 GFLOP) and writes two
// fp32 outputs (1.24 GB, 0.37 ms): memory-bound too. The loads are
// synchronous 16-byte copies; cp.async/TMA pipelining and wgmma are later
// work.
//
// Supported: float32 or bfloat16, head_dim 64 or 128, contiguous inputs
// with 16-byte aligned bases. The C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>

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

__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
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
// dK/dV: one CTA per (b*h, kv tile), looping over q tiles.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  using L = Ld<T, D>;
  static constexpr bool kTc = TensorCore<T>::value;
  // bf16: s, dp (fp32) + p_hi, p_lo, ds_hi, ds_lo (bf16);
  // fp32: p^T, ds^T (fp32).
  static constexpr size_t kWork =
      kTc ? 2 * L::kScore + 4 * L::kProb : 2 * L::kProb32;
  static constexpr size_t kRowStats = 2 * kBlock * sizeof(float);
  static constexpr size_t kBytes = 4 * L::kTile + kWork + kRowStats;
  static_assert(2 * size_t(kBlock) * L::kO * sizeof(float) <= kBytes,
                "output staging must fit in the tile buffers");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int lq, int lk, int kv_tiles,
                     float scale, int causal, int q_off, int k_off) {
  using L = Ld<T, D>;
  using S = DkvSmem<T, D>;
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      dk_tc[TensorCore<T>::value ? D / 16 : 1],
      dv_tc[TensorCore<T>::value ? D / 16 : 1];
  float dk_acc[TensorCore<T>::value ? 1 : D / 2];
  float dv_acc[TensorCore<T>::value ? 1 : D / 2];
  if constexpr (TensorCore<T>::value) {
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      wmma::fill_fragment(dk_tc[t], 0.f);
      wmma::fill_fragment(dv_tc[t], 0.f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  }

  // A lane pair owns one row: a q row of the score tile (bf16) or a kv
  // row of the transposed tile (fp32); `half` picks 32 of its 64 columns.
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

    if constexpr (TensorCore<T>::value) {
      float* s_s = reinterpret_cast<float*>(work);
      float* dp_s = reinterpret_cast<float*>(work + L::kScore);
      __nv_bfloat16* p_hi =
          reinterpret_cast<__nv_bfloat16*>(work + 2 * L::kScore);
      __nv_bfloat16* p_lo = p_hi + kBlock * L::kP;
      __nv_bfloat16* ds_hi = p_lo + kBlock * L::kP;
      __nv_bfloat16* ds_lo = ds_hi + kBlock * L::kP;
      // Rows of s and dp are q rows; each warp fills and reads its own.
      wmma_abt<D>(q_s, k_s, s_s, warp);
      wmma_abt<D>(do_s, v_s, dp_s, warp);
      __syncwarp();
      const bool q_valid = q0 + row < lq;
      const int qpos = q_off + q0 + row;
      const float lse_r = lse_s[row];
      const float delta_r = delta_s[row];
#pragma unroll 8
      for (int c = 0; c < kHalfCols; ++c) {
        const int col = half * kHalfCols + c;
        const int kcol = k0 + col;
        float s = s_s[row * L::kS + col] * scale;
        if (kcol >= lk) s = kNegInf;
        if (causal && k_off + kcol > qpos) s = kNegInf;
        float p = prob(s, lse_r);
        float ds = p * (dp_s[row * L::kS + col] - delta_r) * scale;
        if (!q_valid) p = ds = 0.f;
        split_bf16(p, p_hi + row * L::kP + col, p_lo + row * L::kP + col);
        split_bf16(ds, ds_hi + row * L::kP + col, ds_lo + row * L::kP + col);
      }
      __syncthreads();  // dV/dK below read every warp's q rows
      // This warp's 16 kv rows: dV += P^T dO, dK += dS^T Q over 64 q rows.
#pragma unroll
      for (int kk = 0; kk < kBlock; kk += 16) {
        // P^T as a column-major A: element (kv i, q j) = P[j][i].
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            a_hi, a_lo, b_hi, b_lo;
        const int off = kk * L::kP + warp * kRowsPerWarp;
        wmma::load_matrix_sync(a_hi, p_hi + off, L::kP);
        wmma::load_matrix_sync(a_lo, p_lo + off, L::kP);
        wmma::load_matrix_sync(b_hi, ds_hi + off, L::kP);
        wmma::load_matrix_sync(b_lo, ds_lo + off, L::kP);
#pragma unroll
        for (int t = 0; t < D / 16; ++t) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              m;
          wmma::load_matrix_sync(m, do_s + kk * L::kT + t * 16, L::kT);
          wmma::mma_sync(dv_tc[t], a_hi, m, dv_tc[t]);
          wmma::mma_sync(dv_tc[t], a_lo, m, dv_tc[t]);
          wmma::load_matrix_sync(m, q_s + kk * L::kT + t * 16, L::kT);
          wmma::mma_sync(dk_tc[t], b_hi, m, dk_tc[t]);
          wmma::mma_sync(dk_tc[t], b_lo, m, dk_tc[t]);
        }
      }
    } else {
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
  }
  __syncthreads();  // every warp is done with the tiles: reuse them below

  const int rows = min(kBlock, lk - k0);
  float* dk_out = dk + (size_t(bh) * lk + k0) * D;
  float* dv_out = dv + (size_t(bh) * lk + k0) * D;
  if constexpr (TensorCore<T>::value) {
    float* stage_k = reinterpret_cast<float*>(smem);
    float* stage_v = stage_k + kBlock * L::kO;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      wmma::store_matrix_sync(stage_k + warp * kRowsPerWarp * L::kO + t * 16,
                              dk_tc[t], L::kO, wmma::mem_row_major);
      wmma::store_matrix_sync(stage_v + warp * kRowsPerWarp * L::kO + t * 16,
                              dv_tc[t], L::kO, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < rows * D; e += kThreads) {
      dk_out[e] = stage_k[(e / D) * L::kO + e % D];
      dv_out[e] = stage_v[(e / D) * L::kO + e % D];
    }
  } else if (row < rows) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_out[size_t(row) * D + half * (D / 2) + i] = dk_acc[i];
      dv_out[size_t(row) * D + half * (D / 2) + i] = dv_acc[i];
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

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int lq, int lk,
                       float scale, int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  constexpr size_t bytes = DkvSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int kv_tiles = (lk + kBlock - 1) / kBlock;
  flash_dkv_kernel<T, D><<<dim3(bh * kv_tiles), dim3(kThreads), bytes,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), lq, lk, kv_tiles,
      scale, causal, q_off, k_off);
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
#define NTX_DKV(T, D)                                                      \
  return launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk,  \
                          scale, causal, q_off, k_off, s)
  if (dtype == 0 && head_dim == 64) NTX_DKV(float, 64);
  if (dtype == 0 && head_dim == 128) NTX_DKV(float, 128);
  if (dtype == 1 && head_dim == 64) NTX_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) NTX_DKV(__nv_bfloat16, 128);
#undef NTX_DKV
  return cudaErrorInvalidValue;
}
