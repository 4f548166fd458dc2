// The tile machinery of the carried-statistics fold (flash_attention_fold.cu,
// kernel #12, both dtypes) and of the fp32 variant of the flash-attention
// forward (flash_attention_fwd.cu, kernel #11); #11's bf16 variant walks
// its tiles with TMA and wgmma instead (flash_attention_sm90.cuh).
//
// One CTA owns one (batch*head, 64-row q tile); 4 warps, each warp 16 q
// rows, a lane pair one row. The q tile stays in shared memory; each K/V
// tile is staged through shared memory once per q tile. In bf16 the two
// products run on the tensor cores through WMMA (16x16x16, fp32
// accumulate); s and the fp32 accumulator round-trip through shared
// memory so that the row-wise softmax update can address rows. In fp32
// both products are plain FMA (TF32 would lose the fp32 contract).
//
// `fold_kv_tiles` is the online-softmax walk over the live K/V tiles
// (attention_pallas.py:93-110 and :236-253): per tile,
//   s = (q . k^T) * scale in fp32; keys past Lk and, when causal, keys
//   after the query's global position (k_off + j > q_off + i) -> -1e30;
//   m_new = max(m, rowmax s); p = 0 where s <= -5e29, else
//   exp(min(s - m_new, 0)); alpha = exp(min(m - m_new, 0));
//   l = l * alpha + sum p; acc = acc * alpha + (p cast to V's dtype) . V.
// Causal tiles that lie wholly above the diagonal are skipped, so a hop
// that lies wholly in a row tile's future walks no tile and leaves the
// carried (m, l, acc) untouched.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>

namespace {

using namespace nvcuda;

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16: one WMMA row strip
constexpr int kHalfCols = kBlockKV / 2;         // columns per lane of a pair
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

// Shared-memory layout. Every row is padded by 16 bytes against bank
// conflicts; every region size is a multiple of 128 bytes, so each WMMA
// tile pointer is 32-byte aligned.
template <typename T, int D>
struct Smem {
  static constexpr int kPadT = 16 / sizeof(T);
  static constexpr int kLdT = D + kPadT;         // q, k, v rows
  static constexpr int kLdP = kBlockKV + kPadT;  // p rows
  static constexpr int kLdS = kBlockKV + 4;      // fp32 s rows
  static constexpr int kLdO = D + 4;             // fp32 accumulator rows
  static constexpr size_t kQ = size_t(kBlockQ) * kLdT * sizeof(T);
  static constexpr size_t kKV = size_t(kBlockKV) * kLdT * sizeof(T);
  static constexpr size_t kS =
      TensorCore<T>::value ? size_t(kBlockQ) * kLdS * sizeof(float) : 0;
  static constexpr size_t kP = size_t(kBlockQ) * kLdP * sizeof(T);
  static constexpr size_t kO = size_t(kBlockQ) * kLdO * sizeof(float);
  static constexpr size_t kBytes = kQ + 2 * kKV + kS + kP + kO;
};

// The regions of one CTA's dynamic shared memory.
template <typename T, int D>
struct Tiles {
  using S = Smem<T, D>;
  T* q;
  T* k;
  T* v;
  float* s;
  T* p;
  float* o;
  __device__ explicit Tiles(unsigned char* smem)
      : q(reinterpret_cast<T*>(smem)),
        k(reinterpret_cast<T*>(smem + S::kQ)),
        v(reinterpret_cast<T*>(smem + S::kQ + S::kKV)),
        s(reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV)),
        p(reinterpret_cast<T*>(smem + S::kQ + 2 * S::kKV + S::kS)),
        o(reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV + S::kS +
                                   S::kP)) {}
};

// Copy `rows_valid` rows of a 64-row tile (global row stride D) into
// shared memory in 16-byte chunks; rows past the end are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int rows_valid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = D / kVec;
  constexpr int kChunks = kBlockKV * kChunksPerRow;
  for (int c = tid; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + size_t(r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<T, D>::kLdT + col) = val;
  }
}

// s[16 x 64] = q[16 rows of this warp] . k^T on the tensor cores.
template <int D>
__device__ __forceinline__ void wmma_scores(const __nv_bfloat16* q_s,
                                            const __nv_bfloat16* k_s,
                                            float* s_s, int warp) {
  using S = Smem<__nv_bfloat16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlockKV / 16];
#pragma unroll
  for (int n = 0; n < kBlockKV / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a;
    wmma::load_matrix_sync(a, q_s + warp * kRowsPerWarp * S::kLdT + kk,
                           S::kLdT);
#pragma unroll
    for (int n = 0; n < kBlockKV / 16; ++n) {
      // k^T as a column-major B: element (kk + i, 16n + j) = k[16n + j][kk + i].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b;
      wmma::load_matrix_sync(b, k_s + n * 16 * S::kLdT + kk, S::kLdT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBlockKV / 16; ++n) {
    wmma::store_matrix_sync(s_s + warp * kRowsPerWarp * S::kLdS + n * 16,
                            acc[n], S::kLdS, wmma::mem_row_major);
  }
}

// acc[16 x D] (already rescaled) += p[16 x 64] . v[64 x D].
template <int D>
__device__ __forceinline__ void wmma_pv(const __nv_bfloat16* p_s,
                                        const __nv_bfloat16* v_s, float* o_s,
                                        int warp) {
  using S = Smem<__nv_bfloat16, D>;
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    float* optr = o_s + warp * kRowsPerWarp * S::kLdO + t * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, optr, S::kLdO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBlockKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b;
      wmma::load_matrix_sync(a, p_s + warp * kRowsPerWarp * S::kLdP + kk,
                             S::kLdP);
      wmma::load_matrix_sync(b, v_s + kk * S::kLdT + t * 16, S::kLdT);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(optr, acc, S::kLdO, wmma::mem_row_major);
  }
}

// The number of K/V tiles this q tile (rows q0 .. q0 + 63) has to walk:
// all of them, or when causal those whose first key is at or before the
// tile's last query (k_off + j*64 <= q_off + q0 + 63); 0 when the whole
// block lies in the tile's future.
__device__ __forceinline__ int live_kv_tiles(int lk, int q0, int causal,
                                             int q_off, int k_off) {
  int kv_tiles = (lk + kBlockKV - 1) / kBlockKV;
  if (causal) {
    const long long span =
        static_cast<long long>(q_off) + q0 + kBlockQ - 1 - k_off;
    const long long live = span < 0 ? 0 : span / kBlockKV + 1;
    if (live < kv_tiles) kv_tiles = static_cast<int>(live);
  }
  return kv_tiles;
}

// Fold the live K/V tiles of one (batch*head) row into the running (m, l)
// of this lane pair's q row (registers) and the fp32 accumulator rows in
// t.o. The q tile must be in t.q and t.o must hold the starting
// accumulator; both become visible to every thread at the loop's first
// barrier. `row` is this lane pair's row of the tile, `half` its half of
// the columns.
template <typename T, int D>
__device__ __forceinline__ void fold_kv_tiles(const Tiles<T, D>& t,
                                              const T* k_bh, const T* v_bh,
                                              int lk, int q0, int row,
                                              int half, float scale,
                                              int causal, int q_off,
                                              int k_off, float& m, float& l) {
  using S = Smem<T, D>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int qpos = q_off + q0 + row;
  const int kv_tiles = live_kv_tiles(lk, q0, causal, q_off, k_off);

  for (int j = 0; j < kv_tiles; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // the previous tile's readers are done with k/v
    load_tile<T, D>(t.k, k_bh + size_t(k0) * D, min(kBlockKV, lk - k0), tid);
    load_tile<T, D>(t.v, v_bh + size_t(k0) * D, min(kBlockKV, lk - k0), tid);
    __syncthreads();

    float s[kHalfCols];
    if constexpr (TensorCore<T>::value) {
      wmma_scores<D>(t.q, t.k, t.s, warp);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kHalfCols; ++c) {
        s[c] = t.s[row * S::kLdS + half * kHalfCols + c];
      }
    } else {
      const T* q_row = t.q + row * S::kLdT;
#pragma unroll
      for (int c = 0; c < kHalfCols; ++c) {
        const T* k_row = t.k + (half * kHalfCols + c) * S::kLdT;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          acc = fmaf(to_float(q_row[d]), to_float(k_row[d]), acc);
        }
        s[c] = acc;
      }
    }

    float row_max = kNegInf;
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c) {
      const int kcol = k0 + half * kHalfCols + c;
      float x = s[c] * scale;
      if (kcol >= lk) x = kNegInf;
      if (causal && k_off + kcol > qpos) x = kNegInf;
      s[c] = x;
      row_max = fmaxf(row_max, x);
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    const float m_new = fmaxf(m, row_max);

    float row_sum = 0.f;
    T* p_row = t.p + row * S::kLdP + half * kHalfCols;
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c) {
      const float p =
          s[c] <= kNegInf * 0.5f ? 0.f : expf(fminf(s[c] - m_new, 0.f));
      row_sum += p;
      p_row[c] = from_float<T>(p);
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    const float alpha = expf(fminf(m - m_new, 0.f));
    l = l * alpha + row_sum;
    m = m_new;

    float* o_row = t.o + row * S::kLdO;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
      o_row[d] *= alpha;
    }
    __syncwarp();
    if constexpr (TensorCore<T>::value) {
      wmma_pv<D>(t.p, t.v, t.o, warp);
    } else {
      const T* p_full = t.p + row * S::kLdP;
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
        float acc = o_row[d];
#pragma unroll 16
        for (int c = 0; c < kBlockKV; ++c) {
          acc = fmaf(to_float(p_full[c]), to_float(t.v[c * S::kLdT + d]),
                     acc);
        }
        o_row[d] = acc;
      }
    }
    __syncwarp();
  }
  __syncthreads();  // t.o is complete and visible even with no live tile
}

// Set the kernel's dynamic shared memory to its tiles' size.
template <typename T, int D, typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Smem<T, D>::kBytes));
}

}  // namespace
