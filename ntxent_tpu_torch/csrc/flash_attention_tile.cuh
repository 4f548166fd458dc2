// The fp32 tile walk of the flash-attention forward (flash_attention_fwd.cu,
// kernel #11) and the carried-statistics fold (flash_attention_fold.cu,
// kernel #12). Their bf16 variants walk the tiles with TMA and wgmma
// instead (flash_attention_sm90.cuh).
//
// One CTA owns one (batch*head, 64-row q tile); 4 warps, each warp 16 q
// rows, a lane pair one row. The q tile stays in shared memory; each K/V
// tile is staged through shared memory once per q tile. Both products
// are plain FMA (the tensor cores' TF32 would lose the fp32 contract);
// the fp32 accumulator lives in shared memory, each lane pair owning its
// row's D columns.
//
// `fold_kv_tiles` is the online-softmax walk over the live K/V tiles
// (attention_pallas.py:93-110 and :236-253): per tile,
//   s = (q . k^T) * scale in fp32; keys past Lk and, when causal, keys
//   after the query's global position (k_off + j > q_off + i) -> -1e30;
//   m_new = max(m, rowmax s); p = 0 where s <= -5e29, else
//   exp(min(s - m_new, 0)); alpha = exp(min(m - m_new, 0));
//   l = l * alpha + sum p; acc = acc * alpha + p . V.
// Causal tiles that lie wholly above the diagonal are skipped, so a hop
// that lies wholly in a row tile's future walks no tile and leaves the
// carried (m, l, acc) untouched.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr int kHalfCols = kBlockKV / 2;         // columns per lane of a pair
constexpr float kNegInf = -1e30f;

// Shared-memory layout. Every row is padded by 16 bytes against bank
// conflicts.
template <int D>
struct Smem {
  static constexpr int kLdT = D + 4;             // q, k, v rows
  static constexpr int kLdP = kBlockKV + 4;      // p rows
  static constexpr int kLdO = D + 4;             // accumulator rows
  static constexpr size_t kQ = size_t(kBlockQ) * kLdT * sizeof(float);
  static constexpr size_t kKV = size_t(kBlockKV) * kLdT * sizeof(float);
  static constexpr size_t kP = size_t(kBlockQ) * kLdP * sizeof(float);
  static constexpr size_t kO = size_t(kBlockQ) * kLdO * sizeof(float);
  static constexpr size_t kBytes = kQ + 2 * kKV + kP + kO;
};

// The regions of one CTA's dynamic shared memory.
template <int D>
struct Tiles {
  using S = Smem<D>;
  float* q;
  float* k;
  float* v;
  float* p;
  float* o;
  __device__ explicit Tiles(unsigned char* smem)
      : q(reinterpret_cast<float*>(smem)),
        k(reinterpret_cast<float*>(smem + S::kQ)),
        v(reinterpret_cast<float*>(smem + S::kQ + S::kKV)),
        p(reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV)),
        o(reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV + S::kP)) {}
};

// Copy `rows_valid` rows of a 64-row tile (global row stride D) into
// shared memory in 16-byte chunks; rows past the end are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows_valid, int tid) {
  constexpr int kChunksPerRow = D / 4;
  constexpr int kChunks = kBlockKV * kChunksPerRow;
  for (int c = tid; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) {
      val = *reinterpret_cast<const float4*>(src + size_t(r) * D + col);
    }
    *reinterpret_cast<float4*>(dst + r * Smem<D>::kLdT + col) = val;
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
template <int D>
__device__ __forceinline__ void fold_kv_tiles(const Tiles<D>& t,
                                              const float* k_bh,
                                              const float* v_bh, int lk,
                                              int q0, int row, int half,
                                              float scale, int causal,
                                              int q_off, int k_off, float& m,
                                              float& l) {
  using S = Smem<D>;
  const int tid = threadIdx.x;
  const int qpos = q_off + q0 + row;
  const int kv_tiles = live_kv_tiles(lk, q0, causal, q_off, k_off);

  for (int j = 0; j < kv_tiles; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // the previous tile's readers are done with k/v
    load_tile<D>(t.k, k_bh + size_t(k0) * D, min(kBlockKV, lk - k0), tid);
    load_tile<D>(t.v, v_bh + size_t(k0) * D, min(kBlockKV, lk - k0), tid);
    __syncthreads();

    float s[kHalfCols];
    const float* q_row = t.q + row * S::kLdT;
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c) {
      const float* k_row = t.k + (half * kHalfCols + c) * S::kLdT;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(q_row[d], k_row[d], acc);
      s[c] = acc;
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
    float* p_row = t.p + row * S::kLdP + half * kHalfCols;
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c) {
      const float p =
          s[c] <= kNegInf * 0.5f ? 0.f : expf(fminf(s[c] - m_new, 0.f));
      row_sum += p;
      p_row[c] = p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    const float alpha = expf(fminf(m - m_new, 0.f));
    l = l * alpha + row_sum;
    m = m_new;

    float* o_row = t.o + row * S::kLdO;
    __syncwarp();
    const float* p_full = t.p + row * S::kLdP;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
      float acc = o_row[d] * alpha;
#pragma unroll 16
      for (int c = 0; c < kBlockKV; ++c) {
        acc = fmaf(p_full[c], t.v[c * S::kLdT + d], acc);
      }
      o_row[d] = acc;
    }
    __syncwarp();
  }
  __syncthreads();  // t.o is complete and visible even with no live tile
}

// Set the kernel's dynamic shared memory to its tiles' size.
template <int D, typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Smem<D>::kBytes));
}

}  // namespace
