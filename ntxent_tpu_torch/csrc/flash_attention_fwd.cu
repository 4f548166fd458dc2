// Flash-attention forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/attention_pallas.py:73
// (_fwd_kernel, launched by _flash_fwd at attention_pallas.py:488).
// It computes exactly what that kernel computes, per (batch*head) row:
//   s   = (q . k^T) * scale in fp32, whatever the input dtype;
//   keys past Lk (tile padding) and, when causal, keys after the query's
//   global position (k_off + j > q_off + i) are masked to -1e30;
//   online softmax over kv tiles with running (m, l, acc) in fp32, the
//   exp(min(x, 0)) clamp, and masked entries weighted 0;
//   p is cast to V's dtype before p . V (attention_pallas.py:105-107);
//   o   = acc / l (l == 0 -> 1 for fully masked rows), in q's dtype;
//   lse = m + log(max(l, 1e-37)).
// Causal kv tiles that lie entirely above the diagonal are skipped.
//
// Design. The TPU kernel walks a sequential kv grid axis with (m, l, acc)
// carried in VMEM scratch between grid steps. Hopper blocks run in no
// order, so the kv axis becomes a loop inside one thread block: one CTA
// per (batch*head, 64-row q tile), 4 warps, each warp owning 16 q rows.
// The q tile stays in shared memory; each K/V tile is staged through
// shared memory once per q tile. In bf16 the two products run on the
// tensor cores through WMMA (16x16x16, fp32 accumulate); s and the fp32
// accumulator round-trip through shared memory so that the row-wise
// softmax update can address rows. In fp32 both products are plain FMA
// (the tensor cores' TF32 would lose the fp32 contract).
//
// Bound at the serving shape (bucket 64 of ViT-B/16: B*H = 768, L = 197,
// D = 64, bf16, non-causal): 4*B*H*L^2*D = 7.63 GFLOP, 7.7 us at the bf16
// tensor-core peak of 989 TFLOP/s; q, k, v and o are 77.5 MB, 23.1 us at
// 3.35 TB/s. The call is memory-bound, so the design reads each K/V tile
// once per q tile and keeps s, p and the accumulator on chip. With
// L = 197 a (b*h) row has 4 q tiles, so K and V are read 4 times from
// L2/HBM; the loads are synchronous 16-byte copies (cp.async/TMA
// pipelining and wgmma are later work).
//
// Supported: dtype float32 or bfloat16, head_dim 64 or 128, q/k/v/o
// contiguous (B*H, L, D) with 16-byte aligned bases. The C entry point
// returns cudaGetLastError() after the launch.

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int lq, int lk, int q_tiles,
                     float scale, int causal, int q_off, int k_off) {
  using S = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + S::kQ);
  T* v_s = reinterpret_cast<T*>(smem + S::kQ + S::kKV);
  float* s_s = reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV);
  T* p_s = reinterpret_cast<T*>(smem + S::kQ + 2 * S::kKV + S::kS);
  float* o_s =
      reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV + S::kS + S::kP);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const T* k_bh = k + size_t(bh) * lk * D;
  const T* v_bh = v + size_t(bh) * lk * D;

  load_tile<T, D>(q_s, q + (size_t(bh) * lq + q0) * D, min(kBlockQ, lq - q0),
                  tid);
  for (int i = tid; i < kBlockQ * S::kLdO; i += kThreads) o_s[i] = 0.f;

  // A lane pair owns one q row: `half` picks its 32 of the 64 columns of
  // s and p, and its D/2 columns of the accumulator. Both lanes keep the
  // row's running (m, l) in registers.
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane & 1;
  const int qpos = q_off + q0 + row;
  float m = kNegInf;
  float l = 0.f;

  int kv_tiles = (lk + kBlockKV - 1) / kBlockKV;
  if (causal) {
    // Tile j is live iff its first key is at or before the tile's last
    // query: k_off + j*64 <= q_off + q0 + 63.
    const long long span =
        static_cast<long long>(q_off) + q0 + kBlockQ - 1 - k_off;
    const long long live = span < 0 ? 0 : span / kBlockKV + 1;
    if (live < kv_tiles) kv_tiles = static_cast<int>(live);
  }

  for (int j = 0; j < kv_tiles; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s
    load_tile<T, D>(k_s, k_bh + size_t(k0) * D, min(kBlockKV, lk - k0), tid);
    load_tile<T, D>(v_s, v_bh + size_t(k0) * D, min(kBlockKV, lk - k0), tid);
    __syncthreads();

    float s[kHalfCols];
    if constexpr (TensorCore<T>::value) {
      wmma_scores<D>(q_s, k_s, s_s, warp);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kHalfCols; ++c) {
        s[c] = s_s[row * S::kLdS + half * kHalfCols + c];
      }
    } else {
      const T* q_row = q_s + row * S::kLdT;
#pragma unroll
      for (int c = 0; c < kHalfCols; ++c) {
        const T* k_row = k_s + (half * kHalfCols + c) * S::kLdT;
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
    T* p_row = p_s + row * S::kLdP + half * kHalfCols;
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

    float* o_row = o_s + row * S::kLdO;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
      o_row[d] *= alpha;
    }
    __syncwarp();
    if constexpr (TensorCore<T>::value) {
      wmma_pv<D>(p_s, v_s, o_s, warp);
    } else {
      const T* p_full = p_s + row * S::kLdP;
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
        float acc = o_row[d];
#pragma unroll 16
        for (int c = 0; c < kBlockKV; ++c) {
          acc = fmaf(to_float(p_full[c]), to_float(v_s[c * S::kLdT + d]), acc);
        }
        o_row[d] = acc;
      }
    }
    __syncwarp();
  }
  __syncthreads();  // the zeroed accumulator is visible even with no live tile

  if (q0 + row < lq) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float* o_row = o_s + row * S::kLdO;
    T* out = o + (size_t(bh) * lq + q0 + row) * D;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
      out[d] = from_float<T>(o_row[d] / l_safe);
    }
    if (half == 0) {
      lse[size_t(bh) * lq + q0 + row] = m + logf(fmaxf(l, 1e-37f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, float scale, int causal,
                   int q_off, int k_off, cudaStream_t stream) {
  using S = Smem<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<T, D><<<dim3(bh * q_tiles), dim3(kThreads), S::kBytes,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      lq, lk, q_tiles, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int ntx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int lq, int lk, int head_dim,
                                       int dtype, float scale, int causal,
                                       int q_off, int k_off, int device,
                                       void* stream) {
  if (bh < 1 || lq < 1 || lk < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, lse, bh, lq, lk, scale, causal,
                             q_off, k_off, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, lq, lk, scale, causal,
                              q_off, k_off, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, lq, lk, scale,
                                     causal, q_off, k_off, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, lq, lk, scale,
                                      causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
