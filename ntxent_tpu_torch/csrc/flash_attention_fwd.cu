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
// per (batch*head, 64-row q tile), 4 warps, each warp owning 16 q rows
// (the walk, shared with the fold kernel #12, is fold_kv_tiles in
// flash_attention_tile.cuh). The q tile stays in shared memory; each K/V
// tile is staged through shared memory once per q tile. In bf16 the two
// products run on the tensor cores through WMMA (16x16x16, fp32
// accumulate); s and the fp32 accumulator round-trip through shared
// memory so that the row-wise softmax update can address rows. In fp32
// both products are plain FMA (the tensor cores' TF32 would lose the
// fp32 contract).
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

#include "flash_attention_tile.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int lq, int lk, int q_tiles,
                     float scale, int causal, int q_off, int k_off) {
  using S = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T, D> t(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;

  load_tile<T, D>(t.q, q + (size_t(bh) * lq + q0) * D, min(kBlockQ, lq - q0),
                  tid);
  for (int i = tid; i < kBlockQ * S::kLdO; i += kThreads) t.o[i] = 0.f;

  // A lane pair owns one q row: `half` picks its 32 of the 64 columns of
  // s and p, and its D/2 columns of the accumulator. Both lanes keep the
  // row's running (m, l) in registers.
  const int row = (tid / 32) * kRowsPerWarp + lane / 2;
  const int half = lane & 1;
  float m = kNegInf;
  float l = 0.f;
  fold_kv_tiles<T, D>(t, k + size_t(bh) * lk * D, v + size_t(bh) * lk * D,
                      lk, q0, row, half, scale, causal, q_off, k_off, m, l);

  if (q0 + row < lq) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float* o_row = t.o + row * S::kLdO;
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
  cudaError_t err = allow_smem<T, D>(flash_fwd_kernel<T, D>);
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<T, D><<<dim3(bh * q_tiles), dim3(kThreads),
                           Smem<T, D>::kBytes, stream>>>(
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
