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
// Causal kv tiles that lie entirely above the diagonal are skipped
// (live_kv_tiles), so a row tile with no live key writes o = 0 and
// lse = -1e30 + log(1e-37).
//
// Bound at the ViT-B/16 shapes (D = 64, L = 197, bf16, non-causal; B*H
// 768 serving bucket 64, 6144 training at batch 256): 4 * B*H * L^2 * D
// flops (61 GFLOP at B*H 6144, 62 us at 989 TFLOP/s) against q, k, v and
// o read or written once (0.62 GB, 0.19 ms at 3.35 TB/s): memory-bound,
// so what counts is reading each tile once per CTA with the loads in
// flight while the tensor cores work, and keeping s, p and the
// accumulator out of memory.
//
// Design, bf16 (flash_fwd_kernel_tma; FlashAttention-3's shape): the
// forward walk of flash_attention_sm90.cuh (fwd_produce, fwd_consume),
// shared with #12. One CTA per (batch*head, 64-row q tile): one consumer
// warpgroup (128 threads) and one producer warp, which loads the q tile
// once and streams the live K/V tiles through an mbarrier ring by TMA
// ((D, L, B*H) tensor maps, the 128-byte swizzle, rows past L
// zero-filled); S = Q K^T and O += P V run as wgmma with P in registers,
// and O stays in registers for the whole walk; only the epilogue writes
// o and lse. With so little work a tile (L = 197 is 4 K/V tiles), the
// softmax's instructions, not the tensor cores or the loads, bound a
// CTA: exp runs on the SFU (sm90::exp0), the masks run only on tiles
// that hold keys past Lk or meet the causal diagonal
// (online_softmax<kEdge>), and at D = 64 the kernel is small enough in
// registers for 4 CTAs (16 consumer warps) to share an SM.
//
// Design, fp32: the FMA walk of flash_attention_tile.cuh (fold_kv_tiles,
// shared with #12): one CTA per (batch*head, 64-row q tile), 4 warps, a
// lane pair per q row, the accumulator in shared memory (the tensor
// cores' TF32 would lose the fp32 contract).
//
// Supported: dtype float32 or bfloat16, head_dim 64 or 128, q/k/v/o
// contiguous (B*H, L, D) with 16-byte aligned bases. The C entry point
// returns cudaGetLastError() after the launch (or the error of building
// a tensor map).

#include "flash_attention_tile.cuh"
#include "flash_attention_sm90.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int lq, int lk, int q_tiles,
                     float scale, int causal, int q_off, int k_off) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<D> t(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;

  load_tile<D>(t.q, q + (size_t(bh) * lq + q0) * D, min(kBlockQ, lq - q0),
               tid);
  for (int i = tid; i < kBlockQ * S::kLdO; i += kThreads) t.o[i] = 0.f;

  // A lane pair owns one q row: `half` picks its 32 of the 64 columns of
  // s and p, and its D/2 columns of the accumulator. Both lanes keep the
  // row's running (m, l) in registers.
  const int row = (tid / 32) * kRowsPerWarp + lane / 2;
  const int half = lane & 1;
  float m = kNegInf;
  float l = 0.f;
  fold_kv_tiles<D>(t, k + size_t(bh) * lk * D, v + size_t(bh) * lk * D, lk,
                   q0, row, half, scale, causal, q_off, k_off, m, l);

  if (q0 + row < lq) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float* o_row = t.o + row * S::kLdO;
    float* out = o + (size_t(bh) * lq + q0 + row) * D;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
      out[d] = o_row[d] / l_safe;
    }
    if (half == 0) {
      lse[size_t(bh) * lq + q0 + row] = m + logf(fmaxf(l, 1e-37f));
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, float scale, int causal,
                   int q_off, int k_off, cudaStream_t stream) {
  cudaError_t err = allow_smem<D>(flash_fwd_kernel<D>);
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<D><<<dim3(bh * q_tiles), dim3(kThreads),
                        Smem<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), lq, lk, q_tiles, scale, causal, q_off,
      k_off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, producer warp, wgmma consumer warpgroup.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 2)
    flash_fwd_kernel_tma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int lq, int lk,
                         int q_tiles, float scale, int causal, int q_off,
                         int k_off) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const int kv_tiles = live_kv_tiles(lk, q0, causal, q_off, k_off);
  uint64_t* bars = sm90::fwd_barriers<D>(smem);
  if (threadIdx.x >= sm90::kWarpgroup) {
    sm90::fwd_produce<D>(smem, bars, &tm_q, &tm_k, &tm_v, bh, q0, kv_tiles);
    return;
  }

  // The consumer warpgroup. This thread holds rows r and r + 8 of the
  // tile, columns 8i + c and 8i + c + 1 of every 8-column group.
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  sm90::fwd_consume<D>(smem, bars, kv_tiles, lk, q0, r, c, scale, causal,
                       q_off, k_off, acc, m, l);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r + 8 * h;
    if (row >= lq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* out = o + (size_t(bh) * lq + row) * D + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {  // acc / l, as the plain version
      const uint32_t v = sm90::pack_bf16(acc[4 * i + 2 * h] / l_safe,
                                         acc[4 * i + 2 * h + 1] / l_safe);
      *reinterpret_cast<uint32_t*>(out + 8 * i) = v;
    }
    if (lane % 4 == 0) {
      lse[size_t(bh) * lq + row] = m[h] + logf(fmaxf(l[h], 1e-37f));
    }
  }
}

template <int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int lq, int lk, float scale,
                       int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = sm90::tensor_map(&tm_q, q, bh, lq, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_k, k, bh, lk, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_v, v, bh, lk, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_kernel_tma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sm90::FwdSmem<D>::kLaunch);
  }
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel_tma<D><<<dim3(bh * q_tiles), dim3(sm90::kThreads),
                            sm90::FwdSmem<D>::kLaunch, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), lq, lk, q_tiles, scale, causal, q_off, k_off);
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
    return launch<64>(q, k, v, o, lse, bh, lq, lk, scale, causal, q_off,
                      k_off, s);
  if (dtype == 0 && head_dim == 128)
    return launch<128>(q, k, v, o, lse, bh, lq, lk, scale, causal, q_off,
                       k_off, s);
  if (dtype == 1 && head_dim == 64)
    return launch_tma<64>(q, k, v, o, lse, bh, lq, lk, scale, causal, q_off,
                          k_off, s);
  if (dtype == 1 && head_dim == 128)
    return launch_tma<128>(q, k, v, o, lse, bh, lq, lk, scale, causal, q_off,
                           k_off, s);
  return cudaErrorInvalidValue;
}
