// One flash fold with carried statistics, for Hopper (sm_90a), bound to
// PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/attention_pallas.py:217
// (_fold_kernel, launched by flash_fold at attention_pallas.py:261, its
// pallas_call at :291): the per-hop fold of the fused ring attention
// (ntxent_tpu/parallel/ring_attention.py:297-391). Per (batch*head) row
// it takes the running fp32 (m, l, acc) of earlier hops, folds every live
// tile of this hop's K/V block into them exactly as the forward kernel
// #11 folds its tiles (fp32 scores, keys past Lk and, when causal, keys
// after the query's global position k_off + j > q_off + i masked to
// -1e30, p = 0 where s <= -5e29 else exp(min(s - m_new, 0)),
// alpha = exp(min(m - m_new, 0)), l = l alpha + sum p,
// acc = acc alpha + (p cast to V's dtype) . V), and writes (m, l, acc) out
// unnormalized: no division, no lse. The ring forms
// lse = m + log(max(l, 1e-37)) and out = acc / l after its last hop.
//
// Bound at the long-context path's shape (world 1: B*H = 8, L = 32768,
// D = 64, bf16, causal): 2 * 2 * 8 * 32768^2 * 64 / 2 = 1.10 TFLOP, 1.11
// ms at the bf16 tensor-core peak of 989 TFLOP/s; q, k, v (0.1 GB) and
// (m, l, acc) in and out (0.27 GB) are 0.11 ms at 3.35 TB/s. The call is
// compute-bound: the regime of wgmma.
//
// Design, bf16 (flash_fold_kernel_tma): #11's TMA/wgmma walk
// (flash_attention_sm90.cuh: fwd_produce, fwd_consume) with the carry
// loaded. Before the walk each consumer thread loads its rows' fp32 acc
// straight into the wgmma register accumulator (the fragment layout of
// flash_attention_sm90.cuh) and their (m, l) into registers; after it
// the three leave as they are. Causal grids run tile-major across heads,
// heaviest first: under a causal mask the last q tiles see the most live
// K/V tiles. An early causal hop lies wholly in a q tile's future
// (k_off > q_off + q0 + 63): the tile loads nothing, waits on no barrier
// and writes its carry back bit for bit. On the first hop (m = -1e30,
// l = 0, acc = 0) a row whose keys are all masked keeps m = -1e30, and
// alpha = exp(min(0, 0)) = 1 with p = 0 leaves l and acc at exactly 0.
//
// Design, fp32: the FMA walk of flash_attention_tile.cuh (fold_kv_tiles,
// shared with the fp32 #11), the accumulator staged through shared
// memory.
//
// The inputs and outputs are separate buffers (the wrapper allocates new
// ones; no aliasing). Supported: dtype float32 or bfloat16 for q/k/v,
// head_dim 64 or 128, q, k, v, acc contiguous (B*H, L, D) and m, l
// contiguous (B*H, Lq) fp32, all with 16-byte aligned bases. The C entry
// point returns cudaGetLastError() after the launch (or the error of
// building a tensor map).

#include "flash_attention_tile.cuh"
#include "flash_attention_sm90.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fold_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ acc_in,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ acc_out, int lq, int lk,
                      int q_tiles, float scale, int causal, int q_off,
                      int k_off) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<D> t(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const int rows_valid = min(kBlockQ, lq - q0);
  const size_t base = size_t(bh) * lq + q0;  // first row of the tile

  load_tile<D>(t.q, q + base * D, rows_valid, tid);
  // The carried accumulator, 16 bytes at a time; rows past Lq start at 0.
  constexpr int kVecPerRow = D / 4;
  for (int c = tid; c < kBlockQ * kVecPerRow; c += kThreads) {
    const int r = c / kVecPerRow;
    const int col = (c % kVecPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) {
      val = *reinterpret_cast<const float4*>(acc_in + (base + r) * D + col);
    }
    *reinterpret_cast<float4*>(t.o + r * S::kLdO + col) = val;
  }

  const int row = (tid / 32) * kRowsPerWarp + lane / 2;
  const int half = lane & 1;
  const bool live_row = row < rows_valid;
  float m = live_row ? m_in[base + row] : kNegInf;
  float l = live_row ? l_in[base + row] : 0.f;
  fold_kv_tiles<D>(t, k + size_t(bh) * lk * D, v + size_t(bh) * lk * D, lk,
                   q0, row, half, scale, causal, q_off, k_off, m, l);

  if (live_row && half == 0) {
    m_out[base + row] = m;
    l_out[base + row] = l;
  }
  for (int c = tid; c < rows_valid * kVecPerRow; c += kThreads) {
    const int r = c / kVecPerRow;
    const int col = (c % kVecPerRow) * 4;
    *reinterpret_cast<float4*>(acc_out + (base + r) * D + col) =
        *reinterpret_cast<const float4*>(t.o + r * S::kLdO + col);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* m_in, const void* l_in, const void* acc_in,
                   void* m_out, void* l_out, void* acc_out, int bh, int lq,
                   int lk, float scale, int causal, int q_off, int k_off,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem<D>(flash_fold_kernel<D>);
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fold_kernel<D><<<dim3(bh * q_tiles), dim3(kThreads), Smem<D>::kBytes,
                         stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(m_in),
      static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), lq, lk, q_tiles, scale, causal, q_off,
      k_off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: #11's TMA ring, producer warp and wgmma consumers, with the carry.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 2)
    flash_fold_kernel_tma(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ acc_in,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out,
                          float* __restrict__ acc_out, int bh_count, int lq,
                          int lk, int q_tiles, float scale, int causal,
                          int q_off, int k_off) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  // Causal: q tile i walks the K/V tiles up to about i, so the last q
  // tiles are heavy; tile-major order launches every head's heaviest
  // first. Otherwise head-major, so a head's CTAs share its K and V in L2.
  const int bh = causal ? blockIdx.x % bh_count : blockIdx.x / q_tiles;
  const int q0 = (causal ? q_tiles - 1 - blockIdx.x / bh_count
                         : blockIdx.x % q_tiles) * kBlockQ;
  const int kv_tiles = live_kv_tiles(lk, q0, causal, q_off, k_off);
  uint64_t* bars = sm90::fwd_barriers<D>(smem);
  if (threadIdx.x >= sm90::kWarpgroup) {
    sm90::fwd_produce<D>(smem, bars, &tm_q, &tm_k, &tm_v, bh, q0, kv_tiles);
    return;
  }

  // The consumer warpgroup. This thread holds rows r and r + 8 of the
  // tile, columns 8i + c and 8i + c + 1 of every 8-column group: the
  // carry goes straight into those registers (rows past Lq start empty).
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  float acc[D / 2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r + 8 * h;
    const bool live = row < lq;
    const size_t at = size_t(bh) * lq + row;
    m[h] = live ? m_in[at] : kNegInf;
    l[h] = live ? l_in[at] : 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 a =
          live ? *reinterpret_cast<const float2*>(acc_in + at * D + 8 * i + c)
               : make_float2(0.f, 0.f);
      acc[4 * i + 2 * h] = a.x;
      acc[4 * i + 2 * h + 1] = a.y;
    }
  }
  sm90::fwd_consume<D>(smem, bars, kv_tiles, lk, q0, r, c, scale, causal,
                       q_off, k_off, acc, m, l);

  // The carry out, unnormalized, one owner per row.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r + 8 * h;
    if (row >= lq) continue;
    const size_t at = size_t(bh) * lq + row;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(acc_out + at * D + 8 * i + c) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
    if (lane % 4 == 0) {
      m_out[at] = m[h];
      l_out[at] = l[h];
    }
  }
}

template <int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v,
                       const void* m_in, const void* l_in, const void* acc_in,
                       void* m_out, void* l_out, void* acc_out, int bh,
                       int lq, int lk, float scale, int causal, int q_off,
                       int k_off, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = sm90::tensor_map(&tm_q, q, bh, lq, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_k, k, bh, lk, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_v, v, bh, lk, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fold_kernel_tma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sm90::FwdSmem<D>::kLaunch);
  }
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fold_kernel_tma<D><<<dim3(bh * q_tiles), dim3(sm90::kThreads),
                             sm90::FwdSmem<D>::kLaunch, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(m_in),
      static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), bh, lq, lk, q_tiles, scale, causal,
      q_off, k_off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v; the carry is float32).
// Returns a cudaError_t (0 = success).
extern "C" int ntx_flash_attention_fold(
    const void* q, const void* k, const void* v, const void* m_in,
    const void* l_in, const void* acc_in, void* m_out, void* l_out,
    void* acc_out, int bh, int lq, int lk, int head_dim, int dtype,
    float scale, int causal, int q_off, int k_off, int device, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NTX_FOLD(launch, D)                                                 \
  return launch<D>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, bh,  \
                   lq, lk, scale, causal, q_off, k_off, s)
  if (dtype == 0 && head_dim == 64) NTX_FOLD(launch, 64);
  if (dtype == 0 && head_dim == 128) NTX_FOLD(launch, 128);
  if (dtype == 1 && head_dim == 64) NTX_FOLD(launch_tma, 64);
  if (dtype == 1 && head_dim == 128) NTX_FOLD(launch_tma, 128);
#undef NTX_FOLD
  return cudaErrorInvalidValue;
}
