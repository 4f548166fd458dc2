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
// Design, bf16 (flash_fwd_kernel_tma; FlashAttention-3's shape). One CTA
// per (batch*head, 64-row q tile): one consumer warpgroup (128 threads)
// and one producer warp. The producer's lane 0 loads the q tile once and
// streams the live K/V tiles through a ring of kStages shared-memory
// stages by TMA (flash_attention_sm90.cuh: (D, L, B*H) tensor maps, the
// 128-byte swizzle, rows past L zero-filled), each stage completing on an
// mbarrier and released by the consumers on another. Per K/V tile the
// consumers issue S = Q K^T as wgmma m64n64k16 from shared memory (Q and
// K both K-major, as stored), take the row max and sum from the
// accumulator fragment with quad shuffles, rescale the output
// accumulator in registers, convert p to bf16 in registers and issue
// O += P V as wgmma m64nDk16 with P as the register A operand and V as
// the MN-major B. O stays in registers for the whole walk; only the
// epilogue writes o and lse. No s, p or accumulator byte goes through
// shared memory. With so little work a tile (L = 197 is 4 K/V tiles),
// the softmax's instructions, not the tensor cores or the loads, bound a
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

// ---------------------------------------------------------------------------
// bf16: TMA ring, producer warp, wgmma consumer warpgroup.
// ---------------------------------------------------------------------------

constexpr int kStages = 2;  // K/V ring depth

template <int D>
struct TmaSmem {
  static constexpr int kTile = sm90::kRows * D * 2;  // one 64-row tile
  static constexpr int kQ = 0;
  static constexpr int kKV = kTile;  // stage s: K at kKV + 2 s kTile, V next
  static constexpr int kBars = kKV + 2 * kStages * kTile;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kLaunch = kBytes + 1024;  // room to align to 1024
};

// The online-softmax step of one 64 x 64 score tile, on this thread's 32
// entries of rows r and r + 8 (query positions qpos and qpos + 8): scale,
// mask (kEdge: the tile holds keys past Lk or meets the causal diagonal),
// m_new = max(m, row max) over the quad, p = 0 where s <= -5e29 else
// exp(min(s - m_new, 0)) in place of s, alpha = exp(min(m - m_new, 0)),
// l = l alpha + row sum, m = m_new.
template <bool kEdge>
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               float scale, int k0, int c,
                                               int lk, int causal, int qpos,
                                               int k_off) {
  // Entry i holds key k0 + c + n, n = 8 (i / 4) + i % 2: it lies past Lk
  // when n >= past, and after row h's query when n > after[h] (causal).
  const int past = lk - k0 - c;
  const int after[2] = {qpos - k_off - k0 - c, qpos + 8 - k_off - k0 - c};
  float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) % 2;
    const int n = 8 * (i / 4) + i % 2;
    float x = sc[i] * scale;
    if constexpr (kEdge) {
      const bool masked = (n >= past) | (causal & (n > after[h]));
      x = masked ? kNegInf : x;
    }
    sc[i] = x;
    row_max[h] = fmaxf(row_max[h], x);
  }
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_max[h] = fmaxf(row_max[h],
                       __shfl_xor_sync(0xffffffffu, row_max[h], 1));
    row_max[h] = fmaxf(row_max[h],
                       __shfl_xor_sync(0xffffffffu, row_max[h], 2));
    row_max[h] = fmaxf(m[h], row_max[h]);  // m_new
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) % 2;
    const float x = sc[i];
    const float p = x <= kNegInf * 0.5f ? 0.f : sm90::exp0(x - row_max[h]);
    sc[i] = p;
    row_sum[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    alpha[h] = sm90::exp0(m[h] - row_max[h]);
    l[h] = l[h] * alpha[h] + row_sum[h];
    m[h] = row_max[h];
  }
}

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 2)
    flash_fwd_kernel_tma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int lq, int lk,
                         int q_tiles, float scale, int causal, int q_off,
                         int k_off) {
  using L = TmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;       // a K/V stage has landed
  uint64_t* empty = full + kStages;  // the consumers are done with it

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlockQ;
  const int kv_tiles = live_kv_tiles(lk, q0, causal, q_off, k_off);
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], sm90::kWarpgroup);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (tid >= sm90::kWarpgroup) {  // the producer warp: lane 0 issues TMA
    if (tid == sm90::kWarpgroup && kv_tiles > 0) {
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::bar_expect(q_full, L::kTile);
      sm90::tma_tile<D>(smem + L::kQ, &tm_q, q_full, q0, bh);
      for (int j = 0; j < kv_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) sm90::bar_wait(&empty[s], (j / kStages - 1) & 1);
        unsigned char* k_s = smem + L::kKV + 2 * s * L::kTile;
        sm90::bar_expect(&full[s], 2 * L::kTile);
        sm90::tma_tile<D>(k_s, &tm_k, &full[s], j * kBlockKV, bh);
        sm90::tma_tile<D>(k_s + L::kTile, &tm_v, &full[s], j * kBlockKV, bh);
      }
    }
    return;
  }

  // The consumer warpgroup. This thread holds rows r and r + 8 of the
  // tile, columns 8i + c and 8i + c + 1 of every 8-column group.
  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (kv_tiles > 0) sm90::bar_wait(q_full, 0);
  for (int j = 0; j < kv_tiles; ++j) {
    const int s = j % kStages;
    sm90::bar_wait(&full[s], (j / kStages) & 1);
    const unsigned char* k_s = smem + L::kKV + 2 * s * L::kTile;
    const unsigned char* v_s = k_s + L::kTile;

    float sc[32];  // s = q . k^T, 64 x 64
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::mma_ss_n64(sc, sm90::desc_k(smem + L::kQ, kk),
                       sm90::desc_k(k_s, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::hold(sc);

    const int k0 = j * kBlockKV;
    float alpha[2];
    // Only a tile with keys past Lk, or one that meets the causal
    // diagonal (its last key after its first query), needs the masks.
    const bool edge = k0 + kBlockKV > lk ||
                      (causal && static_cast<long long>(k_off) + k0 +
                                         kBlockKV - 1 >
                                     static_cast<long long>(q_off) + q0);
    if (edge) {
      online_softmax<true>(sc, m, l, alpha, scale, k0, c, lk, causal,
                           q_off + q0 + r, k_off);
    } else {
      online_softmax<false>(sc, m, l, alpha, scale, k0, c, lk, causal,
                            q_off + q0 + r, k_off);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // p in bf16 (V's dtype) as the register A operand of O += P V.
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = sm90::pack_bf16(sc[2 * i], sc[2 * i + 1]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::mma_rs<D>(acc, pa + 4 * kk, sm90::desc_mn(v_s, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::hold(acc);
    sm90::hold(pa);
    sm90::bar_arrive(&empty[s]);
  }

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
                               TmaSmem<D>::kLaunch);
  }
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel_tma<D><<<dim3(bh * q_tiles), dim3(sm90::kThreads),
                            TmaSmem<D>::kLaunch, stream>>>(
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
    return launch<float, 64>(q, k, v, o, lse, bh, lq, lk, scale, causal,
                             q_off, k_off, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse, bh, lq, lk, scale, causal,
                              q_off, k_off, s);
  if (dtype == 1 && head_dim == 64)
    return launch_tma<64>(q, k, v, o, lse, bh, lq, lk, scale, causal, q_off,
                          k_off, s);
  if (dtype == 1 && head_dim == 128)
    return launch_tma<128>(q, k, v, o, lse, bh, lq, lk, scale, causal, q_off,
                           k_off, s);
  return cudaErrorInvalidValue;
}
