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
// dQ (#13). One CTA per (b*h, 64-row q tile) loops over the live kv
// tiles, as the TPU grid's innermost axis does.
//   bf16 (flash_dq_kernel_tma): #11's walk with one product more. One
//   consumer warpgroup and one producer warp. The producer loads Q and dO
//   once by TMA, with the rows' lse and delta by cp.async (fp32 rows with
//   a ragged stride, which TMA cannot describe), and streams the live K/V
//   tiles through a ring of kStages shared-memory stages. The consumers
//   issue S = Q K^T and dP = dO V^T as wgmma m64n64k16 from shared memory
//   (all operands K-major, as stored), form p and
//   ds = p (dp - delta) scale in registers, round ds to bf16 exactly once
//   as the TPU kernel does (attention_pallas.py:153), and issue
//   dQ += dS K as wgmma m64nDk16 with dS as the register A operand and K
//   as the MN-major B. dq stays in the register accumulator for the whole
//   walk and leaves once, in fp32, one owner per row. The masks run only
//   on edge tiles (keys past Lk, the causal diagonal); causal grids run
//   tile-major across heads, the heaviest (last) q tiles first; a q tile
//   with no live kv tile (a wholly masked ring hop) loads nothing, waits
//   on nothing and writes zeros.
//   fp32: plain FMA (no TF32), a lane pair per row, each tile staged
//   through shared memory by synchronous 16-byte loads.
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
// half of dQ's 3 products is 1.65 TFLOP (1.67 ms) and of dK/dV's 4
// products 2.2 TFLOP (2.2 ms): compute-bound, the regime wgmma is for.
//
// Supported: float32 or bfloat16, head_dim 64 or 128, contiguous inputs
// with 16-byte aligned bases. The C entry points return cudaGetLastError()
// (or the error of building a tensor map).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kBlock = 64;  // q rows and kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlock / kWarps;  // 16
constexpr int kHalfCols = kBlock / 2;          // tile columns per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float exp0(float x) { return expf(fminf(x, 0.f)); }

// p from a scaled, masked score and the row's lse (attention_pallas.py:146).
__device__ __forceinline__ float prob(float s, float lse) {
  return s <= kNegInf * 0.5f ? 0.f : exp0(s - lse);
}

// Row strides (fp32 elements) of the FMA kernels' shared memory. Rows
// are padded by 16 bytes against bank conflicts.
template <int D>
struct Ld {
  static constexpr int kT = D + 4;       // q, k, v, dO rows
  static constexpr int kS = kBlock + 4;  // p / ds rows
  static constexpr size_t kTile = size_t(kBlock) * kT * sizeof(float);
  static constexpr size_t kProb32 = size_t(kBlock) * kS * sizeof(float);
};

// Copy `rows_valid` rows of a 64-row fp32 tile (global row stride D) into
// shared memory in 16-byte chunks; rows past the end are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows_valid) {
  constexpr int kChunksPerRow = D / 4;
  constexpr int kChunks = kBlock * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) {
      val = *reinterpret_cast<const float4*>(src + size_t(r) * D + col);
    }
    *reinterpret_cast<float4*>(dst + r * Ld<D>::kT + col) = val;
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
// dQ, fp32: one CTA per (b*h, q tile), looping over kv tiles (FMA).
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  using L = Ld<D>;
  static constexpr size_t kBytes = 4 * L::kTile + L::kProb32;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int lq, int lk, int q_tiles, float scale, int causal,
                    int q_off, int k_off) {
  using L = Ld<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = reinterpret_cast<float*>(smem + L::kTile);
  float* k_s = reinterpret_cast<float*>(smem + 2 * L::kTile);
  float* v_s = reinterpret_cast<float*>(smem + 3 * L::kTile);
  float* ds_s = reinterpret_cast<float*>(smem + 4 * L::kTile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlock;
  const float* k_bh = k + size_t(bh) * lk * D;
  const float* v_bh = v + size_t(bh) * lk * D;

  load_tile<D>(q_s, q + (size_t(bh) * lq + q0) * D, min(kBlock, lq - q0));
  load_tile<D>(do_s, dout + (size_t(bh) * lq + q0) * D,
               min(kBlock, lq - q0));

  // A lane pair owns one q row: `half` picks its 32 of the 64 columns.
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane & 1;
  const bool row_valid = q0 + row < lq;
  const int qpos = q_off + q0 + row;
  const float lse_r = row_valid ? lse[size_t(bh) * lq + q0 + row] : 0.f;
  const float delta_r = row_valid ? delta[size_t(bh) * lq + q0 + row] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const int kv_tiles =
      live_kv_tiles((lk + kBlock - 1) / kBlock, causal, q_off, q0, k_off);
  for (int j = 0; j < kv_tiles; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s
    load_tile<D>(k_s, k_bh + size_t(k0) * D, min(kBlock, lk - k0));
    load_tile<D>(v_s, v_bh + size_t(k0) * D, min(kBlock, lk - k0));
    __syncthreads();

    const float* q_row = q_s + row * L::kT;
    const float* do_row = do_s + row * L::kT;
    for (int c = 0; c < kHalfCols; ++c) {
      const int col = half * kHalfCols + c;
      const int kcol = k0 + col;
      const float* k_row = k_s + col * L::kT;
      const float* v_row = v_s + col * L::kT;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_row[d], k_row[d], s);
        dp = fmaf(do_row[d], v_row[d], dp);
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
        a = fmaf(ds_row[c], k_s[c * L::kT + d], a);
      }
      acc[i] = a;
    }
    __syncwarp();
  }

  if (row_valid) {
    float* out = dq + (size_t(bh) * lq + q0 + row) * D + half * (D / 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) out[i] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// dQ, bf16: TMA ring, producer warp, wgmma consumer warpgroup.
// ---------------------------------------------------------------------------

using sm90::kStages;  // K/V ring depth, as in #11's walk

template <int D>
struct DqTmaSmem {
  static constexpr int kTile = kBlock * D * 2;  // one 64-row bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  // stage s: K at kKV + 2 s kTile, V after it
  static constexpr int kKV = 2 * kTile;
  static constexpr int kStats = kKV + 2 * kStages * kTile;  // lse, delta
  static constexpr int kBars = kStats + 2 * kBlock * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kLaunch = kBytes + 1024;  // room to align to 1024
};

// ds of one 64 x 64 tile from s and dp, packed to bf16 pairs as the
// register A operand of dQ += dS K (the fragment layout of
// flash_attention_sm90.cuh): this thread's entries of rows r and r + 8,
// query positions qpos and qpos + 8, whose lse and delta are lse[h] and
// delta[h]. p = 0 where s <= -5e29, else exp(min(s - lse, 0));
// ds = p (dp - delta) scale, rounded to bf16 once. kEdge: the tile holds
// keys past Lk or meets the causal diagonal, so the masks run.
template <bool kEdge>
__device__ __forceinline__ void dq_probs(const float (&sc)[32],
                                         const float (&dp)[32],
                                         const float (&lse)[2],
                                         const float (&delta)[2],
                                         float scale, int k0, int c, int lk,
                                         int causal, int qpos, int k_off,
                                         uint32_t (&ds)[16]) {
  // Entry 2i + e holds column n = 8 (i / 2) + e of row h = i % 2.
  const sm90::QueryRowMask mask(lk, k0, c, qpos, k_off);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = i % 2;
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = sc[2 * i + e] * scale;
      if constexpr (kEdge) x = mask(x, 8 * (i / 2) + e, h, causal);
      const float p = sm90::prob(x, lse[h]);
      d[e] = p * (dp[2 * i + e] - delta[h]) * scale;
    }
    ds[i] = sm90::pack_bf16(d[0], d[1]);
  }
}

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 2)
    flash_dq_kernel_tma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int bh_count, int lq, int lk,
                        int q_tiles, float scale, int causal, int q_off,
                        int k_off) {
  using L = DqTmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;         // a K/V stage has landed
  uint64_t* empty = full + kStages;  // the consumers are done with it

  // Causal: q tile i walks the kv tiles up to about i, so the last q tiles
  // are heavy; tile-major order launches every head's heaviest first.
  // Otherwise head-major, so a head's CTAs share its K and V in L2.
  const int bh = causal ? blockIdx.x % bh_count : blockIdx.x / q_tiles;
  const int q0 = (causal ? q_tiles - 1 - blockIdx.x / bh_count
                         : blockIdx.x % q_tiles) * kBlock;
  const int kv_tiles =
      live_kv_tiles((lk + kBlock - 1) / kBlock, causal, q_off, q0, k_off);
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::bar_init(q_full, 32 + 1);  // 32 lanes' copies + lane 0's TMA
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], sm90::kWarpgroup);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (tid >= sm90::kWarpgroup) {
    // The producer warp: every lane copies its share of the rows' lse and
    // delta by cp.async and arrives when its copies land; lane 0 issues
    // the TMA loads.
    const int lane = tid - sm90::kWarpgroup;
    if (kv_tiles == 0) return;
    for (int i = lane; i < kBlock; i += 32) {
      const bool valid = q0 + i < lq;
      const size_t at = valid ? size_t(bh) * lq + q0 + i : 0;
      sm90::copy_word(stats + i, lse + at, valid);  // 0 past Lq
      sm90::copy_word(stats + kBlock + i, delta + at, valid);
    }
    sm90::bar_arrive_copies(q_full);
    if (lane != 0) return;
    sm90::prefetch_map(&tm_k);
    sm90::prefetch_map(&tm_v);
    sm90::bar_expect(q_full, 2 * L::kTile);
    sm90::tma_tile<D>(smem + L::kQ, &tm_q, q_full, q0, bh);
    sm90::tma_tile<D>(smem + L::kDo, &tm_do, q_full, q0, bh);
    for (int j = 0; j < kv_tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) sm90::bar_wait(&empty[s], (j / kStages - 1) & 1);
      unsigned char* k_s = smem + L::kKV + 2 * s * L::kTile;
      sm90::bar_expect(&full[s], 2 * L::kTile);
      sm90::tma_tile<D>(k_s, &tm_k, &full[s], j * kBlock, bh);
      sm90::tma_tile<D>(k_s + L::kTile, &tm_v, &full[s], j * kBlock, bh);
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

  if (kv_tiles > 0) {
    sm90::bar_wait(q_full, 0);
    const float lse_r[2] = {stats[r], stats[r + 8]};
    const float delta_r[2] = {stats[kBlock + r], stats[kBlock + r + 8]};
    const int qpos = q_off + q0 + r;
    for (int j = 0; j < kv_tiles; ++j) {
      const int s = j % kStages;
      sm90::bar_wait(&full[s], (j / kStages) & 1);
      const unsigned char* k_s = smem + L::kKV + 2 * s * L::kTile;
      const unsigned char* v_s = k_s + L::kTile;

      float sc[32];  // s = Q K^T
      float dp[32];  // dp = dO V^T
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::mma_ss_n64(sc, sm90::desc_k(smem + L::kQ, kk),
                         sm90::desc_k(k_s, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::mma_ss_n64(dp, sm90::desc_k(smem + L::kDo, kk),
                         sm90::desc_k(v_s, kk), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::hold(sc);
      sm90::hold(dp);

      const int k0 = j * kBlock;
      uint32_t ds[16];
      if (sm90::edge_tile(k0, lk, causal, q_off, q0, k_off)) {
        dq_probs<true>(sc, dp, lse_r, delta_r, scale, k0, c, lk, causal,
                       qpos, k_off, ds);
      } else {
        dq_probs<false>(sc, dp, lse_r, delta_r, scale, k0, c, lk, causal,
                        qpos, k_off, ds);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::mma_rs<D>(acc, ds + 4 * kk, sm90::desc_mn(k_s, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::hold(acc);
      sm90::hold(ds);
      sm90::bar_arrive(&empty[s]);
    }
  }

  // One owner per output row: fp32 dq straight from the accumulator
  // (zeros for a q tile with no live kv tile).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r + 8 * h;
    if (row >= lq) continue;
    float* out = dq + (size_t(bh) * lq + row) * D + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(out + 8 * i) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV, fp32: one CTA per (b*h, kv tile), looping over q tiles (FMA).
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  using L = Ld<D>;
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
  using L = Ld<D>;
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

  load_tile<D>(k_s, k + (size_t(bh) * lk + k0) * D, min(kBlock, lk - k0));
  load_tile<D>(v_s, v + (size_t(bh) * lk + k0) * D, min(kBlock, lk - k0));

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
    load_tile<D>(q_s, q_bh + size_t(q0) * D, min(kBlock, lq - q0));
    load_tile<D>(do_s, do_bh + size_t(q0) * D, min(kBlock, lq - q0));
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
        s = fmaf(q_row[d], k_row[d], s);
        dp = fmaf(do_row[d], v_row[d], dp);
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
        av = fmaf(p_row[c], do_s[c * L::kT + d], av);
        ak = fmaf(ds_row[c], q_s[c * L::kT + d], ak);
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
  // Entry 4g + 2h + e holds column n = 8g + e of row h.
  const sm90::KeyRowMask mask(lq, lk, q0, kv, c, q_off, k_off);
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
        const float x = mask(sc[4 * g + 2 * h + e] * scale, n, h, causal);
        const float lse_e = e ? lse_q.y : lse_q.x;
        const float delta_e = e ? delta_q.y : delta_q.x;
        p[e] = sm90::prob(x, lse_e);
        ds[e] = p[e] * (dp[4 * g + 2 * h + e] - delta_e) * scale;
        p[e] = n >= mask.q_past ? 0.f : p[e];
        ds[e] = n >= mask.q_past ? 0.f : ds[e];
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

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int lq, int lk, float scale,
                      int causal, int q_off, int k_off, cudaStream_t stream) {
  constexpr size_t bytes = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlock - 1) / kBlock;
  flash_dq_kernel<D><<<dim3(bh * q_tiles), dim3(kThreads), bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), lq, lk, q_tiles, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int lq,
                          int lk, float scale, int causal, int q_off,
                          int k_off, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = sm90::tensor_map(&tm_q, q, bh, lq, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_k, k, bh, lk, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_v, v, bh, lk, D);
  if (err == cudaSuccess) err = sm90::tensor_map(&tm_do, dout, bh, lq, D);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_dq_kernel_tma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqTmaSmem<D>::kLaunch);
  }
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlock - 1) / kBlock;
  flash_dq_kernel_tma<D><<<dim3(bh * q_tiles), dim3(sm90::kThreads),
                           DqTmaSmem<D>::kLaunch, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), bh, lq, lk,
      q_tiles, scale, causal, q_off, k_off);
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
#define NTX_DQ(launch, D)                                                  \
  return launch<D>(q, k, v, dout, lse, delta, dq, bh, lq, lk, scale, causal, \
                   q_off, k_off, s)
  if (dtype == 0 && head_dim == 64) NTX_DQ(launch_dq, 64);
  if (dtype == 0 && head_dim == 128) NTX_DQ(launch_dq, 128);
  if (dtype == 1 && head_dim == 64) NTX_DQ(launch_dq_tma, 64);
  if (dtype == 1 && head_dim == 128) NTX_DQ(launch_dq_tma, 128);
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
