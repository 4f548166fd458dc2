// NT-Xent symmetric backward for Hopper (sm_90a) on TF32 tensor cores,
// bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/ntxent_pallas.py:445
// (_bwd_sym_kernel, launched by _bwd_sym_call at ntxent_pallas.py:612).
// For the stacked views z (2N, D) and the forward's row logsumexp lse it
// computes, as that kernel does,
//   s[a, b]  = (z_a . z_b) * inv_t in fp32, diagonal masked to -1e30;
//   p_row    = exp(min(s[a, b] - lse[a], 0)),  p_col = exp(min(s[a, b] - lse[b], 0));
//   G[a, b]  = (p_row - pos[a, b]) + (p_col - pos[a, b]),
//              pos[a, b] = 1 iff b = (a + N) mod 2N;
//   grad[a]  = sum_b G[a, b] z_b   (fp32, before the caller's g / T scale).
// Both gradient terms of z_a (as a row and as a column of s) fold into one
// pass because s is symmetric and the positive map is an involution.
// Every row of the symmetric layout is real (no tile padding here), so
// the valid_row / valid_col factors of the TPU kernel are 1.
//
// Design (ntxent_tf32.cuh holds the walk). The operand-prep pass writes
// z's hi and lo (rows, Dp) and, transposed, (DT, Cp): grad = G . z takes
// z as the B operand with K = the columns, which is MN-major as z lies,
// and TF32 wgmma takes only K-major operands. One CTA per (64-row tile,
// column split, chunk of D of at most 128): per 64-column tile it forms s
// as the forward does (3xTF32 for fp32 z), G in the accumulator fragment,
// G's hi and lo (G is fp32, not exact in TF32), and adds G . z by wgmma
// m64nNk8 with G as the register A operand and the transposed tile, two K
// boxes of 32 columns, as B: three products for fp32 z (G_lo z_hi, G_hi
// z_lo, then G_hi z_hi), two for bf16 (z_lo = 0).
//
// Sums. The tensor core adds into its fp32 accumulator without rounding
// to nearest, so a chain of 3 x 8 x 2N / 64 products (3072 at 2N = 8192)
// drifts (4e-5 on the gradient at 2N = 8192 on an H100; one
// TF32 pass errs 2.5e-4). Each 64-column tile therefore starts a fresh
// accumulator, and each thread adds it to its own running sum in shared
// memory (64 x 128 fp32, 32 KB) with a rounded fp32 add: 24 products
// to a chain.
//
// G from registers. The fp32 accumulator holds row r's columns 2q and
// 2q + 1 of each 8-column group (q = lane % 4); a TF32 A fragment holds K
// q and q + 4. So the prep pass stores the transposed z with each group's
// columns in the order (0, 2, 4, 6, 1, 3, 5, 7): K index q + 4e is column
// 2q + e, and the accumulator's registers d[4i], d[4i + 2], d[4i + 1],
// d[4i + 3] are the A fragment of k8 step i as they lie. Chosen over
// staging G through shared memory: no store, fence or 32 KB of G tiles,
// and the permutation costs nothing in a pass that writes the copy anyway.
//
// Splits. With one split each CTA writes its rows' gradient; with more,
// each writes a partial (splits, 2N, D) and a sum kernel adds the splits
// in order. One owner per output, no atomics: repeatable bit for bit.
//
// Bound: two 2N x 2N x D products, each three TF32 passes (165 TFLOP/s
// for fp32-accurate products): at 2N = 512, D = 128, 134 MFLOP, 0.81 us;
// at 2N = 8192, 208 us. z, lse and grad are 0.5 MB at 2N = 512 (0.16 us
// at 3.35 TB/s). Shared memory: the row tile 2 Dp x 256 bytes (64 KB at
// D = 128, 128 KB at 256), the running sums (ND x 256 bytes, 32 KB for
// 128 columns of D) and a ring of 32 KB stages (a K box of the column
// tile, hi and lo, or a 32-column half of the transposed tile): 4 stages
// at D = 128 (224 KB), 2 at D = 256 (224 KB).
//
// Supported: float32 or bfloat16 z, contiguous (rows, D), rows even >= 2,
// 1 <= D <= 256. The C entry point returns cudaGetLastError().

#include "ntxent_tf32.cuh"

namespace {

using namespace ntx;

template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_bwd_sym_walk(const __grid_constant__ CUtensorMap tm_h,
                        const __grid_constant__ CUtensorMap tm_l,
                        const __grid_constant__ CUtensorMap tm_ht,
                        const __grid_constant__ CUtensorMap tm_lt,
                        const float* __restrict__ lse,
                        float* __restrict__ out, Plan p, int n, int d,
                        int split_cols, float inv_t) {
  constexpr int kHalfBytes = ND * 128;  // one K box of the transposed tile
  extern __shared__ unsigned char raw[];
  unsigned char* smem = sm90::aligned_smem(raw);
  uint64_t* bars = walk_barriers(smem, p);
  Ring ring(smem, bars, p);
  const int row0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int d0 = blockIdx.z * ND;
  const int cb = split * split_cols;
  const int ce = min(cb + split_cols, n);
  const int tiles = (ce - cb + kTile - 1) / kTile;

  if (threadIdx.x >= kWarpgroup) {  // the producer warp
    if (threadIdx.x == kWarpgroup) {
      load_rows<kSplit>(smem, bars, p, &tm_h, &tm_l, row0);
      for (int t = 0; t < tiles; ++t) {
        const int col0 = cb + t * kTile;
        load_cols<kSplit>(ring, p, &tm_h, &tm_l, col0);
        for (int half = 0; half < 2; ++half) {
          uint64_t* bar;
          unsigned char* slot =
              ring.load(kHalfBytes * (kSplit ? 2 : 1), &bar);
          tma_box_2d(slot, &tm_ht, bar, col0 + half * kBoxK, d0);
          if constexpr (kSplit) {
            tma_box_2d(slot + kHalfBytes, &tm_lt, bar, col0 + half * kBoxK,
                       d0);
          }
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  const int q = lane % 4;
  const int n_half = n / 2;
  int row[2], pos_col[2];
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row0 + r + 8 * h;
    pos_col[h] = row[h] < n_half ? row[h] + n_half : row[h] - n_half;
    lse_r[h] = row[h] < n ? lse[row[h]] : 0.f;
  }
  float acc[ND / 2];
  // This thread's running sum of acc[j], at sum[j * kWarpgroup + tid].
  float* sum = reinterpret_cast<float*>(smem + p.extra) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < ND / 2; ++j) sum[j * kWarpgroup] = 0.f;

  bar_wait(bars, 0);
  for (int t = 0; t < tiles; ++t) {
    const int col0 = cb + t * kTile;
    float lse_c[16];  // entry 2i + e: column col0 + 8i + 2q + e
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * (j / 2) + 2 * q + j % 2;
      lse_c[j] = col < ce ? lse[col] : 0.f;
    }
    float s[32];
    s_tile<kSplit>(smem, p, ring, s);

    // G in place of s, split into TF32 hi and lo.
    uint32_t g_hi[32], g_lo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // row r + 8h, column 8 (i / 4) + 2q + i % 2
      const int h = (i / 2) % 2;
      const int col = col0 + 8 * (i / 4) + 2 * q + i % 2;
      const bool live = col < ce;
      const float x = (!live || col == row[h]) ? kNegInf : s[i] * inv_t;
      const float pos = col == pos_col[h] ? 1.f : 0.f;
      float g = (exp0(x - lse_r[h]) - pos) +
                (exp0(x - lse_c[2 * (i / 4) + i % 2]) - pos);
      if (!live || row[h] >= n) g = 0.f;
      g_hi[i] = tf32_bits(g);
      g_lo[i] = __float_as_uint(g - __uint_as_float(g_hi[i]));
    }

    for (int half = 0; half < 2; ++half) {
      const unsigned char* zt_hi = ring.acquire();
      const unsigned char* zt_lo = zt_hi + kHalfBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int i = 4 * half + kk;  // k8 step: columns 8i .. 8i + 7
        const uint32_t a_hi[4] = {g_hi[4 * i], g_hi[4 * i + 2],
                                  g_hi[4 * i + 1], g_hi[4 * i + 3]};
        const uint32_t a_lo[4] = {g_lo[4 * i], g_lo[4 * i + 2],
                                  g_lo[4 * i + 1], g_lo[4 * i + 3]};
        mma_tf32_rs<ND>(acc, a_lo, desc_k(zt_hi, kk), i > 0);
        if constexpr (kSplit) {
          mma_tf32_rs<ND>(acc, a_hi, desc_k(zt_lo, kk), 1);
        }
        mma_tf32_rs<ND>(acc, a_hi, desc_k(zt_hi, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(acc);
      hold(g_hi);
      hold(g_lo);
      ring.release();
    }
#pragma unroll
    for (int j = 0; j < ND / 2; ++j) sum[j * kWarpgroup] += acc[j];
  }
  // sum[4i + 2h + e]: row r + 8h, column d0 + 8i + 2q + e of grad.
#pragma unroll
  for (int i = 0; i < ND / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = d0 + 8 * i + 2 * q + e;
        if (row[h] < n && k < d) {
          out[(size_t(split) * n + row[h]) * d + k] =
              sum[(4 * i + 2 * h + e) * kWarpgroup];
        }
      }
    }
  }
}

// Each gradient entry: the splits' partials added in split order.
__global__ void ntxent_bwd_sym_sum(const float* __restrict__ part,
                                   float* __restrict__ grad, size_t count,
                                   int splits) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < count;
       i += size_t(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int s = 1; s < splits; ++s) sum += part[s * count + i];
    grad[i] = sum;
  }
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_bwd_sym_prep(const T* __restrict__ z, int n, int d,
                        float* __restrict__ hi, float* __restrict__ lo,
                        float* __restrict__ hi_t, float* __restrict__ lo_t) {
  prep_tile<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t);
}

// The scratch of one launch: z's hi and lo (rows, Dp) and their
// transposes hi_t and lo_t (DT, Cp) fp32 (Dp = D rounded up to 32, DT = Dp
// rounded up to d_chunk(D), Cp = rows rounded up to 64; lo and lo_t only
// for fp32 z), and with more than one split the partial gradients,
// splits * rows * D fp32.
struct Buffers {
  float *hi, *lo, *hi_t, *lo_t, *part;
};

Buffers carve(Carver& c, int n, int d, bool split, int splits) {
  Buffers b{};
  const size_t rows = size_t(n) * padded_d(d);
  const size_t cols = size_t(padded_dt(d)) * padded_cols(n);
  b.hi = c.take(rows);
  b.lo = c.take(split ? rows : 0);
  b.hi_t = c.take(cols);
  b.lo_t = c.take(split ? cols : 0);
  b.part = c.take(splits > 1 ? size_t(splits) * n * d : 0);
  return b;
}

template <typename T, int ND>
cudaError_t launch(const T* z, const float* lse, float* grad,
                   const Buffers& b, int n, int d, float inv_t, int splits,
                   int split_cols, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int dp = padded_d(d);
  const int dt = padded_dt(d);
  const int cp = padded_cols(n);
  ntxent_bwd_sym_prep<T, kSplit>
      <<<dim3(cp / 32, dt / 32), kPrepThreads, 0, stream>>>(
          z, n, d, b.hi, b.lo, b.hi_t, b.lo_t);
  cudaError_t err = cudaGetLastError();
  CUtensorMap tm_h, tm_l, tm_ht, tm_lt;
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&tm_h, b.hi, dp, n, kBoxK, kTile);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&tm_l, kSplit ? b.lo : b.hi, dp, n, kBoxK,
                               kTile);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&tm_ht, b.hi_t, cp, dt, kBoxK, ND);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&tm_lt, kSplit ? b.lo_t : b.hi_t, cp, dt,
                               kBoxK, ND);
  }
  const int half_bytes = ND * 128 * (kSplit ? 2 : 1);
  const int box_bytes = kBoxBytes * (kSplit ? 2 : 1);
  const Plan p = make_plan(d, kSplit,
                           half_bytes > box_bytes ? half_bytes : box_bytes,
                           ND * kWarpgroup * 2);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ntxent_bwd_sym_walk<kSplit, ND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes + 1024);
  }
  if (err != cudaSuccess) return err;
  ntxent_bwd_sym_walk<kSplit, ND>
      <<<dim3((n + kTile - 1) / kTile, splits, dt / ND), kThreads,
         p.bytes + 1024, stream>>>(tm_h, tm_l, tm_ht, tm_lt, lse,
                                   splits == 1 ? grad : b.part, p, n, d,
                                   split_cols, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = size_t(n) * d;
  const int blocks = static_cast<int>((count + 255) / 256);
  ntxent_bwd_sym_sum<<<blocks < 1024 ? blocks : 1024, 256, 0, stream>>>(
      b.part, grad, count, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* z, const float* lse, float* grad,
                     const Buffers& b, int n, int d, float inv_t, int splits,
                     int split_cols, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  switch (d_chunk(d)) {
    case 32:
      return launch<T, 32>(zt, lse, grad, b, n, d, inv_t, splits,
                           split_cols, s);
    case 64:
      return launch<T, 64>(zt, lse, grad, b, n, d, inv_t, splits,
                           split_cols, s);
    default:
      return launch<T, 128>(zt, lse, grad, b, n, d, inv_t, splits,
                            split_cols, s);
  }
}

}  // namespace

// Floats of scratch one call takes.
extern "C" long long ntx_ntxent_bwd_sym_scratch(int n_rows, int d, int dtype,
                                                int splits) {
  Carver c{nullptr};
  carve(c, n_rows, d, dtype == 0, splits);
  return static_cast<long long>(c.used);
}

// dtype: 0 = float32, 1 = bfloat16. The columns are cut into `splits`
// runs of `split_cols` (the last one shorter), each non-empty. `scratch`
// holds ntx_ntxent_bwd_sym_scratch(rows, d, dtype, splits) floats.
// Returns a cudaError_t (0 = success).
extern "C" int ntx_ntxent_bwd_sym(const void* z, const void* lse, void* grad,
                                  void* scratch, int n_rows, int d, int dtype,
                                  float inv_t, int splits, int split_cols,
                                  int device, void* stream) {
  if (n_rows < 2 || n_rows % 2 || d < 1 || d > kMaxD || splits < 1 ||
      split_cols < 1 ||
      static_cast<long long>(splits - 1) * split_cols >= n_rows ||
      static_cast<long long>(splits) * split_cols < n_rows) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carver c{static_cast<float*>(scratch)};
  const Buffers b = carve(c, n_rows, d, dtype == 0, splits);
  const float* l = static_cast<const float*>(lse);
  float* g = static_cast<float*>(grad);
  if (dtype == 0) {
    return dispatch<float>(z, l, g, b, n_rows, d, inv_t, splits, split_cols,
                           s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(z, l, g, b, n_rows, d, inv_t, splits,
                                   split_cols, s);
  }
  return cudaErrorInvalidValue;
}
