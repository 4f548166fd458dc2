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
// Design (ntxent_tf32.cuh holds the walk, bwd_walk, which #6 shares).
// The operand-prep pass writes z's hi and lo (rows, Dp) and, transposed,
// (DT, Cp): grad = G . z takes z as the B operand with K = the columns,
// which is MN-major as z lies, and TF32 wgmma takes only K-major operands.
// One CTA per (64-row tile, column split, chunk of D of at most 128): per
// 64-column tile it forms s as the forward does (3xTF32 for fp32 z), G
// (SymG of ntxent_tf32.cuh) in the accumulator fragment, and adds G . z with G as the
// register A operand; each tile's product starts a fresh accumulator that
// is added into a running sum in shared memory (the tensor core does not
// round its fp32 accumulator to nearest: a 3072-product chain drifted
// 4e-5 at 2N = 8192 on an H100, one TF32 pass errs 2.5e-4).
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
// 1 <= D <= kMaxWidth (past D = 256 in fp32, 512 in bf16, the row tile
// streams through the ring, ntxent_tf32.cuh). The C entry point returns
// cudaGetLastError().

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
  SymG g{lse, n, inv_t};
  bwd_walk<kSplit, ND>(&tm_h, &tm_l, &tm_h, &tm_l, &tm_ht, &tm_lt, g, out, p,
                       n, n, d, split_cols);
}

// Each gradient entry: the splits' partials added in split order.
__global__ void ntxent_bwd_sym_sum(const float* __restrict__ part,
                                   float* __restrict__ grad, size_t count,
                                   int splits) {
  split_sum(part, grad, count, splits);
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
      <<<dim3(cp / 32, prep_grid_y(dt)), kPrepThreads, 0, stream>>>(
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
  const Plan p = make_plan(d, kSplit, bwd_half_bytes<ND>(kSplit),
                           bwd_sum_bytes<ND>());
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
  if (n_rows < 2 || n_rows % 2 || !width_ok(d) || splits < 1 ||
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
