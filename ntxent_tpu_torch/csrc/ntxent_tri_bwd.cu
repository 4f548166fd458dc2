// NT-Xent triangular symmetric backward for Hopper (sm_90a) on TF32 tensor
// cores, bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel _bwd_tri_kernel
// (ntxent_tpu/ops/ntxent_pallas.py:350, launched by _bwd_tri_call at :406,
// pallas_call at :414), the backward of ntxent_loss_fused(triangular=True).
// For stacked views z (2N, D) and the forward's lse (2N,), as that kernel
// computes:
//   s[i, j] = (z_i . z_j) * inv_t in fp32, the diagonal masked to -1e30;
//   G[i, j] = (exp(min(s - lse[i], 0)) - pos) + (exp(min(s - lse[j], 0))
//             - pos), pos = 1 iff j = (i + N) mod 2N;
//   grad    = G @ z (2N, D) fp32, before the caller's g / T scale.
// G is symmetric, so only the upper tiles (i <= j, in 64-row blocks) are
// formed, each driving grad[block i] += G_ij z_j and, for j > i,
// grad[block j] += G_ij^T z_i: 3 (2N)^2 D products where the rectangular
// backward (#5) does 4.
//
// Design. The TPU kernel adds both products into a full-length fp32
// accumulator carried across its sequential grid. Hopper blocks run in no
// order and this port uses no atomics, so every output has one owner and
// the partials are summed in a fixed order. Three launches:
//   prep  z's TF32 hi and lo (rows, Dp) and the transposed copy (DT, Cp)
//         with each 8-column group in the order 0, 2, 4, 6, 1, 3, 5, 7
//         (the K-major B of grad = G . z), as #5's;
//   walk  #5's backward walk (bwd_walk_pieces of ntxent_tf32.cuh, G from
//         #5's SymG) over the plan of ops/ntxent.py's tri_runs, one CTA
//         per (stretch of upper tiles, chunk of D of at most 128 columns);
//         a stretch is a few pieces, each a run of
//         consecutive column tiles j >= i of one row tile i. Per tile,
//         s once (3xTF32 wgmma from the TMA ring; two products for bf16),
//         G in the accumulator fragment (positives and the diagonal
//         masked), and
//         * the direct product grad[block i] += G . z_j, G as the register
//           A operand, a fresh accumulator per tile added into the run's
//           running sums in shared memory, written once a run: a per-run
//           partial of block i;
//         * for j > i the transposed product grad[block j] += G^T . z_i:
//           G's TF32 hi and lo stored transposed into shared memory as
//           the K-major A operand (TF32 wgmma takes no other), z_i's
//           transposed halves streamed through the ring after z_j's (L2
//           hits), 64 K steps in a fresh accumulator, written to the
//           tile's own partial of block j;
//   sum   grad[k] = block(k)'s per-run partials in run order, then the
//         transposed partials of the tiles (t, block(k)), t < block(k), in
//         tile order.
// No atomics: the gradient is bitwise repeatable.
//
// Shared memory at D = 128, fp32 (make_plan): the row tile 64 KB, the
// running sums 32 KB, G^T's hi and lo 32 KB and three ring stages of
// 32 KB (224 KB); at D = 256 the row tile (128 KB) streams through the
// ring beside the column tile's boxes (four stages), as at D = 288-512.
//
// Scratch: z's copies (about 4 2N D fp32), the per-run partials (most
// runs of a row tile) 2N D fp32 and the transposed partials nb (nb - 1) /
// 2 * 64 D fp32 (nb = ceil(2N / 64)): 1.8 MB at 2N = 512, D = 128; 266 MB
// at 2N = 8192 (0.3% of an 80 GB card), written once by the walk and read
// once by the sum.
//
// Bound: 3 (2N)^2 D operations, each product three TF32 passes in fp32
// (165 TFLOP/s), against 2N D inputs, 2N lse and 2N D fp32 outputs. At
// 2N = 512, D = 128: 101 MFLOP, 0.61 us (36 tiles: the launches bound it);
// at 2N = 8192: 25.8 GFLOP, 156 us. The transposed partials add 2 x 266
// MB of traffic at 2N = 8192, 0.16 ms at 3.35 TB/s.
//
// Supported: float32 or bfloat16 z, contiguous (2N, D), 2N even >= 2,
// 1 <= D <= kMaxWidth. The C entry point returns cudaGetLastError().

#include "ntxent_tf32.cuh"

namespace {

using namespace ntx;

// The kernels carry the wrapper's name (the profiler groups by it).

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kPrepThreads)
    ntxent_bwd_tri_prep(const T* __restrict__ z, int n, int d,
                        float* __restrict__ hi, float* __restrict__ lo,
                        float* __restrict__ hi_t, float* __restrict__ lo_t) {
  prep_tile<T, kSplit>(z, n, d, hi, lo, hi_t, lo_t);
}

// blockIdx.x: the plan's CTA, blockIdx.y: the chunk of D. part: the
// per-run partials (slots, n, d); part_t: the transposed partials.
template <bool kSplit, int ND>
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_bwd_tri_walk(const __grid_constant__ CUtensorMap tm_h,
                        const __grid_constant__ CUtensorMap tm_l,
                        const __grid_constant__ CUtensorMap tm_ht,
                        const __grid_constant__ CUtensorMap tm_lt,
                        const float* __restrict__ lse, TriPlan plan,
                        float* __restrict__ part, float* __restrict__ part_t,
                        Plan p, int n, int d, float inv_t) {
  SymG g{lse, n, inv_t};
  bwd_walk_pieces<kSplit, ND>(&tm_h, &tm_l, &tm_h, &tm_l, &tm_ht, &tm_lt, g,
                              part, part_t, p, n, d, TriPieces(plan, n),
                              blockIdx.y);
}

// grad[k][c] = the per-run partials of block(k) in run order, then the
// transposed partials of tiles (t, block(k)), t < block(k), in tile order.
__global__ void ntxent_bwd_tri_sum(const float* __restrict__ part,
                                   const float* __restrict__ part_t,
                                   float* __restrict__ grad, TriPlan plan,
                                   int n, int d) {
  const size_t count = size_t(n) * d;
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < count;
       e += size_t(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e / d);
    const int c = static_cast<int>(e % d);
    const int bk = k / kTile;
    float sum = part[e];
    for (int s = 1; s < plan.runs_of(bk); ++s) sum += part[s * count + e];
    for (int t = 0; t < bk; ++t) {
      const int slot = t * plan.nb - t * (t + 1) / 2 + bk - t - 1;
      sum += part_t[(size_t(slot) * kTile + k % kTile) * d + c];
    }
    grad[e] = sum;
  }
}

// The scratch of one call: z's hi and lo (rows, Dp) and their transposes
// (DT, Cp) fp32 (the lo copies only for fp32 z), the per-run partials
// slots * rows * d and the transposed partials nb (nb - 1) / 2 * 64 * d.
struct Buffers {
  float *hi, *lo, *hi_t, *lo_t, *part, *part_t;
};

Buffers carve(Carver& c, int n, int d, bool split, int slots) {
  Buffers b{};
  const size_t rows = size_t(n) * padded_d(d);
  const size_t cols = size_t(padded_dt(d)) * padded_cols(n);
  const size_t nb = (n + kTile - 1) / kTile;
  b.hi = c.take(rows);
  b.lo = c.take(split ? rows : 0);
  b.hi_t = c.take(cols);
  b.lo_t = c.take(split ? cols : 0);
  b.part = c.take(size_t(slots) * n * d);
  b.part_t = c.take(nb * (nb - 1) / 2 * kTile * d);
  return b;
}

// The walk's plan: the ring stages hold a K box of the column tile or one
// half of a transposed tile; its own bytes are the running sums and G^T.
template <int ND>
Plan tri_bwd_plan(int d, bool split) {
  return make_plan(d, split, bwd_half_bytes<ND>(split),
                   bwd_sum_bytes<ND>() + kGtBytes);
}

template <typename T, int ND>
cudaError_t launch(const T* z, const float* lse, float* grad,
                   const TriPlan& plan, const Buffers& b, int n, int d,
                   float inv_t, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int dt = padded_dt(d);
  const int cp = padded_cols(n);
  ntxent_bwd_tri_prep<T, kSplit>
      <<<dim3(cp / 32, prep_grid_y(dt)), kPrepThreads, 0, stream>>>(
          z, n, d, b.hi, b.lo, b.hi_t, b.lo_t);
  cudaError_t err = cudaGetLastError();
  CUtensorMap tm_h, tm_l, tm_ht, tm_lt;
  if (err == cudaSuccess) {
    err = operand_maps<kSplit>(&tm_h, &tm_l, b.hi, b.lo, n, d);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&tm_ht, b.hi_t, cp, dt, kBoxK, ND);
  }
  if (err == cudaSuccess) {
    err = sm90::tensor_map_f32(&tm_lt, kSplit ? b.lo_t : b.hi_t, cp, dt,
                               kBoxK, ND);
  }
  const Plan p = tri_bwd_plan<ND>(d, kSplit);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ntxent_bwd_tri_walk<kSplit, ND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes + 1024);
  }
  if (err != cudaSuccess) return err;
  ntxent_bwd_tri_walk<kSplit, ND>
      <<<dim3(plan.ctas, dt / ND), kThreads, p.bytes + 1024, stream>>>(
          tm_h, tm_l, tm_ht, tm_lt, lse, plan, b.part, b.part_t, p, n, d,
          inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ntxent_bwd_tri_sum<<<sum_blocks(size_t(n) * d), 256, 0, stream>>>(
      b.part, b.part_t, grad, plan, n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* z, const float* lse, float* grad,
                     const TriPlan& plan, const Buffers& b, int n, int d,
                     float inv_t, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  switch (d_chunk(d)) {
    case 32:
      return launch<T, 32>(zt, lse, grad, plan, b, n, d, inv_t, s);
    case 64:
      return launch<T, 64>(zt, lse, grad, plan, b, n, d, inv_t, s);
    default:
      return launch<T, 128>(zt, lse, grad, plan, b, n, d, inv_t, s);
  }
}

}  // namespace

// Floats of scratch one call takes (dtype 0: fp32, with lo copies); slots:
// the most runs a row tile has in the plan.
extern "C" long long ntx_ntxent_tri_bwd_scratch(int rows, int d, int dtype,
                                                int slots) {
  Carver c{nullptr};
  carve(c, rows, d, dtype == 0, slots);
  return static_cast<long long>(c.used);
}

// grad (rows, d) fp32 = G @ z from z (rows, d) and lse (rows,) fp32.
// plan: the device int32 table of TriPlan (ops/ntxent.py's tri_runs, one
// CTA of `ctas` per chunk of D); `scratch` holds
// ntx_ntxent_tri_bwd_scratch(rows, d, dtype, slots) floats. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int ntx_ntxent_tri_bwd(const void* z, const void* lse,
                                  const void* plan, void* grad,
                                  void* scratch, int rows, int d, int dtype,
                                  float inv_t, int pieces, int ctas,
                                  int slots, int device, void* stream) {
  if (rows < 2 || rows % 2 != 0 || !width_ok(d) || plan == nullptr ||
      pieces < ctas || ctas < 1 || slots < 1 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const TriPlan tp{static_cast<const int*>(plan), pieces, ctas, slots,
                   (rows + kTile - 1) / kTile};
  Carver c{static_cast<float*>(scratch)};
  const Buffers b = carve(c, rows, d, dtype == 0, slots);
  const float* l = static_cast<const float*>(lse);
  float* g = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(z, l, g, tp, b, rows, d, inv_t, s);
  return dispatch<__nv_bfloat16>(z, l, g, tp, b, rows, d, inv_t, s);
}
