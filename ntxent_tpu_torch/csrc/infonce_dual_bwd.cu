// Cross-modal InfoNCE (CLIP) backward for Hopper (sm_90a), bound to
// PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel ntxent_tpu/ops/infonce_pallas.py:204
// (_dual_bwd_kernel, launched by _dual_bwd_call at infonce_pallas.py:274)
// as _infonce_bwd runs it. From za, zb (N, D), the logit scale (a device
// scalar) and the forward's lse_a, lse_b it computes, as that kernel does,
//   s[i, j] = (za_i . zb_j) * scale in fp32;
//   G[i, j] = (exp(min(s - lse_a[i], 0)) - I) + (exp(min(s - lse_b[j], 0)) - I)
//             (the total dL/ds before the caller's g / 2N; the diagonal I
//             is the positive and is not masked);
//   o_a = G . zb,  o_b = G^T . za   (fp32, (N, D) each).
// The TPU kernel's valid_row / valid_col factors are 1 on every real entry:
// the ragged edge is masked here by bounds instead (G = 0 past N).
//
// Design. The TPU kernel forms one s tile and one G tile and adds G . zb_j
// into a full-length row accumulator and G^T . za_i into a full-length
// column accumulator, both carried across its sequential grid. Hopper
// blocks run in no order, so each output row must have one owner: o_b is
// computed as the row side of the swapped problem, since with za <-> zb
// and lse_a <-> lse_b exchanged, G becomes G^T (blockIdx.y = 1 in the same
// launch). One launch; each CTA owns 64 output rows of one side and walks
// every 64-column tile: the s tile by the register-blocked product of
// infonce_tile.cuh, G to shared memory, then G . b_tile in 64-wide slices
// of D added into the CTA's (64, D) fp32 accumulator, which lives in
// shared memory (135 KB at D = 512, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize). No atomics: the result is
// repeatable. The work is 8 N^2 D against the TPU kernel's 6 N^2 D (s is
// formed once per side). Arithmetic is fp32 FMA of widened inputs, no TF32.
//
// Bound at the training shape (N = 256, D = 512, fp32): 6 N^2 D = 201
// MFLOP, 3.0 us at the 67 TFLOP/s fp32 peak; za, zb, lse and the two
// outputs are 2 MB, 0.63 us at 3.35 TB/s. Compute-bound on paper,
// launch-bound in practice (8 CTAs).
//
// Supported: float32 or bfloat16 za, zb, contiguous (N, D), N >= 1,
// 1 <= D <= 512. The C entry point returns cudaGetLastError().

#include "infonce_tile.cuh"

namespace {

using namespace infonce;

constexpr int kLdG = kTile + 1;  // G tile and the staged b slice

// Row stride of the accumulator: d rounded up to 32, plus 16, so the two
// rows a warp touches (ty even and odd) fall in opposite bank halves.
__host__ __device__ __forceinline__ int acc_stride(int d) {
  return (d + 31) / 32 * 32 + 16;
}

__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  return size_t(kTile) * acc_stride(d) + 2 * kTile * kLd + kTile * kLdG;
}

// blockIdx.y = 0: o_a[i] = sum_j G[i, j] zb_j; 1: o_b[j] = sum_i G[i, j] za_i
// as the row side of the swapped problem.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    infonce_dual_bwd_kernel(const T* __restrict__ za,
                            const T* __restrict__ zb,
                            const float* __restrict__ scale_ptr,
                            const float* __restrict__ lse_a,
                            const float* __restrict__ lse_b,
                            float* __restrict__ o_a, float* __restrict__ o_b,
                            int n, int d) {
  extern __shared__ float smem[];
  const int ld_acc = acc_stride(d);
  float* acc = smem;                 // kTile x ld_acc
  float* as = acc + kTile * ld_acc;  // kTile x kLd, then bs
  float* bs = as + kTile * kLd;
  float* bd = as;                    // kTile x kLdG over as and bs
  float* gs = bs + kTile * kLd;      // kTile x kLdG

  const bool swap = blockIdx.y == 1;
  const T* a = swap ? zb : za;
  const T* b = swap ? za : zb;
  const float* lse_rows = swap ? lse_b : lse_a;
  const float* lse_cols = swap ? lse_a : lse_b;
  float* out = swap ? o_b : o_a;
  const float scale = *scale_ptr;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kTile;

  for (int e = threadIdx.x; e < kTile * ld_acc; e += kThreads) acc[e] = 0.f;
  float lse_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    lse_r[i] = row < n ? lse_rows[row] : 0.f;
  }

  for (int col0 = 0; col0 < n; col0 += kTile) {
    float s[4][4];
    tile_products(s, as, bs, a, b, row0, col0, n, d);
    float lse_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      lse_c[j] = col < n ? lse_cols[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        const float pos = col == row ? 1.f : 0.f;
        const float g = (exp0(x - lse_r[i]) - pos) + (exp0(x - lse_c[j]) - pos);
        gs[(ty + 16 * i) * kLdG + tx + 16 * j] =
            (row < n && col < n) ? g : 0.f;
      }
    }
    for (int d0 = 0; d0 < d; d0 += kTile) {
      __syncthreads();  // gs is written; bd's previous readers are done
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int c = e / kTile;
        const int k = e % kTile;
        const int gc = col0 + c;
        const int gk = d0 + k;
        bd[c * kLdG + k] =
            (gc < n && gk < d) ? to_float(b[size_t(gc) * d + gk]) : 0.f;
      }
      __syncthreads();
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      }
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) {
        float gv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = gs[(ty + 16 * i) * kLdG + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bd[c * kLdG + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(gv[i], bv[j], o[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = d0 + tx + 16 * j;
          if (k < d) acc[(ty + 16 * i) * ld_acc + k] += o[i][j];
        }
      }
    }
    // the next tile_products starts with a barrier before it restages
    // as/bs (= bd) and gs is rewritten only after it
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d;
    const int k = e % d;
    if (row0 + r < n) out[size_t(row0 + r) * d + k] = acc[r * ld_acc + k];
  }
}

template <typename T>
cudaError_t launch(const void* za, const void* zb, const void* scale,
                   const void* lse_a, const void* lse_b, void* o_a, void* o_b,
                   int n, int d, cudaStream_t stream) {
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      infonce_dual_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTile - 1) / kTile;
  infonce_dual_bwd_kernel<T><<<dim3(tiles, 2), kThreads, smem, stream>>>(
      static_cast<const T*>(za), static_cast<const T*>(zb),
      static_cast<const float*>(scale), static_cast<const float*>(lse_a),
      static_cast<const float*>(lse_b), static_cast<float*>(o_a),
      static_cast<float*>(o_b), n, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `scale` points to one fp32 on the
// device. Returns a cudaError_t (0 = success).
extern "C" int ntx_infonce_dual_bwd(const void* za, const void* zb,
                                    const void* scale, const void* lse_a,
                                    const void* lse_b, void* o_a, void* o_b,
                                    int n, int d, int dtype, int device,
                                    void* stream) {
  if (n < 1 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(za, zb, scale, lse_a, lse_b, o_a, o_b, n, d, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(za, zb, scale, lse_a, lse_b, o_a, o_b, n, d,
                                 s);
  }
  return cudaErrorInvalidValue;
}
