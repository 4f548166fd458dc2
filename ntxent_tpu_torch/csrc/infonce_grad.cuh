// Shared by csrc/infonce_dual_bwd.cu and csrc/infonce_bwd_cols.cu: one
// CTA's share of an InfoNCE gradient, out = G . other over 64 output rows.
//
// "own" (n_own, D) holds the CTA's output vectors, "other" (n_other, D) the
// vectors it walks. For own vector r and other vector j:
//   s[r, j] = (own_r . other_j) * scale in fp32;
//   G[r, j] = (exp(min(s - lse_own[r], 0)) - pos) * valid_own[r]
//           + (exp(min(s - lse_other[j], 0)) - pos) * valid_other[j],
//   pos = 1 iff id(own_r) = id(other_j);
//   out[r] = sum_j G[r, j] other_j   (fp32 (n_own, D)).
// An id is the vector's entry of its id array, or its index where the
// array is null; valid is 1 for a vector without ids, and id < n_valid for
// one with ids (a padding row carries the sentinel n_valid). That is the
// combined G of the TPU kernels (_dual_bwd_kernel, _bwd_sym_kernel and
// _bwd_sym_cols_kernel in their cross-modal mode): the row term at the row
// lse times valid_row, the column term at the column lse times valid_col.
// Which side is "own" decides only which output is formed: with rows as
// own, out = G . z_cols; with columns as own, out = G^T . z_rows, G being
// symmetric in its two terms.
//
// Design. The CTA walks every 64-vector tile of "other": the s tile by the
// register-blocked product of infonce_tile.cuh, G to shared memory, then
// G . other_tile in 64-wide slices of D added into the CTA's (64, D) fp32
// accumulator in shared memory (smem_floats(d) floats, 165 KB at D = 512,
// opted in with cudaFuncAttributeMaxDynamicSharedMemorySize). Each output
// row has one owner: no atomics, and the result is repeatable. fp32 FMA of
// widened inputs, no TF32.

#pragma once

#include "infonce_tile.cuh"

namespace infonce {

constexpr int kLdG = kTile + 1;  // G tile and the staged other slice

// Row stride of the accumulator: d rounded up to 32, plus 16, so the two
// rows a warp touches (ty even and odd) fall in opposite bank halves.
__host__ __device__ __forceinline__ int acc_stride(int d) {
  return (d + 31) / 32 * 32 + 16;
}

__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  return size_t(kTile) * acc_stride(d) + 2 * kTile * kLd + kTile * kLdG;
}

template <typename T>
__device__ void grad_rows(const T* __restrict__ own,
                          const T* __restrict__ other,
                          const int* __restrict__ own_id,
                          const int* __restrict__ other_id,
                          const float* __restrict__ lse_own,
                          const float* __restrict__ lse_other, float scale,
                          float* __restrict__ out, int n_own, int n_other,
                          int n_valid, int d, int row0, float* smem) {
  const int ld_acc = acc_stride(d);
  float* acc = smem;                 // kTile x ld_acc
  float* as = acc + kTile * ld_acc;  // kTile x kLd, then bs
  float* bs = as + kTile * kLd;
  float* bd = as;                    // kTile x kLdG over as and bs
  float* gs = bs + kTile * kLd;      // kTile x kLdG

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  for (int e = threadIdx.x; e < kTile * ld_acc; e += kThreads) acc[e] = 0.f;
  float lse_r[4], v_r[4];
  int id_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    const bool in = row < n_own;
    id_r[i] = in && own_id ? own_id[row] : row;
    lse_r[i] = in ? lse_own[row] : 0.f;
    v_r[i] = (!own_id || id_r[i] < n_valid) ? 1.f : 0.f;
  }

  for (int col0 = 0; col0 < n_other; col0 += kTile) {
    float s[4][4];
    tile_products(s, as, bs, own, other, row0, col0, n_own, n_other, d);
    float lse_c[4], v_c[4];
    int id_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      const bool in = col < n_other;
      id_c[j] = in && other_id ? other_id[col] : col;
      lse_c[j] = in ? lse_other[col] : 0.f;
      v_c[j] = (!other_id || id_c[j] < n_valid) ? 1.f : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        const float pos = id_c[j] == id_r[i] ? 1.f : 0.f;
        const float g = (exp0(x - lse_r[i]) - pos) * v_r[i] +
                        (exp0(x - lse_c[j]) - pos) * v_c[j];
        gs[(ty + 16 * i) * kLdG + tx + 16 * j] =
            (row < n_own && col < n_other) ? g : 0.f;
      }
    }
    for (int d0 = 0; d0 < d; d0 += kTile) {
      __syncthreads();  // gs is written; bd's previous readers are done
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int c = e / kTile;
        const int k = e % kTile;
        const int gc = col0 + c;
        const int gk = d0 + k;
        bd[c * kLdG + k] = (gc < n_other && gk < d)
                               ? to_float(other[size_t(gc) * d + gk])
                               : 0.f;
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
    if (row0 + r < n_own) out[size_t(row0 + r) * d + k] = acc[r * ld_acc + k];
  }
}

// Opt a kernel in to smem_floats(d) floats of dynamic shared memory.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int d, size_t* bytes) {
  *bytes = smem_floats(d) * sizeof(float);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace infonce
