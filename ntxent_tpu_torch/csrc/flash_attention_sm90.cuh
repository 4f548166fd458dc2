// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels
// #11 (flash_attention_fwd.cu), #12 (flash_attention_fold.cu), #13 and
// #14 (the dQ and dK/dV kernels of flash_attention_bwd.cu): tensor maps
// and TMA tile loads, mbarriers, wgmma shared-memory descriptors and the
// wgmma instructions they issue; and the forward walk that #11 and #12
// share (fwd_produce, fwd_consume). The TF32 NT-Xent kernels #1 and #5
// (ntxent_tf32.cuh) share the tensor-map encoder, the mbarriers and the
// K-major descriptor, and add 2-D fp32 maps and boxes (tensor_map_f32,
// tma_box_2d).
//
// Tiles. A flat (B*H, L, D) bf16 tensor is described to TMA as the 3-D
// tensor (D, L, B*H), so a box never crosses into the next head and rows
// past L come in as zeros. One box is 64 rows x 64 columns (128 bytes a
// row) in the 128-byte swizzle; a 64 x 128 tile is two boxes, one after
// the other (kBoxBytes apart). Tiles sit on 1024-byte boundaries, as the
// swizzle pattern requires.
//
// Operands. wgmma reads such a tile in two ways (the descriptors below):
// K-major, rows as the M or N dimension and the 128-byte row as K (A = Q
// or K, B = K or Q in a score product), and MN-major, rows as K and the
// row as N (B = V in P.V, dO or Q in dV and dK). A k16 step is 32 bytes
// along a K-major row, or 16 rows (2048 bytes) of an MN-major tile.
//
// Fragments. The fp32 accumulator of an m64nNk16 wgmma gives each of the
// 128 threads of the warpgroup two rows, r = 16 * warp + lane / 4 and
// r + 8, and in every 8-column group the columns 2 * (lane % 4) and the
// next: d[4i + 2h + e] is row r + 8h, column 8i + 2 * (lane % 4) + e.
// Columns 16kk .. 16kk + 15 of such an accumulator, packed to bf16 pairs
// as (d[8kk], d[8kk+1]), (d[8kk+2], d[8kk+3]), (d[8kk+4], d[8kk+5]),
// (d[8kk+6], d[8kk+7]), are the register A operand of the k16 step kk of
// a product that takes those columns as its K dimension.

#pragma once

// CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace sm90 {

constexpr int kRows = 64;     // rows of a q, k, v or dO tile
constexpr int kBoxCols = 64;  // bf16 columns of one 128-byte swizzled row
constexpr int kBoxBytes = kRows * kBoxCols * 2;
constexpr int kWarpgroup = 128;
constexpr int kThreads = kWarpgroup + 32;  // consumers + one producer warp
constexpr float kNegInf = -1e30f;          // a masked score

// --- host: the tensor map of a flat (B*H, L, D) bf16 tensor ---------------

// cuTensorMapEncodeTiled is a driver call; it is reached through the
// runtime's entry-point query, so the library links the runtime alone.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int bh,
                              int len, int d) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(len), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2,
                                 cuuint64_t(d) * 2 * cuuint64_t(len)};
  const cuuint32_t box[3] = {kBoxCols, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // rows past L read as zeros
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a row-major (height, width) fp32 matrix whose rows
// are `width` floats apart (width a multiple of 4: TMA's 16-byte stride
// rule), in boxes of box_h rows x box_w columns (box_w * 4 <= 128 bytes
// in the 128-byte swizzle); a box's rows past `height` read as zeros.
inline cudaError_t tensor_map_f32(CUtensorMap* map, const float* base,
                                  int width, int height, int box_w,
                                  int box_h) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cuuint64_t(width), cuuint64_t(height)};
  const cuuint64_t strides[1] = {cuuint64_t(width) * 4};
  const cuuint32_t box[2] = {cuuint32_t(box_w), cuuint32_t(box_h)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --- device: shared memory, mbarriers, TMA --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to the 1024-byte swizzle boundary
// (the launch asks for 1024 bytes more than the layout).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and announce `bytes` of TMA traffic that complete the phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy one fp32 word from global memory, or write 0 when `valid` is
// false, without waiting (cp.async).
__device__ __forceinline__ void copy_word(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival counts against the barrier's expected count).
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box: rows row .. row + 63, columns col .. col + 63 of head bh.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bh),
      "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2-D map: rows row .. row + box_h - 1, columns col ..
// col + box_w - 1.
__device__ __forceinline__ void tma_box_2d(void* dst, const CUtensorMap* map,
                                           uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// A 64-row tile of D columns (D / 64 boxes).
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int h = 0; h < D / kBoxCols; ++h) {
    tma_box(dst + h * kBoxBytes, map, bar, h * kBoxCols, row, bh);
  }
}

// --- device: wgmma descriptors -------------------------------------------

// Start address, leading and stride byte offsets (16-byte units), and
// the 128-byte swizzle (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major view of a tile, k16 step kk: 8-row groups 1024 bytes apart,
// 32 bytes of K a step, the second box for D = 128 (kk >= 4). The
// leading offset is unused in a swizzled K-major layout. A k8 step of
// TF32 is 32 bytes of K as well; a tile whose boxes hold other than 64
// rows passes their size.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk,
                                           int box_bytes = kBoxBytes) {
  return descriptor(smem_u32(tile) + (kk / 4) * box_bytes + (kk % 4) * 32,
                    16, 1024);
}

// MN-major view of a tile, k16 step kk (rows 16kk .. 16kk + 15): 8-row
// groups of K 1024 bytes apart (stride offset), the 64-column boxes along
// N kBoxBytes apart (leading offset).
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk) {
  return descriptor(smem_u32(tile) + kk * 16 * 128, kBoxBytes, 1024);
}

// --- device: wgmma ----------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses of registers that an issued
// wgmma reads or writes across its wait (and from reusing them before).
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// exp(min(x, 0)) on the SFU (ex2.approx of x log2 e): a few ulp from
// expf, far inside the bf16 roundings of every result it feeds, and a
// fraction of its instructions, which bound these kernels' softmax.
__device__ __forceinline__ float exp0(float x) {
  return __expf(fminf(x, 0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64 x 64] (+)= A . B, A and B both K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A . B, A in registers (a0..a3), B MN-major in shared
// memory.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= A . B, A in registers (a0..a3), B MN-major in shared
// memory.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d[64 x D] (+)= A . B for D = 64 or 128, A in registers, B MN-major.
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t* a,
                                       uint64_t b, int accumulate = 1) {
  if constexpr (D == 64) {
    mma_rs_n64(d, a[0], a[1], a[2], a[3], b, accumulate);
  } else {
    mma_rs_n128(d, a[0], a[1], a[2], a[3], b, accumulate);
  }
}

// --- device: the masks and probabilities of #11, #12, #13 and #14 --------
//
// A score is masked to -1e30 when its key lies past Lk or, causal, after
// its query (k_off + j > q_off + i); p = 0 where s <= -5e29, else
// exp(min(s - m, 0)) against the row's running max or its lse
// (attention_pallas.py:95-112, :138-147). Each kernel's fragment holds
// its entries at compile-time columns n = 0..63 of a 64 x 64 tile, so the
// masks reduce to comparing n with per-row thresholds formed once a tile.

__device__ __forceinline__ float prob(float x, float m) {
  return x <= kNegInf * 0.5f ? 0.f : exp0(x - m);
}

// Only a tile with keys past Lk, or one that meets the causal diagonal
// (its last key after its first query), needs the masks.
__device__ __forceinline__ bool edge_tile(int k0, int lk, int causal,
                                          int q_off, int q0, int k_off) {
  return k0 + kRows > lk ||
         (causal && static_cast<long long>(k_off) + k0 + kRows - 1 >
                        static_cast<long long>(q_off) + q0);
}

// Rows are queries (#11, #12, #13): this thread's entries of rows r and
// r + 8 of the tile, query positions qpos and qpos + 8, column n holding
// key k0 + c + n. It lies past Lk when n >= past, after row h's query
// when n > after[h].
struct QueryRowMask {
  int past, after[2];
  __device__ __forceinline__ QueryRowMask(int lk, int k0, int c, int qpos,
                                          int k_off)
      : past(lk - k0 - c),
        after{qpos - k_off - k0 - c, qpos + 8 - k_off - k0 - c} {}
  __device__ __forceinline__ float operator()(float x, int n, int h,
                                              int causal) const {
    return ((n >= past) | (causal & (n > after[h]))) ? kNegInf : x;
  }
};

// Rows are keys (#14): this thread's kv rows kv and kv + 8 of the tile,
// column n holding query q0 + c + n. Row h's key lies past Lk when
// key_past[h], after column n's query when n < before[h]; the query lies
// past Lq when n >= q_past, and its p and ds are zeroed.
struct KeyRowMask {
  int q_past, before[2];
  bool key_past[2];
  __device__ __forceinline__ KeyRowMask(int lq, int lk, int q0, int kv,
                                        int c, int q_off, int k_off)
      : q_past(lq - q0 - c),
        before{k_off + kv - q_off - q0 - c, k_off + kv + 8 - q_off - q0 - c},
        key_past{kv >= lk, kv + 8 >= lk} {}
  __device__ __forceinline__ float operator()(float x, int n, int h,
                                              int causal) const {
    return (key_past[h] | (causal & (n < before[h]))) ? kNegInf : x;
  }
};

// --- device: the forward walk of #11 and #12 -----------------------------
//
// One CTA per (batch*head, 64-row q tile). The producer warp's lane 0
// loads the q tile once and streams the live K/V tiles through a ring of
// kStages shared-memory stages by TMA, each stage completing on an
// mbarrier and released by the consumers on another. Per K/V tile the
// consumer warpgroup issues S = Q K^T as wgmma m64n64k16 from shared
// memory (Q and K both K-major, as stored), takes the row max and sum
// from the accumulator fragment with quad shuffles, rescales the output
// accumulator in registers, converts p to bf16 in registers and issues
// O += P V as wgmma m64nDk16 with P as the register A operand and V as
// the MN-major B. The running (m, l) and O stay in registers for the
// whole walk; no s, p or accumulator byte goes through shared memory.

constexpr int kStages = 2;  // K/V ring depth

template <int D>
struct FwdSmem {
  static constexpr int kTile = kRows * D * 2;  // one 64-row tile
  static constexpr int kQ = 0;
  static constexpr int kKV = kTile;  // stage s: K at kKV + 2 s kTile, V next
  static constexpr int kBars = kKV + 2 * kStages * kTile;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kLaunch = kBytes + 1024;  // room to align to 1024
};

// The walk's barriers: the q tile's, then full[kStages] (a K/V stage has
// landed) and empty[kStages] (the consumers are done with it). Every
// thread of the CTA calls this before it splits into producer and
// consumers.
template <int D>
__device__ __forceinline__ uint64_t* fwd_barriers(unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + FwdSmem<D>::kBars);
  if (threadIdx.x == 0) {
    bar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&bars[1 + s], 1);
      bar_init(&bars[1 + kStages + s], kWarpgroup);
    }
    bar_init_fence();
  }
  __syncthreads();
  return bars;
}

// The producer warp: its lane 0 issues every TMA load of the walk.
template <int D>
__device__ __forceinline__ void fwd_produce(unsigned char* smem,
                                            uint64_t* bars,
                                            const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v, int bh,
                                            int q0, int kv_tiles) {
  using L = FwdSmem<D>;
  if (threadIdx.x != kWarpgroup || kv_tiles == 0) return;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;
  prefetch_map(tm_k);
  prefetch_map(tm_v);
  bar_expect(bars, L::kTile);
  tma_tile<D>(smem + L::kQ, tm_q, bars, q0, bh);
  for (int j = 0; j < kv_tiles; ++j) {
    const int s = j % kStages;
    if (j >= kStages) bar_wait(&empty[s], (j / kStages - 1) & 1);
    unsigned char* k_s = smem + L::kKV + 2 * s * L::kTile;
    bar_expect(&full[s], 2 * L::kTile);
    tma_tile<D>(k_s, tm_k, &full[s], j * kRows, bh);
    tma_tile<D>(k_s + L::kTile, tm_v, &full[s], j * kRows, bh);
  }
}

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
  // Entry i holds column n = 8 (i / 4) + i % 2 of row h = (i / 2) % 2.
  const QueryRowMask mask(lk, k0, c, qpos, k_off);
  float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) % 2;
    float x = sc[i] * scale;
    if constexpr (kEdge) x = mask(x, 8 * (i / 4) + i % 2, h, causal);
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
    const float p = prob(sc[i], row_max[h]);
    sc[i] = p;
    row_sum[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    alpha[h] = exp0(m[h] - row_max[h]);
    l[h] = l[h] * alpha[h] + row_sum[h];
    m[h] = row_max[h];
  }
}

// The consumer warpgroup: fold kv_tiles K/V tiles into this thread's
// rows r and r + 8 of the tile starting at q row q0 -- the running (m, l)
// and acc (columns 8i + c and 8i + c + 1 of every 8-column group), which
// hold the starting state on entry (empty, or a carry).
template <int D>
__device__ __forceinline__ void fwd_consume(unsigned char* smem,
                                            uint64_t* bars, int kv_tiles,
                                            int lk, int q0, int r, int c,
                                            float scale, int causal,
                                            int q_off, int k_off,
                                            float (&acc)[D / 2],
                                            float (&m)[2], float (&l)[2]) {
  using L = FwdSmem<D>;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;
  if (kv_tiles > 0) bar_wait(bars, 0);
  for (int j = 0; j < kv_tiles; ++j) {
    const int s = j % kStages;
    bar_wait(&full[s], (j / kStages) & 1);
    const unsigned char* k_s = smem + L::kKV + 2 * s * L::kTile;
    const unsigned char* v_s = k_s + L::kTile;

    float sc[32];  // s = q . k^T, 64 x 64
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss_n64(sc, desc_k(smem + L::kQ, kk), desc_k(k_s, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(sc);

    const int k0 = j * kRows;
    float alpha[2];
    if (edge_tile(k0, lk, causal, q_off, q0, k_off)) {
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
    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<D>(acc, pa + 4 * kk, desc_mn(v_s, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(pa);
    bar_arrive(&empty[s]);
  }
}

}  // namespace sm90
