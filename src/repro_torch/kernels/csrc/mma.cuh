// Tensor-core pieces of the bf16 attention kernels (fused_attention.cu's
// training forward, fused_attention_bwd.cu's dq and dk/dv, and the masked
// body of masked_mma.cuh that the masked, paged and Q-projection kernels
// run): the
// warp-level mma.sync.m16n8k16 product, ldmatrix fragment loads, 16- and
// 4-byte cp.async copies with zero-fill, and the bf16 tile loader that
// stages (rows, width) planes in shared memory for ldmatrix.
//
// Fragment layouts of mma.m16n8k16 (bf16 in, fp32 accumulate), lane =
// 4 * gid + tig:
//   A (16 x 16, row-major): a[0] = (gid, 2tig..+1), a[1] = (gid + 8,
//     2tig..+1), a[2] = (gid, 8 + 2tig..+1), a[3] = (gid + 8, 8 + 2tig..+1);
//   B (16 x 8, k x n): b[0] = (k 2tig..+1, n gid), b[1] = (k 8 + 2tig..+1,
//     n gid);
//   C (16 x 8 fp32): c[0..1] = (gid, 2tig..+1), c[2..3] = (gid + 8,
//     2tig..+1).
// So the C fragments of two neighbouring n-tiles, rounded and packed in
// pairs, are the A fragment of one 16-deep step of the next product:
// a score or gradient tile never leaves the registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {
namespace mma {

using bf16 = __nv_bfloat16;

// Row stride of every bf16 tile in shared memory, in elements: widths
// up to 128 plus 8, so the eight 16-byte rows one ldmatrix reads start
// 16 bytes apart modulo 128 and fall in distinct banks.  (192 + 8, the
// stride of the training bodies' Q and K tiles at MLA's widths, is 400
// bytes: 16 modulo 128 too.)
constexpr int kStride = 128 + 8;

// The widths an instantiation of the training bodies (fwd_mma_body,
// dq_mma_body, dkv_mma_body) serves:
//   kAny: D, Dv <= 128, known at run time;
//   kD128: D = Dv = 128 and 16-byte copies, known to the compiler, so
//     the width guards and the loaders' divisions fold away;
//   kD192: D in (128, 192], Dv <= 128 (MLA's training heads: D = nope
//     128 + rope 64, Dv 128), zero-padded to 192 and 128 in the
//     fragments, so the products' loops are the compiler's too; D and
//     Dv at run time guard only the loads and the stores.
enum class Width { kAny, kD128, kD192 };

template <Width W>
struct Widths {
  static constexpr int kMaxD = W == Width::kD192 ? 192 : 128;  // Q, K
  static constexpr int kMaxDv = 128;                           // V, dO
  static constexpr int kSK = kMaxD + 8;   // row stride of Q and K tiles
  static constexpr int kSV = kMaxDv + 8;  // of V and dO tiles
  static constexpr int kNd = kMaxD / 16;  // 16-column steps of Q and K
  static constexpr int kNdv = kMaxDv / 16;
  // padded widths: D's and Dv's own below kD192, known above
  static __device__ __forceinline__ int dp(int d) {
    return W == Width::kD192 ? kMaxD : (d + 15) & ~15;
  }
  static __device__ __forceinline__ int dvp(int dv) {
    return W == Width::kD192 ? kMaxDv : (dv + 15) & ~15;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives r[j] = its two elements of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16-deep step made from the C fragments of two
// neighbouring n-tiles, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Offsets, in elements of a tile of row stride kS (default kStride), of
// the row this lane hands ldmatrix.x4 for:
//   an A fragment (16 rows x 16 columns at (0, 0));
template <int kS = kStride>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * kS + (lane >> 4) * 8;
}
//   the B fragments of two n-tiles read from n-major rows (16 rows = n,
//   16 columns = k), as K rows are for Q.K^T;
template <int kS = kStride>
__device__ __forceinline__ int bn_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * kS + ((lane >> 3) & 1) * 8;
}
//   the B fragments of two n-tiles read, transposed, from k-major rows
//   (16 rows = k, 16 columns = n), as V rows are for P.V.
template <int kS = kStride>
__device__ __forceinline__ int bk_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * kS + (lane >> 4) * 8;
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src
// is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Rows [r0, r0 + kRows) of a (n_rows, width) bf16 plane into a tile of
// stride kS (default kStride), columns [0, wp), wp = width rounded up
// to 16 or past it; rows past n_rows and columns past width are zeros.
// vec: width % 8 == 0 and the plane 16-byte aligned, so each 16-byte
// chunk is one cp.async (the caller commits and waits); otherwise
// element by element, plain loads and stores, visible after the
// caller's next __syncthreads().
template <int kRows, int kThreads, int kS = kStride>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int n_rows, int width,
                                          int wp, bool vec) {
  if (vec) {
    const int cpr = wp >> 3;  // chunks per row
    for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const bool ok = r0 + j < n_rows && c * 8 < width;
      cp_async16(dst + j * kS + c * 8,
                 ok ? src + (int64_t)(r0 + j) * width + c * 8 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * wp; i += kThreads) {
      const int j = i / wp, d = i - j * wp;
      dst[j * kS + d] = r0 + j < n_rows && d < width
                                 ? src[(int64_t)(r0 + j) * width + d]
                                 : __float2bfloat16(0.f);
    }
  }
}

// Rows [r0, r0 + kRows) of an fp32 (n_rows,) vector into dst, zeros
// past n_rows, asynchronously (the caller commits and waits).
template <int kRows, int kThreads>
__device__ __forceinline__ void load_row_vec(float* dst,
                                             const float* __restrict__ src,
                                             int r0, int n_rows) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const bool ok = r0 + i < n_rows;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// Whether a bf16 (rows, width) plane at p can take load_tile's 16-byte
// copies.
inline bool vec_ok(const void* p, int width) {
  return width % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mma
}  // namespace rt
