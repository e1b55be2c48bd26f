// The masked attention body on the tensor cores (bf16), shared by the
// one-pass kernels of fused_attention.cu (fused_attention_masked,
// fused_attention_paged) and by fused_qproj_attention.cu's three kernels,
// dense and paged: masked_mma_rows, with the K/V tile loader load_keys
// (also the split-KV body's) and the strided tile loader load_block
// (the Q projection's x and Wq tiles).
//
// One block of 4 warps owns 64 query rows, 16 per warp, the m16 of every
// product.  Each warp holds its rows' Q as A fragments in registers (8
// steps of 16 columns, zero past D); K and V come 64 keys a tile, bf16,
// rows padded to mma::kStride, by 16-byte cp.async in a ring of kStages
// buffers, one barrier per tile (a ring of three bought nothing:
// time_masked_mma.py).
// S = Q.K^T on mma.sync m16n8k16 with fp32 accumulators; the online
// softmax runs on the accumulator layout, a row's max and sum taken over
// the 4 lanes that share it; l sums p unrounded and p is rounded to bf16
// (V's dtype, the TPU kernels' cast point) and repacked with c_to_a as
// the A operand of P.V, whose O accumulates in fp32 registers.
//
// Rows come as RowInfo (common.cuh): out_off < 0 marks a padding row.  A
// row sees column c iff c < min(len, anchor + 1), its limit; a warp's 16
// rows may belong to two query heads with anchors of their own.  The
// block walks tiles up to kv_end (its deepest row's limit); a warp skips
// the tiles past its own rows' deepest limit, and masks only the tiles
// that reach past its live rows' least limit.  A masked score is -inf
// while m starts at kNegInf, so its p is exactly 0 (never exp(kNegInf -
// kNegInf) = 1), and a row that sees no column (length 0, a causal row
// before the prefix, a padding row) has l = 0, counted as 1, and emits
// zeros; lse (nullable) = m + log(l_safe).  K and V rows at or past
// kv_end (<= len) are zero-filled, never read, so what a cache holds past
// a row's length never reaches a product.
#pragma once

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace rt {

// Keys [j0, j0 + nk) of the tile the policy kv has staged into a tile of
// stride kMaxD + 16 / sizeof(T) elements (kMaxD rows padded by one
// 16-byte piece; for bf16 that is mma::kStride), columns [0, wp); keys
// past nk and columns past width are zeros.  vec: width a multiple of
// 16 / sizeof(T) and the array 16-byte aligned, so each 16-byte piece of
// a key's row is one cp.async (the caller commits and waits); otherwise
// element by element, plain loads and stores, visible after the caller's
// next __syncthreads().
template <typename T, int kKeys, int kThreads, typename KV>
__device__ __forceinline__ void load_keys(T* dst, const T* __restrict__ src,
                                          const KV& kv, int j0, int nk,
                                          int width, int wp, bool vec) {
  constexpr int kE = 16 / (int)sizeof(T), kS = kMaxD + kE;
  if (vec) {
    const int cpr = wp / kE;  // copies per key
    for (int i = threadIdx.x; i < kKeys * cpr; i += kThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const bool ok = j < nk && c * kE < width;
      mma::cp_async16(dst + j * kS + c * kE,
                      ok ? src + kv.row(j0 + j) * width + c * kE : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * wp; i += kThreads) {
      const int j = i / wp, d = i - j * wp;
      dst[j * kS + d] = j < nk && d < width ? src[kv.row(j0 + j) * width + d]
                                            : from_f<T>(0.f);
    }
  }
}

namespace mma {

// Rows [r0, r0 + kRows) of a bf16 plane of row stride `stride` (src at
// its column 0) into a tile of stride kDst, columns [0, wp); rows at or
// past n_rows and columns at or past n_cols are zeros.  vec: stride and
// n_cols multiples of 8 and src 16-byte aligned, so each 16-byte chunk
// is one cp.async (the caller commits and waits); otherwise element by
// element, visible after the caller's next __syncthreads().
template <int kRows, int kThreads, int kDst>
__device__ __forceinline__ void load_block(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int64_t stride, int r0,
                                           int n_rows, int n_cols, int wp,
                                           bool vec) {
  if (vec) {
    const int cpr = wp >> 3;
    for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const bool ok = r0 + j < n_rows && c * 8 < n_cols;
      cp_async16(dst + j * kDst + c * 8,
                 ok ? src + (r0 + j) * stride + c * 8 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * wp; i += kThreads) {
      const int j = i / wp, d = i - j * wp;
      dst[j * kDst + d] = r0 + j < n_rows && d < n_cols
                              ? src[(r0 + j) * stride + d]
                              : __float2bfloat16(0.f);
    }
  }
}

}  // namespace mma

// Geometry of masked_mma_rows: 4 warps, 64 rows, 64-key tiles in a ring
// of kStages, and the dynamic shared memory of its K buffers (one per
// stage) followed by its V buffers.
namespace masked_mma {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;
constexpr int kBk = 64;
constexpr int kStages = 2;
constexpr int kTile = kBk * mma::kStride;  // elements of one buffer
constexpr int kSmemBytes = 2 * kStages * kTile * 2;

// A row's limit: the columns [0, limit) it sees; 0 for a padding row.
__device__ __forceinline__ int row_limit(const RowInfo& r, int len) {
  return r.out_off < 0 ? 0 : max(0, min(len, r.anchor + 1));
}

// Called by threads [0, kRows) with their row's RowInfo (all others pass
// nothing): stores it in rows[tid] and returns, after one
// __syncthreads() of the whole block, the block's kv_end (its rows'
// deepest limit).
__device__ __forceinline__ int publish_rows(RowInfo* rows, int* end_s,
                                            const RowInfo& mine, int len) {
  const int tid = threadIdx.x;
  if (tid < kRows) {
    rows[tid] = mine;
    const int end = __reduce_max_sync(0xffffffffu, row_limit(mine, len));
    if ((tid & 31) == 0) end_s[tid >> 5] = end;
  }
  __syncthreads();
  int end = 0;
#pragma unroll
  for (int w = 0; w < kRows / 32; ++w) end = max(end, end_s[w]);
  return end;
}

// K/V tile t (keys [64 t, 64 t + nk), nk = min(64, kv_end - 64 t)) into
// buffer buf; every thread calls it (the paged policy's stage() syncs).
template <bool kFull, typename KV>
__device__ __forceinline__ void fetch_tile(mma::bf16* k_s, mma::bf16* v_s,
                                           const mma::bf16* __restrict__ k,
                                           const mma::bf16* __restrict__ v,
                                           KV& kv, int t, int buf, int kv_end,
                                           int D, int Dv, bool vec) {
  if (kFull) D = Dv = 128;
  const int j0 = t * kBk, nk = min(kBk, kv_end - j0);
  kv.stage(j0, nk);
  if (KV::kStaged) __syncthreads();
  load_keys<mma::bf16, kBk, kThreads>(k_s + buf * kTile, k, kv, j0, nk, D,
                                      (D + 15) & ~15, vec);
  load_keys<mma::bf16, kBk, kThreads>(v_s + buf * kTile, v, kv, j0, nk, Dv,
                                      (Dv + 15) & ~15, vec);
}

// The walk (see the notes above).  On entry tile 0 has been fetched into
// stage 0 and committed (when kv_end > 0), no other cp.async group is
// pending, no thread reads stages 1 and up any more (the last stage may
// still be read until the first barrier of the walk), and qf holds
// this warp's 16 rows of Q (rows[16 warp .. 16 warp + 15]) rounded to
// bf16.  k_s and v_s are the kStages K and V buffers; k, v are the whole
// K/V arrays, addressed through kv.  kFull: D = Dv = 128, known to the
// compiler.  out (B, Hq, Sq, Dv) at each row's out_off; lse (nullable) at
// out_off / Dv.
template <bool kFull, typename KV>
__device__ __forceinline__ void masked_mma_rows(
    mma::bf16* k_s, mma::bf16* v_s, const uint32_t (&qf)[8][4],
    const RowInfo* rows, const mma::bf16* __restrict__ k,
    const mma::bf16* __restrict__ v, KV& kv, mma::bf16* __restrict__ out,
    float* __restrict__ lse, int len, int kv_end, int D, int Dv,
    float scale, bool vec) {
  using namespace mma;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (kFull) D = Dv = 128;
  const int Dp = (D + 15) & ~15, Dvp = (Dv + 15) & ~15;

  // this lane's rows: 16 warp + gid and + 8
  int64_t off[2];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const RowInfo r = rows[warp * 16 + gid + 8 * i];
    off[i] = r.out_off;
    lim[i] = row_limit(r, len);
  }
  // the warp's reach (tiles past it are skipped) and the least limit of
  // its live rows (tiles that end at or before it need no mask)
  const int reach = __reduce_max_sync(0xffffffffu, max(lim[0], lim[1]));
  const int full = __reduce_min_sync(
      0xffffffffu, min(off[0] < 0 ? INT_MAX : lim[0],
                       off[1] < 0 ? INT_MAX : lim[1]));
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[16][4];  // O: n-tile n holds columns 8n + 2tig, +1
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 1; t < kStages - 1; ++t) {  // tile 0 is the caller's
    if (t < n_tiles)
      fetch_tile<kFull>(k_s, v_s, k, v, kv, t, t, kv_end, D, Dv, vec);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBk;
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread; tile t - 1's stage is free
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles)
      fetch_tile<kFull>(k_s, v_s, k, v, kv, ahead, ahead % kStages, kv_end,
                        D, Dv, vec);
    cp_async_commit();
    if (j0 < reach) {
      const bf16* ks = k_s + (t % kStages) * kTile;
      const bf16* vs = v_s + (t % kStages) * kTile;

      // S = Q.K^T: n-tile n holds keys j0 + 8n + 2tig, +1
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk * 16 >= Dp) break;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + np * 16 * kStride + kk * 16 + bn_off(lane));
          mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }

      // scale; mask a tile only where it reaches past a live row's limit
      const bool edge = j0 + kBk > full;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (edge && j0 + 8 * n + 2 * tig + (e & 1) >= lim[e >> 1])
            x = -INFINITY;
          s[n][e] = x;
        }

      // online softmax over the rows' 4 lanes
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = expf(m[i] - mx);
        m[i] = mx;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;  // l sums p unrounded, as the plain version
          s[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P.V, p rounded to bf16 (V's dtype) in the A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (np * 16 >= Dvp) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, vs + kk * 16 * kStride + np * 16 + bk_off(lane));
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // emit: a row that saw no column has l = 0 (counted as 1), m = kNegInf
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (off[i] < 0) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    bf16* o = out + off[i];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + 2 * tig;
      if (col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
    }
    if (lse != nullptr && tig == 0) lse[off[i] / Dv] = m[i] + logf(l_safe);
  }
}

}  // namespace masked_mma
}  // namespace rt
