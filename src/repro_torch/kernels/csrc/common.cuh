// Shared pieces of the Hopper attention kernels: element conversions,
// warp reductions, the KV addressing policies, and the masked
// online-softmax body that fused_attention.cu and
// fused_qproj_attention.cu both run, dense and paged.
//
// Every kernel here computes in fp32 and keeps the TPU kernels' cast
// points: p is rounded to the V dtype before P.V, and a Q tile built
// in-kernel is rounded to the K dtype before Q.K^T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Masked scores take this value (as the TPU kernels' NEG_INF) rather
// than -inf, so exp(m_prev - m_new) never evaluates inf - inf.
constexpr float kNegInf = -1e30f;

// dtype codes passed across the C interface (see kernels/build.py)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value through T and back: the cast points above.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tile geometry of the masked attention body: a block of kThreads
// threads owns kRows query rows (kRowsPerWarp per warp) and walks the
// KV prefix kTileK columns at a time.  Head widths up to kMaxD.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kTileK = 64;
constexpr int kMaxD = 128;

// The widest heads of the training attention (fused_attention_fwd and
// its backward): Multi-head Latent Attention's D = nope 128 + rope 64,
// with Dv 128.  Past kMaxD, which sizes every other body, they take
// instantiations of their own.
constexpr int kTrainMaxD = 192;
constexpr int kTrainMaxDv = 128;

// Dynamic shared memory of the body with Q and K rows up to kMD wide
// (V's up to kMaxD), in bytes.
template <int kMD>
constexpr int smem_bytes() {
  return 4 * (kRows * kMD           // q tile
              + kTileK * (kMD + 1)  // K tile
              + kTileK * kMaxD      // V tile
              + kRows * kTileK);    // p tile
}
constexpr int kSmemBytes = smem_bytes<kMaxD>();

// Where a kernel's KV lives, as its launch gives it: a dense cache
// (tbl == nullptr) or a paged pool read through (B, max_pages) block
// tables.  skv is a row's capacity, Skv or max_pages * page: lengths
// are clamped to it, as the TPU kernels clamp them.
struct KVSource {
  const int* tbl;
  int max_pages, page, skv;
};

// KV addressing policies.  The attention bodies walk logical KV
// positions p of one (batch row, KV head) and ask the policy for the
// row index of p in the K/V arrays; the element is then
// k[row * D + d] / v[row * Dv + d].  A policy is a per-thread value
// made by KV::make(src, b, kvh, Hkv, scratch), scratch being the
// kernel's shared PagedScratch: stage(j0, nk) runs on every thread of
// the block at the start of each KV tile [j0, j0 + nk), followed by a
// __syncthreads() when kStaged, and row(p) is valid for p inside the
// staged tile.  The walk, the masking, the softmax and the
// cast points are the bodies' own, one for both policies, so a paged
// kernel over any table gives bit for bit what its dense kernel gives
// over the gathered cache.

// A dense (B, Hkv, Skv, D) cache: plane (b, kvh) starts at row
// (b * Hkv + kvh) * Skv.
struct DenseKV {
  static constexpr bool kStaged = false;
  int64_t base;
  template <typename Scratch>
  static __device__ __forceinline__ DenseKV make(const KVSource& src, int b,
                                                 int kvh, int hkv, Scratch&) {
    return DenseKV{((int64_t)b * hkv + kvh) * src.skv};
  }
  __device__ __forceinline__ void stage(int, int) {}
  __device__ __forceinline__ int64_t row(int p) const { return base + p; }
};

// Smallest page the paged policy takes (kernels/ops.py refuses others).
constexpr int kMinPage = 8;

// Shared memory of the paged policy for tiles of kTile keys: the
// tile's slice of the block table and the row index of each key.
template <int kTile>
struct PagedScratch {
  int tbl[kTile / kMinPage + 1];
  int64_t row[kTile];
};

// A paged pool (num_pages, Hkv, page, D) read through one batch row's
// block-table row: logical position p of KV head kvh sits at row
// (tbl[p / page] * Hkv + kvh) * page + p % page.  Pages may be smaller
// than a tile (page 8 against a 64- or 256-key tile), so stage() copies
// the tile's slice of the table, at most tile / kMinPage + 1 entries,
// into shared memory once per tile, then resolves each key's row from
// it, once per key; row() is a shared-memory read, so the loaders do
// no division per element.  The slice covers only pages that hold
// positions < j0 + nk, and the bodies never walk past a row's clamped
// length, so no table entry past the row's last live page is read; a
// length-0 row reads none.
struct PagedKV {
  static constexpr bool kStaged = true;
  const int* tbl;    // this batch row's (max_pages,) table row
  int* tbl_s;        // shared: the staged slice
  int64_t* row_s;    // shared: the staged tile's row indices
  int hkv, kvh, page, j0;
  template <int kTile>
  static __device__ __forceinline__ PagedKV make(const KVSource& src, int b,
                                                 int kvh, int hkv,
                                                 PagedScratch<kTile>& s) {
    return PagedKV{src.tbl + (int64_t)b * src.max_pages, s.tbl, s.row, hkv,
                   kvh, src.page, 0};
  }
  // The caller's next __syncthreads() publishes row_s.
  __device__ __forceinline__ void stage(int tile0, int nk) {
    j0 = tile0;
    const int first = j0 / page;
    const int n = (j0 + nk - 1) / page - first + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) tbl_s[i] = tbl[first + i];
    __syncthreads();
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
      const int p = j0 + i, pg = p / page;
      row_s[i] = ((int64_t)tbl_s[pg - first] * hkv + kvh) * page +
                 (p - pg * page);
    }
  }
  __device__ __forceinline__ int64_t row(int p) const { return row_s[p - j0]; }
};

// The KVSource of a paged launch, or false when the page size is one
// the paged policy does not take.
inline bool paged_source(const int* tbl, int max_pages, int page,
                         KVSource* src) {
  if (page < kMinPage || page % kMinPage || max_pages < 1) return false;
  *src = KVSource{tbl, max_pages, page, max_pages * page};
  return true;
}

struct RowInfo {
  int64_t out_off;  // element offset of the row's output, -1: padding row
  int anchor;       // last column the row may see (causal), else len - 1
};

// The masked online-softmax body for the kRows rows whose Q (fp32,
// already rounded to K's dtype, kMD stride: Q and K widths up to kMD,
// V's up to kMaxD) sits in q_s.  k / v are
// the whole K/V arrays, addressed through the policy kv (DenseKV or
// PagedKV) for this (b, kv-head).  Columns c < kv_end are walked; a
// row sees column c iff c < len and c <= anchor (the end-anchored
// causal triangle, the q_offset-anchored one of the training forward,
// or the whole prefix).  p is zeroed under the mask, so a row with no
// valid column emits 0.  lse (nullable; the training kernels pass it)
// receives each row's m + log(l) in fp32, l = 0 counted as 1, at
// out_off / Dv: the outputs are (B, Hq, Sq, Dv) and lse (B, Hq, Sq).
template <typename T, typename KV, int kMD = kMaxD>
__device__ void masked_attention_rows(float* smem, const RowInfo* rows,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v, KV kv,
                                      T* __restrict__ out,
                                      float* __restrict__ lse, int len,
                                      int kv_end, int D, int Dv,
                                      float scale) {
  constexpr int kKS = kMD + 1;  // pad K rows: conflict-free column reads
  float* q_s = smem;
  float* k_s = q_s + kRows * kMD;
  float* v_s = k_s + kTileK * kKS;
  float* p_s = v_s + kTileK * kMaxD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxD / 32];
  int anchor[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    const RowInfo r = rows[warp * kRowsPerWarp + i];
    anchor[i] = r.out_off < 0 ? -1 : r.anchor;
#pragma unroll
    for (int t = 0; t < kMaxD / 32; ++t) acc[i][t] = 0.f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += kTileK) {
    const int nk = min(kTileK, kv_end - j0);
    __syncthreads();  // previous tile fully consumed
    kv.stage(j0, nk);
    if (KV::kStaged) __syncthreads();
    for (int idx = tid; idx < kTileK * D; idx += kThreads) {
      const int j = idx / D, d = idx - j * D;
      k_s[j * kKS + d] = j < nk ? to_f(k[kv.row(j0 + j) * D + d]) : 0.f;
    }
    for (int idx = tid; idx < kTileK * Dv; idx += kThreads) {
      const int j = idx / Dv, d = idx - j * Dv;
      v_s[j * kMaxD + d] = j < nk ? to_f(v[kv.row(j0 + j) * Dv + d]) : 0.f;
    }
    __syncthreads();

    // scores: lane owns columns lane and lane + 32 of every row of its warp
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = k_s + lane * kKS;
    const float* k1 = k_s + (lane + 32) * kKS;
    for (int d = 0; d < D; ++d) {
      const float a = k0[d], b = k1[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float q = q_s[(warp * kRowsPerWarp + i) * kMD + d];
        s[i][0] = fmaf(q, a, s[i][0]);
        s[i][1] = fmaf(q, b, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float p[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j0 + lane + 32 * c;
        ok[c] = col < len && col <= anchor[i] && (lane + 32 * c) < nk;
        s[i][c] = ok[c] ? s[i][c] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[c] = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        psum += p[c];
        p_s[(warp * kRowsPerWarp + i) * kTileK + lane + 32 * c] =
            round_to<T>(p[c]);
      }
      l[i] = l[i] * alpha + warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < kMaxD / 32; ++t) acc[i][t] *= alpha;
    }
    __syncwarp();

    // P.V: lane owns output dims lane + 32 t
    for (int j = 0; j < nk; ++j) {
      float vv[kMaxD / 32];
#pragma unroll
      for (int t = 0; t < kMaxD / 32; ++t) vv[t] = v_s[j * kMaxD + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = p_s[(warp * kRowsPerWarp + i) * kTileK + j];
#pragma unroll
        for (int t = 0; t < kMaxD / 32; ++t) acc[i][t] = fmaf(p, vv[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const RowInfo r = rows[warp * kRowsPerWarp + i];
    if (r.out_off < 0) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int t = 0; t < kMaxD / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < Dv) out[r.out_off + d] = from_f<T>(acc[i][t] / l_safe);
    }
    if (lse != nullptr && lane == 0) lse[r.out_off / Dv] = m[i] + logf(l_safe);
  }
}

}  // namespace rt
