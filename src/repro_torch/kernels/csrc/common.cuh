// Shared pieces of the Hopper attention kernels: element conversions,
// warp reductions, and the masked online-softmax body that
// fused_attention.cu and fused_qproj_attention.cu both run.
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
constexpr int kKStride = kMaxD + 1;  // pad K rows: conflict-free column reads

// Dynamic shared memory of the body, in floats.
constexpr int kSmemFloats = kRows * kMaxD      // q tile
                            + kTileK * kKStride  // K tile
                            + kTileK * kMaxD     // V tile
                            + kRows * kTileK;    // p tile
constexpr int kSmemBytes = kSmemFloats * 4;

struct RowInfo {
  int64_t out_off;  // element offset of the row's output, -1: padding row
  int anchor;       // last column the row may see (causal), else len - 1
};

// The masked online-softmax body for the kRows rows whose Q (fp32,
// already rounded to K's dtype, kMaxD stride) sits in q_s.  kb / vb
// point at this (b, kv-head)'s (Skv, D) / (Skv, Dv) planes.  Columns
// c < kv_end are walked; a row sees column c iff c < len and
// c <= anchor (the end-anchored causal triangle, or the whole prefix).
// p is zeroed under the mask, so a row with no valid column emits 0.
template <typename T>
__device__ void masked_attention_rows(float* smem, const RowInfo* rows,
                                      const T* __restrict__ kb,
                                      const T* __restrict__ vb,
                                      T* __restrict__ out, int len,
                                      int kv_end, int D, int Dv,
                                      float scale) {
  float* q_s = smem;
  float* k_s = q_s + kRows * kMaxD;
  float* v_s = k_s + kTileK * kKStride;
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
    for (int idx = tid; idx < kTileK * D; idx += kThreads) {
      const int j = idx / D, d = idx - j * D;
      k_s[j * kKStride + d] =
          j < nk ? to_f(kb[(int64_t)(j0 + j) * D + d]) : 0.f;
    }
    for (int idx = tid; idx < kTileK * Dv; idx += kThreads) {
      const int j = idx / Dv, d = idx - j * Dv;
      v_s[j * kMaxD + d] = j < nk ? to_f(vb[(int64_t)(j0 + j) * Dv + d]) : 0.f;
    }
    __syncthreads();

    // scores: lane owns columns lane and lane + 32 of every row of its warp
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = k_s + lane * kKStride;
    const float* k1 = k_s + (lane + 32) * kKStride;
    for (int d = 0; d < D; ++d) {
      const float a = k0[d], b = k1[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float q = q_s[(warp * kRowsPerWarp + i) * kMaxD + d];
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
  }
}

}  // namespace rt
