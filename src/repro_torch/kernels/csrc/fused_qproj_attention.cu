// fused_qproj_attention_masked, fused_qproj_attention_paged and
// fused_qproj_attention_fwd for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_qproj_attention.py
// fused_qproj_attention_masked (pallas_call at :243, body
// _qproj_masked_fwd_kernel :146): the Q tile is projected from the
// pre-projection activations inside the kernel (x @ Wq[:, h, :] in
// fp32), rotated by RoPE at lengths[b] - Sq + row, rounded to the K
// dtype, and then runs the masked attention body of fused_attention.cu.
// Q never reaches device memory.
// Replaces the TPU kernel src/repro/kernels/fused_qproj_attention.py
// fused_qproj_attention_paged (pallas_call at :322, body
// _qproj_paged_fwd_kernel :260): the same kernel over a page pool,
// through the paged addressing policy of common.cuh.
// Replaces the TPU kernel src/repro/kernels/fused_qproj_attention.py
// _qproj_fwd (pallas_call at :104, body _qproj_fwd_kernel :34), the
// forward of the custom_vjp fused_qproj_attention:
// fused_qproj_attention_fwd is the same kernel over the whole Skv (no
// lengths), rows anchored and rotated at q_offset + r, and the lse
// output of fused_attention_fwd.  Its backward recomputes Q outside
// the kernel and runs fused_attention_bwd.cu's two kernels.
//
// Bound on an H100 at the serve path's shapes (bf16, E=4608, Hq=36,
// D=128, a 256-row chunk over a ~512-column prefix): the projection's
// 2*Sq*E*Hq*D = 11 GFLOP dominates the operations, and x, Wq (42.5 MB)
// and O dominate the ~50 MB of bytes, so the bound is the bytes, about
// 15 us.  The paged kernel on the rung-down decode path (M=1,
// starcoder2-7b, B=4 at contexts 301..705) reads Wq (42.5 MB) and about
// 4.3 MB of KV: about 14 us, bytes-bound.
// Design: one block owns 16 rows of one (batch row, query head); its
// 128 threads each build one Q column for the 16 rows, so every Wq
// element a block reads feeds 16 FMAs, and the block's x rows are
// staged through shared memory.  Blocks of the same head read the same
// Wq slice from L2.  The FMA projection is far from the bound; the
// later lever is a tensor-core (wgmma) projection over larger row
// tiles.  The paged policy stages each tile's slice of the block table
// in shared memory, as in fused_attention.cu.  At M=1 a block computes
// one live row of its 16, and each batch row's block of a head reads
// that head's Wq slice again (from L2 after the first).
// The forward with lse at starcoder2-7b's training shapes (B=2,
// Sq=Skv=2048, causal): 2*B*Sq*E*Hq*D = 174 GFLOP of projection plus
// 77 GFLOP of attention against about 127 MB (x, Wq, K, V, O, lse):
// 0.25 ms at 989 TFLOP/s, bound by the operations.
#include "common.cuh"

namespace {

constexpr int kChunkE = 64;  // x columns staged per step of the projection

template <typename T, typename KV>
__global__ void __launch_bounds__(rt::kThreads)
    qproj_attention_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const int* __restrict__ lengths, rt::KVSource src,
                           T* __restrict__ out, float* __restrict__ lse,
                           int Hq, int Hkv, int Sq, int E, int D, int Dv,
                           int causal, int q_offset, float scale,
                           float rope_theta, int use_rope) {
  extern __shared__ float smem[];
  __shared__ rt::RowInfo rows[rt::kRows];
  __shared__ int kv_end_s;
  __shared__ rt::PagedScratch<rt::kTileK> scratch;
  const int bh = blockIdx.y;  // b * Hq + query head
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  // masked: rows anchored (and rotated) at the end of the valid prefix;
  // without lengths (the training forward): at q_offset over all Skv
  const int len = lengths ? max(0, min(lengths[b], src.skv)) : src.skv;
  const int off = lengths ? len - Sq : q_offset;
  const int r0 = blockIdx.x * rt::kRows;
  const int tid = threadIdx.x;

  if (tid < rt::kRows) {
    const int pos = r0 + tid;
    rt::RowInfo info{-1, -1};
    if (pos < Sq) {
      info.out_off = (((int64_t)b * Hq + h) * Sq + pos) * Dv;
      info.anchor = causal ? off + pos : len - 1;
    }
    rows[tid] = info;
  }

  // fusion step: the Q tile, x[b, r0:r0+16, :] @ Wq[:, h, :] in fp32;
  // thread tid builds column d = tid of all 16 rows
  float* q_s = smem;
  float* x_s = smem + rt::kRows * rt::kMaxD;  // the K tile's space, free now
  float acc[rt::kRows];
#pragma unroll
  for (int i = 0; i < rt::kRows; ++i) acc[i] = 0.f;
  const T* xb = x + ((int64_t)b * Sq + r0) * E;
  const T* wcol = wq + (int64_t)h * D + tid;
  const int64_t wstride = (int64_t)Hq * D;
  for (int e0 = 0; e0 < E; e0 += kChunkE) {
    __syncthreads();
    for (int idx = tid; idx < rt::kRows * kChunkE; idx += rt::kThreads) {
      const int i = idx / kChunkE, e = idx - i * kChunkE;
      x_s[idx] = (r0 + i < Sq && e0 + e < E)
                     ? rt::to_f(xb[(int64_t)i * E + e0 + e])
                     : 0.f;
    }
    __syncthreads();
    if (tid < D) {
      const int ne = min(kChunkE, E - e0);
#pragma unroll 8
      for (int e = 0; e < ne; ++e) {
        const float w = rt::to_f(wcol[(int64_t)(e0 + e) * wstride]);
#pragma unroll
        for (int i = 0; i < rt::kRows; ++i)
          acc[i] = fmaf(x_s[i * kChunkE + e], w, acc[i]);
      }
    }
  }
  if (tid < D) {
#pragma unroll
    for (int i = 0; i < rt::kRows; ++i) q_s[i * rt::kMaxD + tid] = acc[i];
  }
  __syncthreads();

  // RoPE in fp32 at position off + row (the half-split rotation
  // of models.common.rope), then the cast to K's dtype before Q.K^T
  const int half = D / 2;
  for (int idx = tid; idx < rt::kRows * half; idx += rt::kThreads) {
    const int i = idx / half, d = idx - i * half;
    float* row = q_s + i * rt::kMaxD;
    float a = row[d], c = row[d + half];
    if (use_rope) {
      const float freq = expf((float)d * (-logf(rope_theta) / (float)half));
      const float ang = (float)(off + r0 + i) * freq;
      const float cs = cosf(ang), sn = sinf(ang);
      const float a2 = a * cs - c * sn;
      c = c * cs + a * sn;
      a = a2;
    }
    row[d] = rt::round_to<T>(a);
    row[d + half] = rt::round_to<T>(c);
  }
  if (tid == 0) {
    int end = 0;
    for (int i = 0; i < rt::kRows; ++i)
      if (rows[i].out_off >= 0) end = max(end, min(len, rows[i].anchor + 1));
    kv_end_s = end;
  }
  __syncthreads();
  rt::masked_attention_rows<T>(smem, rows, k, v,
                               KV::make(src, b, kvh, Hkv, scratch), out, lse,
                               len, kv_end_s, D, Dv, scale);
}

template <typename T, typename KV>
int launch(const void* x, const void* wq, const void* k, const void* v,
           const int* lengths, rt::KVSource src, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int E, int D, int Dv, int causal,
           int q_offset, float scale, float rope_theta, int use_rope,
           cudaStream_t stream) {
  auto kern = qproj_attention_kernel<T, KV>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       rt::kSmemBytes);
  dim3 grid((Sq + rt::kRows - 1) / rt::kRows, B * Hq);
  kern<<<grid, rt::kThreads, rt::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq),
      static_cast<const T*>(k), static_cast<const T*>(v), lengths, src,
      static_cast<T*>(out), lse, Hq, Hkv, Sq, E, D, Dv, causal, q_offset,
      scale, rope_theta, use_rope);
  return (int)cudaGetLastError();
}

template <typename KV>
int run(int dtype, const void* x, const void* wq, const void* k,
        const void* v, const int* lengths, rt::KVSource src, void* out,
        float* lse, int B, int Hq, int Hkv, int Sq, int E, int D, int Dv,
        int causal, int q_offset, float scale, float rope_theta,
        int use_rope, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float, KV>(x, wq, k, v, lengths, src, out, lse, B, Hq,
                               Hkv, Sq, E, D, Dv, causal, q_offset, scale,
                               rope_theta, use_rope, s);
    case rt::kBF16:
      return launch<__nv_bfloat16, KV>(x, wq, k, v, lengths, src, out, lse, B,
                                       Hq, Hkv, Sq, E, D, Dv, causal,
                                       q_offset, scale, rope_theta, use_rope,
                                       s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_qproj_attention_masked_launch(
    const void* x, const void* wq, const void* k, const void* v,
    const int* lengths, void* out, int B, int Hq, int Hkv, int Sq, int Skv,
    int E, int D, int Dv, int causal, float scale, float rope_theta,
    int use_rope, int dtype, void* stream) {
  return run<rt::DenseKV>(dtype, x, wq, k, v, lengths,
                          rt::KVSource{nullptr, 0, 0, Skv}, out, nullptr, B,
                          Hq, Hkv, Sq, E, D, Dv, causal, 0, scale, rope_theta,
                          use_rope, stream);
}

extern "C" int fused_qproj_attention_fwd_launch(
    const void* x, const void* wq, const void* k, const void* v, void* out,
    float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int E, int D, int Dv,
    int causal, int q_offset, float scale, float rope_theta, int use_rope,
    int dtype, void* stream) {
  return run<rt::DenseKV>(dtype, x, wq, k, v, nullptr,
                          rt::KVSource{nullptr, 0, 0, Skv}, out, lse, B, Hq,
                          Hkv, Sq, E, D, Dv, causal, q_offset, scale,
                          rope_theta, use_rope, stream);
}

extern "C" int fused_qproj_attention_paged_launch(
    const void* x, const void* wq, const void* k_pool, const void* v_pool,
    const int* lengths, const int* block_tables, void* out, int B, int Hq,
    int Hkv, int Sq, int max_pages, int page, int E, int D, int Dv,
    int causal, float scale, float rope_theta, int use_rope, int dtype,
    void* stream) {
  rt::KVSource src;
  if (!rt::paged_source(block_tables, max_pages, page, &src))
    return (int)cudaErrorInvalidValue;
  return run<rt::PagedKV>(dtype, x, wq, k_pool, v_pool, lengths, src, out,
                          nullptr, B, Hq, Hkv, Sq, E, D, Dv, causal, 0, scale,
                          rope_theta, use_rope, stream);
}
