// fused_attention_masked, fused_attention_paged and fused_attention_fwd
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_attention.py
// fused_attention_masked (pallas_call at :310, body _masked_fwd_kernel
// :228): online-softmax GQA attention over a dense KV cache with a
// per-row valid prefix lengths[b], causal rows anchored at
// lengths[b] - Sq + r, KV blocks past the prefix skipped, and rows with
// no valid column emitting zeros.
// Replaces the TPU kernel src/repro/kernels/fused_attention.py
// fused_attention_paged (pallas_call at :408, body _paged_fwd_kernel
// :341): the same attention with K/V read from a page pool through
// block_tables[b, p / page].  As on the TPU, the paged kernel is the
// masked kernel with another KV address: one body
// (common.cuh masked_attention_rows), two addressing policies.
//
// Replaces the TPU kernel src/repro/kernels/fused_attention.py _fwd
// (pallas_call at :155, body _fwd_kernel :93), the forward of the
// custom_vjp fused_attention that every training step runs:
// fused_attention_fwd is the same body over the whole Skv (no lengths),
// with causal rows anchored at q_offset + r (default Skv - Sq) and a
// second output, lse = m + log(l) in fp32, the residual its backward
// (fused_attention_bwd.cu) recomputes p from.
//
// Bound on an H100 at the serve path's shapes (bf16, Hq=36, Hkv=4,
// D=128, a 256-row prefill chunk): about 5 MB moved (Q and O dominate)
// against about 0.6 GFLOP of scores and P.V, so the card's bound is
// the bytes, a few microseconds.  The paged kernel at qwen3-8b's
// decode shapes (Hq=32, Hkv=8, B=4 rows at contexts 301..705) reads
// about 8.5 MB of KV: about 2.5 us, bytes-bound too.
// Design: one block owns 16 query rows of one (batch row, KV head),
// taken across the whole GQA group, so a K/V tile brought into shared
// memory serves every query head that reads it and M=1 decode still
// fills a block with the group's heads.  The block loads lengths[b]
// itself and stops at the last KV tile the prefix and the causal
// anchor allow: tiles past it cost no loads.  The paged policy stages
// each 64-key tile's slice of the block table in shared memory (a page
// may be as small as 8 keys) and resolves every key's row from it.
// Products run as fp32 FMAs; moving them onto the tensor cores
// (mma.sync / wgmma) and the page gather onto cp.async or TMA are the
// levers a later change pulls.
// The training forward at starcoder2-7b's shapes (B=2, Sq=Skv=2048,
// causal) does 4*B*Hq*D*(Sq*(Sq+1)/2) = 77 GFLOP against 84 MB of Q, K,
// V, O and lse: 0.078 ms at 989 TFLOP/s (0.025 ms for the bytes), bound by the operations,
// which this FMA body runs on the CUDA cores, not the tensor cores.
#include "common.cuh"

namespace {

template <typename T, typename KV>
__global__ void __launch_bounds__(rt::kThreads)
    masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            rt::KVSource src, T* __restrict__ out,
                            float* __restrict__ lse, int Hq, int Hkv, int Sq,
                            int D, int Dv, int causal, int q_offset,
                            float scale) {
  extern __shared__ float smem[];
  __shared__ rt::RowInfo rows[rt::kRows];
  __shared__ int kv_end_s;
  __shared__ rt::PagedScratch<rt::kTileK> scratch;
  const int group = Hq / Hkv;
  const int bk = blockIdx.y;  // b * Hkv + kv head
  const int b = bk / Hkv, kvh = bk - b * Hkv;
  // masked: the row's valid prefix, rows anchored at its end; without
  // lengths (the training forward): all Skv, rows anchored at q_offset
  const int len = lengths ? max(0, min(lengths[b], src.skv)) : src.skv;
  const int off = lengths ? len - Sq : q_offset;
  const int r0 = blockIdx.x * rt::kRows;
  const int n_rows = group * Sq;

  if (threadIdx.x < rt::kRows) {
    const int r = r0 + threadIdx.x;
    rt::RowInfo info{-1, -1};
    if (r < n_rows) {
      const int g = r / Sq, pos = r - g * Sq;
      const int h = kvh * group + g;
      info.out_off = (((int64_t)b * Hq + h) * Sq + pos) * Dv;
      info.anchor = causal ? off + pos : len - 1;
    }
    rows[threadIdx.x] = info;
  }
  // the Q tile: row r of the block is query head kvh*group + r/Sq
  float* q_s = smem;
  for (int idx = threadIdx.x; idx < rt::kRows * D; idx += rt::kThreads) {
    const int i = idx / D, d = idx - i * D;
    const int r = r0 + i;
    float val = 0.f;
    if (r < n_rows) {
      const int g = r / Sq, pos = r - g * Sq;
      const int h = kvh * group + g;
      val = rt::to_f(q[(((int64_t)b * Hq + h) * Sq + pos) * D + d]);
    }
    q_s[i * rt::kMaxD + d] = val;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the block-skip bound: nothing past the deepest row's anchor
    int end = 0;
    for (int i = 0; i < rt::kRows; ++i)
      if (rows[i].out_off >= 0) end = max(end, min(len, rows[i].anchor + 1));
    kv_end_s = end;
  }
  __syncthreads();
  rt::masked_attention_rows<T>(smem, rows, k, v,
                               KV::make(src, b, kvh, Hkv, scratch), out,
                               lse, len, kv_end_s, D, Dv, scale);
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           rt::KVSource src, void* out, float* lse, int B, int Hq, int Hkv,
           int Sq, int D, int Dv, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  auto kern = masked_attention_kernel<T, KV>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       rt::kSmemBytes);
  const int n_rows = (Hq / Hkv) * Sq;
  dim3 grid((n_rows + rt::kRows - 1) / rt::kRows, B * Hkv);
  kern<<<grid, rt::kThreads, rt::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, src, static_cast<T*>(out), lse, Hq,
      Hkv, Sq, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename KV>
int run(int dtype, const void* q, const void* k, const void* v,
        const int* lengths, rt::KVSource src, void* out, float* lse, int B,
        int Hq, int Hkv, int Sq, int D, int Dv, int causal, int q_offset,
        float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float, KV>(q, k, v, lengths, src, out, lse, B, Hq, Hkv,
                               Sq, D, Dv, causal, q_offset, scale, s);
    case rt::kBF16:
      return launch<__nv_bfloat16, KV>(q, k, v, lengths, src, out, lse, B,
                                       Hq, Hkv, Sq, D, Dv, causal, q_offset,
                                       scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_attention_masked_launch(
    const void* q, const void* k, const void* v, const int* lengths, void* out,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,
    float scale, int dtype, void* stream) {
  return run<rt::DenseKV>(dtype, q, k, v, lengths,
                          rt::KVSource{nullptr, 0, 0, Skv}, out, nullptr, B,
                          Hq, Hkv, Sq, D, Dv, causal, 0, scale, stream);
}

extern "C" int fused_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,
    int q_offset, float scale, int dtype, void* stream) {
  return run<rt::DenseKV>(dtype, q, k, v, nullptr,
                          rt::KVSource{nullptr, 0, 0, Skv}, out, lse, B, Hq,
                          Hkv, Sq, D, Dv, causal, q_offset, scale, stream);
}

extern "C" int fused_attention_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* lengths,
    const int* block_tables, void* out, int B, int Hq, int Hkv, int Sq,
    int max_pages, int page, int D, int Dv, int causal, float scale,
    int dtype, void* stream) {
  rt::KVSource src;
  if (!rt::paged_source(block_tables, max_pages, page, &src))
    return (int)cudaErrorInvalidValue;
  return run<rt::PagedKV>(dtype, q, k_pool, v_pool, lengths, src, out,
                          nullptr, B, Hq, Hkv, Sq, D, Dv, causal, 0, scale,
                          stream);
}
