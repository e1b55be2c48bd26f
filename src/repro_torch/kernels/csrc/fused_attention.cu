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
// (pallas_call at :155, body _fwd_kernel :99), the forward of the
// custom_vjp fused_attention that every training step runs:
// fused_attention_fwd, over the whole Skv (no lengths), with causal rows
// anchored at q_offset + r (default Skv - Sq) and a second output, lse =
// m + log(l) in fp32, the residual its backward (fused_attention_bwd.cu)
// recomputes p from.
//
// Bound on an H100 at the serve path's shapes (bf16, Hq=36, Hkv=4,
// D=128, a 256-row prefill chunk): about 5 MB moved (Q and O dominate)
// against about 0.6 GFLOP of scores and P.V, so the card's bound is
// the bytes, a few microseconds.  The paged kernel at qwen3-8b's
// decode shapes (Hq=32, Hkv=8, B=4 rows at contexts 301..705) reads
// about 8.5 MB of KV: about 2.5 us, bytes-bound too.
// Design: in the masked and paged kernels one block owns 16 query rows
// of one (batch row, KV head), taken across the whole GQA group, so a
// K/V tile brought into shared memory serves every query head that
// reads it and M=1 decode still fills a block with the group's heads.
// The block loads lengths[b] itself and stops at the last KV tile the
// prefix and the causal anchor allow: tiles past it cost no loads.  The
// paged policy stages each 64-key tile's slice of the block table in
// shared memory (a page may be as small as 8 keys) and resolves every
// key's row from it.  Products run as fp32 FMAs (common.cuh
// masked_attention_rows); moving them onto the tensor cores and the page
// gather onto cp.async or TMA are the levers a later change pulls.
//
// The training forward at starcoder2-7b's shapes (B=2, Sq=Skv=2048,
// causal) does 4*B*Hq*D*(Sq*(Sq+1)/2) = 77.4 GFLOP against 84 MB of Q,
// K, V, O and lse: 0.0782 ms at 989 TFLOP/s (0.025 ms for the bytes),
// bound by the operations.  So its bf16 body (fwd_mma_body) runs both
// products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate; mma.cuh): one block of 4 warps owns 64 query rows of one
// (b * Hq + h), 16 per warp, the m16 of the product.  Q is staged once
// in shared memory and read into A fragments; K and V stay bf16 in shared
// memory, 64 keys a tile, double-buffered with cp.async (rows padded to
// 136 elements, so ldmatrix is free of bank conflicts; Q borrows the
// second K buffer, so a block needs 68 KB and three fit an SM); S = Q.K^T accumulates in fp32
// registers and the online softmax runs on that accumulator layout, the
// row max and sum taken over the 4 lanes that share a row; p is rounded
// to bf16 (the TPU kernel's cast point, as masked_attention_rows rounds
// it to V's dtype) and repacked in registers as the A operand of P.V;
// O (16 x Dv per warp) accumulates in fp32 registers; lse = m +
// log(l_safe).  A causal block walks key tiles only up to its last
// row's anchor and masks only the tiles that cross the diagonal or the
// Skv edge; row tiles launch heaviest first.  A width that is not a
// multiple of 16 is zero-padded in the fragments' k dimension; one that
// is not a multiple of 8 (or a plane not 16-byte aligned) is staged by
// plain loads instead of cp.async.  K/V (8 MB at B=2, seq 2048) stay in
// the 50 MB L2, so each query head's block rereads them from there.
// fp32 inputs take masked_attention_kernel without lengths, the FMA
// body: the card tests hold fp32 to 1e-4, which neither bf16 nor TF32
// tensor cores can, and no path of the port runs the training attention
// in fp32 on the card.  The split is a dispatch on the dtype code in
// fused_attention_fwd_launch, not a fallback.
#include "common.cuh"
#include "mma.cuh"

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

// The bf16 training forward on the tensor cores (see the notes above).
namespace fwd {

using rt::mma::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBk = 64;           // keys per tile
constexpr int kS = rt::mma::kStride;
// two buffers of (K, V); Q is staged in the second K buffer, read into
// registers before that buffer's first tile is loaded
constexpr int kSmemBytes = 4 * kBk * kS * 2;
static_assert(kBq <= kBk, "the Q tile must fit a K buffer");

// One block: query rows [r0, r0 + 64) of plane bh = b * Hq + h, the row
// tile y counted from the last (heaviest under the causal mask) first.
// kFull: D = Dv = 128 and 16-byte copies, known to the compiler, so the
// width guards and the loaders' divisions fold away (on an H100, 0.41
// against 0.63 ms at the training shape).  Launched as
// fwd_mma_kernel_d128 or _any below, 3 blocks per SM (168 registers, 68
// KB of shared memory each).
template <bool kFull>
__device__ __forceinline__ void fwd_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,
    int causal, int q_offset, float scale, bool vec) {
  using namespace rt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // two buffers of kBk rows
  bf16* v_s = k_s + 2 * kBk * kS;                  // two buffers of kBk rows
  bf16* q_s = k_s + kBk * kS;                      // K's second buffer
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (kFull) D = Dv = 128, vec = true;
  const int Dp = (D + 15) & ~15, Dvp = (Dv + 15) & ~15;
  const bf16* qp = q + (int64_t)bh * Sq * D;
  const bf16* kp = k + ((int64_t)b * Hkv + kvh) * Skv * D;
  const bf16* vp = v + ((int64_t)b * Hkv + kvh) * Skv * Dv;
  // the causal frontier: nothing past the block's last row's anchor
  const int last = min(r0 + kBq, Sq) - 1;
  const int kv_end = causal ? max(0, min(Skv, q_offset + last + 1)) : Skv;
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  load_tile<kBq, kThreads>(q_s, qp, r0, Sq, D, Dp, vec);
  if (n_tiles > 0) {
    load_tile<kBk, kThreads>(k_s, kp, 0, Skv, D, Dp, vec);
    load_tile<kBk, kThreads>(v_s, vp, 0, Skv, Dv, Dvp, vec);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[8][4];  // Q's A fragments, 16 columns each
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk * 16 < Dp)
      ldsm_x4(qf[kk], q_s + warp * 16 * kS + kk * 16 + a_off(lane));
  __syncthreads();  // Q read before tile 1 overwrites it

  // this lane's rows: wr + gid and wr + gid + 8
  const int wr = r0 + warp * 16;
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  float acc[16][4];  // O: n-tile n holds columns 8n + 2tig, +1
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBk;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      load_tile<kBk, kThreads>(k_s + nb * kBk * kS, kp, j0 + kBk, Skv, D, Dp,
                               vec);
      load_tile<kBk, kThreads>(v_s + nb * kBk * kS, vp, j0 + kBk, Skv, Dv,
                               Dvp, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kBk * kS;
    const bf16* vs = v_s + (t & 1) * kBk * kS;

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
        ldsm_x4(bf, ks + np * 16 * kS + kk * 16 + bn_off(lane));
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, and mask only a tile that crosses the diagonal (for some
    // row of this warp) or the Skv edge; a masked score is -inf, so its
    // p is exactly 0 while m stays at least kNegInf, finite
    const bool edge = (causal && j0 + kBk - 1 > q_offset + wr) ||
                      j0 + kBk > Skv;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int col = j0 + 8 * n + 2 * tig + (e & 1);
          const int row = wr + gid + 8 * (e >> 1);
          if (col >= Skv || (causal && col > q_offset + row)) x = -INFINITY;
        }
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
        ldsm_x4_t(bf, vs + kk * 16 * kS + np * 16 + bk_off(lane));
        mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // tile t consumed before its buffer is refilled
  }
  cp_async_wait<0>();

  // emit: a row that saw no column has l = 0 (counted as 1), m = kNegInf
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = wr + gid + 8 * i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    bf16* o = out + ((int64_t)bh * Sq + row) * Dv;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + 2 * tig;
      if (col < Dv) {
        o[col] = __float2bfloat16_rn(acc[n][2 * i] / l_safe);
        o[col + 1] = __float2bfloat16_rn(acc[n][2 * i + 1] / l_safe);
      }
    }
    if (tig == 0) lse[(int64_t)bh * Sq + row] = m[i] + logf(l_safe);
  }
}

}  // namespace fwd
}  // namespace

// The body's two instantiations as kernels with names of their own (C
// linkage), so the build's ptxas report and the SASS name each one:
// fwd_mma_kernel_d128 is the one the training path runs.
#define FWD_MMA_KERNEL(name, full)                                          \
  extern "C" __global__ void __launch_bounds__(fwd::kThreads, 3) name(     \
      const rt::mma::bf16* __restrict__ q,                                  \
      const rt::mma::bf16* __restrict__ k,                                  \
      const rt::mma::bf16* __restrict__ v, rt::mma::bf16* __restrict__ out, \
      float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int D,     \
      int Dv, int causal, int q_offset, float scale, bool vec) {            \
    fwd::fwd_mma_body<full>(q, k, v, out, lse, Hq, Hkv, Sq, Skv, D, Dv,     \
                            causal, q_offset, scale, vec);                  \
  }
FWD_MMA_KERNEL(fwd_mma_kernel_d128, true)
FWD_MMA_KERNEL(fwd_mma_kernel_any, false)
#undef FWD_MMA_KERNEL

namespace {
namespace fwd {

int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int Dv, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  const bool vec = rt::mma::vec_ok(q, D) && rt::mma::vec_ok(k, D) &&
                   rt::mma::vec_ok(v, Dv);
  auto kern = vec && D == 128 && Dv == 128 ? fwd_mma_kernel_d128
                                           : fwd_mma_kernel_any;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  dim3 grid(B * Hq, (Sq + kBq - 1) / kBq);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Hq, Hkv,
      Sq, Skv, D, Dv, causal, q_offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace fwd

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

// bf16 runs the tensor-core body, fp32 the FMA body (masked_attention_rows
// without lengths): a dispatch on the dtype, stated in the notes above.
extern "C" int fused_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,
    int q_offset, float scale, int dtype, void* stream) {
  if (dtype == rt::kBF16)
    return fwd::launch(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, Dv, causal,
                       q_offset, scale, static_cast<cudaStream_t>(stream));
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
