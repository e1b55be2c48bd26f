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
// D=128, a 188-row chunk over a 700-column prefix): the projection's
// 2*Sq*E*Hq*D = 8 GFLOP and 2 GFLOP of attention against x, Wq (42.5
// MB), K, V and O, about 47 MB, so the bound is the bytes, 14 us.  The
// paged kernel on the rung-down decode path (M=1, starcoder2-7b, B=4 at
// contexts 301..705) reads Wq (42.5 MB) and about 4.3 MB of KV: about
// 14 us, bytes-bound.  The forward with lse at starcoder2-7b's training
// shapes (B=2, Sq=Skv=2048, causal): 2*B*Sq*E*Hq*D = 174 GFLOP of
// projection plus 77 GFLOP of attention against about 127 MB (x, Wq,
// K, V, O, lse): 0.25 ms at 989 TFLOP/s, bound by the operations.
// Design: in bf16, one block of 4 warps owns 64 rows of one (batch row,
// query head), rows launched deepest first.  The projection x[b, r0:r0
// + 64, :] . Wq[:, h, :] runs on mma.sync m16n8k16 (bf16 in, fp32
// accumulate): E is walked 64 columns a step, x's 64 x 64 and Wq's 64 x
// D tiles coming by 16-byte cp.async, four steps in flight (104 KB, two
// blocks an SM; the K/V buffers reuse it after the projection; two steps
// in flight cost #2 7% and M=1 decode 12%: time_masked_mma.py); each
// warp takes x's A fragments by ldmatrix and Wq's B fragments by
// ldmatrix.trans and accumulates its 16 x D tile of Q in registers, so
// Wq is read once per 64 rows
// (through L2: blocks of one head share it), and a warp with only
// padding rows (M=1 decode: 63 of 64) does no products.  RoPE runs in
// fp32 at position lengths[b] - Sq + row (or q_offset + row), column d
// at frequency exp(d * (-ln theta / (D / 2))), as the TPU kernel's
// _rope_tile: at D = 128
// in registers, columns d and d + 64 sitting in n-tiles n and n + 8 of
// one thread; at other widths through shared memory.  Q is rounded to
// bf16 (K's dtype) as it is repacked into the A fragments of the masked
// body of fused_attention.cu (masked_mma.cuh masked_mma_rows), and
// never reaches device memory.  Instantiated for D = Dv = 128
// (qproj_mma_kernel_d128, qproj_paged_mma_kernel_d128: the serve and
// training paths) and any even width (*_any), chosen by the widths
// alone, so a dense call and its paged twin run the same arithmetic.
// At the serve chunk's shape the grid is 3 x 36 = 108 blocks on 132
// SMs; splitting E or rows further is left to a later change.
// In fp32, one block owns 16 rows, each of its 128 threads builds
// one Q column with fp32 FMAs, and runs the FMA body (common.cuh
// masked_attention_rows), which the card tests hold to 1e-4; a dispatch
// on the dtype code, not a fallback.  The paged policy stages each
// tile's slice of the block table in shared memory, as in
// fused_attention.cu.
#include "common.cuh"
#include "masked_mma.cuh"
#include "mma.cuh"

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

// The bf16 body on the tensor cores (see the notes above).
namespace qmma {

using rt::mma::bf16;
namespace mm = rt::masked_mma;
// The projection's pipeline: kStages steps of kBe columns of E in
// flight, each an x tile (64 rows, stride kXS: rows 144 bytes apart, so
// the 8 rows one ldmatrix reads fall in distinct banks) and a Wq tile
// (kBe rows of stride kStride), in the dynamic shared memory that the
// K/V buffers take once the projection is done.
constexpr int kBe = 64;
constexpr int kStages = 4;
constexpr int kXS = kBe + 8;
constexpr int kXTile = mm::kRows * kXS;
constexpr int kStage = kXTile + kBe * rt::mma::kStride;  // elements
constexpr int kSmemBytes = kStages * kStage * 2 > mm::kSmemBytes
                               ? kStages * kStage * 2
                               : mm::kSmemBytes;

// One block: rows [r0, r0 + 64) of plane bh = b * Hq + h (blockIdx.y),
// row tiles counted from the last first.  The projection walks E 64
// columns a step, x's and Wq's tiles by cp.async, kStages steps in
// flight, in the memory the K/V buffers take afterwards; each warp
// accumulates its 16 x D tile of Q in fp32 from x's A fragments and Wq's
// B fragments (ldmatrix.trans).  RoPE in fp32 at position off + row: in
// registers at
// D = 128 (columns d and d + 64 sit in n-tiles n and n + 8 of one
// thread), through shared memory at other widths.  Q is rounded to bf16
// (K's dtype) into the body's A fragments and never leaves the block.
template <bool kFull, typename KV>
__device__ __forceinline__ void body(
    const bf16* __restrict__ x, const bf16* __restrict__ wq,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, rt::KVSource src,
    bf16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq,
    int E, int D, int Dv, int causal, int q_offset, float scale,
    float rope_theta, int use_rope, bool vec_x, bool vec_w, bool vec_kv) {
  using namespace rt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // mm::kStages buffers
  bf16* v_s = k_s + mm::kStages * mm::kTile;       // mm::kStages buffers
  __shared__ rt::RowInfo rows[mm::kRows];
  __shared__ int end_s[mm::kRows / 32];
  __shared__ rt::PagedScratch<mm::kBk> scratch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (kFull) D = Dv = 128;
  const int Dp = (D + 15) & ~15;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  // masked: rows anchored (and rotated) at the end of the valid prefix;
  // without lengths (the training forward): at q_offset over all Skv
  const int len = lengths ? max(0, min(lengths[b], src.skv)) : src.skv;
  const int off = lengths ? len - Sq : q_offset;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * mm::kRows;

  rt::RowInfo mine{-1, -1};
  if (tid < mm::kRows && r0 + tid < Sq) {
    const int pos = r0 + tid;
    mine.out_off = (((int64_t)b * Hq + h) * Sq + pos) * Dv;
    mine.anchor = causal ? off + pos : len - 1;
  }
  const int kv_end = mm::publish_rows(rows, end_s, mine, len);

  // the projection: Q = x[b, r0:r0+64, :] . Wq[:, h, :], fp32 accumulate
  const bf16* xb = x + (int64_t)b * Sq * E;
  const bf16* wb = wq + (int64_t)h * D;
  const int64_t wstride = (int64_t)Hq * D;
  const int n_e = (E + kBe - 1) / kBe;
  bf16* stages = k_s;
  auto fetch = [&](int st) {  // step st into stage st % kStages
    const int e0 = st * kBe;
    bf16* xs = stages + (st % kStages) * kStage;
    load_block<mm::kRows, mm::kThreads, kXS>(xs, xb + e0, E, r0, Sq, E - e0,
                                             kBe, vec_x);
    load_block<kBe, mm::kThreads, kStride>(xs + kXTile, wb + e0 * wstride,
                                           wstride, 0, E - e0, D, Dp, vec_w);
  };
  const bool live = r0 + warp * 16 < Sq;  // padding rows only: no products
  float acc[16][4];  // Q: n-tile n holds columns 8n + 2tig, +1
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_e) fetch(st);
    cp_async_commit();
  }
  const int a_row = (warp * 16 + (lane & 15)) * kXS + (lane >> 4) * 8;
  for (int st = 0; st < n_e; ++st) {
    cp_async_wait<kStages - 2>();  // step st has landed
    __syncthreads();  // ... for every thread; step st - 1's stage is free
    if (st + kStages - 1 < n_e) fetch(st + kStages - 1);
    cp_async_commit();
    if (live) {
      const bf16* xs = stages + (st % kStages) * kStage;
      const bf16* ws = xs + kXTile;
#pragma unroll
      for (int kk = 0; kk < kBe / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, xs + a_row + kk * 16);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (np * 16 >= Dp) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, ws + kk * 16 * kStride + np * 16 + bk_off(lane));
          mma_bf16(acc[2 * np], a, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp past the stages, which Q and K/V reuse

  // RoPE in fp32 at position off + row (the half-split rotation of
  // models.common.rope), then the cast to K's dtype in the A fragments
  const int half = D / 2;
  const float inv = -logf(rope_theta) / (float)half;
  uint32_t qf[8][4];
  if (kFull) {
    if (use_rope) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 8 * n + 2 * tig + (e & 1);
          const int pos = off + r0 + warp * 16 + gid + 8 * (e >> 1);
          const float ang = (float)pos * expf((float)d * inv);
          const float cs = cosf(ang), sn = sinf(ang);
          const float a = acc[n][e], c = acc[n + 8][e];
          acc[n][e] = a * cs - c * sn;
          acc[n + 8][e] = c * cs + a * sn;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) c_to_a(qf[kk], acc[2 * kk], acc[2 * kk + 1]);
  } else {
    // fp32 Q into K's first two buffers, rotated and rounded into V's
    // last (no K/V tile comes before Q is read)
    constexpr int kQ = rt::kMaxD + 4;
    static_assert(mm::kRows * kQ * 4 <= 2 * mm::kTile * 2, "fp32 Q tile");
    float* q32 = reinterpret_cast<float*>(smem_raw);
    bf16* q_s = v_s + (mm::kStages - 1) * mm::kTile;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + 2 * tig;
      if (col >= Dp) break;
      float* r = q32 + (warp * 16 + gid) * kQ + col;
      r[0] = acc[n][0], r[1] = acc[n][1];
      r[8 * kQ] = acc[n][2], r[8 * kQ + 1] = acc[n][3];
    }
    __syncthreads();
    for (int i = tid; i < mm::kRows * half; i += mm::kThreads) {
      const int j = i / half, d = i - j * half;
      float a = q32[j * kQ + d], c = q32[j * kQ + d + half];
      if (use_rope) {
        const float ang = (float)(off + r0 + j) * expf((float)d * inv);
        const float cs = cosf(ang), sn = sinf(ang);
        const float a2 = a * cs - c * sn;
        c = c * cs + a * sn;
        a = a2;
      }
      q_s[j * kStride + d] = __float2bfloat16_rn(a);
      q_s[j * kStride + d + half] = __float2bfloat16_rn(c);
    }
    for (int i = tid; i < mm::kRows * (Dp - D); i += mm::kThreads) {
      const int j = i / (Dp - D);
      q_s[j * kStride + D + (i - j * (Dp - D))] = __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk * 16 < Dp)
        ldsm_x4(qf[kk], q_s + warp * 16 * kStride + kk * 16 + a_off(lane));
    __syncthreads();  // fp32 Q read before tiles 0 and 1 overwrite it
  }

  KV kv = KV::make(src, b, kvh, Hkv, scratch);
  if (kv_end > 0)
    mm::fetch_tile<kFull>(k_s, v_s, k, v, kv, 0, 0, kv_end, D, Dv, vec_kv);
  cp_async_commit();
  mm::masked_mma_rows<kFull>(k_s, v_s, qf, rows, k, v, kv, out, lse, len,
                             kv_end, D, Dv, scale, vec_kv);
}

}  // namespace qmma
}  // namespace

// The bf16 body's instantiations as kernels with names of their own (C
// linkage), dense (masked and training forward) and paged: *_d128 is the
// one the serve and training paths run.
#define QPROJ_MMA_BODY_KERNEL(name, full, KV)                                 \
  extern "C" __global__ void __launch_bounds__(rt::masked_mma::kThreads, 2)  \
      name(const rt::mma::bf16* __restrict__ x,                               \
           const rt::mma::bf16* __restrict__ wq,                              \
           const rt::mma::bf16* __restrict__ k,                               \
           const rt::mma::bf16* __restrict__ v,                               \
           const int* __restrict__ lengths, rt::KVSource src,                 \
           rt::mma::bf16* __restrict__ out, float* __restrict__ lse, int Hq,  \
           int Hkv, int Sq, int E, int D, int Dv, int causal, int q_offset,   \
           float scale, float rope_theta, int use_rope, bool vec_x,           \
           bool vec_w, bool vec_kv) {                                         \
    qmma::body<full, KV>(x, wq, k, v, lengths, src, out, lse, Hq, Hkv, Sq, E, \
                         D, Dv, causal, q_offset, scale, rope_theta,          \
                         use_rope, vec_x, vec_w, vec_kv);                     \
  }
#define QPROJ_MMA_KERNEL(name, full) \
  QPROJ_MMA_BODY_KERNEL(name, full, rt::DenseKV)
#define QPROJ_PAGED_MMA_KERNEL(name, full) \
  QPROJ_MMA_BODY_KERNEL(name, full, rt::PagedKV)
QPROJ_MMA_KERNEL(qproj_mma_kernel_d128, true)
QPROJ_MMA_KERNEL(qproj_mma_kernel_any, false)
QPROJ_PAGED_MMA_KERNEL(qproj_paged_mma_kernel_d128, true)
QPROJ_PAGED_MMA_KERNEL(qproj_paged_mma_kernel_any, false)
#undef QPROJ_PAGED_MMA_KERNEL
#undef QPROJ_MMA_KERNEL
#undef QPROJ_MMA_BODY_KERNEL

namespace {
namespace qmma {

// The instantiation reads the widths alone, which a dense call and its
// paged twin share; the loaders (vec_*) read the pointers' alignment too.
template <typename KV>
int launch(const void* x, const void* wq, const void* k, const void* v,
           const int* lengths, rt::KVSource src, void* out, float* lse,
           int B, int Hq, int Hkv, int Sq, int E, int D, int Dv, int causal,
           int q_offset, float scale, float rope_theta, int use_rope,
           cudaStream_t stream) {
  const bool full = D == 128 && Dv == 128;
  auto kern = full ? qproj_mma_kernel_d128 : qproj_mma_kernel_any;
  if constexpr (KV::kStaged)
    kern = full ? qproj_paged_mma_kernel_d128 : qproj_paged_mma_kernel_any;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  const bool vec_x = rt::mma::vec_ok(x, E), vec_w = rt::mma::vec_ok(wq, D);
  const bool vec_kv = rt::mma::vec_ok(k, D) && rt::mma::vec_ok(v, Dv);
  dim3 grid((Sq + mm::kRows - 1) / mm::kRows, B * Hq);
  kern<<<grid, mm::kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), lengths, src,
      static_cast<bf16*>(out), lse, Hq, Hkv, Sq, E, D, Dv, causal, q_offset,
      scale, rope_theta, use_rope, vec_x, vec_w, vec_kv);
  return (int)cudaGetLastError();
}

}  // namespace qmma

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
      return qmma::launch<KV>(x, wq, k, v, lengths, src, out, lse, B, Hq, Hkv,
                              Sq, E, D, Dv, causal, q_offset, scale,
                              rope_theta, use_rope, s);
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
