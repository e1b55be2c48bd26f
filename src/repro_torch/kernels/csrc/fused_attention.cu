// fused_attention_masked, fused_attention_paged and fused_attention_fwd
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_attention.py
// fused_attention_masked (pallas_call at :310, body _masked_fwd_kernel
// :228): online-softmax GQA attention over a dense KV cache with a
// per-row valid prefix lengths[b], causal rows anchored at
// lengths[b] - Sq + r, KV blocks past the prefix skipped, and rows with
// no valid column emitting zeros.
// Past the narrow bodies' width (D or Dv over 128: Multi-head Latent
// Attention's absorbed form, D 576, Dv 512, 128 query heads over one
// latent head), fused_attention_masked runs the wide body of
// masked_wide.cuh (its notes: V read from K's staged tile, 16 warps of
// row group x column quarter, its own split into KV chunks at decode),
// launched as masked_wide_mma_kernel (bf16) or masked_wide_fma_kernel
// (fp32).
// Replaces the TPU kernel src/repro/kernels/fused_attention.py
// fused_attention_paged (pallas_call at :408, body _paged_fwd_kernel
// :341): the same attention with K/V read from a page pool through
// block_tables[b, p / page].  As on the TPU, the paged kernel is the
// masked kernel with another KV address: for each grid shape and dtype
// one body (masked_mma.cuh masked_mma_rows in bf16, common.cuh
// masked_attention_rows in fp32; split_kernel below), two addressing
// policies (common.cuh DenseKV, PagedKV).
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
// D=128, a 256-row prefill chunk at length 256): about 5 MB moved (Q
// and O dominate) against about 0.6 GFLOP of scores and P.V, so the
// card's bound is the bytes, 1.6 us.  The paged kernel at qwen3-8b's
// decode shapes (Hq=32, Hkv=8, B=4 rows at contexts 301..705) reads
// about 8.5 MB of KV: about 2.5 us, bytes-bound too.
// Design: in the masked and paged kernels' one-pass body a block owns
// query rows of one (batch row, KV head), taken across the whole GQA
// group (row r is query head kvh * group + r / Sq at position r % Sq),
// so a K/V tile brought into shared memory serves every query head that
// reads it.  The block loads lengths[b] itself and stops at the last KV
// tile its deepest row's prefix and causal anchor allow: tiles past it
// cost no loads.  The paged policy stages each 64-key tile's slice of
// the block table in shared memory (a page may be as small as 8 keys)
// and resolves every key's row from it.  In bf16 the block owns 64 rows
// and runs the tensor-core body (masked_mma.cuh masked_mma_rows; its
// notes): 4 warps of 16 rows, Q staged in K's last buffer while tile 0
// comes into the first, then read into A fragments by ldmatrix, bf16
// K/V tiles double-buffered by cp.async, S and P.V on mma.sync, the
// online softmax on the accumulators, p rounded to bf16 before P.V, row
// tiles launched deepest first; a warp's 16 rows may span two query
// heads, each row masked at its own limit.  Instantiated for D = Dv =
// 128 (masked_mma_kernel_d128, paged_mma_kernel_d128: the serve path)
// and any even width (*_any), chosen by the widths alone.  In fp32 the
// block owns 16 rows and runs the FMA body (common.cuh
// masked_attention_rows), which the card tests hold to 1e-4; a dispatch
// on the dtype, not a fallback.
// That grid has ceil(group * Sq / rows) x B * Hkv blocks: at qwen3-8b's
// decode (group 4, Sq 1, B 4, Hkv 8) 32 blocks on 132 SMs, most rows
// padding, each block walking up to 12 tiles alone.  So where the grid
// that would launch in the call's dtype has fewer blocks than the card
// has SMs, the wrapper (kernels/fused_attention.py split_chunks) asks
// for the split-KV body (split::split_kernel) with n_chunks = floor(2 *
// SMs / its 16-row tiles) chunks, at most two blocks per SM, one wave,
// where that is at least 2, and allocates its partials and ticket
// counters; the same rule for the masked and the paged kernel, whose
// shapes and dtype are the same, so the split is too.  One block owns the live
// rows of one 16-row tile of one (batch row, KV head), no padding rows
// (the group's 4 at decode), and one chunk of that row's valid prefix:
// its nt tiles of 64 keys cut into chunks of ceil(nt / n_chunks) whole
// tiles, by logical key position and lengths[b] alone.  K and V come
// tile by tile with 16-byte cp.async copies, double-buffered, into
// rows of T padded by one copy; the paged policy stages each tile's
// slice of the block table once (one table read per page, as above)
// and every copy takes its key's row from it, a key's row being
// contiguous in the (num_pages, Hkv, page, D) pool.  Scores (a thread
// per key and half the rows, 16-byte reads of its key's row), the online
// softmax (a warp per row) and P.V (a thread per output dim) are fp32
// FMAs, bound by bytes and latency, not by the operations; so the fp32
// kernels run the same code and hold 1e-4.  Each chunk writes its fp32
// partial (m, l, unnormalized o) per row; the block that draws the last
// ticket of its (row tile, batch row, KV head) merges the chunks in
// chunk order, so the result is deterministic and no second launch is
// needed.  Tables are read only for keys below the row's length, so a
// length-0 row reads none and emits zeros.  Products on the tensor
// cores and TMA page loads are the levers a later change pulls there.
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
// MLA's cache-free training attention (deepseek-v3: 128 heads over 128,
// D = nope 128 + rope 64 = 192, Dv = 128; B=2, S=2048, causal) does
// 2 * (D + Dv) * B*Hq*Sq*(Sq+1)/2 = 343.8 GFLOP against 0.67 GB of Q, K,
// V, O and lse: 0.3476 ms at 989 TFLOP/s, bound by the operations.  Q
// and K past 128 wide take an instantiation of the same body,
// fwd_mma_kernel_d192 (mma.cuh Width::kD192): K rows padded to 200
// elements (400 bytes, 16 modulo 128: still free of bank conflicts),
// V's kept at 136, Q's twelve A fragments held in registers, widths
// zero-padded to 192 and 128 in the fragments so the products' loops
// are the compiler's; 84 KB of shared memory and 228 registers, two
// blocks per SM.  Widths past D 192 or Dv 128 are refused.
// fp32 inputs take masked_attention_kernel without lengths, the FMA
// body (sized for 192 where D is past 128, with its own shared memory):
// the card tests hold fp32 to 1e-4, which neither bf16 nor TF32
// tensor cores can, and no path of the port runs the training attention
// in fp32 on the card.  The split is a dispatch on the dtype code in
// fused_attention_fwd_launch, not a fallback.
#include "common.cuh"
#include "masked_mma.cuh"
#include "masked_wide.cuh"
#include "mma.cuh"

namespace {

// kMD: the widest Q and K rows (q_s's stride); V's are at most kMaxD.
template <typename T, typename KV, int kMD = rt::kMaxD>
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
    q_s[i * kMD + d] = val;
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
  rt::masked_attention_rows<T, KV, kMD>(smem, rows, k, v,
                               KV::make(src, b, kvh, Hkv, scratch), out,
                               lse, len, kv_end_s, D, Dv, scale);
}

// The split-KV decode body of fused_attention_masked and
// fused_attention_paged (see the notes above).
namespace split {

constexpr int kThreads = rt::kThreads;
constexpr int kRows = rt::kRows;   // query rows per block
constexpr int kBk = rt::kTileK;    // keys per tile
constexpr int kQS = rt::kMaxD;     // q_s row stride, floats
static_assert(kThreads == 2 * kBk, "scores: a thread per key, half the rows");
static_assert(kThreads >= rt::kMaxD, "P.V: a thread per output dim");
static_assert(kRows % 4 == 0, "softmax: each warp a quarter of the rows");

// A K or V tile of kBk keys in shared memory, in T: kE elements per
// 16-byte copy, rows padded by one copy so that the 8 rows a quarter
// warp reads with 16-byte loads fall in distinct banks.
template <typename T>
struct Tile {
  static constexpr int kE = 16 / sizeof(T);
  static constexpr int kS = rt::kMaxD + kE;
  static constexpr int kElems = kBk * kS;
};

// Two buffers each of K and V, then the fp32 q tile and score tile.
template <typename T>
constexpr int smem_bytes() {
  return 4 * Tile<T>::kElems * (int)sizeof(T) +
         (kRows * kQS + kRows * kBk) * 4;
}

__device__ __forceinline__ void unpack(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Whether a (rows, width) plane of T at p can take 16-byte copies.
template <typename T>
inline bool vec_ok(const void* p, int width) {
  return width % Tile<T>::kE == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One block: rows [r0, r0 + kRows) of the group * Sq rows of one (batch
// row b, KV head kvh), blockIdx.y = b * Hkv + kvh, and chunk c of that
// row's valid prefix, blockIdx.x = row tile * n_chunks + c.  The plan:
// the prefix's nt tiles of kBk keys are cut into chunks of ceil(nt /
// n_chunks) whole tiles, chunk c taking tiles [c * that, ...) (so a
// length-0 row has none, and a short row fewer than n_chunks): a
// function of lengths[b] and n_chunks alone, the same for both
// policies.  A chunk walks its tiles with the online softmax and writes
// its fp32 partial (m, l, unnormalized o) per row to part; then every
// block of the (row tile, b, kvh) takes a ticket, and the one that
// draws the last merges the chunks' partials in chunk order and writes
// the output, and resets the ticket counter.
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 rt::KVSource src, T* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counter, int Hq,
                 int Hkv, int Sq, int D, int Dv, int causal, float scale,
                 int n_chunks, bool vec) {
  using Tl = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // two buffers
  T* v_s = k_s + 2 * Tl::kElems;            // two buffers
  float* q_s = reinterpret_cast<float*>(v_s + 2 * Tl::kElems);
  float* p_s = q_s + kRows * kQS;  // a tile's scores, then its p
  __shared__ rt::RowInfo rows[kRows];
  __shared__ float alpha_s[kRows];
  __shared__ rt::PagedScratch<kBk> scratch;
  __shared__ bool last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = Hq / Hkv;
  const int bk = blockIdx.y;
  const int b = bk / Hkv, kvh = bk - b * Hkv;
  const int n_rt = gridDim.x / n_chunks;
  const int rt_i = blockIdx.x / n_chunks, c = blockIdx.x - rt_i * n_chunks;
  const int len = max(0, min(lengths[b], src.skv));
  const int r0 = rt_i * kRows;
  const int n = min(kRows, group * Sq - r0);  // this block's rows
  const int nt = (len + kBk - 1) / kBk;
  const int tpc = (nt + n_chunks - 1) / n_chunks;  // tiles per chunk
  const int t0 = c * tpc, t1 = min(nt, t0 + tpc);
  const int Dp = (D + Tl::kE - 1) / Tl::kE * Tl::kE;
  const int Dvp = (Dv + Tl::kE - 1) / Tl::kE * Tl::kE;

  KV kv = KV::make(src, b, kvh, Hkv, scratch);
  // softmax state of the rows warp owns (warp + 4 i); o of dim tid
  float m[kRows / 4], l[kRows / 4], acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) m[i] = rt::kNegInf, l[i] = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  // tile t into buffer buf (called by every thread: stage() may sync)
  auto load = [&](int t, int buf) {
    const int j0 = t * kBk, nk = min(kBk, len - j0);
    kv.stage(j0, nk);
    if (KV::kStaged) __syncthreads();
    rt::load_keys<T, kBk, kThreads>(k_s + buf * Tl::kElems, k, kv, j0, nk, D,
                                    Dp, vec);
    rt::load_keys<T, kBk, kThreads>(v_s + buf * Tl::kElems, v, kv, j0, nk,
                                    Dv, Dvp, vec);
  };
  // the first tile's copies fly while the rows and q are set up
  if (t0 < t1) load(t0, 0);
  rt::mma::cp_async_commit();
  if (tid < kRows) {
    rt::RowInfo info{-1, -1};
    if (tid < n) {
      const int r = r0 + tid, g = r / Sq, pos = r - g * Sq;
      info.out_off = (((int64_t)b * Hq + kvh * group + g) * Sq + pos) * Dv;
      info.anchor = causal ? len - Sq + pos : len - 1;
    }
    rows[tid] = info;
  }
  // the q tile of the n live rows, fp32, zeros past D: row i is query
  // head kvh*group + r/Sq (rows past n are never read)
#pragma unroll 4
  for (int idx = tid; idx < n * Dp; idx += kThreads) {
    const int i = idx / Dp, d = idx - i * Dp;
    const int r = r0 + i, g = r / Sq, pos = r - g * Sq;
    q_s[i * kQS + d] =
        d < D ? rt::to_f(q[(((int64_t)b * Hq + kvh * group + g) * Sq + pos) *
                               D + d])
              : 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) load(t + 1, buf ^ 1);
    rt::mma::cp_async_commit();
    rt::mma::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const int j0 = t * kBk, nk = min(kBk, len - j0);
    const T* ks = k_s + buf * Tl::kElems;
    const T* vs = v_s + buf * Tl::kElems;

    // scores: thread tid takes key tid % kBk for rows tid / kBk + 2 i
    {
      const int j = tid % kBk, rh = tid / kBk;
      const T* kr = ks + j * Tl::kS;
      float s[kRows / 2];
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) s[i] = 0.f;
      for (int d = 0; d < Dp; d += Tl::kE) {
        float kf[Tl::kE];
        unpack(kr + d, kf);
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          if (rh + 2 * i >= n) break;
          const float* qr = q_s + (rh + 2 * i) * kQS + d;
#pragma unroll
          for (int e = 0; e < Tl::kE; ++e) s[i] = fmaf(qr[e], kf[e], s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i)
        if (rh + 2 * i < n) p_s[(rh + 2 * i) * kBk + j] = s[i];
    }
    __syncthreads();

    // online softmax: warp takes rows warp + 4 i, lane keys lane, lane + 32
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = warp + 4 * i;
      if (r >= n) break;
      const int anchor = rows[r].anchor;
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jj = lane + 32 * cc;
        ok[cc] = jj < nk && j0 + jj <= anchor;
        sv[cc] = ok[cc] ? p_s[r * kBk + jj] * scale : rt::kNegInf;
      }
      const float m_new = fmaxf(m[i], rt::warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float p = ok[cc] ? expf(sv[cc] - m_new) : 0.f;
        psum += p;  // l sums p unrounded
        p_s[r * kBk + lane + 32 * cc] = rt::round_to<T>(p);
      }
      l[i] = l[i] * alpha + rt::warp_sum(psum);
      m[i] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // P.V: thread tid owns output dim tid of every row
    if (tid < Dv) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < n) acc[r] *= alpha_s[r];
      const T* vc = vs + tid;
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const float vv = rt::to_f(vc[j * Tl::kS]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < n) acc[r] = fmaf(p_s[r * kBk + j], vv, acc[r]);
      }
    }
    __syncthreads();  // tile t consumed before its buffer and p_s are reused
  }
  rt::mma::cp_async_wait<0>();

  // partials: o at part[(row * n_chunks + c) * Dv + d], then (m, l) at
  // part[rows_total * n_chunks * Dv + (row * n_chunks + c) * 2]
  const int64_t rows_total = (int64_t)gridDim.y / Hkv * Hq * Sq;
  float* part_ml = part + rows_total * n_chunks * Dv;
  if (t0 < t1) {
    if (tid < Dv) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < n)
          part[(rows[r].out_off / Dv * n_chunks + c) * Dv + tid] = acc[r];
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const int r = warp + 4 * i;
        if (r >= n) break;
        reinterpret_cast<float2*>(part_ml)[rows[r].out_off / Dv * n_chunks +
                                           c] = make_float2(m[i], l[i]);
      }
    }
  }
  int* ticket = counter + (int64_t)bk * n_rt + rt_i;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n_chunks - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last block in: merge the live chunks in chunk order.  A warp
  // per row takes the chunks' max m and their weights exp(m_c - max)
  // into shared memory (the K/V buffers, idle now) and sums l; then a
  // thread per dim sums the weighted o.  A row with no valid column (no
  // chunk, or every p masked) has l = 0, counted as 1, and o = 0.
  const int nc = tpc > 0 ? (nt + tpc - 1) / tpc : 0;
  float* w_s = reinterpret_cast<float*>(smem_raw);  // (kRows, nc) weights
  float* l_s = w_s + kRows * nc;                     // (kRows,) sums
  for (int r = warp; r < n; r += kThreads / 32) {
    const float2* ml = reinterpret_cast<const float2*>(part_ml) +
                       rows[r].out_off / Dv * n_chunks;
    // lane takes chunks lane, lane + 32, ...: the first (m, l) stays in
    // registers, so up to 32 chunks cost one round of loads
    const float2 first = lane < nc ? __ldcg(ml + lane)
                                   : make_float2(rt::kNegInf, 0.f);
    float mx = first.x;
    for (int cc = lane + 32; cc < nc; cc += 32)
      mx = fmaxf(mx, __ldcg(ml + cc).x);
    mx = rt::warp_max(mx);
    float lsum = 0.f;
    for (int cc = lane; cc < nc; cc += 32) {
      const float2 v = cc == lane ? first : __ldcg(ml + cc);
      const float w = expf(v.x - mx);
      w_s[r * nc + cc] = w;
      lsum = fmaf(v.y, w, lsum);
    }
    lsum = rt::warp_sum(lsum);
    if (lane == 0) l_s[r] = lsum == 0.f ? 1.f : lsum;
  }
  __syncthreads();
  if (tid < Dv) {
    for (int r = 0; r < n; ++r) {
      const float* po = part + rows[r].out_off / Dv * n_chunks * Dv + tid;
      float o = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < nc; ++cc)
        o = fmaf(__ldcg(po + (int64_t)cc * Dv), w_s[r * nc + cc], o);
      out[rows[r].out_off + tid] = rt::from_f<T>(o / l_s[r]);
    }
  }
  if (tid == 0) *ticket = 0;  // the counters are reusable as they stand
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           rt::KVSource src, void* out, float* part, int* counter, int B,
           int Hq, int Hkv, int Sq, int D, int Dv, int causal, float scale,
           int n_chunks, cudaStream_t stream) {
  auto kern = split_kernel<T, KV>;
  constexpr int smem = smem_bytes<T>();
  // the merge's weights and sums borrow the K/V buffers
  if ((int64_t)kRows * (n_chunks + 1) * 4 > 4 * Tile<T>::kElems * sizeof(T))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int n_rt = ((Hq / Hkv) * Sq + kRows - 1) / kRows;
  const bool vec = vec_ok<T>(k, D) && vec_ok<T>(v, Dv);
  dim3 grid(n_rt * n_chunks, B * Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, src, static_cast<T*>(out), part,
      counter, Hq, Hkv, Sq, D, Dv, causal, scale, n_chunks, vec);
  return (int)cudaGetLastError();
}

}  // namespace split

// The bf16 one-pass body of fused_attention_masked and
// fused_attention_paged on the tensor cores (see the notes above).
namespace onepass {

using rt::mma::bf16;
namespace mm = rt::masked_mma;

// One block: rows [r0, r0 + 64) of the group * Sq rows of one (batch row
// b, KV head kvh), blockIdx.y = b * Hkv + kvh, row r being query head
// kvh * group + r / Sq at position r % Sq; row tiles counted from the
// last (the deepest causal rows) first.  Q is staged in K's last
// buffer while tile 0 comes into the first, then read into A fragments.
// kFull: D = Dv = 128, known to the compiler.
template <bool kFull, typename KV>
__device__ __forceinline__ void body(const bf16* __restrict__ q,
                                     const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const int* __restrict__ lengths,
                                     rt::KVSource src, bf16* __restrict__ out,
                                     int Hq, int Hkv, int Sq, int D, int Dv,
                                     int causal, float scale, bool vec_q,
                                     bool vec_kv) {
  using namespace rt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);    // kStages buffers
  bf16* v_s = k_s + mm::kStages * mm::kTile;         // kStages buffers
  bf16* q_s = k_s + (mm::kStages - 1) * mm::kTile;   // K's last buffer
  __shared__ rt::RowInfo rows[mm::kRows];
  __shared__ int end_s[mm::kRows / 32];
  __shared__ rt::PagedScratch<mm::kBk> scratch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kFull) D = Dv = 128;
  const int Dp = (D + 15) & ~15;
  const int group = Hq / Hkv;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y - b * Hkv;
  const int len = max(0, min(lengths[b], src.skv));
  const int r0 = (gridDim.x - 1 - blockIdx.x) * mm::kRows;
  const int n_rows = group * Sq;
  // (b, query head, position) of block row j, or -1 past the rows
  auto q_row = [&](int j) -> int64_t {
    const int r = r0 + j;
    if (r >= n_rows) return -1;
    const int g = r / Sq;
    return ((int64_t)b * Hq + kvh * group + g) * Sq + (r - g * Sq);
  };

  rt::RowInfo mine{-1, -1};
  if (tid < mm::kRows) {
    const int64_t row = q_row(tid);
    if (row >= 0) {
      mine.out_off = row * Dv;
      const int pos = (int)(row % Sq);
      mine.anchor = causal ? len - Sq + pos : len - 1;
    }
  }
  const int kv_end = mm::publish_rows(rows, end_s, mine, len);

  KV kv = KV::make(src, b, kvh, Hkv, scratch);
  if (kv_end > 0)
    mm::fetch_tile<kFull>(k_s, v_s, k, v, kv, 0, 0, kv_end, D, Dv, vec_kv);
  if (vec_q) {
    const int cpr = Dp >> 3;
    for (int i = tid; i < mm::kRows * cpr; i += mm::kThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const int64_t row = q_row(j);
      const bool ok = row >= 0 && c * 8 < D;
      cp_async16(q_s + j * kStride + c * 8, ok ? q + row * D + c * 8 : q, ok);
    }
  } else {
    for (int i = tid; i < mm::kRows * Dp; i += mm::kThreads) {
      const int j = i / Dp, d = i - j * Dp;
      const int64_t row = q_row(j);
      q_s[j * kStride + d] =
          row >= 0 && d < D ? q[row * D + d] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[8][4];  // Q's A fragments, 16 columns each
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk * 16 < Dp)
      ldsm_x4(qf[kk], q_s + warp * 16 * kStride + kk * 16 + a_off(lane));
  // the walk's first barrier comes before anything overwrites Q
  mm::masked_mma_rows<kFull>(k_s, v_s, qf, rows, k, v, kv, out, nullptr, len,
                             kv_end, D, Dv, scale, vec_kv);
}

}  // namespace onepass

// The bf16 training forward on the tensor cores (see the notes above).
namespace fwd {

using rt::mma::bf16;
using rt::mma::Width;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBk = 64;           // keys per tile
// two buffers of (K, V); Q is staged in the second K buffer, read into
// registers before that buffer's first tile is loaded
template <Width W>
constexpr int smem_bytes() {
  using Wd = rt::mma::Widths<W>;
  return 2 * kBk * (Wd::kSK + Wd::kSV) * 2;
}
static_assert(kBq <= kBk, "the Q tile must fit a K buffer");

// One block: query rows [r0, r0 + 64) of plane bh = b * Hq + h, the row
// tile y counted from the last (heaviest under the causal mask) first.
// W: the widths it serves (mma.cuh Width).  kD128 folds the width
// guards and the loaders' divisions away (on an H100, 0.41 against 0.63
// ms for kAny at the training shape).  Launched as fwd_mma_kernel_d128
// or _any below, 3 blocks per SM (168 registers, 68 KB of shared memory
// each), or as fwd_mma_kernel_d192 (Q's 12 A fragments held in
// registers, K rows of 200 elements: 84 KB, 2 blocks per SM).
template <Width W>
__device__ __forceinline__ void fwd_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,
    int causal, int q_offset, float scale, bool vec) {
  using namespace rt::mma;
  using Wd = Widths<W>;
  constexpr int kSK = Wd::kSK, kSV = Wd::kSV, kNd = Wd::kNd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // two buffers of kBk rows
  bf16* v_s = k_s + 2 * kBk * kSK;                 // two buffers of kBk rows
  bf16* q_s = k_s + kBk * kSK;                     // K's second buffer
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (W == Width::kD128) D = Dv = 128, vec = true;
  const int Dp = Wd::dp(D), Dvp = Wd::dvp(Dv);
  const bf16* qp = q + (int64_t)bh * Sq * D;
  const bf16* kp = k + ((int64_t)b * Hkv + kvh) * Skv * D;
  const bf16* vp = v + ((int64_t)b * Hkv + kvh) * Skv * Dv;
  // the causal frontier: nothing past the block's last row's anchor
  const int last = min(r0 + kBq, Sq) - 1;
  const int kv_end = causal ? max(0, min(Skv, q_offset + last + 1)) : Skv;
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  load_tile<kBq, kThreads, kSK>(q_s, qp, r0, Sq, D, Dp, vec);
  if (n_tiles > 0) {
    load_tile<kBk, kThreads, kSK>(k_s, kp, 0, Skv, D, Dp, vec);
    load_tile<kBk, kThreads, kSV>(v_s, vp, 0, Skv, Dv, Dvp, vec);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kNd][4];  // Q's A fragments, 16 columns each
#pragma unroll
  for (int kk = 0; kk < kNd; ++kk)
    if (kk * 16 < Dp)
      ldsm_x4(qf[kk], q_s + warp * 16 * kSK + kk * 16 + a_off<kSK>(lane));
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
      load_tile<kBk, kThreads, kSK>(k_s + nb * kBk * kSK, kp, j0 + kBk, Skv,
                                    D, Dp, vec);
      load_tile<kBk, kThreads, kSV>(v_s + nb * kBk * kSV, vp, j0 + kBk, Skv,
                                    Dv, Dvp, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kBk * kSK;
    const bf16* vs = v_s + (t & 1) * kBk * kSV;

    // S = Q.K^T: n-tile n holds keys j0 + 8n + 2tig, +1
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNd; ++kk) {
      if (kk * 16 >= Dp) break;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + np * 16 * kSK + kk * 16 + bn_off<kSK>(lane));
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
        ldsm_x4_t(bf, vs + kk * 16 * kSV + np * 16 + bk_off<kSV>(lane));
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

// The body's instantiations as kernels with names of their own (C
// linkage), so the build's ptxas report and the SASS name each one:
// fwd_mma_kernel_d128 is the one the GQA training path runs,
// fwd_mma_kernel_d192 the one MLA's does.
#define FWD_MMA_KERNEL(name, width, blocks)                                 \
  extern "C" __global__ void __launch_bounds__(fwd::kThreads, blocks) name( \
      const rt::mma::bf16* __restrict__ q,                                  \
      const rt::mma::bf16* __restrict__ k,                                  \
      const rt::mma::bf16* __restrict__ v, rt::mma::bf16* __restrict__ out, \
      float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int D,     \
      int Dv, int causal, int q_offset, float scale, bool vec) {            \
    fwd::fwd_mma_body<rt::mma::Width::width>(q, k, v, out, lse, Hq, Hkv,    \
                                             Sq, Skv, D, Dv, causal,        \
                                             q_offset, scale, vec);         \
  }
FWD_MMA_KERNEL(fwd_mma_kernel_d128, kD128, 3)
FWD_MMA_KERNEL(fwd_mma_kernel_any, kAny, 3)
FWD_MMA_KERNEL(fwd_mma_kernel_d192, kD192, 2)
#undef FWD_MMA_KERNEL

// The one-pass body's instantiations as kernels with names of their own
// (C linkage), dense and paged: *_d128 is the one the serve path runs.
#define ONE_PASS_MMA_KERNEL(name, full, KV)                                  \
  extern "C" __global__ void __launch_bounds__(rt::masked_mma::kThreads, 2) \
      name(const rt::mma::bf16* __restrict__ q,                              \
           const rt::mma::bf16* __restrict__ k,                              \
           const rt::mma::bf16* __restrict__ v,                              \
           const int* __restrict__ lengths, rt::KVSource src,                \
           rt::mma::bf16* __restrict__ out, int Hq, int Hkv, int Sq, int D,  \
           int Dv, int causal, float scale, bool vec_q, bool vec_kv) {       \
    onepass::body<full, KV>(q, k, v, lengths, src, out, Hq, Hkv, Sq, D, Dv,  \
                            causal, scale, vec_q, vec_kv);                   \
  }
#define MASKED_MMA_KERNEL(name, full) \
  ONE_PASS_MMA_KERNEL(name, full, rt::DenseKV)
#define PAGED_MMA_KERNEL(name, full) \
  ONE_PASS_MMA_KERNEL(name, full, rt::PagedKV)
MASKED_MMA_KERNEL(masked_mma_kernel_d128, true)
MASKED_MMA_KERNEL(masked_mma_kernel_any, false)
PAGED_MMA_KERNEL(paged_mma_kernel_d128, true)
PAGED_MMA_KERNEL(paged_mma_kernel_any, false)
#undef PAGED_MMA_KERNEL
#undef MASKED_MMA_KERNEL
#undef ONE_PASS_MMA_KERNEL

namespace {
namespace onepass {

// The instantiation reads the widths alone, which a dense call and its
// paged twin share; the loaders (vec) read the pointers' alignment too.
template <typename KV>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           rt::KVSource src, void* out, int B, int Hq, int Hkv, int Sq,
           int D, int Dv, int causal, float scale, cudaStream_t stream) {
  const bool full = D == 128 && Dv == 128;
  auto kern = full ? masked_mma_kernel_d128 : masked_mma_kernel_any;
  if constexpr (KV::kStaged)
    kern = full ? paged_mma_kernel_d128 : paged_mma_kernel_any;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       mm::kSmemBytes);
  const bool vec_q = rt::mma::vec_ok(q, D);
  const bool vec_kv = rt::mma::vec_ok(k, D) && rt::mma::vec_ok(v, Dv);
  dim3 grid(((Hq / Hkv) * Sq + mm::kRows - 1) / mm::kRows, B * Hkv);
  kern<<<grid, mm::kThreads, mm::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, src, static_cast<bf16*>(out), Hq,
      Hkv, Sq, D, Dv, causal, scale, vec_q, vec_kv);
  return (int)cudaGetLastError();
}

}  // namespace onepass
namespace fwd {

int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
           int Dv, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  const bool vec = rt::mma::vec_ok(q, D) && rt::mma::vec_ok(k, D) &&
                   rt::mma::vec_ok(v, Dv);
  // by the widths alone (the caller refuses D > 192 or Dv > 128)
  auto kern = vec && D == 128 && Dv == 128 ? fwd_mma_kernel_d128
                                           : fwd_mma_kernel_any;
  int smem = smem_bytes<Width::kAny>();
  if (D > rt::kMaxD)
    kern = fwd_mma_kernel_d192, smem = smem_bytes<Width::kD192>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid(B * Hq, (Sq + kBq - 1) / kBq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Hq, Hkv,
      Sq, Skv, D, Dv, causal, q_offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// The FMA one-pass body (masked_attention_rows), which fp32 runs: the
// masked and paged kernels' one-pass shapes and the training forward,
// with Q and K rows up to kMD wide (kTrainMaxD: the training forward's
// MLA widths, an instantiation of its own with its own shared memory).
template <typename KV, int kMD = rt::kMaxD>
int fma_launch(int dtype, const void* q, const void* k, const void* v,
               const int* lengths, rt::KVSource src, void* out, float* lse,
               int B, int Hq, int Hkv, int Sq, int D, int Dv, int causal,
               int q_offset, float scale, cudaStream_t stream) {
  if (dtype != rt::kF32) return (int)cudaErrorInvalidValue;
  auto kern = masked_attention_kernel<float, KV, kMD>;
  constexpr int smem = rt::smem_bytes<kMD>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int n_rows = (Hq / Hkv) * Sq;
  dim3 grid((n_rows + rt::kRows - 1) / rt::kRows, B * Hkv);
  kern<<<grid, rt::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, src, static_cast<float*>(out),
      lse, Hq, Hkv, Sq, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// The masked and paged kernels: the split-KV body when the wrapper gives
// chunks (n_chunks > 0, with the partials and ticket counters it
// allocated), the one-pass body otherwise: on the tensor cores in bf16,
// the FMA body (masked_attention_rows) in fp32, a dispatch on the dtype.
template <typename KV>
int run_masked(int dtype, const void* q, const void* k, const void* v,
               const int* lengths, rt::KVSource src, void* out, float* part,
               int* counter, int B, int Hq, int Hkv, int Sq, int D, int Dv,
               int causal, int n_chunks, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_chunks <= 0) {
    if (dtype == rt::kBF16)
      return onepass::launch<KV>(q, k, v, lengths, src, out, B, Hq, Hkv, Sq,
                                 D, Dv, causal, scale, s);
    return fma_launch<KV>(dtype, q, k, v, lengths, src, out, nullptr, B, Hq,
                          Hkv, Sq, D, Dv, causal, 0, scale, s);
  }
  switch (dtype) {
    case rt::kF32:
      return split::launch<float, KV>(q, k, v, lengths, src, out, part,
                                      counter, B, Hq, Hkv, Sq, D, Dv, causal,
                                      scale, n_chunks, s);
    case rt::kBF16:
      return split::launch<__nv_bfloat16, KV>(q, k, v, lengths, src, out,
                                              part, counter, B, Hq, Hkv, Sq,
                                              D, Dv, causal, scale, n_chunks,
                                              s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The wide body's two instantiations (masked_wide.cuh), with names of
// their own (C linkage): bf16 on the tensor cores, fp32 on FMAs.
extern "C" __global__ void __launch_bounds__(rt::wide::kThreads, 1)
    masked_wide_mma_kernel(const rt::mma::bf16* __restrict__ q,
                           const rt::mma::bf16* __restrict__ k,
                           const int* __restrict__ lengths, int skv,
                           rt::mma::bf16* __restrict__ out,
                           float* __restrict__ part, int* __restrict__ counter,
                           int Hq, int Hkv, int Sq, int D, int Dv, int causal,
                           float scale, int n_chunks, bool vec) {
  rt::wide::mma_body(q, k, lengths, skv, out, part, counter, Hq, Hkv, Sq, D,
                     Dv, causal, scale, n_chunks, vec);
}

extern "C" __global__ void __launch_bounds__(rt::wide::kThreads, 1)
    masked_wide_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const int* __restrict__ lengths, int skv,
                           float* __restrict__ out, float* __restrict__ part,
                           int* __restrict__ counter, int Hq, int Hkv, int Sq,
                           int D, int Dv, int causal, float scale,
                           int n_chunks, bool vec) {
  rt::wide::fma_body(q, k, lengths, skv, out, part, counter, Hq, Hkv, Sq, D,
                     Dv, causal, scale, n_chunks, vec);
}

namespace {

// fused_attention_masked past the narrow bodies' kMaxD: the wide body,
// which reads V as the first Dv columns of K's rows, so v must be k
// itself (the wrapper passes k's pointer for a column prefix of k), with
// Dv <= D <= 576 and Dv <= 512, and n_chunks >= 1 (1: one pass, no
// partials; the wrapper's wide_chunks).
int wide_launch(int dtype, const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* part, int* counter,
                int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,
                int causal, int n_chunks, float scale, cudaStream_t stream) {
  namespace w = rt::wide;
  if (v != k || Dv > D || D > w::kMaxD || Dv > w::kMaxDv || D % 2 ||
      Dv % 2 || n_chunks < 1 || (n_chunks > 1 && (!part || !counter)))
    return (int)cudaErrorInvalidValue;
  const bool bf = dtype == rt::kBF16;
  if (!bf && dtype != rt::kF32) return (int)cudaErrorInvalidValue;
  const int rows = bf ? w::kMmaRows : w::kFmaRows;
  // the merge's weights and sums borrow Q's (bf16) or K's (fp32) tiles
  const int64_t scratch = bf ? w::kQElems / 2 : 2 * w::kBk * w::kSf;
  if ((int64_t)rows * (n_chunks + 1) > scratch)
    return (int)cudaErrorInvalidValue;
  const int n_rt = ((Hq / Hkv) * Sq + rows - 1) / rows;
  dim3 grid(n_rt * n_chunks, B * Hkv);
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k);
  if (bf) {
    const bool vec = D % 8 == 0 && align % 16 == 0;
    cudaFuncSetAttribute(masked_wide_mma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         w::kMmaSmemBytes);
    masked_wide_mma_kernel<<<grid, w::kThreads, w::kMmaSmemBytes, stream>>>(
        static_cast<const rt::mma::bf16*>(q),
        static_cast<const rt::mma::bf16*>(k), lengths, Skv,
        static_cast<rt::mma::bf16*>(out), part, counter, Hq, Hkv, Sq, D, Dv,
        causal, scale, n_chunks, vec);
  } else {
    const bool vec = D % 4 == 0 && align % 16 == 0;
    cudaFuncSetAttribute(masked_wide_fma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         w::kFmaSmemBytes);
    masked_wide_fma_kernel<<<grid, w::kThreads, w::kFmaSmemBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), lengths,
        Skv, static_cast<float*>(out), part, counter, Hq, Hkv, Sq, D, Dv,
        causal, scale, n_chunks, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_attention_masked_launch(
    const void* q, const void* k, const void* v, const int* lengths, void* out,
    float* part, int* counter, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    int Dv, int causal, int n_chunks, float scale, int dtype, void* stream) {
  if (D > rt::kMaxD || Dv > rt::kMaxD)
    return wide_launch(dtype, q, k, v, lengths, out, part, counter, B, Hq,
                       Hkv, Sq, Skv, D, Dv, causal, n_chunks, scale,
                       static_cast<cudaStream_t>(stream));
  return run_masked<rt::DenseKV>(dtype, q, k, v, lengths,
                                 rt::KVSource{nullptr, 0, 0, Skv}, out, part,
                                 counter, B, Hq, Hkv, Sq, D, Dv, causal,
                                 n_chunks, scale, stream);
}

// bf16 runs the tensor-core body, fp32 the FMA body (masked_attention_rows
// without lengths): a dispatch on the dtype, stated in the notes above.
// Widths past D 192 or Dv 128 are refused.
extern "C" int fused_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,
    int q_offset, float scale, int dtype, void* stream) {
  if (D < 1 || Dv < 1 || D > rt::kTrainMaxD || Dv > rt::kTrainMaxDv)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return fwd::launch(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, D, Dv, causal,
                       q_offset, scale, s);
  const rt::KVSource src{nullptr, 0, 0, Skv};
  if (D > rt::kMaxD)
    return fma_launch<rt::DenseKV, rt::kTrainMaxD>(
        dtype, q, k, v, nullptr, src, out, lse, B, Hq, Hkv, Sq, D, Dv, causal,
        q_offset, scale, s);
  return fma_launch<rt::DenseKV>(dtype, q, k, v, nullptr, src, out, lse, B,
                                 Hq, Hkv, Sq, D, Dv, causal, q_offset, scale,
                                 s);
}

extern "C" int fused_attention_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* lengths,
    const int* block_tables, void* out, float* part, int* counter, int B,
    int Hq, int Hkv, int Sq, int max_pages, int page, int D, int Dv,
    int causal, int n_chunks, float scale, int dtype, void* stream) {
  rt::KVSource src;
  if (!rt::paged_source(block_tables, max_pages, page, &src))
    return (int)cudaErrorInvalidValue;
  return run_masked<rt::PagedKV>(dtype, q, k_pool, v_pool, lengths, src, out,
                                 part, counter, B, Hq, Hkv, Sq, D, Dv, causal,
                                 n_chunks, scale, stream);
}
