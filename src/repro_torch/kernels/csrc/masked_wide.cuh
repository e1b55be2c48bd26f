// The wide body of fused_attention_masked: heads up to kMaxD = 576 keys
// wide and kMaxDv = 512 values wide, the absorbed form of Multi-head
// Latent Attention (deepseek-v3: 128 query heads over one latent "KV
// head" of kv_lora 512 + rope 64, V the first 512 columns of the same
// latent rows).  The narrow bodies (masked_mma.cuh, common.cuh's
// masked_attention_rows, fused_attention.cu's split_kernel) stage tiles
// sized by kMaxD = 128 and hold a 16 x Dv output per warp in registers;
// at 576 / 512 neither fits, so this is a body of its own and kMaxD,
// which sizes #2-#6 too, stays 128.
//
// What the width changes, and what the design does about it:
// * V shares K's storage.  The kernel reads no V array: its P.V takes
//   V from the first Dv columns of the K tile it has already staged, so
//   a latent row crosses from device memory once (the wrapper accepts
//   exactly such a v, a column prefix of k).
// * Shared memory.  A 64-row bf16 Q tile at 576 is 73.7 KB and each
//   bf16 K tile of 32 keys 37.4 KB (rows padded by 16 bytes, so the 8
//   rows one ldmatrix reads fall in distinct banks): Q plus a double
//   buffered K ring plus the score partials below is 178 KB, one block
//   of 16 warps per SM.  fp32 keeps 16 rows a block: Q 36.9 KB, two K
//   tiles of 32 keys 148.5 KB.
// * Registers.  A warp's 16 rows x 512 fp32 output columns would be
//   256 accumulators a thread.  So a bf16 block's 16 warps are 4 row
//   groups x 4 column quarters: warp (g, c) owns rows 16 g.. and output
//   columns 128 c.. (64 accumulators a thread, as the narrow body), and
//   computes Q.K^T over its quarter of the key width only (9 of the 36
//   k-steps at 576); the four quarter-partials of a row group's 16 x 32
//   scores meet in shared memory and each of its warps sums them in the
//   same order (quarter 0 to 3), so all four hold the same scores and
//   run the same online softmax: the scores are computed once, the
//   softmax four times (cheap), and nothing is recomputed at the
//   width.  fp32 gives a thread one (row, key) score, a warp one row's
//   softmax over the tile's 32 keys, and a thread one output column of
//   every row (16 accumulators).
// * Grid.  At decode (B = 4, Sq = 1) the 128 query heads of a batch
//   row are 2 tiles of 64 rows: 8 blocks for 132 SMs.  Where the
//   one-pass grid has fewer blocks than the card has SMs, the wrapper
//   (kernels/fused_attention.py wide_chunks) cuts each row's valid
//   prefix into n_chunks chunks of whole 32-key tiles, one block per
//   (row tile, chunk); each chunk writes its fp32 partial (m, l,
//   unnormalized o) per row and the block that draws the last ticket of
//   its row tile merges them in chunk order, as the narrow split body
//   does, so the result is deterministic and one launch suffices.
//
// Masking as the narrow bodies: a row sees column c iff c < min(len,
// anchor + 1), the anchor len - Sq + pos under causal (the TPU kernel's
// end-anchored triangle), else len - 1; p is rounded to the value dtype
// before P.V and l sums it unrounded; a row that sees no column has l =
// 0, counted as 1, and emits zeros.  K rows at or past len are zero
// filled, never read.
//
// Bound on an H100 (bf16): decode at B = 4, C = 2048 reads 9.4 MB of
// latent against 2.3 GFLOP, about 3 us from the bytes; a 1024-row
// prefill chunk at C = 2048 does about 0.44 TFLOP, 0.44 ms from the
// operations.
#pragma once

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace rt {
namespace wide {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 576;
constexpr int kMaxDv = 512;
constexpr int kBk = 32;  // keys per tile

// bf16: rows padded by 8 elements (16 bytes): 1168-byte rows, 16 bytes
// apart modulo 128, so ldmatrix is free of bank conflicts
constexpr int kS = kMaxD + 8;
constexpr int kMmaRows = 64;
constexpr int kQElems = kMmaRows * kS;
constexpr int kKElems = kBk * kS;
constexpr int kPartFloats = kWarps * 16 * kBk;  // score partials
constexpr int kMmaSmemBytes = (kQElems + 2 * kKElems) * 2 + kPartFloats * 4;

// fp32: rows padded by 4 floats (16 bytes): float4 reads of 8 keys'
// rows by a quarter warp fall in distinct banks
constexpr int kSf = kMaxD + 4;
constexpr int kFmaRows = 16;
constexpr int kFmaSmemBytes =
    (kFmaRows * kMaxD + 2 * kBk * kSf + kFmaRows * kBk) * 4;

static_assert(kThreads >= kMaxDv, "merge and fp32 P.V: a thread per column");
static_assert(kFmaRows * kBk == kThreads, "fp32 scores: a thread each");

// What a block owns: rows [r0, r0 + n) of the group * Sq rows of one
// (batch row b, KV head kvh), and tiles [t0, t1) of chunk c.
struct Block {
  int b, kvh, rt, c, n_rt, r0, n, len, t0, t1, nc;
};

// The block's rows and its tiles.  Threads [0, kRows) write the rows'
// RowInfo to rows[0, kRows); here out_off is the row's index (b * Hq +
// h) * Sq + pos in the (B, Hq, Sq) rows, -1 for a padding row.  The
// prefix's nt tiles are cut into chunks of ceil(nt / n_chunks) (nc of
// them non-empty); this chunk's end at the block's deepest row limit
// (kv_end).  Two __syncthreads inside.
template <int kRows>
__device__ __forceinline__ Block plan_block(const int* __restrict__ lengths,
                                            int skv, RowInfo* rows,
                                            int* kv_end_s, int Hq, int Hkv,
                                            int Sq, int causal,
                                            int n_chunks) {
  Block k;
  const int group = Hq / Hkv;
  k.b = blockIdx.y / Hkv;
  k.kvh = blockIdx.y - k.b * Hkv;
  k.n_rt = gridDim.x / n_chunks;
  k.rt = blockIdx.x / n_chunks;
  k.c = blockIdx.x - k.rt * n_chunks;
  k.r0 = k.rt * kRows;
  k.n = min(kRows, group * Sq - k.r0);
  k.len = max(0, min(lengths[k.b], skv));
  if (threadIdx.x == 0) *kv_end_s = 0;
  __syncthreads();
  if (threadIdx.x < kRows) {
    RowInfo info{-1, -1};
    if ((int)threadIdx.x < k.n) {
      const int r = k.r0 + threadIdx.x, g = r / Sq, pos = r - g * Sq;
      info.out_off = ((int64_t)k.b * Hq + k.kvh * group + g) * Sq + pos;
      info.anchor = causal ? k.len - Sq + pos : k.len - 1;
      atomicMax(kv_end_s, max(0, min(k.len, info.anchor + 1)));
    }
    rows[threadIdx.x] = info;
  }
  __syncthreads();
  const int nt = (k.len + kBk - 1) / kBk;
  const int tpc = (nt + n_chunks - 1) / n_chunks;
  k.nc = tpc > 0 ? (nt + tpc - 1) / tpc : 0;
  k.t0 = k.c * tpc;
  k.t1 = min(min(nt, k.t0 + tpc), (*kv_end_s + kBk - 1) / kBk);
  return k;
}

// A row's limit: the columns [0, limit) it sees; 0 for a padding row.
__device__ __forceinline__ int row_limit(const RowInfo& r, int len) {
  return r.out_off < 0 ? 0 : max(0, min(len, r.anchor + 1));
}

// Keys [j0, j0 + nk) of (b, kvh)'s K plane into a tile of stride kStr
// elements, columns [0, wp), zeros past nk and past D.  vec: 16-byte
// copies (cp.async; the caller commits and waits), else plain.
template <typename T, int kStr>
__device__ __forceinline__ void load_k(T* dst, const T* __restrict__ plane,
                                       int j0, int nk, int D, int wp,
                                       bool vec) {
  constexpr int kE = 16 / (int)sizeof(T);
  if (vec) {
    const int cpr = wp / kE;
    for (int i = threadIdx.x; i < kBk * cpr; i += kThreads) {
      const int j = i / cpr, cc = i - j * cpr;
      const bool ok = j < nk && cc * kE < D;
      mma::cp_async16(dst + j * kStr + cc * kE,
                      ok ? plane + (int64_t)(j0 + j) * D + cc * kE : plane,
                      ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBk * wp; i += kThreads) {
      const int j = i / wp, d = i - j * wp;
      dst[j * kStr + d] = j < nk && d < D ? plane[(int64_t)(j0 + j) * D + d]
                                          : from_f<T>(0.f);
    }
  }
}

// The chunked epilogue of both bodies, after each thread has stored its
// partials: every block of the (row tile, b, kvh) takes a ticket; the one
// that draws the last merges the nc chunks' partials of its n rows in
// chunk order into out (B, Hq, Sq, Dv) and resets the ticket.  part: o at
// (row * n_chunks + c) * Dv, then (m, l) pairs at rows_total * n_chunks *
// Dv + (row * n_chunks + c) * 2.  scratch: idle shared memory for the
// (kRows, nc) merge weights and the kRows sums.
template <typename T, int kRows>
__device__ __forceinline__ void merge(const Block& k, const RowInfo* rows,
                                      const float* __restrict__ part,
                                      int* __restrict__ counter,
                                      T* __restrict__ out, float* scratch,
                                      bool* last_s, int64_t rows_total,
                                      int n_chunks, int Dv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* ticket = counter + (int64_t)blockIdx.y * k.n_rt + k.rt;
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(ticket, 1) == n_chunks - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  const float* part_ml = part + rows_total * n_chunks * Dv;
  const int nc = k.nc;
  float* w_s = scratch;            // (kRows, nc)
  float* l_s = w_s + kRows * nc;   // (kRows,)
  for (int r = warp; r < k.n; r += kWarps) {
    const float2* ml =
        reinterpret_cast<const float2*>(part_ml) + rows[r].out_off * n_chunks;
    float mx = kNegInf;
    for (int cc = lane; cc < nc; cc += 32) mx = fmaxf(mx, __ldcg(ml + cc).x);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int cc = lane; cc < nc; cc += 32) {
      const float2 v = __ldcg(ml + cc);
      const float w = expf(v.x - mx);
      w_s[r * nc + cc] = w;
      lsum = fmaf(v.y, w, lsum);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) l_s[r] = lsum == 0.f ? 1.f : lsum;
  }
  __syncthreads();
  if (tid < Dv) {
    for (int r = 0; r < k.n; ++r) {
      const float* po = part + rows[r].out_off * n_chunks * Dv + tid;
      float o = 0.f;
      for (int cc = 0; cc < nc; ++cc)
        o = fmaf(__ldcg(po + (int64_t)cc * Dv), w_s[r * nc + cc], o);
      out[rows[r].out_off * Dv + tid] = from_f<T>(o / l_s[r]);
    }
  }
  if (tid == 0) *ticket = 0;  // the counters are reusable as they stand
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, 64 rows, 16 warps of (row group, column quarter)
// ---------------------------------------------------------------------------

using mma::bf16;

__device__ __forceinline__ void mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const int* __restrict__ lengths, int skv, bf16* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counter, int Hq, int Hkv,
    int Sq, int D, int Dv, int causal, float scale, int n_chunks, bool vec) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kQElems;  // two stages
  float* sp = reinterpret_cast<float*>(k_s + 2 * kKElems);
  __shared__ RowInfo rows[kMmaRows];
  __shared__ int kv_end_s;
  __shared__ bool last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, cq = warp >> 2;  // row group, column quarter
  const int group = Hq / Hkv;

  const Block blk = plan_block<kMmaRows>(lengths, skv, rows, &kv_end_s, Hq,
                                         Hkv, Sq, causal, n_chunks);
  const int Dp = (D + 15) & ~15, Dvp = (Dv + 15) & ~15;
  const bf16* plane = k + ((int64_t)blk.b * Hkv + blk.kvh) * skv * D;

  // the first K tile flies while Q is staged: row j of the block is query
  // head kvh * group + (r0 + j) / Sq at position (r0 + j) % Sq
  if (blk.t0 < blk.t1)
    load_k<bf16, kS>(k_s, plane, blk.t0 * kBk,
                     min(kBk, blk.len - blk.t0 * kBk), D, Dp, vec);
  const int cpr = Dp >> 3;
  for (int i = tid; i < kMmaRows * cpr; i += kThreads) {
    const int j = i / cpr, cc = i - j * cpr;
    const bool ok = j < blk.n && cc * 8 < D;
    int64_t row = 0;
    if (ok) {
      const int r = blk.r0 + j, g = r / Sq;
      row = ((int64_t)blk.b * Hq + blk.kvh * group + g) * Sq + (r - g * Sq);
    }
    if (vec) {
      cp_async16(q_s + j * kS + cc * 8, ok ? q + row * D + cc * 8 : q, ok);
    } else {
      for (int e = 0; e < 8; ++e)
        q_s[j * kS + cc * 8 + e] =
            ok && cc * 8 + e < D ? q[row * D + cc * 8 + e] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();

  // this lane's rows: 16 rg + gid and + 8
  int64_t off[2];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const RowInfo r = rows[rg * 16 + gid + 8 * i];
    off[i] = r.out_off;
    lim[i] = row_limit(r, blk.len);
  }
  const int reach = __reduce_max_sync(0xffffffffu, max(lim[0], lim[1]));
  const int full = __reduce_min_sync(
      0xffffffffu, min(off[0] < 0 ? INT_MAX : lim[0],
                       off[1] < 0 ? INT_MAX : lim[1]));
  // this warp's k-steps of Q.K^T: a quarter of the key width
  const int ks = Dp >> 4, per = (ks + 3) >> 2;
  const int kk0 = cq * per, kk1 = min(ks, kk0 + per);
  const int col0 = cq * 128;  // this warp's output columns

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = blk.t0; t < blk.t1; ++t) {
    const int j0 = t * kBk, buf = (t - blk.t0) & 1;
    cp_async_wait<0>();  // tile t (and Q) have landed
    __syncthreads();     // ... for every thread; tile t - 1's stage and
                         // sp are free again
    if (t + 1 < blk.t1) {
      load_k<bf16, kS>(k_s + (buf ^ 1) * kKElems, plane, j0 + kBk,
                       min(kBk, blk.len - j0 - kBk), D, Dp, vec);
      cp_async_commit();
    }
    const bf16* ks_ = k_s + buf * kKElems;
    const bool live = j0 < reach;

    // this warp's quarter of S = Q.K^T: n-tile n holds keys j0 + 8n +
    // 2tig, +1 of rows gid, gid + 8
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (live) {
      for (int kk = kk0; kk < kk1; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_s + rg * 16 * kS + kk * 16 + mma::a_off<kS>(lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf,
                  ks_ + np * 16 * kS + kk * 16 + mma::bn_off<kS>(lane));
          mma_bf16(s[2 * np], a, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
    float* mine = sp + warp * (16 * kBk);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = s[n][e];
    __syncthreads();
    if (live) {
      // the row group's four quarters, summed in quarter order
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = 0.f;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            x += sp[(rg + 4 * qq) * (16 * kBk) + (n * 4 + e) * 32 + lane];
          s[n][e] = x;
        }
      // scale; mask a tile only where it reaches past a live row's limit
      const bool edge = j0 + kBk > full;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (edge && j0 + 8 * n + 2 * tig + (e & 1) >= lim[e >> 1])
            x = -INFINITY;
          s[n][e] = x;
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = expf(m[i] - mx);
        m[i] = mx;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
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
      // O += P.V over this warp's 128 columns, V = the K tile's first Dv
      // columns, p rounded to bf16 in the A fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (col0 + np * 16 >= Dvp) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, ks_ + kk * 16 * kS + col0 + np * 16 +
                            mma::bk_off<kS>(lane));
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (n_chunks == 1) {
    // one pass: a row that saw no column has l = 0, counted as 1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (off[i] < 0) continue;
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      bf16* o = out + off[i] * Dv;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = col0 + 8 * n + 2 * tig;
        if (col < Dv)
          *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
              acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
      }
    }
    return;
  }
  // partials of a chunk that has tiles in the prefix (c < nc), even if
  // the rows' limits left it none to walk
  const int64_t rows_total = (int64_t)gridDim.y / Hkv * Hq * Sq;
  if (blk.c < blk.nc) {
    float* part_ml = part + rows_total * n_chunks * Dv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (off[i] < 0) continue;
      float* po = part + (off[i] * n_chunks + blk.c) * Dv;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = col0 + 8 * n + 2 * tig;
        if (col < Dv)
          *reinterpret_cast<float2*>(po + col) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      if (cq == 0 && tig == 0)
        reinterpret_cast<float2*>(part_ml)[off[i] * n_chunks + blk.c] =
            make_float2(m[i], l[i]);
    }
  }
  merge<bf16, kMmaRows>(blk, rows, part, counter, out,
                        reinterpret_cast<float*>(smem_raw), &last_s,
                        rows_total, n_chunks, Dv);
}

// ---------------------------------------------------------------------------
// fp32: FMAs, 16 rows: a thread per (row, key) score, a warp per row's
// softmax, a thread per output column
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fma_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const int* __restrict__ lengths, int skv, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counter, int Hq, int Hkv,
    int Sq, int D, int Dv, int causal, float scale, int n_chunks, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (16, kMaxD)
  float* k_s = q_s + kFmaRows * kMaxD;               // two stages
  float* p_s = k_s + 2 * kBk * kSf;                  // (16, kBk)
  __shared__ RowInfo rows[kFmaRows];
  __shared__ float alpha_s[kFmaRows], l_s[kFmaRows];
  __shared__ int kv_end_s;
  __shared__ bool last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = Hq / Hkv;

  const Block blk = plan_block<kFmaRows>(lengths, skv, rows, &kv_end_s, Hq,
                                         Hkv, Sq, causal, n_chunks);
  const int Dp = (D + 3) & ~3;
  const float* plane = k + ((int64_t)blk.b * Hkv + blk.kvh) * skv * D;
  if (blk.t0 < blk.t1)
    load_k<float, kSf>(k_s, plane, blk.t0 * kBk,
                       min(kBk, blk.len - blk.t0 * kBk), D, Dp, vec);
  mma::cp_async_commit();
  for (int i = tid; i < kFmaRows * Dp; i += kThreads) {
    const int j = i / Dp, d = i - j * Dp;
    float val = 0.f;
    if (j < blk.n && d < D) {
      const int r = blk.r0 + j, g = r / Sq;
      val = q[(((int64_t)blk.b * Hq + blk.kvh * group + g) * Sq +
               (r - g * Sq)) * D + d];
    }
    q_s[j * kMaxD + d] = val;
  }

  // warp w owns row w's softmax: its limit; thread tid owns column tid
  const int my_lim = row_limit(rows[warp], blk.len);
  float m = kNegInf, l = 0.f, acc[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;

  for (int t = blk.t0; t < blk.t1; ++t) {
    const int j0 = t * kBk, buf = (t - blk.t0) & 1;
    const int nk = min(kBk, blk.len - j0);
    mma::cp_async_wait<0>();  // tile t has landed
    __syncthreads();  // ... for every thread; tile t - 1 is consumed
    if (t + 1 < blk.t1) {
      load_k<float, kSf>(k_s + (buf ^ 1) * kBk * kSf, plane, j0 + kBk,
                         min(kBk, blk.len - j0 - kBk), D, Dp, vec);
      mma::cp_async_commit();
    }
    const float* ks_ = k_s + buf * kBk * kSf;

    // score of (row warp, key lane): 16-byte reads of the key's row
    float s = 0.f;
    {
      const float* kr = ks_ + lane * kSf;
      const float* qr = q_s + warp * kMaxD;
      for (int d = 0; d < Dp; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
    }
    const bool ok = lane < nk && j0 + lane < my_lim;
    s = ok ? s * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
    p_s[warp * kBk + lane] = p;
    if (lane == 0) alpha_s[warp] = alpha;
    __syncthreads();

    // P.V: column tid of every row, V = the K tile's first Dv columns
    if (tid < Dv) {
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) acc[r] *= alpha_s[r];
      for (int j = 0; j < nk; ++j) {
        const float v = ks_[j * kSf + tid];
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r)
          acc[r] = fmaf(p_s[r * kBk + j], v, acc[r]);
      }
    }
  }
  mma::cp_async_wait<0>();
  if (lane == 0) l_s[warp] = l;
  __syncthreads();

  if (n_chunks == 1) {
    if (tid < Dv)
      for (int r = 0; r < blk.n; ++r) {
        const float l_safe = l_s[r] == 0.f ? 1.f : l_s[r];
        out[rows[r].out_off * Dv + tid] = acc[r] / l_safe;
      }
    return;
  }
  const int64_t rows_total = (int64_t)gridDim.y / Hkv * Hq * Sq;
  if (blk.c < blk.nc) {
    if (tid < Dv)
      for (int r = 0; r < blk.n; ++r)
        part[(rows[r].out_off * n_chunks + blk.c) * Dv + tid] = acc[r];
    if (lane == 0 && warp < blk.n)
      reinterpret_cast<float2*>(part + rows_total * n_chunks * Dv)
          [rows[warp].out_off * n_chunks + blk.c] = make_float2(m, l);
  }
  __syncthreads();  // every thread done with the K tiles the merge reuses
  merge<float, kFmaRows>(blk, rows, part, counter, out, k_s, &last_s,
                         rows_total, n_chunks, Dv);
}

}  // namespace wide
}  // namespace rt
