// ssd_scan for Hopper (sm_90a): the Mamba-2 chunked SSD scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py ssd_scan
// (pallas_call at :102, body _ssd_kernel :34).  Per (batch row, head)
// and chunk of `chunk` positions, in fp32:
//   cum_t  = sum_{s<=t} a dt_s;  total = cum_{chunk-1}
//   L[t,u] = exp(cum_t - cum_u) dt_u for u <= t, else 0 (the exponent is
//            zeroed above the diagonal before exp: it is positive there)
//   y_t    = sum_u (c_t . b_u) L[t,u] x_u + exp(cum_t) (c_t . h) + d x_t
//   h      = exp(total) h + sum_u x_u (outer) b_u exp(total - cum_u) dt_u
// The state h starts at h0 (zeros when h0 is null, which is exactly the
// TPU kernel) and the final state is written to hout, fp32.  Where the
// TPU kernel and the JAX package's chunked_ssd round differently, this
// follows chunked_ssd (the function the JAX serve path computes): a, a dt
// and the decay stay fp32, and d x is added in fp32 before the one cast
// of y to x's dtype.  Head h reads group h / (H / G) of b and c.
//
// Bound on an H100 at the cache-free forward's shapes (mamba2-130m, B=4,
// L=2048, H=24, P=64, G=1, S=128, bf16): x and y 25.2 MB each, b and c
// 4.2 MB, dt 0.4 MB, the final state 3.1 MB: 58.065 MB, 0.0173 ms at
// 3.35 TB/s; the causal products are 11.312 GFLOP, 0.0114 ms at the
// bf16 tensor-core peak, so the bytes bound it.  At the serve path's
// prefill chunk (B=1, L=188, with h0) it is 2.8 MB, 0.0008 ms.
//
// What held the first body back (the fp32 FMA body below, which fp32
// inputs and shapes off the tensor-core grid still run): one block per
// (row, head) walking the chunks in series (96 blocks at the cache-free
// shape, 24 at the serve chunk, on 132 SMs, one block an SM for its
// 216 KB of shared memory); every product as fp32 FMAs; c b^T recomputed
// for every head of a group (mamba2-130m has one group for 24 heads); a
// one-thread cumsum.  It ran at 137x its bound.
//
// Design: the bf16 body (namespace ssd) runs the chunks in parallel.
// The state recurrence is linear, so each work item (row, chunk, group,
// tile of ht heads of the group, slice of pw of the P columns), one block
// of 16 warps, does the part that needs no incoming state first and then
// waits for it:
//  1. Items are drawn from a ticket in chunk order (chunk-major), so the
//     item that publishes chunk j-1's state has always started before
//     one of chunk j waits on it: no deadlock whatever order the blocks
//     are scheduled in.  kernels/ssd_scan.py ssd_plan mirrors the
//     partition and picks ht and pw from the shapes and the SM count
//     (12-head tiles, 128 items, at the cache-free shape; one head and
//     32 columns, 96 items, at the serve chunk).
//  2. c b^T is computed once per item for all of its heads on the tensor
//     cores (rows 16 rt.., rt = w % 8, the causal column blocks split by
//     parity between warps w and w + 8), kept fp32 in shared memory.
//  3. Per head: the chunk's own state s = X^T (B o w) on the tensor cores
//     (warp w: S columns 16 rt.. of P tiles w / 8, w / 8 + 2); then thread
//     0 waits (ld.acquire) for the flag of chunk j-1's state of this (row,
//     head, slice), every thread loads its units of h_{j-1} (all loads in
//     flight at once), forms h_j = exp(total) h_{j-1} + s, stores it to a
//     slot (two a chain in the workspace, in fragment order so that each
//     warp's access is 256 contiguous bytes; the last chunk writes hout)
//     and keeps h_{j-1} in shared memory for C.h; after a barrier thread
//     0 alone fences and releases the flag (as a grid barrier does), and
//     the other warps go on to y = (C B^T o L) X + exp(cum) (C h_{j-1}^T)
//     + d x on the tensor cores (warp w: rows 16 rt.., half w / 8 of the
//     slice's columns).  The chain from one chunk to the next is thus one
//     flag, one L2 round trip of the state, an elementwise FMA and a
//     fence; the own-state product runs before the wait, off that path.
//     Below the diagonal block the scores take exp(cum_t - cum_u) as
//     exp(cum_t - cum_e) exp(cum_e - cum_u) (e: the column block's last
//     position; both factors <= 1), two exps a block and thread.
//  4. The cumsum is a warp-shuffle scan (four positions a lane, then a
//     Hillis-Steele scan of the lane sums: a fixed order), computed by
//     warp 0, whose y rows are fewest, for the next head at the end of
//     each head; the next head's x tile loads by cp.async meanwhile.  x, b
//     and c go by 16-byte cp.async where the views' strides allow, by
//     plain loads otherwise.
//  5. The flags hold the launch's epoch, which the wrapper counts up per
//     workspace, and the ticket only counts up (an item is the ticket
//     less its value when the launch began, which the wrapper counts
//     too), so nothing is cleared between launches; one workspace is kept
//     per (device, stream), grown to the largest plan it has served.
//  Every sum has a fixed order: y and the state are bitwise repeatable.
//  Measured on an H100 (time_ssd_scan.py's trace): the cache-free shape
//  spends about 9.5 us a head of a 12-head item and 2.5 us a hop of its
//  16-chunk chain, the sum of ht heads and nj - 1 hops being the
//  pipeline's length.
//  Cast points (mma.sync m16n8k16, bf16 in, fp32 accumulate), chosen by
//  a measurement on the card against the plain version per row of y and
//  of the state: x, b and c are bf16 already; B o w (w = exp(total -
//  cum_u) dt_u) is rounded to bf16 for X^T (B o w); the masked scores
//  (C B^T o L) are rounded to bf16 before the product with X, as the
//  attention kernels round p before P.V, except on the diagonal 16 x 16
//  block, and h_{j-1} for C.h, which both go as a bf16 pair hi + lo (two
//  products, about 16 bits).  With one bf16 there, rows of y that cancel
//  to near zero (d x against c_t.b_t dt_t x_t where a steep decay leaves
//  only the diagonal term) missed 2e-2 of the row's largest |y| many
//  times over at chip_smoke.py's inputs, and still missed it with only
//  the scores' diagonal taken as a pair; with both pairs those rows stay
//  near one bf16 rounding of y.  The carried state and every accumulator
//  stay fp32.
#include "common.cuh"
#include "mma.cuh"

// The first body, one block per (batch row, head) walking the chunks, every
// product an fp32 FMA: fp32 inputs, and bf16 shapes off the tensor-core
// grid (chunk, S or a P slice not a multiple of 16).
namespace serial {

constexpr int kThreadsS = 256;
constexpr int kMaxP = 64;
constexpr int kMaxS = 128;
constexpr int kMaxChunk = 128;
constexpr int kRowBlock = 32;  // rows of (c b^T) o L held at once

// Shared memory of one block, in floats (kernels/ssd_scan.py smem_bytes).
inline int smem_floats(int chunk, int P, int S) {
  return chunk * P + 2 * chunk * (S + 1) + P * (S + 1) +
         kRowBlock * (chunk + 1) + 3 * chunk;
}

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreadsS)
    ssd_scan_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ d,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hout, int L, int H, int P, int G,
                    int S, int chunk, long long x_sb, long long x_sl,
                    long long dt_sb, long long dt_sl, long long b_sb,
                    long long b_sl, long long c_sb, long long c_sl) {
  extern __shared__ float smem[];
  const int SP = S + 1, CP = chunk + 1;
  float* x_s = smem;                     // (chunk, P)
  float* b_s = x_s + chunk * P;          // (chunk, S+1)
  float* c_s = b_s + chunk * SP;         // (chunk, S+1)
  float* h_s = c_s + chunk * SP;         // (P, S+1): the carried state
  float* gl_s = h_s + P * SP;            // (kRowBlock, chunk+1)
  float* cum_s = gl_s + kRowBlock * CP;  // (chunk,)
  float* dt_s = cum_s + chunk;           // (chunk,)
  float* w_s = dt_s + chunk;             // (chunk,)

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H;
  const int gi = hi / (H / G);
  const int tid = threadIdx.x;
  const float ah = a[hi];
  const float dh = d ? d[hi] : 0.f;

  const T* xb = x + bi * x_sb + (long long)hi * P;
  const TD* dtb = dt + bi * dt_sb + hi;
  const T* bb = bm + bi * b_sb + (long long)gi * S;
  const T* cb = cm + bi * c_sb + (long long)gi * S;
  T* yb = y + ((long long)bi * L * H + hi) * P;  // y is packed (B, L, H, P)
  const long long y_sl = (long long)H * P;
  const long long hoff = (long long)bh * P * S;

  for (int i = tid; i < P * S; i += kThreadsS)
    h_s[(i / S) * SP + i % S] = h0 ? h0[hoff + i] : 0.f;

  const int nj = (L + chunk - 1) / chunk;
  for (int j = 0; j < nj; ++j) {
    const int l0 = j * chunk;
    const int n = min(chunk, L - l0);  // valid rows of this chunk
    __syncthreads();  // the previous chunk is done with the tiles
    for (int i = tid; i < chunk * P; i += kThreadsS) {
      const int t = i / P, p = i % P;
      x_s[i] = t < n ? rt::to_f(xb[(l0 + t) * x_sl + p]) : 0.f;
    }
    for (int i = tid; i < chunk * S; i += kThreadsS) {
      const int t = i / S, s = i % S;
      const bool ok = t < n;
      b_s[t * SP + s] = ok ? rt::to_f(bb[(l0 + t) * b_sl + s]) : 0.f;
      c_s[t * SP + s] = ok ? rt::to_f(cb[(l0 + t) * c_sl + s]) : 0.f;
    }
    for (int t = tid; t < chunk; t += kThreadsS)
      dt_s[t] = t < n ? rt::to_f(dtb[(l0 + t) * dt_sl]) : 0.f;
    __syncthreads();
    if (tid == 0) {  // the chunk's cumulative a dt, in position order
      float acc = 0.f;
      for (int t = 0; t < chunk; ++t) {
        acc += dt_s[t] * ah;
        cum_s[t] = acc;
      }
    }
    __syncthreads();
    const float total = cum_s[chunk - 1];
    for (int t = tid; t < chunk; t += kThreadsS)
      w_s[t] = expf(total - cum_s[t]) * dt_s[t];

    for (int r0 = 0; r0 < n; r0 += kRowBlock) {
      const int ucols = min(r0 + kRowBlock, n);  // u <= t < n
      {
        // (c b^T) o L for rows r0 + ty*4 + i, columns tx + 32 jj
        const int ty = tid >> 5, tx = tid & 31;
        const int jn = (ucols + 31) / 32;
        float acc[4][4] = {};
        for (int s = 0; s < S; ++s) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = r0 + ty * 4 + i;
            cv[i] = t < n ? c_s[t * SP + s] : 0.f;
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int u = tx + 32 * jj;
            bv[jj] = (jj < jn && u < ucols) ? b_s[u * SP + s] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] += cv[i] * bv[jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tr = ty * 4 + i, t = r0 + tr;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int u = tx + 32 * jj;
            if (u >= ucols) continue;
            float v = 0.f;
            if (u <= t && t < n)  // masked before exp
              v = acc[i][jj] * expf(cum_s[t] - cum_s[u]) * dt_s[u];
            gl_s[tr * CP + u] = v;
          }
        }
      }
      __syncthreads();
      {
        // y for rows r0 + ty*2 + i, p = tx + 16 k
        const int ty = tid >> 4, tx = tid & 15;
        float yi[2][4] = {}, ye[2][4] = {};
        for (int u = 0; u < ucols; ++u) {
          const float g0 = gl_s[(ty * 2) * CP + u];
          const float g1 = gl_s[(ty * 2 + 1) * CP + u];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            const float xv = p < P ? x_s[u * P + p] : 0.f;
            yi[0][k] += g0 * xv;
            yi[1][k] += g1 * xv;
          }
        }
        const int t0 = r0 + ty * 2;
        for (int s = 0; s < S; ++s) {
          const float c0 = t0 < n ? c_s[t0 * SP + s] : 0.f;
          const float c1 = t0 + 1 < n ? c_s[(t0 + 1) * SP + s] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            const float hv = p < P ? h_s[p * SP + s] : 0.f;
            ye[0][k] += c0 * hv;
            ye[1][k] += c1 * hv;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + i;
          if (t >= n) continue;
          const float e = expf(cum_s[t]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            if (p >= P) continue;
            const float v = yi[i][k] + e * ye[i][k] + dh * x_s[t * P + p];
            yb[(l0 + t) * y_sl + p] = rt::from_f<T>(v);
          }
        }
      }
      __syncthreads();  // the next row block rewrites gl_s; h_s is read
    }
    {
      // h = exp(total) h + sum_u x_u (outer) (b_u w_u), p = ty + 8 i,
      // s = tx + 32 jj; rows past n carry dt = 0, so w = 0 there
      const int ty = tid >> 5, tx = tid & 31;
      const float dec = expf(total);
      float acc[8][4] = {};
      for (int u = 0; u < n; ++u) {
        const float wu = w_s[u];
        float bw[4], xv[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int s = tx + 32 * jj;
          bw[jj] = s < S ? b_s[u * SP + s] * wu : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = ty + 8 * i;
          xv[i] = p < P ? x_s[u * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] += xv[i] * bw[jj];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = ty + 8 * i;
        if (p >= P) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int s = tx + 32 * jj;
          if (s < S) h_s[p * SP + s] = h_s[p * SP + s] * dec + acc[i][jj];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * S; i += kThreadsS)
    hout[hoff + i] = h_s[(i / S) * SP + i % S];
}

template <typename T, typename TD>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, const float* d, const float* h0, void* y,
           float* hout, int B, int L, int H, int P, int G, int S, int chunk,
           long long x_sb, long long x_sl, long long dt_sb, long long dt_sl,
           long long b_sb, long long b_sl, long long c_sb, long long c_sl,
           cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T, TD>;
  const int smem = smem_floats(chunk, P, S) * 4;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  kern<<<B * H, kThreadsS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), d, h0,
      static_cast<T*>(y), hout, L, H, P, G, S, chunk, x_sb, x_sl, dt_sb,
      dt_sl, b_sb, b_sl, c_sb, c_sl);
  return (int)cudaGetLastError();
}

}  // namespace serial

namespace ssd {

using rt::mma::bf16;
using rt::mma::cp_async16;
using rt::mma::ldsm_x4;
using rt::mma::ldsm_x4_t;
using rt::mma::mma_bf16;
using rt::mma::pack_bf16;

constexpr int kThreads = 512;
constexpr int kSS = 136;  // row stride (bf16) of the C, B and h tiles: S + 8
constexpr int kXS = 72;   // row stride (bf16) of an x tile: a P slice + 8
constexpr int kMaxSmem = 232448;

struct Args {
  const void* x;
  const void* dt;
  const float* a;
  const bf16* b;
  const bf16* c;
  const float* d;
  const float* h0;
  bf16* y;
  float* hout;
  unsigned long long* ticket;
  unsigned long long* flags;  // (chain, chunk): the epoch that published it
  float* slots;               // (chain, 2, pw, S): h_j in slot j & 1
  unsigned long long epoch;
  unsigned long long ticket_base;  // the ticket's value when this launch began
  long long* trace;  // null, or (n_items, 1 + 5 ht) globaltimer stamps
  long long x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl;
  int B, L, H, P, G, S, chunk, nj, ht, nht, pw, nps, n_items;
  int dt_bf16, vec;
};

// Shared memory of one block (kernels/ssd_scan.py mma_smem_bytes): the C
// and B tiles, two x tiles, h_{j-1} as a bf16 pair (hi, lo), C B^T in
// fp32 (rows padded by 8), dt of the item's heads, cum and w of two
// heads and the scores' column factors f of two heads, the item and two
// chunk totals.
inline int smem_bytes(int chunk, int pw, int ht) {
  return 2 * (2 * chunk * kSS + 2 * chunk * kXS + 2 * pw * kSS) +
         4 * (chunk * (chunk + 8) + ht * chunk + 6 * chunk) + 16;
}

// ldmatrix row offsets for a tile of row stride R (as rt::mma's a_off,
// bn_off and bk_off for kStride): an A fragment from row-major rows; the
// B fragments of two n-tiles from n-major rows (also A^T from k-major
// rows with .trans); those of two n-tiles from k-major rows, transposed.
template <int R>
__device__ __forceinline__ int off_a(int lane) {
  return (lane & 15) * R + (lane >> 4) * 8;
}
template <int R>
__device__ __forceinline__ int off_bn(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * R + ((lane >> 3) & 1) * 8;
}
template <int R>
__device__ __forceinline__ int off_bk(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * R + (lane >> 4) * 8;
}

// Rows [0, rows) of a (rows, width) bf16 plane read through its row
// stride sl into a tile of row stride R; rows at or past `valid` are
// zeros.  vec: 16-byte cp.async copies (the caller commits and waits);
// else plain loads, visible after the caller's next __syncthreads().
template <int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long sl, int valid, int rows,
                                          int width, bool vec) {
  if (vec) {
    const int cpr = width >> 3;
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, k = i - r * cpr;
      const bool ok = r < valid;
      cp_async16(dst + r * R + k * 8, ok ? src + r * sl + k * 8 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, k = i - r * width;
      dst[r * R + k] = r < valid ? src[r * sl + k] : __float2bfloat16(0.f);
    }
  }
}

// (v0, v1) rounded to a bf16 pair, and in `rest` the pair of what that
// rounding left out: hi + rest holds about 16 bits of each value.
__device__ __forceinline__ uint32_t split2(float v0, float v1,
                                           uint32_t& rest) {
  const uint32_t hi = pack_bf16(v0, v1);
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  rest = pack_bf16(v0 - f.x, v1 - f.y);
  return hi;
}

// A fragment register's two bf16 times (w0, w1), rounded to bf16 again.
__device__ __forceinline__ uint32_t scale2(uint32_t v, float w0, float w1) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * w0, f.y * w1);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A traced launch's stamp: the globaltimer (ns) at slot i of the item's
// row of the trace (thread 0; nothing when the trace is null).
__device__ __forceinline__ void stamp(const Args& a, int item, int i) {
  if (a.trace && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.trace[(long long)item * (1 + 5 * a.ht) + i] = t;
  }
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// One work item a block.  PW, SF: the P slice's width (64) and the state
// width (128), or 0 for any slice width and state width up to 64 and
// 128 (multiples of 16) read from the arguments.
template <int PW, int SF>
__device__ __forceinline__ void body(const Args& a) {
  constexpr int kNT = (PW ? PW : 64) / 16;  // n-tiles of a warp's y rows
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int Cn = a.chunk, S = SF ? SF : a.S, pw = PW ? PW : a.pw;
  const int NT = pw / 8, RT = Cn / 16, CBS = Cn + 8;
  bf16* Cs = reinterpret_cast<bf16*>(ssd_smem);
  bf16* Bs = Cs + Cn * kSS;
  bf16* Xs = Bs + Cn * kSS;  // two tiles of Cn x kXS
  bf16* Hs = Xs + 2 * Cn * kXS;  // h_{j-1}: hi, then lo at Hs + pw * kSS
  bf16* Hl = Hs + pw * kSS;
  float* CBs = reinterpret_cast<float*>(Hl + pw * kSS);
  float* dts = CBs + Cn * CBS;  // (ht, Cn)
  float* cum2 = dts + a.ht * Cn;  // cum, w and f of heads k and k + 1
  float* wt2 = cum2 + 2 * Cn;
  float* fc2 = wt2 + 2 * Cn;
  int* item_s = reinterpret_cast<int*>(fc2 + 2 * Cn);
  float* total2 = reinterpret_cast<float*>(item_s + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == 0) *item_s = (int)(atomicAdd(a.ticket, 1ULL) - a.ticket_base);
  __syncthreads();
  int it = *item_s;  // (chunk, row, group, head tile, P slice), chunk-major
  const int item = it;
  stamp(a, item, 0);
  const int ps = it % a.nps;
  it /= a.nps;
  const int tile = it % a.nht;
  it /= a.nht;
  const int g = it % a.G;
  it /= a.G;
  const int bi = it % a.B;
  const int j = it / a.B;
  const int rep = a.H / a.G;
  const int h_lo = g * rep + tile * a.ht;
  const int nh = min(a.ht, (g + 1) * rep - h_lo);
  const int l0 = j * Cn, n = min(Cn, a.L - l0);
  const int p0 = ps * pw;
  const bool vec = a.vec != 0;

  const bf16* xg = static_cast<const bf16*>(a.x) + bi * a.x_sb +
                   (long long)l0 * a.x_sl + p0;
  load_rows<kSS>(Cs, a.c + bi * a.c_sb + (long long)l0 * a.c_sl +
                         (long long)g * S,
                 a.c_sl, n, Cn, S, vec);
  load_rows<kSS>(Bs, a.b + bi * a.b_sb + (long long)l0 * a.b_sl +
                         (long long)g * S,
                 a.b_sl, n, Cn, S, vec);
  load_rows<kXS>(Xs, xg + (long long)h_lo * a.P, a.x_sl, n, Cn, pw, vec);
  rt::mma::cp_async_commit();
  for (int i = tid; i < nh * Cn; i += kThreads) {
    const int t = i / nh, k = i - t * nh;
    float v = 0.f;
    if (t < n) {
      const long long off = bi * a.dt_sb + (long long)(l0 + t) * a.dt_sl +
                            h_lo + k;
      v = a.dt_bf16 ? __bfloat162float(static_cast<const bf16*>(a.dt)[off])
                    : static_cast<const float*>(a.dt)[off];
    }
    dts[k * Cn + t] = v;
  }
  rt::mma::cp_async_wait<0>();
  __syncthreads();

  // C B^T, once for every head of the item: rows 16 rt.. (rt = w % 8),
  // the causal column blocks kk <= rt, warp w taking those of kk's parity
  // w / 8; fp32, into CBs
  const int rt = warp & 7, half = warp >> 3;
  if (rt < RT && rt * 16 < n) {
    const int r0 = rt * 16;
    for (int kk = half; kk <= rt; kk += 2) {
      float acc[2][4] = {};
      for (int ks = 0; ks < S / 16; ++ks) {
        uint32_t af[4], bq[4];
        ldsm_x4(af, Cs + r0 * kSS + ks * 16 + off_a<kSS>(lane));
        ldsm_x4(bq, Bs + kk * 16 * kSS + ks * 16 + off_bn<kSS>(lane));
        mma_bf16(acc[0], af, bq[0], bq[1]);
        mma_bf16(acc[1], af, bq[2], bq[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = CBs + (r0 + gid) * CBS + kk * 16 + i * 8 + 2 * tig;
        *reinterpret_cast<float2*>(row) = make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(row + 8 * CBS) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
  }

  // head k's cumulative a dt (four positions a lane in order, then the
  // lane sums scanned: a fixed order), w, the chunk total and the
  // scores' column factors f_u = exp(cum_e - cum_u) dt_u, e the last
  // position of u's 16-block, into buffer k & 1; warp 0 computes head 0's
  // here and head k + 1's at the end of head k, behind the other warps'
  // heavier y rows
  auto scan = [&](int k) {
    const float* dtk = dts + k * Cn;
    float* cum = cum2 + (k & 1) * Cn;
    float* wt = wt2 + (k & 1) * Cn;
    float* fc = fc2 + (k & 1) * Cn;
    const float ah = a.a[h_lo + k];
    float v[4], run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      run += (t < Cn ? dtk[t] : 0.f) * ah;
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float total = __shfl_sync(0xffffffffu, excl + v[3], (Cn >> 2) - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      if (t < Cn) {
        cum[t] = excl + v[i];
        wt[t] = __expf(total - cum[t]) * dtk[t];
      }
    }
    // the 16-block's last cum sits in lane 4e + 3's v[3]
    const float ce = __shfl_sync(0xffffffffu, excl + v[3], lane | 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane * 4 + i;
      if (t < Cn) fc[t] = __expf(ce - cum[t]) * dtk[t];
    }
    if (lane == 0) total2[k & 1] = total;
  };
  if (warp == 0) scan(0);
  __syncthreads();

  // the chunk's own state and the chain: warp w takes S columns 16 rt..
  // (S <= 128: at most 8 column blocks) of the 16-row P tiles w / 8,
  // w / 8 + 2
  const int MT = pw / 16;
  const bool has_sg = rt < S / 16;
  const int sc0 = rt * 16;
  // y: warp w takes rows 16 rt.. and half of the P slice's n-tiles (all
  // of them, in warps 0-7, when the slice has only two)
  const int nsplit = NT >= 4 ? 2 : 1, ntw = NT / nsplit;
  const int nt0 = half * ntw;
  const bool ywarp = rt < RT && half < nsplit;
  const bool inter = j > 0 || a.h0 != nullptr;
  for (int k = 0; k < nh; ++k) {
    const int hh = h_lo + k;
    const bf16* Xc = Xs + (k & 1) * Cn * kXS;
    const float* dtk = dts + k * Cn;
    stamp(a, item, 1 + 5 * k);
    if (k + 1 < nh) {  // the next head's x tile, while this one computes
      load_rows<kXS>(Xs + ((k + 1) & 1) * Cn * kXS,
                     xg + (long long)(hh + 1) * a.P, a.x_sl, n, Cn, pw, vec);
      rt::mma::cp_async_commit();
    }
    const float* cums = cum2 + (k & 1) * Cn;
    const float* wts = wt2 + (k & 1) * Cn;
    const float* fcs = fc2 + (k & 1) * Cn;

    // s = X^T (B o w): the P tiles' A fragments (x, by ldmatrix.trans),
    // one B fragment of the warp's S columns a step, scaled by w
    float sacc[2][2][4] = {};
    if (has_sg) {
      for (int kk = 0; kk < RT && kk * 16 < n; ++kk) {
        const int u0 = kk * 16 + 2 * tig;
        const float w0 = wts[u0], w1 = wts[u0 + 1];
        const float w8 = wts[u0 + 8], w9 = wts[u0 + 9];
        uint32_t bq[4], af[2][4];
        ldsm_x4_t(bq, Bs + kk * 16 * kSS + sc0 + off_bk<kSS>(lane));
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (half + 2 * m < MT)
            ldsm_x4_t(af[m], Xc + kk * 16 * kXS + (half + 2 * m) * 16 +
                                 off_bn<kXS>(lane));
        // B o w: fragment registers 0 and 2 hold u0 + 2 tig, + 1; 1 and 3
        // those 8 further
        bq[0] = scale2(bq[0], w0, w1);
        bq[1] = scale2(bq[1], w8, w9);
        bq[2] = scale2(bq[2], w0, w1);
        bq[3] = scale2(bq[3], w8, w9);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (half + 2 * m < MT) {
            mma_bf16(sacc[m][0], af[m], bq[0], bq[1]);
            mma_bf16(sacc[m][1], af[m], bq[2], bq[3]);
          }
        }
      }
    }

    // the chain: h_{j-1} from chunk j-1's item (h0 or zeros at j = 0);
    // waiting after the chunk's own state keeps that product off the
    // chain's path from one chunk to the next
    stamp(a, item, 2 + 5 * k);
    const long long chain = ((long long)bi * a.H + hh) * a.nps + ps;
    if (j > 0 && tid == 0) {
      const unsigned long long* f = a.flags + chain * a.nj + (j - 1);
      while (ld_acquire(f) != a.epoch) __nanosleep(20);
    }
    __syncthreads();
    stamp(a, item, 3 + 5 * k);
    // a slot holds the state in fragment order: unit (P tile mt, S block
    // rt), then (i, hf), then the lane, so that each warp's access is 256
    // contiguous bytes; h0 and hout are (P, S)
    const size_t plane = (size_t)pw * S;
    const float2* slot_in = reinterpret_cast<const float2*>(
        a.slots + (chain * 2 + ((j - 1) & 1)) * plane);
    float2* slot_out =
        reinterpret_cast<float2*>(a.slots + (chain * 2 + (j & 1)) * plane);
    const float* h0 =
        a.h0 ? a.h0 + (((long long)bi * a.H + hh) * a.P + p0) * S : nullptr;
    float* hout = a.hout + (((long long)bi * a.H + hh) * a.P + p0) * S;
    const int SG = S / 16;
    float2 hp[2][2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int mt = half + 2 * m;
          const int p = mt * 16 + gid + 8 * hf, sc = sc0 + i * 8 + 2 * tig;
          float2 v = make_float2(0.f, 0.f);
          if (has_sg && mt < MT) {
            if (j > 0)
              v = __ldcg(slot_in + ((mt * SG + rt) * 4 + i * 2 + hf) * 32 +
                         lane);
            else if (h0)
              v = __ldcg(reinterpret_cast<const float2*>(h0 + p * S + sc));
          }
          hp[m][i][hf] = v;
        }

    // h_j = exp(total) h_{j-1} + s to the slot (hout for the last chunk),
    // h_{j-1} as a bf16 pair into Hs, Hl for C h^T
    if (has_sg) {
      const float dec = expf(total2[k & 1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int mt = half + 2 * m;
        if (mt >= MT) break;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = mt * 16 + gid + 8 * hf, sc = sc0 + i * 8 + 2 * tig;
            const float2 h = hp[m][i][hf];
            const float2 v = make_float2(fmaf(dec, h.x, sacc[m][i][2 * hf]),
                                         fmaf(dec, h.y, sacc[m][i][2 * hf + 1]));
            if (j == a.nj - 1)
              __stcg(reinterpret_cast<float2*>(hout + p * S + sc), v);
            else
              __stcg(slot_out + ((mt * SG + rt) * 4 + i * 2 + hf) * 32 + lane,
                     v);
            uint32_t lo;
            *reinterpret_cast<uint32_t*>(Hs + p * kSS + sc) =
                split2(h.x, h.y, lo);
            *reinterpret_cast<uint32_t*>(Hl + p * kSS + sc) = lo;
          }
      }
    }
    // h_{j-1} ready in Hs for y; the barrier orders every thread's state
    // stores before thread 0's fence, whose release publishes them (as a
    // grid barrier does), while warps 1-15 go on to y
    __syncthreads();
    if (tid == 0 && j < a.nj - 1) {
      __threadfence();
      st_release(a.flags + chain * a.nj + j, a.epoch);
    }
    stamp(a, item, 4 + 5 * k);

    // y rows 16 rt.. of this head: (C B^T o L) X + exp(cum) C h^T + d x
    if (ywarp && rt * 16 < n) {
      const int r0 = rt * 16, t0 = r0 + gid, t1 = t0 + 8;
      const float ct0 = cums[t0], ct1 = cums[t1];
      float yi[kNT][4] = {}, ye[kNT][4] = {};
      for (int kk = 0; kk <= rt; ++kk) {
        // the scores (C B^T o L) of rows t0, t1 as an A fragment.  Below
        // the diagonal block exp(cum_t - cum_u) = exp(cum_t - cum_e) f_u /
        // dt_u, both factors <= 1 (e: the block's last position), so two
        // exps a block; on the diagonal block each entry's own exp, masked
        // before it, and also what bf16 left out (al), so that a row whose
        // y cancels to near zero (d x against c_t.b_t dt_t x_t under a
        // steep decay) keeps about 16 bits of its largest terms
        uint32_t af[4], al[4];
        if (kk < rt) {
          const float ce = cums[kk * 16 + 15];
          const float e0 = __expf(ct0 - ce), e1 = __expf(ct1 - ce);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int u = kk * 16 + hf * 8 + 2 * tig;
            const float2 c0 =
                *reinterpret_cast<const float2*>(CBs + t0 * CBS + u);
            const float2 c1 =
                *reinterpret_cast<const float2*>(CBs + t1 * CBS + u);
            const float f0 = fcs[u], f1 = fcs[u + 1];
            af[2 * hf] = pack_bf16(c0.x * e0 * f0, c0.y * e0 * f1);
            af[2 * hf + 1] = pack_bf16(c1.x * e1 * f0, c1.y * e1 * f1);
          }
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int u = kk * 16 + hf * 8 + 2 * tig;
            const float2 c0 =
                *reinterpret_cast<const float2*>(CBs + t0 * CBS + u);
            const float2 c1 =
                *reinterpret_cast<const float2*>(CBs + t1 * CBS + u);
            const float cu0 = cums[u], cu1 = cums[u + 1];
            const float d0 = dtk[u], d1 = dtk[u + 1];
            af[2 * hf] =
                split2(u <= t0 ? c0.x * __expf(ct0 - cu0) * d0 : 0.f,
                       u + 1 <= t0 ? c0.y * __expf(ct0 - cu1) * d1 : 0.f,
                       al[2 * hf]);
            af[2 * hf + 1] =
                split2(u <= t1 ? c1.x * __expf(ct1 - cu0) * d0 : 0.f,
                       u + 1 <= t1 ? c1.y * __expf(ct1 - cu1) * d1 : 0.f,
                       al[2 * hf + 1]);
          }
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          if (np * 2 >= ntw) break;
          uint32_t bq[4];
          ldsm_x4_t(bq, Xc + kk * 16 * kXS + nt0 * 8 + np * 16 +
                            off_bk<kXS>(lane));
          mma_bf16(yi[2 * np], af, bq[0], bq[1]);
          mma_bf16(yi[2 * np + 1], af, bq[2], bq[3]);
          if (kk == rt) {
            mma_bf16(yi[2 * np], al, bq[0], bq[1]);
            mma_bf16(yi[2 * np + 1], al, bq[2], bq[3]);
          }
        }
      }
      if (inter) {
        for (int ks = 0; ks < S / 16; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, Cs + r0 * kSS + ks * 16 + off_a<kSS>(lane));
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            if (np * 2 >= ntw) break;
            const int hrow = (nt0 * 8 + np * 16) * kSS + ks * 16;
            uint32_t bq[4];  // h_{j-1} = hi + lo
            ldsm_x4(bq, Hs + hrow + off_bn<kSS>(lane));
            mma_bf16(ye[2 * np], af, bq[0], bq[1]);
            mma_bf16(ye[2 * np + 1], af, bq[2], bq[3]);
            ldsm_x4(bq, Hl + hrow + off_bn<kSS>(lane));
            mma_bf16(ye[2 * np], af, bq[0], bq[1]);
            mma_bf16(ye[2 * np + 1], af, bq[2], bq[3]);
          }
        }
      }
      const float e0 = expf(ct0), e1 = expf(ct1);
      const float dh = a.d ? a.d[hh] : 0.f;
      bf16* yg = a.y + (((long long)bi * a.L + l0) * a.H + hh) * a.P + p0;
      const long long y_sl = (long long)a.H * a.P;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= ntw) break;
        const int p = (nt0 + nt) * 8 + 2 * tig;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = hf ? t1 : t0;
          if (t >= n) continue;
          const float e = hf ? e1 : e0;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Xc + t * kXS + p));
          const float v0 = yi[nt][2 * hf] + e * ye[nt][2 * hf] + dh * xv.x;
          const float v1 =
              yi[nt][2 * hf + 1] + e * ye[nt][2 * hf + 1] + dh * xv.y;
          *reinterpret_cast<uint32_t*>(yg + t * y_sl + p) = pack_bf16(v0, v1);
        }
      }
    }
    if (warp == 0 && k + 1 < nh) scan(k + 1);
    rt::mma::cp_async_wait<0>();
    __syncthreads();  // the next head rewrites Hs and the other buffers
    stamp(a, item, 5 + 5 * k);
  }
}

template <typename K>
int mma_launch(K kern, const Args& a, cudaStream_t stream, bool& opted_in) {
  const int smem = smem_bytes(a.chunk, a.pw, a.ht);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (!opted_in) {  // once per instantiation
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  kern<<<a.n_items, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// full: a 64-wide P slice of state width 128 (mamba2-130m's whole head);
// else any slice width up to 64 and state width up to 128.
#define SSD_MMA_KERNEL(name, full)                                      \
  extern "C" __global__ void __launch_bounds__(ssd::kThreads, 1)        \
      name(const ssd::Args a) {                                         \
    ssd::body<(full) ? 64 : 0, (full) ? 128 : 0>(a);                    \
  }
SSD_MMA_KERNEL(ssd_mma_kernel_p64, true)
SSD_MMA_KERNEL(ssd_mma_kernel_any, false)

namespace {

// The bf16 body's launch: the partition (ht heads a tile, nps P slices)
// as kernels/ssd_scan.py ssd_plan chose it; the workspace holds the
// ticket, then the flags (chain, chunk), then the state slots, each
// region at a 256-byte boundary.
int mma_run(const void* x, const void* dt, const float* a, const void* b,
            const void* c, const float* d, const float* h0, void* y,
            float* hout, int B, int L, int H, int P, int G, int S, int chunk,
            long long x_sb, long long x_sl, long long dt_sb, long long dt_sl,
            long long b_sb, long long b_sl, long long c_sb, long long c_sl,
            int dt_dtype, void* ws, long long ws_bytes, long long epoch,
            long long ticket_base, int ht, int nps, long long* trace,
            cudaStream_t stream) {
  const int rep = H / G;
  if (chunk % 16 || S % 16 || P % nps || ht < 1 || ht > rep || nps < 1 ||
      epoch < 1 || ticket_base < 0 || !ws)
    return (int)cudaErrorInvalidValue;
  const int pw = P / nps;
  if (pw % 16 || pw > 64) return (int)cudaErrorInvalidValue;
  ssd::Args s;
  s.x = x;
  s.dt = dt;
  s.a = a;
  s.b = static_cast<const ssd::bf16*>(b);
  s.c = static_cast<const ssd::bf16*>(c);
  s.d = d;
  s.h0 = h0;
  s.y = static_cast<ssd::bf16*>(y);
  s.hout = hout;
  s.B = B;
  s.L = L;
  s.H = H;
  s.P = P;
  s.G = G;
  s.S = S;
  s.chunk = chunk;
  s.nj = (L + chunk - 1) / chunk;
  s.ht = ht;
  s.nht = (rep + ht - 1) / ht;
  s.pw = pw;
  s.nps = nps;
  const long long items = (long long)B * s.nj * G * s.nht * nps;
  const long long chains = (long long)B * H * nps;
  auto up = [](long long v) { return (v + 255) / 256 * 256; };
  const long long flags_at = 256;
  const long long slots_at = up(flags_at + chains * s.nj * 8);
  if (items >= (1LL << 31) ||
      slots_at + chains * 2 * pw * (long long)S * 4 > ws_bytes)
    return (int)cudaErrorInvalidValue;
  s.n_items = (int)items;
  char* w = static_cast<char*>(ws);
  s.ticket = reinterpret_cast<unsigned long long*>(w);
  s.flags = reinterpret_cast<unsigned long long*>(w + flags_at);
  s.slots = reinterpret_cast<float*>(w + slots_at);
  s.epoch = (unsigned long long)epoch;
  s.ticket_base = (unsigned long long)ticket_base;
  s.trace = trace;
  s.x_sb = x_sb;
  s.x_sl = x_sl;
  s.dt_sb = dt_sb;
  s.dt_sl = dt_sl;
  s.b_sb = b_sb;
  s.b_sl = b_sl;
  s.c_sb = c_sb;
  s.c_sl = c_sl;
  s.dt_bf16 = dt_dtype == rt::kBF16;
  // 16-byte copies: every row of x, b and c starts 16-byte aligned
  auto al = [](const void* p, long long off) {
    return (reinterpret_cast<uintptr_t>(p) + off * 2) % 16 == 0;
  };
  s.vec = al(x, 0) && al(b, 0) && al(c, 0) && x_sb % 8 == 0 &&
          x_sl % 8 == 0 && b_sb % 8 == 0 && b_sl % 8 == 0 && c_sb % 8 == 0 &&
          c_sl % 8 == 0 && P % 8 == 0;
  if (pw == 64 && S == 128) {
    static bool opted_in = false;
    return ssd::mma_launch(ssd_mma_kernel_p64, s, stream, opted_in);
  }
  static bool opted_in = false;
  return ssd::mma_launch(ssd_mma_kernel_any, s, stream, opted_in);
}

template <typename T>
int run_dt(int dt_dtype, const void* x, const void* dt, const float* a,
           const void* b, const void* c, const float* d, const float* h0,
           void* y, float* hout, int B, int L, int H, int P, int G, int S,
           int chunk, long long x_sb, long long x_sl, long long dt_sb,
           long long dt_sl, long long b_sb, long long b_sl, long long c_sb,
           long long c_sl, cudaStream_t s) {
  switch (dt_dtype) {
    case rt::kF32:
      return serial::launch<T, float>(x, dt, a, b, c, d, h0, y, hout, B, L, H,
                                   P, G, S, chunk, x_sb, x_sl, dt_sb, dt_sl,
                                   b_sb, b_sl, c_sb, c_sl, s);
    case rt::kBF16:
      return serial::launch<T, __nv_bfloat16>(x, dt, a, b, c, d, h0, y, hout, B,
                                           L, H, P, G, S, chunk, x_sb, x_sl,
                                           dt_sb, dt_sl, b_sb, b_sl, c_sb,
                                           c_sl, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ht > 0: the bf16 tensor-core body with ht heads a tile and nps P
// slices over the workspace ws (epoch: this launch's number on it;
// ticket_base: the tickets earlier launches drew from it), stamping its
// phases into trace where that is not null; ht == 0: the FMA body (fp32,
// or shapes off the tensor-core grid).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const float* a, const void* b,
    const void* c, const float* d, const float* h0, void* y, float* hout,
    int B, int L, int H, int P, int G, int S, int chunk, long long x_sb,
    long long x_sl, long long dt_sb, long long dt_sl, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, int dtype, int dt_dtype,
    void* ws, long long ws_bytes, long long epoch, long long ticket_base,
    int ht, int nps, void* trace, void* stream) {
  if (B < 1 || L < 1 || H < 1 || G < 1 || H % G || P < 1 ||
      P > serial::kMaxP || S < 1 || S > serial::kMaxS || chunk < 1 ||
      chunk > serial::kMaxChunk ||
      (dt_dtype != rt::kF32 && dt_dtype != rt::kBF16))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (ht > 0) {
    if (dtype != rt::kBF16) return (int)cudaErrorInvalidValue;
    return mma_run(x, dt, a, b, c, d, h0, y, hout, B, L, H, P, G, S, chunk,
                   x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl,
                   dt_dtype, ws, ws_bytes, epoch, ticket_base, ht, nps,
                   static_cast<long long*>(trace), s);
  }
  switch (dtype) {
    case rt::kF32:
      return run_dt<float>(dt_dtype, x, dt, a, b, c, d, h0, y, hout, B, L, H,
                           P, G, S, chunk, x_sb, x_sl, dt_sb, dt_sl, b_sb,
                           b_sl, c_sb, c_sl, s);
    case rt::kBF16:
      return run_dt<__nv_bfloat16>(dt_dtype, x, dt, a, b, c, d, h0, y, hout,
                                   B, L, H, P, G, S, chunk, x_sb, x_sl, dt_sb,
                                   dt_sl, b_sb, b_sl, c_sb, c_sl, s);
  }
  return (int)cudaErrorInvalidValue;
}
