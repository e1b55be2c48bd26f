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
// TPU kernel) and the final state is written to hout.  Where the TPU
// kernel and the JAX package's chunked_ssd round differently, this
// follows chunked_ssd (the function the JAX serve path computes): a, a dt
// and the decay stay fp32, and d x is added in fp32 before the one cast
// of y to x's dtype.
//
// Bound on an H100 at the cache-free forward's shapes (mamba2-130m, B=4,
// L=2048, H=24, P=64, G=1, S=128, bf16): x and y are 25.2 MB each, b and
// c 4.2 MB, dt 0.4 MB, the final state 3.1 MB: about 58 MB, 17 us at
// 3.35 TB/s.  The products are about 16 GFLOP, 16 us at the bf16
// tensor-core peak, so the bound is the bytes, narrowly.  At the serve
// path's prefill chunk (B=1, L=188, with h0) it is 2.8 MB, under 1 us.
//
// Design: the TPU's sequential chunk axis (dimension_semantics
// "arbitrary") is a loop inside one block per (batch row, head); the
// state lives in shared memory across the loop, fp32, as do the chunk's
// x, b and c tiles (converted once on load) and a 32-row block of the
// decay-score matrix (c b^T) o L, so shared memory at chunk 128 is
// 215,936 bytes, which needs cudaFuncAttributeMaxDynamicSharedMemorySize.
// The tensors are read through their batch and sequence strides in the
// JAX (B, L, H, P) layout, so x, b and c may be views into the model's
// conv output: no moveaxis copy.  Head h reads group h / (H / G) of b
// and c.  A ragged last chunk is masked on load (zeros, dt = 0), not
// padded in memory.  Each product is a register tile per thread over
// shared memory (rows padded by one float against bank conflicts),
// fp32 FMAs on the CUDA cores.
// Levers for later: only B*H blocks (24 at the serve path's B=1, on 132
// SMs), one chunk after another; c b^T is recomputed for each head of a
// group; no tensor cores (the four products are mma-shaped: 128x128x128
// and 128x64 tiles); the chunk's cumsum runs on one thread.
#include "common.cuh"

namespace {

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
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kThreadsS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), d, h0,
      static_cast<T*>(y), hout, L, H, P, G, S, chunk, x_sb, x_sl, dt_sb,
      dt_sl, b_sb, b_sl, c_sb, c_sl);
  return (int)cudaGetLastError();
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
      return launch<T, float>(x, dt, a, b, c, d, h0, y, hout, B, L, H, P, G,
                              S, chunk, x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl,
                              c_sb, c_sl, s);
    case rt::kBF16:
      return launch<T, __nv_bfloat16>(x, dt, a, b, c, d, h0, y, hout, B, L,
                                      H, P, G, S, chunk, x_sb, x_sl, dt_sb,
                                      dt_sl, b_sb, b_sl, c_sb, c_sl, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const float* a, const void* b,
    const void* c, const float* d, const float* h0, void* y, float* hout,
    int B, int L, int H, int P, int G, int S, int chunk, long long x_sb,
    long long x_sl, long long dt_sb, long long dt_sl, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, int dtype, int dt_dtype,
    void* stream) {
  if (B < 1 || L < 1 || H < 1 || G < 1 || H % G || P < 1 || P > kMaxP ||
      S < 1 || S > kMaxS || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
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
