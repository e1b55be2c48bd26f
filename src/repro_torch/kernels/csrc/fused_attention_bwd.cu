// fused_attention_bwd_dq and fused_attention_bwd_dkv for Hopper (sm_90a):
// the backward of the training attention (fused_attention_fwd in
// fused_attention.cu).
//
// Replaces the TPU kernel src/repro/kernels/fused_attention.py _bwd dq
// (pallas_call at :537, body _dq_kernel :424): fused_attention_bwd_dq
// recomputes s = Q.K^T * scale and p = exp(s - lse) tile by tile from the
// forward's lse, dp = dO.V^T, ds = p * (dp - delta) * scale, and sums
// dq = ds.K over the KV tiles up to the row tile's causal frontier.
// Replaces the TPU kernel src/repro/kernels/fused_attention.py _bwd dk/dv
// (pallas_call at :564, body _dkv_kernel :464): fused_attention_bwd_dkv
// sums dv = p^T.dO and dk = ds^T.Q for one KV tile over every query tile
// of every query head of its GQA group, in a fixed order, inside the
// block: the group's sum never reaches device memory.
// Cast points are the TPU kernels': ds is rounded to K's dtype before
// ds.K and to Q's before ds^T.Q, p to dO's before p^T.dO; dp, ds and all
// sums are fp32; delta = sum(o * dO) is computed outside (kernels/ref.py
// attention_delta), as _bwd computes it outside its kernels.
//
// Bound on an H100 at starcoder2-7b's training shapes (bf16, B=2,
// Sq=Skv=2048, Hq=36, Hkv=4, D=128, causal): dq does 3 products over
// the causal triangle, 6*B*Hq*D*Sq*(Sq+1)/2 = 116 GFLOP, against about
// 84 MB (Q, K, V, dO, lse, delta, dq); dk/dv does 4 products, 155
// GFLOP, against about 84 MB.  Both are bound by the operations: 0.117
// and 0.157 ms at 989 TFLOP/s.
// Design: both kernels run their products as fp32 FMAs on the CUDA
// cores, from fp32 tiles in shared memory (K and V rows padded to 129
// floats, so a lane reading its own key's row and a warp reading one
// column are both conflict-free).
// dq: one block of 128 threads per (b * Hq + h, 16 query rows), as the
// TPU grid (B*Hq, nq, nk) without its sequential nk axis: the block
// walks 64-key tiles up to the last row's anchor, so tiles past the
// causal frontier cost nothing; a warp owns 4 rows, and dq stays in
// registers (lane owns dims lane + 32 t) until its one write.
// dk/dv: one block of 128 threads per (b * Hkv + kv head, 32 keys), as
// the TPU grid (B, Hkv, nk, group * nq) with its sequential last axis
// a loop: for g in the group, for each 16-row query tile, in that
// order, skipping a tile whose last row's anchor is before the block's
// first key (the TPU kernels' per-pair causal skip).  A warp owns 8
// keys; dk and dv stay in registers and are written once.  No atomics:
// every output element has one writer and one summation order, so the
// results are deterministic.  Rows >= Sq and keys >= Skv are never read:
// their tiles load zeros and their p is 0.
// Levers for a later change: mma.sync / wgmma for the products, and a
// single backward walk that also emits dq (the dk/dv block already
// holds every ds it needs; dq then needs a cross-block sum).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBq = 16;       // query rows per tile
constexpr int kBkDq = 64;     // keys per tile of the dq walk
constexpr int kBkDkv = 32;    // keys per dk/dv block
constexpr int kMaxD = rt::kMaxD;
constexpr int kStride = rt::kKStride;
constexpr int kT = kMaxD / 32;  // dims per lane

constexpr int kDqSmemFloats = 2 * kBq * kMaxD      // q, dO tiles
                              + 2 * kBkDq * kStride  // K, V tiles
                              + kBq * kBkDq;         // ds tile
constexpr int kDkvSmemFloats = 2 * kBkDkv * kStride  // K, V tiles
                               + 2 * kBq * kMaxD      // q, dO tiles
                               + 2 * kBq * kBkDkv     // p, ds tiles
                               + 2 * kBq;             // lse, delta

// rows [r0, r0 + kBq) of a (rows, width) plane into an fp32 tile of
// stride kMaxD; rows past n_rows load zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int n_rows, int width) {
  for (int idx = threadIdx.x; idx < kBq * width; idx += kThreads) {
    const int i = idx / width, d = idx - i * width;
    dst[i * kMaxD + d] =
        r0 + i < n_rows ? rt::to_f(src[(int64_t)(r0 + i) * width + d]) : 0.f;
  }
}

// keys [j0, j0 + n) of a (Skv, width) plane into an fp32 tile of stride
// kStride; the tile's rows past n load zeros
template <typename T>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src,
                                          int j0, int n, int tile,
                                          int width) {
  for (int idx = threadIdx.x; idx < tile * width; idx += kThreads) {
    const int j = idx / width, d = idx - j * width;
    dst[j * kStride + d] =
        j < n ? rt::to_f(src[(int64_t)(j0 + j) * width + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int D,
              int Dv, int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBq * kMaxD;
  float* k_s = do_s + kBq * kMaxD;
  float* v_s = k_s + kBkDq * kStride;
  float* ds_s = v_s + kBkDq * kStride;
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int r0 = blockIdx.x * kBq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t plane = (int64_t)bh * Sq;  // row of (b, h, 0)
  const int64_t kv_plane = ((int64_t)b * Hkv + kvh) * Skv;

  load_rows(q_s, q + plane * D, r0, Sq, D);
  load_rows(do_s, dout + plane * Dv, r0, Sq, Dv);
  float lse_r[4], dl_r[4];
  int anchor[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + warp * 4 + i;
    const bool live = r < Sq;
    lse_r[i] = live ? lse[plane + r] : 0.f;
    dl_r[i] = live ? delta[plane + r] : 0.f;
    anchor[i] = !live ? -1 : causal ? q_offset + r : Skv - 1;
  }
  // the causal frontier: nothing past the last row's anchor
  const int last = min(r0 + kBq, Sq) - 1;
  const int kv_end = causal ? max(0, min(Skv, q_offset + last + 1)) : Skv;

  float acc[4][kT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[i][t] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += kBkDq) {
    const int nk = min(kBkDq, kv_end - j0);
    __syncthreads();  // previous tile consumed (and q/dO loaded)
    load_keys(k_s, k + kv_plane * D, j0, nk, kBkDq, D);
    load_keys(v_s, v + kv_plane * Dv, j0, nk, kBkDq, Dv);
    __syncthreads();

    // s = q.k and dp = dO.v: lane owns columns lane and lane + 32
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    const float* k0 = k_s + lane * kStride;
    const float* k1 = k_s + (lane + 32) * kStride;
    for (int d = 0; d < D; ++d) {
      const float a = k0[d], c = k1[d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = q_s[(warp * 4 + i) * kMaxD + d];
        s[i][0] = fmaf(x, a, s[i][0]);
        s[i][1] = fmaf(x, c, s[i][1]);
      }
    }
    const float* v0 = v_s + lane * kStride;
    const float* v1 = v_s + (lane + 32) * kStride;
    for (int d = 0; d < Dv; ++d) {
      const float a = v0[d], c = v1[d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = do_s[(warp * 4 + i) * kMaxD + d];
        dp[i][0] = fmaf(x, a, dp[i][0]);
        dp[i][1] = fmaf(x, c, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j0 + lane + 32 * c;
        const bool ok = lane + 32 * c < nk && col <= anchor[i];
        const float p = ok ? expf(s[i][c] * scale - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][c] - dl_r[i]) * scale;
        ds_s[(warp * 4 + i) * kBkDq + lane + 32 * c] = rt::round_to<T>(ds);
      }
    }
    __syncwarp();

    // dq += ds.K: lane owns dims lane + 32 t of its warp's 4 rows
    for (int j = 0; j < nk; ++j) {
      float kk[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) kk[t] = k_s[j * kStride + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = ds_s[(warp * 4 + i) * kBkDq + j];
#pragma unroll
        for (int t = 0; t < kT; ++t) acc[i][t] = fmaf(g, kk[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + warp * 4 + i;
    if (r >= Sq) continue;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) dq[(plane + r) * D + d] = rt::from_f<T>(acc[i][t]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
               int Sq, int Skv, int D, int Dv, int causal, int q_offset,
               float scale) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBkDkv * kStride;
  float* q_s = v_s + kBkDkv * kStride;
  float* do_s = q_s + kBq * kMaxD;
  float* p_s = do_s + kBq * kMaxD;
  float* ds_s = p_s + kBq * kBkDkv;
  float* lse_s = ds_s + kBq * kBkDkv;
  float* dl_s = lse_s + kBq;
  const int bk = blockIdx.y;  // b * Hkv + kv head
  const int b = bk / Hkv, kvh = bk - b * Hkv;
  const int group = Hq / Hkv;
  const int j0 = blockIdx.x * kBkDkv;
  const int nk = min(kBkDkv, Skv - j0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t kv_plane = (int64_t)bk * Skv;

  load_keys(k_s, k + kv_plane * D, j0, nk, kBkDkv, D);
  load_keys(v_s, v + kv_plane * Dv, j0, nk, kBkDkv, Dv);

  float acc_k[8][kT], acc_v[8][kT];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < kT; ++t) acc_k[j][t] = acc_v[j][t] = 0.f;

  const int nq = (Sq + kBq - 1) / kBq;
  for (int g = 0; g < group; ++g) {
    const int64_t plane = ((int64_t)b * Hq + kvh * group + g) * Sq;
    for (int qi = 0; qi < nq; ++qi) {
      const int r0 = qi * kBq;
      // per-pair causal skip: the tile's last row sees none of our keys
      if (causal && q_offset + min(r0 + kBq, Sq) - 1 < j0) continue;
      __syncthreads();  // previous tile consumed (and K/V loaded)
      load_rows(q_s, q + plane * D, r0, Sq, D);
      load_rows(do_s, dout + plane * Dv, r0, Sq, Dv);
      if (threadIdx.x < kBq) {
        const int r = r0 + threadIdx.x;
        lse_s[threadIdx.x] = r < Sq ? lse[plane + r] : 0.f;
        dl_s[threadIdx.x] = r < Sq ? delta[plane + r] : 0.f;
      }
      __syncthreads();

      // s and dp for rows warp*4 + i and key lane
      float s[4], dp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
      const float* kr = k_s + lane * kStride;
      for (int d = 0; d < D; ++d) {
        const float a = kr[d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i] = fmaf(q_s[(warp * 4 + i) * kMaxD + d], a, s[i]);
      }
      const float* vr = v_s + lane * kStride;
      for (int d = 0; d < Dv; ++d) {
        const float a = vr[d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[i] = fmaf(do_s[(warp * 4 + i) * kMaxD + d], a, dp[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = warp * 4 + i, r = r0 + row, col = j0 + lane;
        const bool ok = r < Sq && lane < nk && (!causal || col <= q_offset + r);
        const float p = ok ? expf(s[i] * scale - lse_s[row]) : 0.f;
        const float ds = p * (dp[i] - dl_s[row]) * scale;
        p_s[row * kBkDkv + lane] = rt::round_to<T>(p);
        ds_s[row * kBkDkv + lane] = rt::round_to<T>(ds);
      }
      __syncthreads();

      // dv += p^T.dO, dk += ds^T.q: warp owns keys warp*8 + jj, lane
      // owns dims lane + 32 t; rows in order
      for (int i = 0; i < kBq; ++i) {
        float o[kT], x[kT];
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          o[t] = do_s[i * kMaxD + lane + 32 * t];
          x[t] = q_s[i * kMaxD + lane + 32 * t];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float pv = p_s[i * kBkDkv + warp * 8 + jj];
          const float gv = ds_s[i * kBkDkv + warp * 8 + jj];
#pragma unroll
          for (int t = 0; t < kT; ++t) {
            acc_v[jj][t] = fmaf(pv, o[t], acc_v[jj][t]);
            acc_k[jj][t] = fmaf(gv, x[t], acc_k[jj][t]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int key = warp * 8 + jj;
    if (key >= nk) continue;
    const int64_t row = kv_plane + j0 + key;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) dk[row * D + d] = rt::from_f<T>(acc_k[jj][t]);
      if (d < Dv) dv[row * Dv + d] = rt::from_f<T>(acc_v[jj][t]);
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, int D, int Dv, int causal,
              int q_offset, float scale, cudaStream_t stream) {
  auto kern = dq_kernel<T>;
  const int bytes = kDqSmemFloats * 4;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  dim3 grid((Sq + kBq - 1) / kBq, B * Hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, Sq, Skv, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,
               int causal, int q_offset, float scale, cudaStream_t stream) {
  auto kern = dkv_kernel<T>;
  const int bytes = kDkvSmemFloats * 4;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  dim3 grid((Skv + kBkDkv - 1) / kBkDkv, B * Hkv);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Skv, D, Dv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int Hq, int Hkv,
    int Sq, int Skv, int D, int Dv, int causal, int q_offset, float scale,
    int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq,
                              Skv, D, Dv, causal, q_offset, scale, s);
    case rt::kBF16:
      return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, Hq,
                                      Hkv, Sq, Skv, D, Dv, causal, q_offset,
                                      scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, int causal, int q_offset,
    float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv,
                               Sq, Skv, D, Dv, causal, q_offset, scale, s);
    case rt::kBF16:
      return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B,
                                       Hq, Hkv, Sq, Skv, D, Dv, causal,
                                       q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
