// fused_decode_block and fused_decode_block_paged for Hopper (sm_90a):
// the whole M=1 attention sub-block in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode_block.py
// fused_decode_block (pallas_call at :258, body _decode_block_kernel
// :40): q = x @ Wq[h] rotated by RoPE at lengths[b] - 1, masked online
// softmax over the valid prefix, o / l, o @ Wo[h] summed over the heads
// in fp32, plus the residual.  A length-0 row returns the residual.
// Replaces the TPU kernel src/repro/kernels/fused_decode_block.py
// fused_decode_block_paged (pallas_call at :194, body
// _paged_decode_block_kernel :121): the same sub-block with K/V read
// from a page pool through block_tables[b, p / page], through the
// paged addressing policy of common.cuh; the body is this file's one.
//
// Bound on an H100 at the serve path's shapes (bf16, B=4, E=4608,
// Hq=36, Hkv=4, D=128, contexts of a few hundred tokens): Wq and Wo are
// 2 x 42.5 MB of a ~90 MB total, against ~1.4 GFLOP, so the bound is
// the bytes, about 27 us.  The paged kernel at the same shapes moves
// the same Wq + Wo (84.9 MB) and about 4.3 MB of KV: about 27 us too.
// Design: one block per (head, batch row), batch row fastest so the B
// blocks of a head run side by side and share its Wq/Wo slice through
// L2.  Each block still reads that slice once per batch row: reading
// the weights once per step (one block per head over all rows) is the
// first lever of a later change.  The heads' o @ Wo[h] contributions are summed deterministically, never with fp32
// atomics: each block writes its (E,) fp32 partial to a workspace,
// takes a ticket from a per-row counter after a fence, and the block
// that draws the last ticket sums the partials in head order (the TPU
// kernel's VMEM order, :89-101), adds the residual in fp32 and casts.
// The paged policy stages each 256-key step's slice of the block table
// (up to 33 entries at page 8) in shared memory and resolves every
// key's row from it.
#include "common.cuh"

namespace {

constexpr int kThreadsD = 256;
constexpr int kWarpsD = kThreadsD / 32;
constexpr int kTileKD = 256;  // keys scored per step of the prefix walk

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreadsD)
    decode_block_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ wo, const T* __restrict__ res,
                        const int* __restrict__ lengths, rt::KVSource src,
                        T* __restrict__ out, float* __restrict__ partial,
                        int* __restrict__ counter, int Hq, int Hkv, int E,
                        int D, int Dv, float scale, float rope_theta,
                        int use_rope) {
  extern __shared__ float smem[];
  float* x_s = smem;                    // (E,)
  float* q_s = x_s + E;                 // (kMaxD,)
  float* red = q_s + rt::kMaxD;         // (2, kMaxD)
  float* p_s = red + 2 * rt::kMaxD;     // (kTileKD,)
  __shared__ float alpha_s, l_s;
  __shared__ int last_s;
  __shared__ rt::PagedScratch<kTileKD> scratch;

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid % rt::kMaxD, part = tid / rt::kMaxD;  // two halves
  const int len = max(0, min(lengths[b], src.skv));

  for (int e = tid; e < E; e += kThreadsD) x_s[e] = rt::to_f(x[(int64_t)b * E + e]);
  __syncthreads();

  // fusion step 1: this head's Q row, x @ Wq[:, h, :] in fp32
  {
    float acc = 0.f;
    if (d < D) {
      const T* wcol = wq + (int64_t)h * D + d;
      const int64_t ws = (int64_t)Hq * D;
#pragma unroll 8
      for (int e = part; e < E; e += 2) acc = fmaf(x_s[e], rt::to_f(wcol[e * ws]), acc);
    }
    red[part * rt::kMaxD + d] = acc;
  }
  __syncthreads();
  const int half = D / 2;
  if (tid < half) {
    float a = red[tid] + red[rt::kMaxD + tid];
    float c = red[tid + half] + red[rt::kMaxD + tid + half];
    if (use_rope) {
      const float freq = expf((float)tid * (-logf(rope_theta) / (float)half));
      const float ang = (float)(len - 1) * freq;
      const float cs = cosf(ang), sn = sinf(ang);
      const float a2 = a * cs - c * sn;
      c = c * cs + a * sn;
      a = a2;
    }
    q_s[tid] = rt::round_to<T>(a);
    q_s[tid + half] = rt::round_to<T>(c);
  }
  __syncthreads();

  // fusion step 2: masked online softmax over the valid prefix
  const int kvh = h / (Hq / Hkv);
  KV kv = KV::make(src, b, kvh, Hkv, scratch);
  float qr[rt::kMaxD / 32];
#pragma unroll
  for (int t = 0; t < rt::kMaxD / 32; ++t)
    qr[t] = (lane + 32 * t) < D ? q_s[lane + 32 * t] : 0.f;
  float m = rt::kNegInf, l = 0.f;  // live in warp 0
  float acc = 0.f;                 // output dim d, keys of parity `part`
  for (int j0 = 0; j0 < len; j0 += kTileKD) {
    const int nk = min(kTileKD, len - j0);
    kv.stage(j0, nk);  // the previous step ended in __syncthreads()
    if (KV::kStaged) __syncthreads();
    for (int jj = warp; jj < nk; jj += kWarpsD) {
      const T* kr = k + kv.row(j0 + jj) * D;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < rt::kMaxD / 32; ++t)
        if (lane + 32 * t < D) s = fmaf(qr[t], rt::to_f(kr[lane + 32 * t]), s);
      s = rt::warp_sum(s);
      if (lane == 0) p_s[jj] = s * scale;
    }
    __syncthreads();
    if (warp == 0) {
      float sv[kTileKD / 32];
      float mt = rt::kNegInf;
#pragma unroll
      for (int t = 0; t < kTileKD / 32; ++t) {
        const int jj = lane + 32 * t;
        sv[t] = jj < nk ? p_s[jj] : rt::kNegInf;
        mt = fmaxf(mt, sv[t]);
      }
      const float m_new = fmaxf(m, rt::warp_max(mt));
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kTileKD / 32; ++t) {
        const int jj = lane + 32 * t;
        const float p = jj < nk ? expf(sv[t] - m_new) : 0.f;
        psum += p;
        if (jj < nk) p_s[jj] = rt::round_to<T>(p);
      }
      l = l * alpha + rt::warp_sum(psum);
      m = m_new;
      if (lane == 0) alpha_s = alpha;
    }
    __syncthreads();
    acc *= alpha_s;
    if (d < Dv)
      for (int jj = part; jj < nk; jj += 2)
        acc = fmaf(p_s[jj], rt::to_f(v[kv.row(j0 + jj) * Dv + d]), acc);
    __syncthreads();
  }
  if (tid == 0) l_s = l;
  red[part * rt::kMaxD + d] = acc;
  __syncthreads();
  if (tid < Dv) {
    const float l_safe = l_s == 0.f ? 1.f : l_s;
    // o is cast to Wo's dtype before the projection
    q_s[tid] = rt::round_to<T>((red[tid] + red[rt::kMaxD + tid]) / l_safe);
  }
  __syncthreads();

  // fusion step 3: this head's o @ Wo[h] into its fp32 partial
  const T* wrow = wo + (int64_t)h * Dv * E;
  float* mine = partial + ((int64_t)b * Hq + h) * E;
  for (int e = tid; e < E; e += kThreadsD) {
    float y = 0.f;
    for (int dd = 0; dd < Dv; ++dd) y = fmaf(q_s[dd], rt::to_f(wrow[(int64_t)dd * E + e]), y);
    mine[e] = y;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counter + b, 1) == Hq - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last head block of row b: sum in head order, residual in fp32
  const float* rowp = partial + (int64_t)b * Hq * E;
  for (int e = tid; e < E; e += kThreadsD) {
    float y = __ldcg(rowp + e);
    for (int hh = 1; hh < Hq; ++hh) y += __ldcg(rowp + (int64_t)hh * E + e);
    out[(int64_t)b * E + e] = rt::from_f<T>(rt::to_f(res[(int64_t)b * E + e]) + y);
  }
  if (tid == 0) counter[b] = 0;  // the workspace is reusable as it stands
}

template <typename T, typename KV>
int launch(const void* x, const void* wq, const void* k, const void* v,
           const void* wo, const void* res, const int* lengths,
           rt::KVSource src, void* out, float* partial, int* counter, int B,
           int Hq, int Hkv, int E, int D, int Dv, float scale,
           float rope_theta, int use_rope, cudaStream_t stream) {
  auto kern = decode_block_kernel<T, KV>;
  const int smem = (E + 3 * rt::kMaxD + kTileKD) * 4;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(B, Hq);
  kern<<<grid, kThreadsD, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(wo), static_cast<const T*>(res), lengths, src,
      static_cast<T*>(out), partial, counter, Hq, Hkv, E, D, Dv, scale,
      rope_theta, use_rope);
  return (int)cudaGetLastError();
}

template <typename KV>
int run(int dtype, const void* x, const void* wq, const void* k,
        const void* v, const void* wo, const void* res, const int* lengths,
        rt::KVSource src, void* out, float* partial, int* counter, int B,
        int Hq, int Hkv, int E, int D, int Dv, float scale, float rope_theta,
        int use_rope, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float, KV>(x, wq, k, v, wo, res, lengths, src, out,
                               partial, counter, B, Hq, Hkv, E, D, Dv, scale,
                               rope_theta, use_rope, s);
    case rt::kBF16:
      return launch<__nv_bfloat16, KV>(x, wq, k, v, wo, res, lengths, src,
                                       out, partial, counter, B, Hq, Hkv, E,
                                       D, Dv, scale, rope_theta, use_rope, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_decode_block_launch(
    const void* x, const void* wq, const void* k, const void* v,
    const void* wo, const void* res, const int* lengths, void* out,
    float* partial, int* counter, int B, int Hq, int Hkv, int Skv, int E,
    int D, int Dv, float scale, float rope_theta, int use_rope, int dtype,
    void* stream) {
  return run<rt::DenseKV>(dtype, x, wq, k, v, wo, res, lengths,
                          rt::KVSource{nullptr, 0, 0, Skv}, out, partial,
                          counter, B, Hq, Hkv, E, D, Dv, scale, rope_theta,
                          use_rope, stream);
}

extern "C" int fused_decode_block_paged_launch(
    const void* x, const void* wq, const void* k_pool, const void* v_pool,
    const void* wo, const void* res, const int* lengths,
    const int* block_tables, void* out, float* partial, int* counter, int B,
    int Hq, int Hkv, int max_pages, int page, int E, int D, int Dv,
    float scale, float rope_theta, int use_rope, int dtype, void* stream) {
  rt::KVSource src;
  if (!rt::paged_source(block_tables, max_pages, page, &src))
    return (int)cudaErrorInvalidValue;
  return run<rt::PagedKV>(dtype, x, wq, k_pool, v_pool, wo, res, lengths, src,
                          out, partial, counter, B, Hq, Hkv, E, D, Dv, scale,
                          rope_theta, use_rope, stream);
}
