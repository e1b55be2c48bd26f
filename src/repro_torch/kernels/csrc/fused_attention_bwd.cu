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
// 84 MB (Q, K, V, dO, lse, delta, dq); dk/dv does 4 products, 154.7
// GFLOP, against about 84 MB.  Both are bound by the operations: 0.117
// and 0.1564 ms at 989 TFLOP/s.
// Design: dq in bf16 (dq_mma_body) runs its three products on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; mma.cuh),
// in the shape of the forward's fwd_mma_body with one product more and
// no online softmax.  One block of 4 warps owns 64 query rows of one
// (b * Hq + h), 16 per warp, the m16 of every product, as the TPU grid
// (B*Hq, nq, nk) with its sequential nk axis a loop.  Q and dO are staged
// once in shared memory (in the second K and V buffers) and read into A
// fragments held in registers; K and V stay bf16 in shared memory, 64
// keys a tile, double-buffered with cp.async (rows padded to 136
// elements, conflict-free for ldmatrix).  Each tile is walked in two
// halves of 32 keys, so S and dP of a half (16 x 32 each per warp) fit
// beside Q's and dO's fragments (64 registers) and dQ (64): per half,
// S = Q.K^T and dP = dO.V^T on the mma, then p = exp(s * scale - lse)
// and ds = p * (dp - delta) * scale in registers; ds rounded to K's
// dtype (the TPU cast point) is repacked as the A fragment of dQ +=
// dS.K, K's B fragments read transposed from its key rows (ldmatrix
// .trans).  dQ (16 x D per warp) stays in fp32 registers until its one
// write: one writer per element and a fixed tile order, so no atomics
// and the result is bitwise repeatable.  A block walks key tiles only up
// to its last row's anchor, a warp skips the halves past its own last
// row's anchor (their p is 0, so skipping adds nothing), and only the
// halves that cross the diagonal or the Skv edge are masked; row tiles
// launch heaviest first.  Widths are zero-padded to 16 in the
// fragments, as in the forward.
// fp32 inputs take dq_kernel<float>, the FMA body (a block of 128
// threads per (b * Hq + h, 16 query rows); fp32 tiles in shared memory,
// K and V rows padded to 129 floats; a warp owns 4 rows, a lane the dims
// lane + 32 t): the card tests hold fp32 to 1e-4, which neither bf16 nor
// TF32 tensor cores can, and no path of the port runs the training
// attention in fp32 on the card.  The split is a dispatch on the dtype
// code in fused_attention_bwd_dq_launch, not a fallback.
// Rows >= Sq and keys >= Skv load zeros and get p = 0, in every kernel
// here.
// dk/dv in bf16 (dkv_mma_body) runs its four products on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; mma.cuh).  One
// block owns 64 keys of one (b * Hkv + kv head), as the TPU grid (B,
// Hkv, nk, group * nq) with its sequential last axis a loop: for g in
// the group, for each 64-row query tile, in that order, skipping the
// tiles whose last row's anchor is before the block's first key (the
// TPU kernels' per-pair causal skip).  The block has two warp groups of
// 4 warps, each warp 16 keys: group w takes the walk's tiles w, w + 2,
// ..., so the heaviest block's walk is halved: under the causal mask
// key tile 0 walks every query tile of the group and the last one a
// single tile, and with 256 blocks on 132 SMs the heaviest block sets
// the time.  K and V are loaded once, into A
// fragments held in registers (253 of them at D = 128, no spill, so one
// block of 8 warps per SM); per step Q, dO, lse and delta of both
// groups' tiles are double-buffered in shared memory with cp.async
// (bf16 rows padded to 136 elements, conflict-free for ldmatrix).  Per
// 16 queries of a tile each warp computes S^T = K.Q^T and dP^T = V.dO^T
// on the mma, then p^T = exp(s * scale - lse) and ds^T = p^T (dp^T -
// delta) * scale in registers; keys are the M dimension of dV += P^T.dO
// and dK += dS^T.Q too, so the first products' accumulators, rounded (p
// to dO's dtype, ds to Q's), are already the A fragments of the second.
// dK and dV (16 x D each per warp) stay in fp32 registers; at the end
// group 1 hands its partial sums to group 0 through shared memory and
// group 0 adds them to its own and writes.  So every dk/dv element has
// one writer and one summation order: deterministic, with no atomics
// and no scratch in device memory.  Only the 16-query slices that cross
// the diagonal or an edge are masked, and key tiles launch heaviest
// first (key tile 0 carries every query tile of the group).  Widths are
// zero-padded to 16 in the fragments, as in the forward.
// fp32 inputs take dkv_kernel<float>, the FMA body (a warp owns 8 keys
// of a 32-key block and walks 16-row query tiles): the card tests hold
// fp32 to 1e-4, which neither bf16 nor TF32 tensor cores can, and no
// path of the port runs the training attention in fp32 on the card.
// The split is a dispatch on the dtype code in
// fused_attention_bwd_dkv_launch, not a fallback.
// MLA's cache-free heads (D = 128 + 64 = 192, Dv = 128, 128 heads over
// 128, B=2, S=2048, causal): dq's three products are (4 D + 2 Dv) = 1024
// FLOP a score entry, 550.0 GFLOP, 0.5561 ms; dk/dv's four, 4 (D + Dv)
// = 1280, 687.5 GFLOP, 0.6952 ms; both bound by the operations.  Their
// bf16 bodies take an instantiation of their own there
// (dq_mma_kernel_d192, dkv_mma_kernel_d192; mma.cuh Width::kD192): Q
// and K rows padded to 200 elements, widths zero-padded to 192 and 128
// in the fragments.  dq's accumulator grows to 16 x 192 a warp (96
// registers), so Q's A fragments are read from a shared tile of their
// own at every step instead of held (dO's stay held): 243 registers,
// 109 KB, two blocks per SM.  dk/dv's accumulators take 160 registers
// (dK 96, dV 64), so K's and V's A fragments are read from their shared
// tiles by ldmatrix at every step: 255 registers, no spill, 212 KB, one
// block per SM.  fp32 takes dq_kernel and dkv_kernel sized for 192,
// each with its own shared memory.  Widths past D 192 or Dv 128 are
// refused.
// Levers for a later change: wgmma with TMA tile loads in dq and dk/dv,
// and a single backward walk that also emits dq (the dk/dv block
// already holds every ds it needs; dq then needs a cross-block sum).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBq = 16;       // query rows per tile
constexpr int kBkDq = 64;     // keys per tile of the dq walk
constexpr int kBkDkv = 32;    // keys per dk/dv block

// The FMA bodies are instantiated for rows up to kMD wide: kMaxD (128),
// and kTrainMaxD (192, MLA's D; V and dO stay within it), each with its
// own shared memory.  Tiles of Q and dO have stride kMD, of K and V kMD
// + 1 (conflict-free column reads); a lane owns kMD / 32 dims.
template <int kMD>
constexpr int dq_smem_bytes() {
  return 4 * (2 * kBq * kMD              // q, dO tiles
              + 2 * kBkDq * (kMD + 1)    // K, V tiles
              + kBq * kBkDq);            // ds tile
}
template <int kMD>
constexpr int dkv_smem_bytes() {
  return 4 * (2 * kBkDkv * (kMD + 1)     // K, V tiles
              + 2 * kBq * kMD            // q, dO tiles
              + 2 * kBq * kBkDkv         // p, ds tiles
              + 2 * kBq);                // lse, delta
}

// rows [r0, r0 + kBq) of a (rows, width) plane into an fp32 tile of
// stride kS; rows past n_rows load zeros
template <int kS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int n_rows, int width) {
  for (int idx = threadIdx.x; idx < kBq * width; idx += kThreads) {
    const int i = idx / width, d = idx - i * width;
    dst[i * kS + d] =
        r0 + i < n_rows ? rt::to_f(src[(int64_t)(r0 + i) * width + d]) : 0.f;
  }
}

// keys [j0, j0 + n) of a (Skv, width) plane into an fp32 tile of stride
// kS; the tile's rows past n load zeros
template <int kS, typename T>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src,
                                          int j0, int n, int tile,
                                          int width) {
  for (int idx = threadIdx.x; idx < tile * width; idx += kThreads) {
    const int j = idx / width, d = idx - j * width;
    dst[j * kS + d] =
        j < n ? rt::to_f(src[(int64_t)(j0 + j) * width + d]) : 0.f;
  }
}

template <typename T, int kMD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int D,
              int Dv, int causal, int q_offset, float scale) {
  constexpr int kStride = kMD + 1, kT = kMD / 32;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBq * kMD;
  float* k_s = do_s + kBq * kMD;
  float* v_s = k_s + kBkDq * kStride;
  float* ds_s = v_s + kBkDq * kStride;
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int r0 = blockIdx.x * kBq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t plane = (int64_t)bh * Sq;  // row of (b, h, 0)
  const int64_t kv_plane = ((int64_t)b * Hkv + kvh) * Skv;

  load_rows<kMD>(q_s, q + plane * D, r0, Sq, D);
  load_rows<kMD>(do_s, dout + plane * Dv, r0, Sq, Dv);
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
    load_keys<kStride>(k_s, k + kv_plane * D, j0, nk, kBkDq, D);
    load_keys<kStride>(v_s, v + kv_plane * Dv, j0, nk, kBkDq, Dv);
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
        const float x = q_s[(warp * 4 + i) * kMD + d];
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
        const float x = do_s[(warp * 4 + i) * kMD + d];
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

template <typename T, int kMD>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv,
               int Sq, int Skv, int D, int Dv, int causal, int q_offset,
               float scale) {
  constexpr int kStride = kMD + 1, kT = kMD / 32;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBkDkv * kStride;
  float* q_s = v_s + kBkDkv * kStride;
  float* do_s = q_s + kBq * kMD;
  float* p_s = do_s + kBq * kMD;
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

  load_keys<kStride>(k_s, k + kv_plane * D, j0, nk, kBkDkv, D);
  load_keys<kStride>(v_s, v + kv_plane * Dv, j0, nk, kBkDkv, Dv);

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
      load_rows<kMD>(q_s, q + plane * D, r0, Sq, D);
      load_rows<kMD>(do_s, dout + plane * Dv, r0, Sq, Dv);
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
          s[i] = fmaf(q_s[(warp * 4 + i) * kMD + d], a, s[i]);
      }
      const float* vr = v_s + lane * kStride;
      for (int d = 0; d < Dv; ++d) {
        const float a = vr[d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[i] = fmaf(do_s[(warp * 4 + i) * kMD + d], a, dp[i]);
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
          o[t] = do_s[i * kMD + lane + 32 * t];
          x[t] = q_s[i * kMD + lane + 32 * t];
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

// The bf16 dk/dv on the tensor cores (see the notes above).
namespace dkv {

using rt::mma::bf16;
using rt::mma::Width;
// kGroups warp groups of 4 warps share a block's 64 keys (16 per warp of
// a group) and take its query tiles in turn: group w the tiles it with
// it % kGroups == w.  They add their partial dK, dV in group order at
// the end, so the order of every sum is still fixed.
constexpr int kGroups = 2;
constexpr int kWarps = 4 * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kBk = 64;  // keys per block
constexpr int kBq = 64;  // query rows per tile
// K, V; two buffers of kGroups (Q, dO) tiles; two of kGroups (lse, delta)
template <Width W>
constexpr int smem_bytes() {
  using Wd = rt::mma::Widths<W>;
  return (kBk + 2 * kGroups * kBq) * (Wd::kSK + Wd::kSV) * 2 +
         4 * kGroups * kBq * 4;
}
// the groups' partial sums (dK's 2 kNd n-tiles, dV's 2 kNdv), exchanged
// through the Q buffers
template <Width W>
constexpr bool partials_fit() {
  using Wd = rt::mma::Widths<W>;
  return (kGroups - 1) * 4 * 32 * (2 * Wd::kNd + 2 * Wd::kNdv) * 4 * 4 <=
         2 * kGroups * kBq * Wd::kSK * 2;
}
static_assert(partials_fit<Width::kD128>() && partials_fit<Width::kD192>(),
              "partial sums must fit the Q buffers");

// One block: keys [j0, j0 + 64) of plane bk = b * Hkv + kvh, key tile
// blockIdx.y = 0 (the heaviest under the causal mask) first.  W: the
// widths it serves (mma.cuh Width).  kD128 folds the width guards and
// the loaders' divisions away and lets the products of neighbouring
// steps interleave (with a runtime width every 16-wide step sits behind
// its own branch): on an H100, 0.77 against 1.55 ms for kAny at the
// training shape.  Below kD192, K's and V's A fragments are loaded once
// and held in registers (253 of them at D = 128); at kD192 dK's
// accumulator alone takes 96 registers and dV's 64, so K's and V's
// fragments are read from their shared tiles by ldmatrix at every step
// instead.  Launched as dkv_mma_kernel_d128, _any or _d192 below.
template <Width W>
__device__ __forceinline__ void dkv_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hkv, int Sq,
    int Skv, int D, int Dv, int causal, int q_offset, float scale,
    bool vec) {
  using namespace rt::mma;
  using Wd = Widths<W>;
  constexpr int kSK = Wd::kSK, kSV = Wd::kSV;
  constexpr int kNd = Wd::kNd, kNdv = Wd::kNdv;
  constexpr bool kKvInSmem = W == Width::kD192;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBk * kSK;
  bf16* q_s = v_s + kBk * kSV;                 // 2 x kGroups tiles of kBq
  bf16* do_s = q_s + 2 * kGroups * kBq * kSK;  // 2 x kGroups tiles of kBq
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kGroups * kBq * kSV);
  float* dl_s = lse_s + 2 * kGroups * kBq;
  const int bk = blockIdx.x;
  const int b = bk / Hkv, kvh = bk - b * Hkv;
  const int group = Hq / Hkv;
  const int j0 = blockIdx.y * kBk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wi = warp & 3;  // warp group, warp in it
  const int gid = lane >> 2, tig = lane & 3;
  if (W == Width::kD128) D = Dv = 128, vec = true;
  const int Dp = Wd::dp(D), Dvp = Wd::dvp(Dv);
  const int64_t kv_plane = (int64_t)bk * Skv;
  const int nq = (Sq + kBq - 1) / kBq;
  // per-pair causal skip: query tiles whose last row sees none of our
  // keys form a prefix [0, qi0)
  int qi0 = 0;
  if (causal)
    while (qi0 < nq && q_offset + min((qi0 + 1) * kBq, Sq) - 1 < j0) ++qi0;
  // the walk: tile it is head g = it / nqi (outer), query tile qi0 + it %
  // nqi (inner); step st holds tiles kGroups * st + w, w < kGroups
  const int nqi = nq - qi0, n_it = group * nqi;
  const int n_steps = (n_it + kGroups - 1) / kGroups;

  load_tile<kBk, kThreads, kSK>(k_s, k + kv_plane * D, j0, Skv, D, Dp, vec);
  load_tile<kBk, kThreads, kSV>(v_s, v + kv_plane * Dv, j0, Skv, Dv, Dvp,
                                vec);
  // step st's tiles into buffer st & 1
  auto load_step = [&](int st) {
    for (int w = 0; w < kGroups; ++w) {
      const int it = kGroups * st + w;
      if (it >= n_it) break;
      const int g = it / nqi, r0 = (qi0 + it - g * nqi) * kBq;
      const int64_t plane = ((int64_t)b * Hq + kvh * group + g) * Sq;
      const int slot = (st & 1) * kGroups + w;
      load_tile<kBq, kThreads, kSK>(q_s + slot * kBq * kSK, q + plane * D, r0,
                                    Sq, D, Dp, vec);
      load_tile<kBq, kThreads, kSV>(do_s + slot * kBq * kSV,
                                    dout + plane * Dv, r0, Sq, Dv, Dvp, vec);
      load_row_vec<kBq, kThreads>(lse_s + slot * kBq, lse + plane, r0, Sq);
      load_row_vec<kBq, kThreads>(dl_s + slot * kBq, delta + plane, r0, Sq);
    }
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  // this lane's keys: wk + gid and wk + gid + 8
  const int wk = j0 + wi * 16;
  // n-tile n: columns 8n + 2tig, +1 (dV's past 2 kNdv are never used)
  float dk_acc[2 * kNd][4], dv_acc[2 * kNd][4];
#pragma unroll
  for (int n = 0; n < 2 * kNd; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  uint32_t kf[kNd][4], vf[kNd][4];  // K's and V's A fragments
#define DKV_K_FRAG(kk) \
  ldsm_x4(kf[kk], k_s + wi * 16 * kSK + (kk) * 16 + a_off<kSK>(lane))
#define DKV_V_FRAG(kk) \
  ldsm_x4(vf[kk], v_s + wi * 16 * kSV + (kk) * 16 + a_off<kSV>(lane))

  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) load_step(st + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step st (and, at st = 0, K and V) has landed
    __syncthreads();
    if (!kKvInSmem && st == 0) {
#pragma unroll
      for (int kk = 0; kk < kNd; ++kk) {
        if (kk * 16 < Dp) DKV_K_FRAG(kk);
        if (kk < kNdv && kk * 16 < Dvp) DKV_V_FRAG(kk);
      }
    }
    const int it = kGroups * st + wg;
    if (it < n_it) {
      const int slot = (st & 1) * kGroups + wg;
      const bf16* qs = q_s + slot * kBq * kSK;
      const bf16* dos = do_s + slot * kBq * kSV;
      const float* ls = lse_s + slot * kBq;
      const float* dls = dl_s + slot * kBq;
      const int g = it / nqi, r0 = (qi0 + it - g * nqi) * kBq;

#pragma unroll 1
      for (int sub = 0; sub < kBq / 16; ++sub) {
        const int rs = r0 + 16 * sub;  // first query of these 16
        if (rs >= Sq) break;
        // S^T = K.Q^T and dP^T = V.dO^T: n-tile n holds queries rs + 8n
        // + 2tig, +1
        float sc[2][4] = {}, dpt[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kNd; ++kk) {
          uint32_t bf[4];
          if (kk * 16 < Dp) {
            if (kKvInSmem) DKV_K_FRAG(kk);
            ldsm_x4(bf, qs + 16 * sub * kSK + kk * 16 + bn_off<kSK>(lane));
            mma_bf16(sc[0], kf[kk], bf[0], bf[1]);
            mma_bf16(sc[1], kf[kk], bf[2], bf[3]);
          }
          if (kk < kNdv && kk * 16 < Dvp) {
            if (kKvInSmem) DKV_V_FRAG(kk);
            ldsm_x4(bf, dos + 16 * sub * kSV + kk * 16 + bn_off<kSV>(lane));
            mma_bf16(dpt[0], vf[kk], bf[0], bf[1]);
            mma_bf16(dpt[1], vf[kk], bf[2], bf[3]);
          }
        }
        // p^T and ds^T; mask only where these 16 queries cross the
        // diagonal for some key of this warp, or an edge
        const bool edge = rs + 16 > Sq || wk + 16 > Skv ||
                          (causal && wk + 15 > q_offset + rs);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 16 * sub + 8 * n + 2 * tig + (e & 1);
            float p = expf(sc[n][e] * scale - ls[ql]);
            if (edge) {
              const int key = wk + gid + 8 * (e >> 1), row = r0 + ql;
              const bool ok = row < Sq && key < Skv &&
                              (!causal || key <= q_offset + row);
              p = ok ? p : 0.f;
            }
            dpt[n][e] = p * (dpt[n][e] - dls[ql]) * scale;
            sc[n][e] = p;
          }
        // dV += P^T.dO (p rounded to dO's dtype), dK += dS^T.Q (ds
        // rounded to Q's): the accumulators above are the A fragments
        uint32_t pa[4], da[4];
        c_to_a(pa, sc[0], sc[1]);
        c_to_a(da, dpt[0], dpt[1]);
#pragma unroll
        for (int np = 0; np < kNd; ++np) {
          uint32_t bf[4];
          if (np < kNdv && np * 16 < Dvp) {
            ldsm_x4_t(bf, dos + 16 * sub * kSV + np * 16 + bk_off<kSV>(lane));
            mma_bf16(dv_acc[2 * np], pa, bf[0], bf[1]);
            mma_bf16(dv_acc[2 * np + 1], pa, bf[2], bf[3]);
          }
          if (np * 16 < Dp) {
            ldsm_x4_t(bf, qs + 16 * sub * kSK + np * 16 + bk_off<kSK>(lane));
            mma_bf16(dk_acc[2 * np], da, bf[0], bf[1]);
            mma_bf16(dk_acc[2 * np + 1], da, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // step st consumed before its buffers are refilled
  }
#undef DKV_K_FRAG
#undef DKV_V_FRAG
  cp_async_wait<0>();

  // groups 1.. hand their partial sums to group 0 through the Q
  // buffers, element (n, e) of lane l of warp wi at [(n * 4 + e) * 32 +
  // l]: dK's 2 kNd n-tiles, then dV's 2 kNdv
  float* red = reinterpret_cast<float*>(q_s);
  constexpr int kDvAt = 2 * kNd * 4;             // dV's first (n * 4 + e)
  constexpr int red_warp = (kDvAt + 2 * kNdv * 4) * 32;  // floats a warp
  if (kGroups > 1) {
    __syncthreads();
    if (wg > 0) {
      float* r = red + ((wg - 1) * 4 + wi) * red_warp + lane;
#pragma unroll
      for (int n = 0; n < 2 * kNd; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          r[(n * 4 + e) * 32] = dk_acc[n][e];
          if (n < 2 * kNdv) r[(kDvAt + n * 4 + e) * 32] = dv_acc[n][e];
        }
    }
    __syncthreads();
    if (wg > 0) return;
    for (int w = 1; w < kGroups; ++w) {
      const float* r = red + ((w - 1) * 4 + wi) * red_warp + lane;
#pragma unroll
      for (int n = 0; n < 2 * kNd; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk_acc[n][e] += r[(n * 4 + e) * 32];
          if (n < 2 * kNdv) dv_acc[n][e] += r[(kDvAt + n * 4 + e) * 32];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk + gid + 8 * i;
    if (key >= Skv) continue;
    bf16* dkr = dk + (kv_plane + key) * D;
    bf16* dvr = dv + (kv_plane + key) * Dv;
#pragma unroll
    for (int n = 0; n < 2 * kNd; ++n) {
      const int col = 8 * n + 2 * tig;
      if (col < D) {
        dkr[col] = __float2bfloat16_rn(dk_acc[n][2 * i]);
        dkr[col + 1] = __float2bfloat16_rn(dk_acc[n][2 * i + 1]);
      }
      if (n < 2 * kNdv && col < Dv) {
        dvr[col] = __float2bfloat16_rn(dv_acc[n][2 * i]);
        dvr[col + 1] = __float2bfloat16_rn(dv_acc[n][2 * i + 1]);
      }
    }
  }
}

}  // namespace dkv

// The bf16 dq on the tensor cores (see the notes above).
namespace dqm {

using rt::mma::bf16;
using rt::mma::Width;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBk = 64;           // keys per tile
constexpr int kHalf = kBk / 2;    // keys per step of the walk
// two buffers of (K, V); dO is staged in the second V buffer, read into
// registers before that buffer's first tile lands, and so is Q in the
// second K buffer below kD192; at kD192 Q keeps a tile of its own
template <Width W>
constexpr int smem_bytes() {
  using Wd = rt::mma::Widths<W>;
  return (2 * kBk * (Wd::kSK + Wd::kSV) +
          (W == Width::kD192 ? kBq * Wd::kSK : 0)) * 2;
}
static_assert(kBq <= kBk, "the Q and dO tiles must fit a K/V buffer");

// One block: query rows [r0, r0 + 64) of plane bh = b * Hq + h, the row
// tile y counted from the last (heaviest under the causal mask) first.
// W: the widths it serves (mma.cuh Width), as in fwd_mma_body.  Below
// kD192 Q's and dO's A fragments are held in registers; at kD192 dQ's
// accumulator takes 96 registers, so Q's 12 fragments are read from its
// shared tile by ldmatrix at every step instead (dO's 8 stay held).
// Launched as dq_mma_kernel_d128, _any or _d192 below, 2 blocks per SM.
template <Width W>
__device__ __forceinline__ void dq_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,
    int causal, int q_offset, float scale, bool vec) {
  using namespace rt::mma;
  using Wd = Widths<W>;
  constexpr int kSK = Wd::kSK, kSV = Wd::kSV;
  constexpr int kNd = Wd::kNd, kNdv = Wd::kNdv;
  constexpr bool kQInSmem = W == Width::kD192;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // two buffers of kBk rows
  bf16* v_s = k_s + 2 * kBk * kSK;                 // two buffers of kBk rows
  // K's second buffer, or (kD192) a tile past V's buffers
  bf16* q_s = kQInSmem ? v_s + 2 * kBk * kSV : k_s + kBk * kSK;
  bf16* do_s = v_s + kBk * kSV;                    // V's second buffer
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  if (W == Width::kD128) D = Dv = 128, vec = true;
  const int Dp = Wd::dp(D), Dvp = Wd::dvp(Dv);
  const int64_t plane = (int64_t)bh * Sq;  // row of (b, h, 0)
  const bf16* kp = k + ((int64_t)b * Hkv + kvh) * Skv * D;
  const bf16* vp = v + ((int64_t)b * Hkv + kvh) * Skv * Dv;
  // the causal frontier: nothing past the block's last row's anchor
  const int last = min(r0 + kBq, Sq) - 1;
  const int kv_end = causal ? max(0, min(Skv, q_offset + last + 1)) : Skv;
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  load_tile<kBq, kThreads, kSK>(q_s, q + plane * D, r0, Sq, D, Dp, vec);
  load_tile<kBq, kThreads, kSV>(do_s, dout + plane * Dv, r0, Sq, Dv, Dvp,
                                vec);
  if (n_tiles > 0) {
    load_tile<kBk, kThreads, kSK>(k_s, kp, 0, Skv, D, Dp, vec);
    load_tile<kBk, kThreads, kSV>(v_s, vp, 0, Skv, Dv, Dvp, vec);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q's and dO's A fragments, 16 columns each (Q's reloaded per step at
  // kD192)
  uint32_t qf[kNd][4], df[kNd][4];  // dO's past kNdv are never used
  const bf16* qw = q_s + warp * 16 * kSK + a_off<kSK>(lane);
#pragma unroll
  for (int kk = 0; kk < kNd; ++kk) {
    if (!kQInSmem && kk * 16 < Dp) ldsm_x4(qf[kk], qw + kk * 16);
    if (kk < kNdv && kk * 16 < Dvp)
      ldsm_x4(df[kk], do_s + warp * 16 * kSV + kk * 16 + a_off<kSV>(lane));
  }
  __syncthreads();  // Q and dO read before tile 1 overwrites them

  // this lane's rows: wr + gid and wr + gid + 8
  const int wr = r0 + warp * 16;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + gid + 8 * i;
    lse_r[i] = row < Sq ? lse[plane + row] : 0.f;
    dl_r[i] = row < Sq ? delta[plane + row] : 0.f;
  }
  float acc[2 * kNd][4];  // dQ: n-tile n holds columns 8n + 2tig, +1
#pragma unroll
  for (int n = 0; n < 2 * kNd; ++n)
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

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int jh = j0 + hf * kHalf;  // first key of this half
      // nothing for this warp: every key past its last row's anchor or
      // Skv (p = 0), or no live row
      if (wr >= Sq || jh >= Skv || (causal && jh > q_offset + wr + 15))
        continue;
      const bf16* kh = ks + hf * kHalf * kSK;
      const bf16* vh = vs + hf * kHalf * kSV;
      // S = Q.K^T and dP = dO.V^T: n-tile n holds keys jh + 8n + 2tig, +1
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNd; ++kk) {
        if (kQInSmem) ldsm_x4(qf[kk], qw + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          if (kk * 16 < Dp) {
            ldsm_x4(bf, kh + np * 16 * kSK + kk * 16 + bn_off<kSK>(lane));
            mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
          }
          if (kk < kNdv && kk * 16 < Dvp) {
            ldsm_x4(bf, vh + np * 16 * kSV + kk * 16 + bn_off<kSV>(lane));
            mma_bf16(dp[2 * np], df[kk], bf[0], bf[1]);
            mma_bf16(dp[2 * np + 1], df[kk], bf[2], bf[3]);
          }
        }
      }
      // p and ds; mask only a half that crosses the diagonal (for some
      // row of this warp) or the Skv edge.  A row that sees no key has
      // lse = -1e30, so its unmasked p would be inf: the select, not a
      // product, zeroes it.
      const bool edge = (causal && jh + kHalf - 1 > q_offset + wr) ||
                        jh + kHalf > Skv;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = expf(s[n][e] * scale - lse_r[i]);
          if (edge) {
            const int col = jh + 8 * n + 2 * tig + (e & 1);
            const int row = wr + gid + 8 * i;
            const bool ok = col < Skv && (!causal || col <= q_offset + row);
            p = ok ? p : 0.f;
          }
          s[n][e] = p * (dp[n][e] - dl_r[i]) * scale;  // ds
        }
      // dQ += dS.K, ds rounded to bf16 (K's dtype) in the A fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < kNd; ++np) {
          if (np * 16 >= Dp) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, kh + kk * 16 * kSK + np * 16 + bk_off<kSK>(lane));
          mma_bf16(acc[2 * np], da, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], da, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // tile t consumed before its buffer is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + gid + 8 * i;
    if (row >= Sq) continue;
    bf16* o = dq + (plane + row) * D;
#pragma unroll
    for (int n = 0; n < 2 * kNd; ++n) {
      const int col = 8 * n + 2 * tig;
      if (col < D) {
        o[col] = __float2bfloat16_rn(acc[n][2 * i]);
        o[col + 1] = __float2bfloat16_rn(acc[n][2 * i + 1]);
      }
    }
  }
}

}  // namespace dqm
}  // namespace

// The bodies' instantiations as kernels with names of their own (C
// linkage), so the build's ptxas report and the SASS name each one:
// *_d128 is the one the GQA training path runs, *_d192 the one MLA's
// does.
#define DKV_MMA_KERNEL(name, width)                                         \
  extern "C" __global__ void __launch_bounds__(dkv::kThreads) name(         \
      const rt::mma::bf16* __restrict__ q,                                  \
      const rt::mma::bf16* __restrict__ k,                                  \
      const rt::mma::bf16* __restrict__ v,                                  \
      const rt::mma::bf16* __restrict__ dout, const float* __restrict__ lse, \
      const float* __restrict__ delta, rt::mma::bf16* __restrict__ dk,      \
      rt::mma::bf16* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,     \
      int D, int Dv, int causal, int q_offset, float scale, bool vec) {     \
    dkv::dkv_mma_body<rt::mma::Width::width>(q, k, v, dout, lse, delta, dk, \
                                             dv, Hq, Hkv, Sq, Skv, D, Dv,   \
                                             causal, q_offset, scale, vec); \
  }
DKV_MMA_KERNEL(dkv_mma_kernel_d128, kD128)
DKV_MMA_KERNEL(dkv_mma_kernel_any, kAny)
DKV_MMA_KERNEL(dkv_mma_kernel_d192, kD192)
#undef DKV_MMA_KERNEL

#define DQ_MMA_KERNEL(name, width)                                          \
  extern "C" __global__ void __launch_bounds__(dqm::kThreads, 2) name(      \
      const rt::mma::bf16* __restrict__ q,                                  \
      const rt::mma::bf16* __restrict__ k,                                  \
      const rt::mma::bf16* __restrict__ v,                                  \
      const rt::mma::bf16* __restrict__ dout, const float* __restrict__ lse, \
      const float* __restrict__ delta, rt::mma::bf16* __restrict__ dq,      \
      int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,          \
      int q_offset, float scale, bool vec) {                                \
    dqm::dq_mma_body<rt::mma::Width::width>(q, k, v, dout, lse, delta, dq,  \
                                            Hq, Hkv, Sq, Skv, D, Dv,        \
                                            causal, q_offset, scale, vec);  \
  }
DQ_MMA_KERNEL(dq_mma_kernel_d128, kD128)
DQ_MMA_KERNEL(dq_mma_kernel_any, kAny)
DQ_MMA_KERNEL(dq_mma_kernel_d192, kD192)
#undef DQ_MMA_KERNEL

namespace {

namespace dkv {

int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  const bool vec = rt::mma::vec_ok(q, D) && rt::mma::vec_ok(k, D) &&
                   rt::mma::vec_ok(v, Dv) && rt::mma::vec_ok(dout, Dv);
  // by the widths alone (the entry point refuses D > 192 or Dv > 128)
  auto kern = vec && D == 128 && Dv == 128 ? dkv_mma_kernel_d128
                                           : dkv_mma_kernel_any;
  int smem = smem_bytes<Width::kAny>();
  if (D > rt::kMaxD)
    kern = dkv_mma_kernel_d192, smem = smem_bytes<Width::kD192>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid(B * Hkv, (Skv + kBk - 1) / kBk);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq, Hkv, Sq,
      Skv, D, Dv, causal, q_offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace dkv

namespace dqm {

int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int Hq,
           int Hkv, int Sq, int Skv, int D, int Dv, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  const bool vec = rt::mma::vec_ok(q, D) && rt::mma::vec_ok(k, D) &&
                   rt::mma::vec_ok(v, Dv) && rt::mma::vec_ok(dout, Dv);
  // by the widths alone (the entry point refuses D > 192 or Dv > 128)
  auto kern = vec && D == 128 && Dv == 128 ? dq_mma_kernel_d128
                                           : dq_mma_kernel_any;
  int smem = smem_bytes<Width::kAny>();
  if (D > rt::kMaxD)
    kern = dq_mma_kernel_d192, smem = smem_bytes<Width::kD192>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid(B * Hq, (Sq + kBq - 1) / kBq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Skv, D, Dv, causal,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace dqm

// The FMA bodies, at kMaxD or (D past it) kTrainMaxD.
template <typename T, int kMD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, int D, int Dv, int causal,
              int q_offset, float scale, cudaStream_t stream) {
  auto kern = dq_kernel<T, kMD>;
  constexpr int bytes = dq_smem_bytes<kMD>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  dim3 grid((Sq + kBq - 1) / kBq, B * Hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, Sq, Skv, D, Dv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T, int kMD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,
               int causal, int q_offset, float scale, cudaStream_t stream) {
  auto kern = dkv_kernel<T, kMD>;
  constexpr int bytes = dkv_smem_bytes<kMD>();
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

bool widths_ok(int D, int Dv) {
  return D >= 1 && Dv >= 1 && D <= rt::kTrainMaxD && Dv <= rt::kTrainMaxDv;
}

}  // namespace

// Widths past D 192 or Dv 128 are refused.
extern "C" int fused_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int Hq, int Hkv,
    int Sq, int Skv, int D, int Dv, int causal, int q_offset, float scale,
    int dtype, void* stream) {
  if (!widths_ok(D, Dv)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      if (D > rt::kMaxD)
        return launch_dq<float, rt::kTrainMaxD>(q, k, v, dout, lse, delta, dq,
                                                B, Hq, Hkv, Sq, Skv, D, Dv,
                                                causal, q_offset, scale, s);
      return launch_dq<float, rt::kMaxD>(q, k, v, dout, lse, delta, dq, B, Hq,
                                         Hkv, Sq, Skv, D, Dv, causal,
                                         q_offset, scale, s);
    case rt::kBF16:  // the tensor-core body; fp32 keeps the FMA body
      return dqm::launch(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,
                         D, Dv, causal, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, int causal, int q_offset,
    float scale, int dtype, void* stream) {
  if (!widths_ok(D, Dv)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      if (D > rt::kMaxD)
        return launch_dkv<float, rt::kTrainMaxD>(q, k, v, dout, lse, delta,
                                                 dk, dv, B, Hq, Hkv, Sq, Skv,
                                                 D, Dv, causal, q_offset,
                                                 scale, s);
      return launch_dkv<float, rt::kMaxD>(q, k, v, dout, lse, delta, dk, dv,
                                          B, Hq, Hkv, Sq, Skv, D, Dv, causal,
                                          q_offset, scale, s);
    case rt::kBF16:  // the tensor-core body; fp32 keeps the FMA body
      return dkv::launch(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                         Skv, D, Dv, causal, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
