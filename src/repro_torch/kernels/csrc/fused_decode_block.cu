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
// Hq=36, Hkv=4, D=Dv=128, lengths 301/460/612/705): 89.3 MB moved, Wq
// and Wo 84.9 MB of it, K/V 4.3 MB, against 0.38 GFLOP, so the bound
// is the bytes, 0.0267 ms at 3.35 TB/s; the paged kernel moves the
// same bytes and its table.  Almost all of it is the two weights, and
// they do not grow with the batch.
//
// The body this file had before (still the fp32 body, below) ran 13x
// that bound: one block per (batch row, head) read its head's Wq and
// Wo slices (2 x 1.18 MB) once per row, so a step moved B times the
// weights through L2; its projections were chains of dependent 2-byte
// loads, about 4 KB in flight per SM where the card's bandwidth needs
// 20-30 KB; and the last block of each row summed 36 heads' (E,)
// partials alone.
//
// Design: the bf16 body (namespace mk) is one cooperative launch of one
// block of 8 warps per SM that reads every weight byte once, in three
// phases separated by two grid barriers (over a count of arrivals in the
// workspace that only counts up; a block arrives, starts the next
// phase's loads that depend on nothing the grid writes, then waits):
//  (a) q = x @ Wq.  Wq is cut into units of 64 rows (E) by one head's
//      D columns; the units, head by head, are dealt to the blocks in
//      contiguous runs of equal length (floor(u * U / G)), so every SM
//      streams the same share whatever the shapes.  Warps 4-7 copy a
//      block's run, each unit with the matching 64 columns of x, into a
//      ring of kStages shared-memory stages by 16-byte cp.async (five
//      units, 80 KB, in flight), and warps 0-3 multiply, each stage
//      handed over by an mbarrier pair (full, empty), so a copying warp
//      that the memory system holds back never holds up the products.
//      The products run on the tensor cores with the weight on the M
//      side (mma.sync m16n8k16, A = a 16 x 16 tile of Wq^T by
//      ldmatrix.trans, B = x^T, the batch rows the n = 8 columns: up to
//      8 rows cost no more weight reads, and rows past 32 go round the
//      run again).  Where its run leaves a head a block writes its fp32
//      partial of that head's q, (B, D), to slot j = block - (first
//      block of the head).
//  (b) Attention, all 8 warps.  Items (batch row, KV head, 16 query rows
//      of the GQA group, key chunk): the group's query heads are the
//      rows of one tile, so a K/V tile is read once for all of them.  A
//      row's valid prefix is cut into n_chunks chunks of whole 64-key
//      tiles by lengths[b] on the card, as #4's split body cuts it, so
//      items past a row's length exit at once.  The item sums its heads'
//      q partials in slot order, rotates (RoPE at lengths[b] - 1, the
//      pairs d and d + D/2 in one thread, each frequency's sine and
//      cosine once an item), rounds q once to bf16, then walks its
//      tiles, double-buffered by cp.async (a block's first two tiles are
//      asked for between arriving at barrier (a) and leaving it): S =
//      q.K^T on the tensor cores (a warp per 8 keys), the online softmax
//      in fp32 (a warp per two rows), p rounded to bf16, P.V on the
//      tensor cores (a warp per 16 output dims).  Chunks write fp32 (m,
//      l, o) partials; the block that draws the last ticket of the (row,
//      KV head, row tile) merges them in chunk order and writes o / l
//      rounded to bf16 to O (B, Hq * Dv) in the workspace: a row with
//      l = 0 writes zeros.
//  (c) y = O @ Wo + residual, in (a)'s roles.  Wo is cut into units of 64
//      rows (Hq * Dv) by 128 columns (E) and dealt as in (a); the first
//      five units' weights of a block are asked for between arriving at
//      barrier (b) and leaving it.  A block writes its fp32 partial of
//      each 128-column tile it covers, takes a ticket weighted by its
//      units, and the block whose units complete the tile sums the
//      tile's partials in slot order, adds the residual in fp32 and
//      casts.  So every sum has a fixed order: the result is bitwise
//      repeatable, and the paged kernel, which differs only in where
//      phase (b) finds a key, equals the dense one bit for bit.
// All of it is a function of the shapes and the SM count
// (kernels/fused_decode_block.py decode_plan mirrors the partition and
// sizes the workspace); lengths are read only on the card.  A launch can
// stamp each block's clock at each phase's end (Args::trace,
// time_decode_block.py reads them).  Instantiated for D = Dv = 128
// (decode_mma_kernel_d128, paged_decode_mma_kernel_d128: the serve path)
// and for any even width up to 128 (*_any), chosen by the widths alone.
// fp32 inputs run the FMA body below (decode_block_kernel<float>), which
// the card tests hold to 1e-4: a dispatch on the dtype, not a fallback.
#include <algorithm>

#include "common.cuh"
#include "masked_mma.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The fp32 FMA body: one block per (batch row, head); the heads'
// (E,) partials summed in head order by the block that draws the row's
// last ticket.
// ---------------------------------------------------------------------------

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

template <typename KV>
int fma_launch(const float* x, const float* wq, const float* k,
               const float* v, const float* wo, const float* res,
               const int* lengths, rt::KVSource src, float* out,
               unsigned char* ws, long long ws_bytes, int B, int Hq, int Hkv,
               int E, int D, int Dv, float scale, float rope_theta,
               int use_rope, cudaStream_t stream) {
  // the workspace: (B, Hq, E) fp32 partials, then B ticket counters at
  // the next 256-byte boundary (kernels/fused_decode_block.py _fma_bytes)
  const long long part_bytes = ((long long)B * Hq * E * 4 + 255) / 256 * 256;
  if (part_bytes + 4LL * B > ws_bytes) return (int)cudaErrorInvalidValue;
  auto kern = decode_block_kernel<float, KV>;
  const int smem = (E + 3 * rt::kMaxD + kTileKD) * 4;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(B, Hq);
  kern<<<grid, kThreadsD, smem, stream>>>(
      x, wq, k, v, wo, res, lengths, src, out,
      reinterpret_cast<float*>(ws), reinterpret_cast<int*>(ws + part_bytes),
      Hq, Hkv, E, D, Dv, scale, rope_theta, use_rope);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 body: one persistent cooperative launch, three phases (see the
// notes at the head of the file).  A named namespace: its Args are the
// extern "C" kernels' parameter.
// ---------------------------------------------------------------------------
namespace mk {

using rt::mma::bf16;
namespace mm = rt::mma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;             // weight rows per unit
constexpr int kCW = 128;            // weight columns per unit, at most
constexpr int kWS = mm::kStride;    // weight and K/V tile row stride
constexpr int kRG = 32;             // batch rows per pass over a run
constexpr int kMaxNT = kRG / 8;     // n-tiles of 8 rows per pass
constexpr int kXS = kKC + 8;        // x / O tile row stride
constexpr int kStages = 6;          // ring of weight stages
constexpr int kWElems = kKC * kWS;
constexpr int kStageElems = kWElems + kRG * kXS;
constexpr int kRingBytes = kStages * kStageElems * 2;
// phase (b): 16 query rows, 64-key tiles
constexpr int kRows = 16;
constexpr int kBk = 64;
constexpr int kKVElems = kBk * kWS;
constexpr int kSS = kBk + 4;        // score tile row stride, floats
constexpr int kPS = kBk + 8;        // p tile row stride, bf16
constexpr int kAttnBytes = 4 * kKVElems * 2 + kRows * kWS * 2 +
                           kRows * kSS * 4 + kRows * kPS * 2;
constexpr int kSmemBytes = kRingBytes > kAttnBytes ? kRingBytes : kAttnBytes;
static_assert(kWarps * 8 == kBk, "a warp per 8 keys of a tile");
static_assert(kWarps * 16 == rt::kMaxD, "a warp per 16 output dims");
static_assert(kWarps * 2 == kRows, "a warp per two softmax rows");

// A weight split into units of kKC rows by one column tile, units
// numbered tile by tile, and dealt to G blocks in contiguous runs:
// block blk takes units [lo(blk), lo(blk + 1)).  A tile's units are
// covered by blocks owner(first) .. owner(last) of it; block blk writes
// its partial of the tile to slot blk - owner(first) of slots() (blocks
// in between whose run is empty write nothing and are skipped).
// In 32-bit arithmetic: the launch refuses U * (G + 1) >= 2^31.
struct Part {
  int U, G, K;  // units, blocks, units per tile
  __device__ __forceinline__ int lo(int blk) const {
    return (int)((unsigned)blk * U / (unsigned)G);
  }
  __device__ __forceinline__ int owner(int u) const {
    return (int)(((unsigned)(u + 1) * G - 1) / (unsigned)U);
  }
  __device__ __forceinline__ int slots() const {
    return min(G, (int)((unsigned)(K - 1) * G / (unsigned)U) + 2);
  }
};

struct Args {
  const bf16 *x, *wq, *k, *v, *wo, *res;
  const int* lengths;
  rt::KVSource src;
  bf16* out;
  unsigned long long* bar;  // grid barrier: arrivals, counting up
  int* tick_b;     // (B * Hkv * n_rt,) attention merge tickets
  int* tick_c;     // (n_rg, tiles_c) output tile tickets (units)
  float* qpart;    // (Hq, slots_a, B, D)
  float* opart;    // (B * Hkv * n_rt * n_chunks, kRows, Dv)
  float2* ml;      // (B * Hkv * n_rt * n_chunks, kRows)
  bf16* o;         // (B, Hq * Dv)
  float* ypart;    // (tiles_c, slots_c, B, kCW)
  unsigned long long* trace;  // nullable: (kStamps, G) globaltimer ns
  int B, Hq, Hkv, E, D, Dv, n_chunks;
  float scale, rope_theta;
  int use_rope;
  bool vec_x, vec_wq, vec_wo, vec_o, vec_kv;
};

// Byte offsets of the workspace's regions, each at a 256-byte boundary:
// the counters first (zero when the wrapper allocates the buffer, and
// left at zero by every launch), then the partials and O.  Mirrored by
// kernels/fused_decode_block.py decode_plan.
struct Layout {
  long long bar, tick_b, tick_c, qpart, opart, ml, o, ypart, total;
};

inline long long up256(long long x) { return (x + 255) / 256 * 256; }

inline Layout layout(int B, int Hq, int Hkv, int E, int D, int Dv, int G,
                     int n_chunks) {
  const int group = Hq / Hkv, n_rt = (group + kRows - 1) / kRows;
  const long long kc_a = (E + kKC - 1) / kKC, kc_c = ((long long)Hq * Dv + kKC - 1) / kKC;
  const long long tiles_c = (E + kCW - 1) / kCW, n_rg = (B + kRG - 1) / kRG;
  const long long ua = Hq * kc_a, uc = tiles_c * kc_c;
  const long long slots_a = std::min<long long>(G, (kc_a - 1) * G / ua + 2);
  const long long slots_c = std::min<long long>(G, (kc_c - 1) * G / uc + 2);
  const long long items = (long long)B * Hkv * n_rt * n_chunks;
  Layout L;
  long long at = 0;
  L.bar = at;    at = up256(at + 8);
  L.tick_b = at; at = up256(at + 4LL * B * Hkv * n_rt);
  L.tick_c = at; at = up256(at + 4LL * n_rg * tiles_c);
  L.qpart = at;  at = up256(at + 4LL * Hq * slots_a * B * D);
  L.opart = at;  at = up256(at + 4LL * items * kRows * Dv);
  L.ml = at;     at = up256(at + 8LL * items * kRows);
  L.o = at;      at = up256(at + 2LL * B * Hq * Dv);
  L.ypart = at;  at = up256(at + 4LL * tiles_c * slots_c * B * kCW);
  L.total = at;
  return L;
}

// A grid barrier in two halves: no block leaves grid_wait before every
// block has called grid_arrive, and what a block wrote before its
// grid_arrive is visible to every block after grid_wait; between the two
// a block may only start work that reads nothing the grid writes.  The
// workspace's 64-bit count of arrivals only counts up: a barrier is
// passed when it reaches the next multiple of the grid (one
// release-acquire atomic a block, then acquiring loads; at 2^64 arrivals
// it would wrap).  grid_arrive returns that multiple to thread 0.
__device__ __forceinline__ unsigned long long grid_arrive(
    unsigned long long* bar) {
  __syncthreads();
  unsigned long long old = 0;
  if (threadIdx.x == 0)
    asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], 1;\n"
                 : "=l"(old)
                 : "l"(bar)
                 : "memory");
  return (old / gridDim.x + 1) * gridDim.x;
}

__device__ __forceinline__ void grid_wait(const unsigned long long* bar,
                                          unsigned long long target) {
  if (threadIdx.x == 0) {
    unsigned long long now;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                   : "=l"(now)
                   : "l"(bar)
                   : "memory");
      if (now >= target) break;
      __nanosleep(20);
    }
  }
  __syncthreads();
}

// Where a traced launch stamps each block's globaltimer: the start, the
// end of phase (a), past barrier (a); in the block's first item of phase
// (b), q ready, its tiles done, its ticket drawn (zero where it has
// none); the end of phase (b), past barrier (b), the end.
constexpr int kStamps = 9;

__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.trace != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    a.trace[i * gridDim.x + blockIdx.x] = t;
  }
}

// The rows of an A fragment (16 m x 16 k) this lane hands ldmatrix.trans
// when the tile is stored k-major (rows = k, columns = m), as a weight
// tile is: matrix j = lane / 8 covers k 8 (j / 2).., m 8 (j % 2)...
__device__ __forceinline__ int at_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * kWS + ((lane >> 3) & 1) * 8;
}

// One skinny product out = in @ W over a Part: W (k_rows, n_cols)
// row-major, tile t its columns [t * tile_stride, + tile_w), in (B,
// k_rows) bf16 rows.
struct Gemv {
  const bf16* w;
  const bf16* in;
  int k_rows, n_cols, tile_w, tile_stride;
  bool vec_w, vec_in;
};

// Roles in phases (a) and (c): warps 0-3 multiply, warps 4-7 copy.  The
// copying warps stall whenever the memory system pushes back, and the
// multiplying ones go on meanwhile: a stage's data is announced by the
// full barrier, its reuse by the empty barrier (mbarriers in shared
// memory, one pair per stage).
constexpr int kConsumers = 128;
constexpr int kProducers = kThreads - kConsumers;
static_assert(kConsumers / 32 * 2 * 16 == kCW,
              "a multiplying warp per two 16-column m-tiles of a tile");
// full: per unit, each producer thread arrives twice (once releasing its
// plain stores, once when its cp.async copies land); empty: each
// consumer warp once
constexpr int kFullCount = 2 * kProducers;
constexpr int kEmptyCount = kConsumers / 32;

struct Ring {
  bf16* smem;
  uint64_t* full;
  uint64_t* empty;
  int g;  // units through the ring so far in this launch, both roles
};

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   mm::smem_u32(b)),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   mm::smem_u32(b))
               : "memory");
}
// Arrives when this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_cp(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   mm::smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(mm::smem_u32(b)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ bf16* stage_w(const Ring& r, int s) {
  return r.smem + s * kStageElems;
}
__device__ __forceinline__ bf16* stage_x(const Ring& r, int s) {
  return r.smem + s * kStageElems + kWElems;
}

__device__ __forceinline__ int tile_cols(const Gemv& g, int t) {
  return min(g.tile_w, g.n_cols - t * g.tile_stride);
}

// Unit u's weight tile into dst (stride kWS, columns zero-filled to the
// 16-wide step, rows past k_rows zeros), by producer thread pt of
// kProducers: 16-byte cp.async copies where vec_w, else plain loads.
__device__ __forceinline__ void load_w(const Gemv& g, const Part& p, int u,
                                       bf16* dst, int pt) {
  const int t = u / p.K, r0 = (u - t * p.K) * kKC;
  const int w = tile_cols(g, t), wp = (w + 15) & ~15;
  const bf16* src = g.w + (int64_t)t * g.tile_stride;
  if (g.vec_w) {
    const int cpr = wp >> 3;
    for (int i = pt; i < kKC * cpr; i += kProducers) {
      const int j = i / cpr, c = (i - j * cpr) * 8;
      const bool ok = r0 + j < g.k_rows && c < w;
      mm::cp_async16(dst + j * kWS + c,
                     ok ? src + (int64_t)(r0 + j) * g.n_cols + c : src, ok);
    }
  } else {
    for (int i = pt; i < kKC * wp; i += kProducers) {
      const int j = i / wp, c = i - j * wp;
      dst[j * kWS + c] = r0 + j < g.k_rows && c < w
                             ? src[(int64_t)(r0 + j) * g.n_cols + c]
                             : __float2bfloat16(0.f);
    }
  }
}

// The unit's kKC columns of the pass's input rows [r0, r0 + 8 ntc), the
// n-tiles it multiplies; rows past B and columns past k_rows are zeros.
__device__ __forceinline__ void load_x(const Gemv& g, const Part& p, int u,
                                       int r0, int ntc, int B, bf16* dst,
                                       int pt) {
  const int c0 = (u % p.K) * kKC, nc = min(kKC, g.k_rows - c0);
  const bf16* src = g.in + c0;
  if (g.vec_in) {
    for (int i = pt; i < ntc * 8 * (kKC / 8); i += kProducers) {
      const int j = i / (kKC / 8), c = (i % (kKC / 8)) * 8;
      const bool ok = r0 + j < B && c < nc;
      mm::cp_async16(dst + j * kXS + c,
                     ok ? src + (int64_t)(r0 + j) * g.k_rows + c : src, ok);
    }
  } else {
    for (int i = pt; i < ntc * 8 * kKC; i += kProducers) {
      const int j = i / kKC, c = i % kKC;
      dst[j * kXS + c] = r0 + j < B && c < nc
                             ? src[(int64_t)(r0 + j) * g.k_rows + c]
                             : __float2bfloat16(0.f);
    }
  }
}

// The weight parts of the first kStages - 1 units of this block's run of
// p, by the producer warps (phase (c)'s, requested before its inputs
// exist); gemv_phase then adds their inputs.
__device__ __forceinline__ void prefetch_w(const Gemv& g, const Part& p,
                                           const Ring& r) {
  if ((int)threadIdx.x < kConsumers) return;
  const int pt = threadIdx.x - kConsumers;
  const int u0 = p.lo(blockIdx.x), u1 = p.lo(blockIdx.x + 1);
#pragma unroll 1
  for (int i = 0; i < kStages - 1 && u0 + i < u1; ++i) {
    const int gi = r.g + i, s = gi % kStages;
    if (gi >= kStages) mbar_wait(r.empty + s, (gi / kStages - 1) & 1);
    load_w(g, p, u0 + i, stage_w(r, s), pt);
  }
}

// Among the consumer warps only.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Phase (a) (kOutput false: each tile's partial to qpart) or (c) (true:
// to ypart, then the tile's ticket, and the tile's sum, residual and
// output by the block that completes it).  `prefetched`: prefetch_w has
// issued the weight parts of the first stages of the first pass.
template <bool kOutput>
__device__ void gemv_phase(const Gemv& g, const Part& p, const Args& a,
                           Ring& ring, float* part, int part_w,
                           bool prefetched) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int blk = blockIdx.x, B = a.B;
  const int u0 = p.lo(blk), u1 = p.lo(blk + 1), n = u1 - u0;
  const int S = p.slots();
  const bool producer = tid >= kConsumers;
  for (int r0 = 0; r0 < B; r0 += kRG) {
    const int ntc = min(kMaxNT, (B - r0 + 7) / 8);
    if (producer) {
      const int pt = tid - kConsumers;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const int gi = ring.g + i, s = gi % kStages;
        if (!(prefetched && r0 == 0 && i < kStages - 1)) {
          if (gi >= kStages) mbar_wait(ring.empty + s, (gi / kStages - 1) & 1);
          load_w(g, p, u0 + i, stage_w(ring, s), pt);
        }
        load_x(g, p, u0 + i, r0, ntc, B, stage_x(ring, s), pt);
        mbar_arrive(ring.full + s);
        mbar_arrive_cp(ring.full + s);
      }
      ring.g += n;
      continue;
    }
    // consumers: warp takes the tile's m-tiles warp and warp + 4
    float acc[2][kMaxNT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int gi = ring.g + i, s = gi % kStages;
      mbar_wait(ring.full + s, (gi / kStages) & 1);
      const int u = u0 + i, t = u / p.K;
      const int wcols = tile_cols(g, t);
      const bf16* ws = stage_w(ring, s);
      const bf16* xs = stage_x(ring, s);
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        uint32_t bx[kMaxNT][2];
#pragma unroll
        for (int nt = 0; nt < kMaxNT; ++nt) {
          if (nt < ntc) {
            const bf16* xr = xs + (nt * 8 + gid) * kXS + ks * 16 + 2 * tig;
            bx[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
            bx[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int mt = warp + 4 * m;
          if (mt * 16 >= wcols) continue;
          uint32_t af[4];
          mm::ldsm_x4_t(af, ws + ks * 16 * kWS + mt * 16 + at_off(lane));
#pragma unroll
          for (int nt = 0; nt < kMaxNT; ++nt)
            if (nt < ntc) mm::mma_bf16(acc[m][nt], af, bx[nt][0], bx[nt][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty + s);
      if (u + 1 < u1 && (u + 1) / p.K == t) continue;
      // this block's share of tile t ends here: its partial to slot j
      const int j = blk - p.owner(t * p.K);
      float* dst = part + ((int64_t)t * S + j) * B * part_w;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int col = (warp + 4 * m) * 16 + gid;
#pragma unroll
        for (int nt = 0; nt < kMaxNT; ++nt) {
          if (nt >= ntc) continue;
          const int row = r0 + nt * 8 + 2 * tig;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = row + (e & 1), cc = col + ((e >> 1) << 3);
            if (rr < B && cc < wcols)
              dst[(int64_t)rr * part_w + cc] = acc[m][nt][e];
            acc[m][nt][e] = 0.f;
          }
        }
      }
      if constexpr (kOutput) {
        // the tile's ticket, weighted by this block's units of it
        __shared__ int last_s;
        const int first = max(u0, t * p.K);
        __threadfence();
        consumers_sync();
        if (tid == 0) {
          int* tk = a.tick_c + (r0 / kRG) * ((a.E + kCW - 1) / kCW) + t;
          const int mine = u + 1 - first;
          last_s = atomicAdd(tk, mine) + mine == p.K;
          if (last_s) *tk = 0;  // reusable as it stands
        }
        consumers_sync();
        if (last_s) {
          // the tile is complete: its slots summed in order, eight
          // elements a thread a round so their loads fly together
          __threadfence();
          const int b0 = p.owner(t * p.K), b1 = p.owner(t * p.K + p.K - 1);
          const int nr = min(kRG, B - r0), c0 = t * g.tile_stride;
          const int total = nr * wcols;
          const float* src = part + ((int64_t)t * S * B + r0) * part_w;
#pragma unroll 1
          for (int base = 0; base < total; base += 8 * kConsumers) {
            float y[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) y[e] = 0.f;
            int off[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int idx = base + tid + e * kConsumers;
              const int rr = idx / wcols;
              off[e] = idx < total ? rr * part_w + idx - rr * wcols : -1;
            }
#pragma unroll 4
            for (int bb = b0; bb <= b1; ++bb) {
              const bool has = p.lo(bb) != p.lo(bb + 1);  // else empty
              const float* sp = src + (int64_t)(bb - b0) * B * part_w;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                y[e] += has && off[e] >= 0 ? __ldcg(sp + off[e]) : 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int idx = base + tid + e * kConsumers;
              if (idx < total) {
                const int rr = idx / wcols, cc = idx - rr * wcols;
                const int64_t at = (int64_t)(r0 + rr) * a.E + c0 + cc;
                a.out[at] =
                    __float2bfloat16_rn(__bfloat162float(a.res[at]) + y[e]);
              }
            }
          }
        }
      }
    }
    ring.g += n;
  }
  __syncthreads();
}

template <int kD, typename KV>
__device__ void body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_s[kStages], empty_s[kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_s + s, kFullCount);
      mbar_init(empty_s + s, kEmptyCount);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring{reinterpret_cast<bf16*>(smem_raw), full_s, empty_s, 0};
  // phase (b)'s tiles share the ring's memory (never in use together)
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);        // two buffers
  bf16* v_s = k_s + 2 * kKVElems;                        // two buffers
  bf16* q_s = v_s + 2 * kKVElems;                        // (kRows, kWS)
  float* s_s = reinterpret_cast<float*>(q_s + kRows * kWS);  // (kRows, kSS)
  bf16* p_s = reinterpret_cast<bf16*>(s_s + kRows * kSS);    // (kRows, kPS)
  __shared__ float alpha_s[kRows];
  __shared__ float2 rope_s[rt::kMaxD / 2];  // (cos, sin) per frequency
  __shared__ float l_s[kRows];
  __shared__ int last_s;
  __shared__ rt::PagedScratch<kBk> scratch;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = gridDim.x, B = a.B, Hq = a.Hq, Hkv = a.Hkv, E = a.E;
  const int D = kD ? kD : a.D, Dv = kD ? kD : a.Dv;
  const int Dp = (D + 15) & ~15, Dvp = (Dv + 15) & ~15;

  // -- (a) q = x @ Wq --------------------------------------------------------
  const int kc_a = (E + kKC - 1) / kKC;
  const Part pa{Hq * kc_a, G, kc_a};
  const Gemv ga{a.wq, a.x, E, Hq * D, D, D, a.vec_wq, a.vec_x};
  const int group = Hq / Hkv, n_rt = (group + kRows - 1) / kRows;
  const int NC = a.n_chunks;
  const int n_items = B * Hkv * n_rt * NC;
  // the length of phase (b)'s first item's row, read while (a) streams
  const int len_first = (int)blockIdx.x < n_items
                            ? a.lengths[(int)blockIdx.x / (NC * n_rt * Hkv)]
                            : 0;
  stamp(a, 0);
  gemv_phase<false>(ga, pa, a, ring, a.qpart, D, false);
  stamp(a, 1);
  const int kc_c = (Hq * Dv + kKC - 1) / kKC;
  const Part pc{((E + kCW - 1) / kCW) * kc_c, G, kc_c};
  const Gemv gc{a.wo, a.o, Hq * Dv, E, kCW, kCW, a.vec_wo, a.vec_o};

  // -- (b) attention ---------------------------------------------------------
  const int Sa = pa.slots();
  struct Item {
    int b, kvh, rt, c, len, t0, t1, tpc, nt, n, bkr;
  };
  // item i: chunk c = i % NC of the 16-row tile rt of (b, kvh), chunk
  // fastest; a row's nt tiles in chunks of ceil(nt / NC) whole tiles
  auto item_of = [&](int i, int len) {
    Item r;
    r.c = i % NC;
    r.bkr = i / NC;  // (b * Hkv + kvh) * n_rt + rt
    r.rt = r.bkr % n_rt;
    const int bk = r.bkr / n_rt;
    r.kvh = bk % Hkv;
    r.b = bk / Hkv;
    r.len = max(0, min(len, a.src.skv));
    r.nt = (r.len + kBk - 1) / kBk;
    r.tpc = (r.nt + NC - 1) / NC;
    r.t0 = r.c * r.tpc;
    r.t1 = min(r.nt, r.t0 + r.tpc);
    r.n = min(kRows, group - r.rt * kRows);
    return r;
  };
  KV kv{};
  auto load_kv = [&](const Item& it, int t, int buf) {
    const int j0 = t * kBk, nk = min(kBk, it.len - j0);
    kv.stage(j0, nk);
    if (KV::kStaged) __syncthreads();
    rt::load_keys<bf16, kBk, kThreads>(k_s + buf * kKVElems, a.k, kv, j0, nk,
                                       D, Dp, a.vec_kv);
    rt::load_keys<bf16, kBk, kThreads>(v_s + buf * kKVElems, a.v, kv, j0, nk,
                                       Dv, Dvp, a.vec_kv);
  };
  Item it{};
  int loaded = 0;  // the tiles of the item asked for so far end here
  const unsigned long long pass_a = grid_arrive(a.bar);
  if ((int)blockIdx.x < n_items) {
    // the first item's first two tiles fly while the grid meets
    it = item_of(blockIdx.x, len_first);
    kv = KV::make(a.src, it.b, it.kvh, Hkv, scratch);
    for (loaded = it.t0; loaded < min(it.t1, it.t0 + 2); ++loaded) {
      load_kv(it, loaded, loaded - it.t0);
      mm::cp_async_commit();
    }
  }
  mm::cp_async_commit();
  grid_wait(a.bar, pass_a);
  stamp(a, 2);

#pragma unroll 1
  for (int item = blockIdx.x; item < n_items; item += G) {
    if (item != (int)blockIdx.x) {
      it = item_of(item, a.lengths[item / (NC * n_rt * Hkv)]);
      kv = KV::make(a.src, it.b, it.kvh, Hkv, scratch);
      loaded = it.t0;
      if (it.t0 < it.t1) load_kv(it, loaded++, 0);
      mm::cp_async_commit();
    }
    const int b = it.b, n = it.n;
    const int h0 = it.kvh * group + it.rt * kRows;  // the tile's first head
    const int slot0 = (it.bkr * NC + it.c) * kRows;
    if (it.t0 < it.t1) {
      // q of the tile's heads: the slots' partials summed in order,
      // rotated, rounded once.  Thread (row tid / 16) takes the pairs
      // (d, d + D/2), d = tid % 16 + 16 i, so a round's loads fly together
      {
        const int r = tid >> 4, half = D / 2;
        float q0[4] = {0.f, 0.f, 0.f, 0.f}, q1[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < n) {
          const int h = h0 + r;
          const int f0 = pa.owner(h * pa.K), f1 = pa.owner(h * pa.K + pa.K - 1);
          const float* src = a.qpart + ((int64_t)h * Sa * B + b) * D;
          // two slots a round: their loads fly together, the sum
          // keeps slot order (a block with an empty run wrote nothing)
#pragma unroll 1
          for (int bb = f0; bb <= f1; bb += 2) {
            const bool has0 = pa.lo(bb) != pa.lo(bb + 1);
            const bool has1 = bb + 1 <= f1 && pa.lo(bb + 1) != pa.lo(bb + 2);
            const float* sp = src + (int64_t)(bb - f0) * B * D;
            const float* sp1 = sp + (int64_t)B * D;
            float v0[4], v1[4], w0[4], w1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int d = (tid & 15) + 16 * i;
              const bool ok = d < half;
              v0[i] = ok && has0 ? __ldcg(sp + d) : 0.f;
              v1[i] = ok && has0 ? __ldcg(sp + d + half) : 0.f;
              w0[i] = ok && has1 ? __ldcg(sp1 + d) : 0.f;
              w1[i] = ok && has1 ? __ldcg(sp1 + d + half) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              q0[i] = (q0[i] + v0[i]) + w0[i];
              q1[i] = (q1[i] + v1[i]) + w1[i];
            }
          }
        }
        // the item's one position lengths[b] - 1: each frequency's
        // rotation once, while the loads above land
        if (a.use_rope && tid < half) {
          const float freq =
              expf((float)tid * (-logf(a.rope_theta) / (float)half));
          float sn, cs;
          sincosf((float)(it.len - 1) * freq, &sn, &cs);
          rope_s[tid] = make_float2(cs, sn);
        }
        __syncthreads();
        bf16* qr = q_s + r * kWS;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = (tid & 15) + 16 * i;
          if (d >= half) continue;
          float lo = q0[i], hi = q1[i];
          if (a.use_rope) {
            const float2 cs = rope_s[d];
            lo = q0[i] * cs.x - q1[i] * cs.y;
            hi = q1[i] * cs.x + q0[i] * cs.y;
          }
          qr[d] = __float2bfloat16_rn(lo);
          qr[d + half] = __float2bfloat16_rn(hi);
        }
        const int pad = Dp - D, pw = max(pad, 1);  // zeros to the step
        for (int idx = tid; idx < kRows * pad; idx += kThreads)
          q_s[(idx / pw) * kWS + D + idx % pw] = __float2bfloat16(0.f);
      }
      __syncthreads();
      if (item == (int)blockIdx.x) stamp(a, 3);
      uint32_t qa[rt::kMaxD / 16][4];
#pragma unroll
      for (int ks = 0; ks < rt::kMaxD / 16; ++ks)
        if (ks * 16 < Dp) mm::ldsm_x4(qa[ks], q_s + ks * 16 + mm::a_off(lane));
      float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
      float oacc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;

#pragma unroll 1
      for (int t = it.t0; t < it.t1; ++t) {
        const int buf = (t - it.t0) & 1;
        if (t + 1 < it.t1 && loaded == t + 1) load_kv(it, loaded++, buf ^ 1);
        mm::cp_async_commit();
        mm::cp_async_wait<1>();  // tile t has landed
        __syncthreads();
        const int j0 = t * kBk, nk = min(kBk, it.len - j0);
        const bf16* ks_ = k_s + buf * kKVElems;
        const bf16* vs_ = v_s + buf * kKVElems;
        // S: warp takes keys 8 warp .. + 7, two 16-deep steps a load
        {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          const bf16* kr = ks_ + (warp * 8 + (lane & 7)) * kWS + (lane >> 3) * 8;
#pragma unroll
          for (int ks = 0; ks < rt::kMaxD / 16; ks += 2) {
            if (ks * 16 >= Dp) break;
            uint32_t r[4];
            mm::ldsm_x4(r, kr + ks * 16);
            mm::mma_bf16(s, qa[ks], r[0], r[1]);
            if ((ks + 1) * 16 < Dp) mm::mma_bf16(s, qa[ks + 1], r[2], r[3]);
          }
          *reinterpret_cast<float2*>(s_s + gid * kSS + warp * 8 + 2 * tig) =
              make_float2(s[0], s[1]);
          *reinterpret_cast<float2*>(s_s + (gid + 8) * kSS + warp * 8 +
                                     2 * tig) = make_float2(s[2], s[3]);
        }
        __syncthreads();
        // online softmax: warp takes rows warp and warp + 8
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp + 8 * i;
          if (r >= n) {
            p_s[r * kPS + lane] = __float2bfloat16(0.f);
            p_s[r * kPS + lane + 32] = __float2bfloat16(0.f);
            if (lane == 0) alpha_s[r] = 0.f;
            continue;
          }
          float sv[2];
          bool ok[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int jj = lane + 32 * cc;
            ok[cc] = jj < nk;
            sv[cc] = ok[cc] ? s_s[r * kSS + jj] * a.scale : rt::kNegInf;
          }
          const float m_new = fmaxf(m[i], rt::warp_max(fmaxf(sv[0], sv[1])));
          const float alpha = expf(m[i] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float pv = ok[cc] ? expf(sv[cc] - m_new) : 0.f;
            psum += pv;  // l sums p unrounded
            p_s[r * kPS + lane + 32 * cc] = __float2bfloat16_rn(pv);
          }
          l[i] = l[i] * alpha + rt::warp_sum(psum);
          m[i] = m_new;
          if (lane == 0) alpha_s[r] = alpha;
        }
        __syncthreads();
        // P.V: warp takes output dims 16 warp .. + 15
        if (warp * 16 < Dvp) {
          const float a0 = alpha_s[gid], a1 = alpha_s[gid + 8];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            oacc[nt][0] *= a0, oacc[nt][1] *= a0;
            oacc[nt][2] *= a1, oacc[nt][3] *= a1;
          }
#pragma unroll
          for (int ks = 0; ks < kBk / 16; ++ks) {
            uint32_t pf[4], vf[4];
            mm::ldsm_x4(pf, p_s + (lane & 15) * kPS + (lane >> 4) * 8 + ks * 16);
            mm::ldsm_x4_t(vf, vs_ + ks * 16 * kWS + warp * 16 + mm::bk_off(lane));
            mm::mma_bf16(oacc[0], pf, vf[0], vf[1]);
            mm::mma_bf16(oacc[1], pf, vf[2], vf[3]);
          }
        }
        __syncthreads();  // tile t consumed before its buffers are reused
      }
      mm::cp_async_wait<0>();
      if (item == (int)blockIdx.x) stamp(a, 4);
      // this chunk's partial: o unnormalized, then (m, l) per row
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = gid + ((e >> 1) << 3);
          const int d = warp * 16 + nt * 8 + 2 * tig + (e & 1);
          if (r < n && d < Dv)
            a.opart[((int64_t)slot0 + r) * Dv + d] = oacc[nt][e];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp + 8 * i;
          if (r < n) a.ml[slot0 + r] = make_float2(m[i], l[i]);
        }
      }
    } else {
      mm::cp_async_wait<0>();
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_s = atomicAdd(a.tick_b + it.bkr, 1) == NC - 1;
      if (last_s) a.tick_b[it.bkr] = 0;  // reusable as it stands
    }
    __syncthreads();
    if (item == (int)blockIdx.x) stamp(a, 5);
    if (last_s) {
      __threadfence();
      // merge the live chunks in chunk order (#4's split body's merge):
      // weights exp(m_c - max) in the K buffers, idle now
      const int nc = it.tpc > 0 ? (it.nt + it.tpc - 1) / it.tpc : 0;
      float* w_s = reinterpret_cast<float*>(k_s);  // (kRows, nc)
      const int base = it.bkr * NC * kRows;        // chunk 0, row 0
      for (int r = warp; r < n; r += kWarps) {
        // lane takes chunks lane, lane + 32, ...: the first (m, l) stays
        // in registers, so up to 32 chunks cost one round of loads
        const float2 first = lane < nc ? __ldcg(a.ml + base + lane * kRows + r)
                                       : make_float2(rt::kNegInf, 0.f);
        float mx = first.x;
        for (int cc = lane + 32; cc < nc; cc += 32)
          mx = fmaxf(mx, __ldcg(&a.ml[base + cc * kRows + r].x));
        mx = rt::warp_max(mx);
        float lsum = 0.f;
        for (int cc = lane; cc < nc; cc += 32) {
          const float2 v = cc == lane ? first
                                      : __ldcg(a.ml + base + cc * kRows + r);
          const float w = expf(v.x - mx);
          w_s[r * nc + cc] = w;
          lsum = fmaf(v.y, w, lsum);
        }
        lsum = rt::warp_sum(lsum);
        if (lane == 0) l_s[r] = lsum == 0.f ? 1.f : lsum;
      }
      __syncthreads();
      // a thread's eight elements (n * Dv <= kRows * kMaxD = 8 * kThreads)
      // take their chunks' loads together, chunk by chunk
      float o[8];
      int row[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = 0.f, row[e] = (tid + e * kThreads) / Dv;
#pragma unroll 4
      for (int cc = 0; cc < nc; ++cc) {
        const float* po = a.opart + ((int64_t)base + cc * kRows) * Dv;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = tid + e * kThreads;
          if (idx < n * Dv)
            o[e] = fmaf(__ldcg(po + idx), w_s[row[e] * nc + cc], o[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = tid + e * kThreads;
        if (idx < n * Dv)
          a.o[((int64_t)b * Hq + h0 + row[e]) * Dv + idx - row[e] * Dv] =
              __float2bfloat16_rn(o[e] / l_s[row[e]]);
      }
    }
    __syncthreads();  // the buffers are free for the next item
  }
  mm::cp_async_wait<0>();
  __syncthreads();
  stamp(a, 6);

  // -- (c) out = residual + O @ Wo ---------------------------------------------
  const unsigned long long pass_b = grid_arrive(a.bar);
  prefetch_w(gc, pc, ring);  // flies while the grid meets
  grid_wait(a.bar, pass_b);
  stamp(a, 7);
  gemv_phase<true>(gc, pc, a, ring, a.ypart, kCW, true);
  stamp(a, 8);
}

template <int kD, typename KV>
int launch(const void* kern, Args a, unsigned char* ws, long long ws_bytes,
           int G, cudaStream_t stream) {
  const Layout L = layout(a.B, a.Hq, a.Hkv, a.E, a.D, a.Dv, G, a.n_chunks);
  const long long units = std::max<long long>(
      (long long)a.Hq * ((a.E + kKC - 1) / kKC),
      (long long)((a.E + kCW - 1) / kCW) * ((a.Hq * a.Dv + kKC - 1) / kKC));
  if (L.total > ws_bytes || G < 1 || a.n_chunks < 1 ||
      units * (G + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.bar = reinterpret_cast<unsigned long long*>(ws + L.bar);
  a.tick_b = reinterpret_cast<int*>(ws + L.tick_b);
  a.tick_c = reinterpret_cast<int*>(ws + L.tick_c);
  a.qpart = reinterpret_cast<float*>(ws + L.qpart);
  a.opart = reinterpret_cast<float*>(ws + L.opart);
  a.ml = reinterpret_cast<float2*>(ws + L.ml);
  a.o = reinterpret_cast<bf16*>(ws + L.o);
  a.ypart = reinterpret_cast<float*>(ws + L.ypart);
  a.vec_o = (a.Hq * a.Dv) % 8 == 0;
  // once per instantiation: the shared memory above 48 KB, and that one
  // block fits an SM (the cooperative launch refuses a grid that cannot
  // be resident at once)
  static int occupancy = -1;
  if (occupancy < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    occupancy = n;
  }
  if (occupancy < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(G), dim3(kThreads), params, kSmemBytes, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace mk

// full: the D = Dv = 128 instantiation, else any width up to 128.
#define DECODE_KERNEL(name, full, KV)                                      \
  extern "C" __global__ void __launch_bounds__(mk::kThreads, 1)            \
      name(const mk::Args a) {                                             \
    mk::body<(full) ? 128 : 0, KV>(a);                                     \
  }
#define DECODE_MMA_KERNEL(name, full) DECODE_KERNEL(name, full, rt::DenseKV)
#define PAGED_DECODE_MMA_KERNEL(name, full) \
  DECODE_KERNEL(name, full, rt::PagedKV)
DECODE_MMA_KERNEL(decode_mma_kernel_d128, true)
DECODE_MMA_KERNEL(decode_mma_kernel_any, false)
PAGED_DECODE_MMA_KERNEL(paged_decode_mma_kernel_d128, true)
PAGED_DECODE_MMA_KERNEL(paged_decode_mma_kernel_any, false)
#undef PAGED_DECODE_MMA_KERNEL
#undef DECODE_MMA_KERNEL
#undef DECODE_KERNEL

namespace {

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename KV>
int run(int dtype, const void* x, const void* wq, const void* k,
        const void* v, const void* wo, const void* res, const int* lengths,
        rt::KVSource src, void* out, void* ws, long long ws_bytes, int B,
        int Hq, int Hkv, int E, int D, int Dv, float scale, float rope_theta,
        int use_rope, int n_blocks, int n_chunks, void* trace, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* wsb = static_cast<unsigned char*>(ws);
  if (dtype == rt::kF32)
    return fma_launch<KV>(
        static_cast<const float*>(x), static_cast<const float*>(wq),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(wo), static_cast<const float*>(res),
        lengths, src, static_cast<float*>(out), wsb, ws_bytes, B, Hq, Hkv, E,
        D, Dv, scale, rope_theta, use_rope, s);
  if (dtype != rt::kBF16) return (int)cudaErrorInvalidValue;
  mk::Args a{};
  a.x = static_cast<const mk::bf16*>(x);
  a.wq = static_cast<const mk::bf16*>(wq);
  a.k = static_cast<const mk::bf16*>(k);
  a.v = static_cast<const mk::bf16*>(v);
  a.wo = static_cast<const mk::bf16*>(wo);
  a.res = static_cast<const mk::bf16*>(res);
  a.lengths = lengths;
  a.src = src;
  a.out = static_cast<mk::bf16*>(out);
  a.B = B, a.Hq = Hq, a.Hkv = Hkv, a.E = E, a.D = D, a.Dv = Dv;
  a.n_chunks = n_chunks;
  a.trace = static_cast<unsigned long long*>(trace);
  a.scale = scale, a.rope_theta = rope_theta, a.use_rope = use_rope;
  a.vec_x = E % 8 == 0 && aligned16(x);
  a.vec_wq = D % 8 == 0 && aligned16(wq);
  a.vec_wo = E % 8 == 0 && aligned16(wo);
  a.vec_kv = D % 8 == 0 && Dv % 8 == 0 && aligned16(k) && aligned16(v);
  const bool dense = KV::kStaged == false;
  const bool d128 = D == 128 && Dv == 128;
  const void* kern =
      dense ? (d128 ? (const void*)decode_mma_kernel_d128
                    : (const void*)decode_mma_kernel_any)
            : (d128 ? (const void*)paged_decode_mma_kernel_d128
                    : (const void*)paged_decode_mma_kernel_any);
  return d128 ? mk::launch<128, KV>(kern, a, wsb, ws_bytes, n_blocks, s)
              : mk::launch<0, KV>(kern, a, wsb, ws_bytes, n_blocks, s);
}

}  // namespace

extern "C" int fused_decode_block_launch(
    const void* x, const void* wq, const void* k, const void* v,
    const void* wo, const void* res, const int* lengths, void* out, void* ws,
    long long ws_bytes, int B, int Hq, int Hkv, int Skv, int E, int D, int Dv,
    float scale, float rope_theta, int use_rope, int dtype, int n_blocks,
    int n_chunks, void* trace, void* stream) {
  return run<rt::DenseKV>(dtype, x, wq, k, v, wo, res, lengths,
                          rt::KVSource{nullptr, 0, 0, Skv}, out, ws, ws_bytes,
                          B, Hq, Hkv, E, D, Dv, scale, rope_theta, use_rope,
                          n_blocks, n_chunks, trace, stream);
}

extern "C" int fused_decode_block_paged_launch(
    const void* x, const void* wq, const void* k_pool, const void* v_pool,
    const void* wo, const void* res, const int* lengths,
    const int* block_tables, void* out, void* ws, long long ws_bytes, int B,
    int Hq, int Hkv, int max_pages, int page, int E, int D, int Dv,
    float scale, float rope_theta, int use_rope, int dtype, int n_blocks,
    int n_chunks, void* trace, void* stream) {
  rt::KVSource src;
  if (!rt::paged_source(block_tables, max_pages, page, &src))
    return (int)cudaErrorInvalidValue;
  return run<rt::PagedKV>(dtype, x, wq, k_pool, v_pool, wo, res, lengths, src,
                          out, ws, ws_bytes, B, Hq, Hkv, E, D, Dv, scale,
                          rope_theta, use_rope, n_blocks, n_chunks, trace,
                          stream);
}
