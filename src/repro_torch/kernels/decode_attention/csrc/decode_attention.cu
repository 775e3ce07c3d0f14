// One-token GQA flash-decode for Hopper (sm_90a), bf16 in and out, fp32
// softmax statistics and accumulation. One source, two entry points that
// share the whole body and differ only in how a key position is addressed:
//
//   decode_attention_bf16        dense cache (B, Skv, Hkv, hd)
//   paged_decode_attention_bf16  page pool (P, ps, Hkv, hd) + table (B, NP)
//
// Replaces the Pallas TPU kernels repro/kernels/decode_attention/kernel.py
// decode_attention_pallas (_decode_kernel) and paged_decode_attention_pallas
// (_paged_decode_kernel): online-softmax attention of the G query heads of
// one KV head over the slot's first kv_len cache positions, tanh softcap,
// output in q's dtype. Both wrappers' clamps are applied here per slot:
// kv_len is clamped to the cache's capacity (Skv, or NP·ps), and the paged
// entry visits only pages holding admitted positions and clips each table
// entry it reads to [0, P-1] (the reference's tail clamp rewrites the table
// past the last occupied page; those pages are never visited here, so the
// rewrite is not needed). A slot with kv_len <= 0 outputs 0 (the jnp oracle
// would output the mean of V there; no caller passes it: kv_len = pos + 1).
//
// What bounds it on an H100: bytes. Each admitted position moves 2·Hkv·hd·2
// bytes of K and V for 4·G·hd operations per KV head, far below the ~295
// operations a byte the tensor cores need, so the design is about keeping
// enough bytes in flight and reading each one once:
//   * the G query heads of a KV head (G <= 16) are the 16 rows of an
//     mma.sync m16n8k16 tile (rows past G are zero), so K and V are read
//     once for all G heads and S = Q·Kᵀ and O += P·V run on the tensor
//     cores with fp32 accumulation (P rounded to bf16, as in the prefill
//     kernel);
//   * the TPU grid walks the KV axis sequentially with the carry in VMEM;
//     here the KV axis is split across blocks (flash-decoding): block
//     (split, b·Hkv + kvh) owns `chunk` positions, its 4 warps take 16 keys
//     each of every 64-key tile, and the block's warps are merged in shared
//     memory at the end. With more than one split, each block writes its
//     normalised partial output and log-sum-exp in fp32 and a second, small
//     pass merges the splits, one block per (slot, query head) (blocks whose
//     chunk starts past kv_len exit at once and are skipped by the merge);
//   * K/V tiles stream through a two-stage cp.async ring in shared memory
//     (16-byte copies, zero-filled past kv_len so no garbage enters P·V),
//     so the next tile's loads are in flight while this one is multiplied;
//   * keys are addressed through a row functor: dense row b·Skv + pos, or
//     paged row table[b, pos / ps]·ps + pos % ps; one head's row inside a
//     page is strided by Hkv·hd, read in place (no densify, no transpose).
// The split count is the host's choice (ops.py): enough blocks to cover
// the card about eight times over.

#include <math.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BK = 64;       // keys per block tile, 16 per warp
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MROWS = 16;    // query-head rows of the mma tile (G <= 16)
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_SPLITS = 1024;
constexpr float NEG_INF = -1.0e30f;

// cache row of (b, pos) in a (rows, Hkv, hd) view of the cache
struct DenseRows {
  int Skv;
  __device__ __forceinline__ size_t operator()(int b, int pos) const {
    return static_cast<size_t>(b) * Skv + pos;
  }
};

struct PagedRows {
  const int* table;  // (B, NP)
  int NP, ps, P;
  __device__ __forceinline__ size_t operator()(int b, int pos) const {
    const int page = min(max(table[static_cast<size_t>(b) * NP + pos / ps], 0), P - 1);
    return static_cast<size_t>(page) * ps + pos % ps;
  }
};

struct Params {
  const __nv_bfloat16* q;  // (B, H, hd)
  const __nv_bfloat16* k;  // cache or pool
  const __nv_bfloat16* v;
  const int* kv_len;       // (B,)
  __nv_bfloat16* o;        // (B, H, hd)
  float* o_part;           // (B·Hkv, splits, G, hd), splits > 1 only
  float* lse;              // (B·Hkv, splits, G), splits > 1 only
  int H, Hkv, G, cap, chunk, splits;
  float scale, softcap;
};

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  // two K and two V stages, the Q tile, and per-warp row max / sum
  return (4 * BK + MROWS) * (HD + 8) * 2 + 2 * NWARPS * MROWS * 4;
}

template <int HD, class Rows>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(Params p, Rows rows) {
  constexpr int LD = HD + 8;      // padded smem row (bf16 elements)
  constexpr int LDA = HD + 4;     // padded fp32 row of the warp merge
  constexpr int KCH = HD / 16;    // k16 chunks of the head dim
  constexpr int DT = HD / 8;      // n8 tiles of the head dim
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  static_assert(NWARPS * MROWS * LDA * 4 <= 4 * BK * LD * 2, "merge buffer must fit the K/V stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * BK * LD;                              // [2][BK][LD]
  __nv_bfloat16* sQ = sV + 2 * BK * LD;                              // [MROWS][LD]
  float* sM = reinterpret_cast<float*>(sQ + MROWS * LD);             // [NWARPS][MROWS]
  float* sL = sM + NWARPS * MROWS;                                   // [NWARPS][MROWS]
  float* sAcc = reinterpret_cast<float*>(smem_raw);  // [NWARPS][MROWS][LDA], over the stages after the loop

  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / p.Hkv, kvh = bk % p.Hkv;
  const int len = min(max(p.kv_len[b], 0), p.cap);
  const int start = split * p.chunk;
  if (p.splits > 1 && start >= len) return;  // no admitted key here; the merge skips this split
  const int end = min(start + p.chunk, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  // the G query rows of this KV head, zero rows past G
  const __nv_bfloat16* qb = p.q + (static_cast<size_t>(b) * p.H + static_cast<size_t>(kvh) * p.G) * HD;
  for (int c = threadIdx.x; c < MROWS * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < p.G) val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(r) * HD + col);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = val;
  }

  auto load_tile = [&](int k0, int stage) {
    __nv_bfloat16* dk = sK + stage * BK * LD;
    __nv_bfloat16* dv = sV + stage * BK * LD;
    for (int c = threadIdx.x; c < BK * CPR; c += NTHREADS) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const int pos = k0 + r;
      const __nv_bfloat16* sk = p.k;
      const __nv_bfloat16* sv = p.v;
      int bytes = 0;
      if (pos < end) {
        const size_t off = (rows(b, pos) * p.Hkv + kvh) * HD + col;
        sk += off;
        sv += off;
        bytes = 16;
      }
      cp_async16(dk + r * LD + col, sk, bytes);
      cp_async16(dv + r * LD + col, sv, bytes);
    }
  };

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int ntiles = end > start ? (end - start + BK - 1) / BK : 0;
  if (ntiles > 0) load_tile(start, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(start + (t + 1) * BK, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed (tile t + 1 may still fly)
    __syncthreads();
    const int kbase = start + t * BK + warp * 16;
    if (kbase < end) {  // warp-uniform: this warp's 16 keys admit at least one
      const __nv_bfloat16* tk = sK + (t & 1) * BK * LD + warp * 16 * LD;
      const __nv_bfloat16* tv = sV + (t & 1) * BK * LD + warp * 16 * LD;

      // S = Q Kᵀ: 16 query rows × this warp's 16 keys
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KCH; ++kc) {
        const __nv_bfloat16* qr = sQ + g * LD + kc * 16 + t4 * 2;
        const uint32_t qf[4] = {*reinterpret_cast<const uint32_t*>(qr),
                                *reinterpret_cast<const uint32_t*>(qr + 8 * LD),
                                *reinterpret_cast<const uint32_t*>(qr + 8),
                                *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat16* kr = tk + (n * 8 + g) * LD + kc * 16 + t4 * 2;
          mma_16x8x16(s[n], qf, *reinterpret_cast<const uint32_t*>(kr),
                      *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }

      // scale, softcap, mask past kv_len; row maxima over the 16 keys
      float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kbase + n * 8 + t4 * 2 + (e & 1);
          float x = s[n][e] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          s[n][e] = kpos < end ? x : NEG_INF;
        }
        tmax0 = fmaxf(tmax0, fmaxf(s[n][0], s[n][1]));
        tmax1 = fmaxf(tmax1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, off));
        tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, off));
      }
      const float mn0 = fmaxf(m0, tmax0), mn1 = fmaxf(m1, tmax1);
      const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp(S - m), masked lanes exactly 0
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][0] > 0.5f * NEG_INF ? expf(s[n][0] - mn0) : 0.f;
        s[n][1] = s[n][1] > 0.5f * NEG_INF ? expf(s[n][1] - mn0) : 0.f;
        s[n][2] = s[n][2] > 0.5f * NEG_INF ? expf(s[n][2] - mn1) : 0.f;
        s[n][3] = s[n][3] > 0.5f * NEG_INF ? expf(s[n][3] - mn1) : 0.f;
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;

      // O = O·alpha + P V: S's accumulator layout is P's A-fragment layout
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const __nv_bfloat16* v0 = tv + (t4 * 2) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha0;
        acc[d][1] *= alpha0;
        acc[d][2] *= alpha1;
        acc[d][3] *= alpha1;
        const __nv_bfloat16* vr = v0 + d * 8;
        mma_16x8x16(acc[d], pa, pack_raw(vr[0], vr[LD]), pack_raw(vr[8 * LD], vr[9 * LD]));
      }
    }
    __syncthreads();  // every warp is done with stage t & 1 before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the 4 warps: row statistics and unnormalised accumulators to smem
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (t4 == 0) {
    sM[warp * MROWS + g] = m0;
    sM[warp * MROWS + g + 8] = m1;
    sL[warp * MROWS + g] = l0;
    sL[warp * MROWS + g + 8] = l1;
  }
  float* wa = sAcc + warp * MROWS * LDA;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + t4 * 2;
    wa[g * LDA + c] = acc[d][0];
    wa[g * LDA + c + 1] = acc[d][1];
    wa[(g + 8) * LDA + c] = acc[d][2];
    wa[(g + 8) * LDA + c + 1] = acc[d][3];
  }
  __syncthreads();

  const size_t part = static_cast<size_t>(bk) * p.splits + split;
  for (int e = threadIdx.x; e < p.G * HD; e += NTHREADS) {
    const int r = e / HD, c = e % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sM[w * MROWS + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sM[w * MROWS + r] - M);
      L += sL[w * MROWS + r] * f;
      A += sAcc[(w * MROWS + r) * LDA + c] * f;
    }
    if (p.splits == 1) {
      p.o[(static_cast<size_t>(b) * p.H + static_cast<size_t>(kvh) * p.G + r) * HD + c] =
          __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {  // this split holds an admitted key, so L > 0
      p.o_part[(part * p.G + r) * HD + c] = A / L;
      if (c == 0) p.lse[part * p.G + r] = M + logf(L);
    }
  }
}

// merge the splits of one (b, kvh, query head r): o = Σ_s w_s·o_s / Σ_s w_s
// with w_s = exp(lse_s - max lse); one block per row, a thread per column
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ o_part, const float* __restrict__ lse,
               const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ o, int H, int Hkv,
               int G, int hd, int cap, int chunk, int splits) {
  __shared__ float sw[MAX_SPLITS];
  __shared__ float sred[COMBINE_THREADS / 32];
  const int bk = blockIdx.x, r = blockIdx.y;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int len = min(max(kv_len[b], 0), cap);
  const int nvalid = (len + chunk - 1) / chunk;  // splits whose chunk starts before kv_len
  const size_t base = static_cast<size_t>(bk) * splits;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float m = NEG_INF;
  for (int s = threadIdx.x; s < nvalid; s += COMBINE_THREADS) m = fmaxf(m, lse[(base + s) * G + r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) sred[warp] = m;
  __syncthreads();
  float M = NEG_INF;
#pragma unroll
  for (int w = 0; w < COMBINE_THREADS / 32; ++w) M = fmaxf(M, sred[w]);
  __syncthreads();  // sred is reused for the sum

  float wsum = 0.f;
  for (int s = threadIdx.x; s < nvalid; s += COMBINE_THREADS) {
    const float w = expf(lse[(base + s) * G + r] - M);
    sw[s] = w;
    wsum += w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
  if (lane == 0) sred[warp] = wsum;
  __syncthreads();
  float W = 0.f;
#pragma unroll
  for (int w = 0; w < COMBINE_THREADS / 32; ++w) W += sred[w];

  for (int c = threadIdx.x; c < hd; c += COMBINE_THREADS) {
    float A = 0.f;
    for (int s = 0; s < nvalid; ++s) A += sw[s] * o_part[((base + s) * G + r) * hd + c];
    o[(static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + r) * hd + c] =
        __float2bfloat16(nvalid > 0 ? A / W : 0.f);
  }
}

template <int HD, class Rows>
cudaError_t launch(const Params& p, const Rows& rows, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  static cudaError_t opted = cudaFuncSetAttribute(
      decode_kernel<HD, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return opted;
  dim3 grid(p.splits, B * p.Hkv);
  decode_kernel<HD, Rows><<<grid, NTHREADS, smem, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  combine_kernel<<<dim3(B * p.Hkv, p.G), COMBINE_THREADS, 0, stream>>>(p.o_part, p.lse, p.kv_len, p.o, p.H, p.Hkv,
                                                            p.G, HD, p.cap, p.chunk, p.splits);
  return cudaGetLastError();
}

template <class Rows>
int dispatch(const Params& p, const Rows& rows, int B, int hd, cudaStream_t stream) {
  if (B <= 0 || B * p.Hkv > 65535 || p.Hkv <= 0 || p.G < 1 || p.G > MROWS || p.H != p.Hkv * p.G ||
      p.cap <= 0 || p.chunk <= 0 || p.chunk % BK != 0 || p.splits < 1 || p.splits > MAX_SPLITS ||
      static_cast<long long>(p.splits) * p.chunk < p.cap || (p.splits > 1 && (!p.o_part || !p.lse)))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch<64>(p, rows, B, stream);
    case 128:
      return launch<128>(p, rows, B, stream);
    case 256:
      return launch<256>(p, rows, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries for ctypes. q, o: (B, H, hd) bf16; kv_len: (B,) int32;
// o_part (B·Hkv·splits·G·hd) and lse (B·Hkv·splits·G) fp32 scratch, used
// when splits > 1; chunk is a multiple of 64 with splits·chunk >= the
// cache's capacity. softcap <= 0 means none. Returns the cudaError_t of the
// launches (0 = launched).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                                     float* o_part, float* lse, int B, int H, int Hkv, int hd, int Skv,
                                     int chunk, int splits, float softcap, float scale, void* stream) {
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), kv_len, static_cast<__nv_bfloat16*>(o), o_part, lse,
                 H, Hkv, Hkv > 0 ? H / Hkv : 0, Skv, chunk, splits, scale, softcap};
  return dispatch(p, DenseRows{Skv}, B, hd, static_cast<cudaStream_t>(stream));
}

// k_pages, v_pages: (P, ps, Hkv, hd) bf16; page_table: (B, NP) int32, the
// slot's physical pages in logical order (entries past the last occupied
// page are never read; the ones read are clipped to [0, P-1]).
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                           const int* page_table, const int* kv_len, void* o, float* o_part,
                                           float* lse, int B, int H, int Hkv, int hd, int P, int ps, int NP,
                                           int chunk, int splits, float softcap, float scale, void* stream) {
  if (P <= 0 || ps <= 0 || NP <= 0) return cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
                 static_cast<const __nv_bfloat16*>(v_pages), kv_len, static_cast<__nv_bfloat16*>(o), o_part,
                 lse, H, Hkv, Hkv > 0 ? H / Hkv : 0, NP * ps, chunk, splits, scale, softcap};
  return dispatch(p, PagedRows{page_table, NP, ps, P}, B, hd, static_cast<cudaStream_t>(stream));
}
