// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax
// statistics and accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel): blockwise online-softmax GQA
// attention with causal and sliding-window masks, tanh softcap and q_offset,
// skipping fully masked key tiles.
//
// What bounds it on an H100: at prefill lengths the (q, k) pair count makes
// it compute-bound (4·hd FLOP per unmasked pair against 2·hd bytes per
// row moved once), so the design keeps everything after the Q/K/V loads on
// chip and on the tensor cores:
//   * one thread block owns one (batch·head, 64-row q tile); its 4 warps own
//     16 q rows each, held as mma.sync A fragments in registers for the
//     whole key loop;
//   * the block walks only the key tiles that the causal and window bounds
//     admit, computed up front from the tile's first and last q position
//     (the TPU grid instead visits every tile and skips with pl.when);
//   * S = Q·Kᵀ and O += P·V run on mma.sync m16n8k16 bf16 → fp32; the S
//     accumulator's register layout is reused directly as P's A fragment;
//   * running max and denominator stay in fp32 registers (one row pair per
//     thread, reduced across the 4 threads of a quad with shuffles);
//   * K/V tiles are staged through padded shared memory (conflict-free
//     fragment reads); GQA maps q head h to kv head h / G, so a K/V tile
//     is read from global memory once per q tile of each head;
//   * ragged Sq/Sk are masked in-kernel (zero-filled rows, predicated
//     stores), so the wrapper needs no padding copies;
//   * Q, K, V, O are read and written in the model's (B, S, H, hd) layout.
// Simple by design: single-buffered synchronous loads, no TMA, no wgmma.
//
// head_dim 256 (RecurrentGemma's local MQA attention) takes a second layout
// of the same kernel. Its fp32 accumulator alone is 16×256 per warp, 128
// registers a thread, and the S tile 32 more; holding Q's fragments in
// registers as well (64 more) would pass the 255-register limit and spill.
// So at hd 256 the block stages its Q tile once in shared memory and each
// warp reads Q's A fragment per k16 chunk inside the S product (4 shared
// loads per chunk, conflict-free for the same padded row stride as K).
// Q, K and V tiles then need (64 + 2·64)·264·2 = 101,376 bytes, over the
// 48 KB static limit, so that layout uses dynamic shared memory, opted in
// once through cudaFuncSetAttribute; two blocks still fit one SM. The
// alternative, BK = 32 with Q kept in registers, would fit the shared
// memory statically but leaves 64 + 128 + 16 registers of live state, too
// close to the limit to stay free of spills. hd 64 and 128 keep Q in
// registers and static shared memory, as before.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1.0e30f;

// Q stays in registers up to hd 128; at hd 256 it is staged in shared memory
template <int HD>
__host__ __device__ constexpr bool q_in_smem() { return HD > 128; }

template <int HD>
__host__ __device__ constexpr int dyn_smem_bytes() {
  return q_in_smem<HD>() ? (BQ + 2 * BK) * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16)) : 0;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int Sq, int Sk, int H, int Hkv, int causal, int window, float softcap,
                 int q_offset, float scale) {
  constexpr int LD = HD + 8;  // padded smem row (bf16 elements)
  constexpr int KCH = HD / 16;  // k16 chunks of the head dim
  constexpr int DT = HD / 8;    // n8 tiles of the head dim
  constexpr int NT = BK / 8;    // n8 tiles of a key tile
  constexpr bool QS = q_in_smem<HD>();
  __nv_bfloat16 *sQ = nullptr, *sK, *sV;
  if constexpr (QS) {
    extern __shared__ __align__(16) __nv_bfloat16 dyn[];
    sQ = dyn;
    sK = dyn + BQ * LD;
    sV = sK + BK * LD;
  } else {
    __shared__ __align__(16) __nv_bfloat16 stK[BK * LD];
    __shared__ __align__(16) __nv_bfloat16 stV[BK * LD];
    sK = stK;
    sV = stV;
  }

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const size_t q_row = static_cast<size_t>(H) * HD;    // stride between q positions
  const size_t kv_row = static_cast<size_t>(Hkv) * HD;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(kvh) * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Sk * kv_row + static_cast<size_t>(kvh) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * HD;

  // this thread's two q rows (local index within the block) and positions
  const int r0 = qt * BQ + warp * 16 + g, r1 = r0 + 8;
  const int qpos0 = r0 + q_offset, qpos1 = r1 + q_offset;

  // Q fragments for the whole key loop (rows past Sq read as zero): in
  // registers, or (hd 256) the block's Q tile in shared memory; the first
  // __syncthreads of the key loop publishes it
  uint32_t qa[QS ? 1 : KCH][4];
  if constexpr (QS) {
    for (int c = threadIdx.x; c < BQ * (HD / 8); c += NTHREADS) {
      const int row = c / (HD / 8), col = (c % (HD / 8)) * 8;
      const int qr = qt * BQ + row;
      uint4 q4 = make_uint4(0, 0, 0, 0);
      if (qr < Sq) q4 = *reinterpret_cast<const uint4*>(qb + qr * q_row + col);
      *reinterpret_cast<uint4*>(sQ + row * LD + col) = q4;
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc) {
      const int c = kc * 16 + t4 * 2;
      const uint32_t z = 0;
      qa[kc][0] = r0 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_row + c) : z;
      qa[kc][1] = r1 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_row + c) : z;
      qa[kc][2] = r0 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_row + c + 8) : z;
      qa[kc][3] = r1 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_row + c + 8) : z;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // key range the block's q rows can attend to, fixed up front
  const int q_first = qt * BQ + q_offset;
  const int q_last = min(qt * BQ + BQ, Sq) - 1 + q_offset;
  int k_lo = 0, k_hi = Sk - 1;
  if (window > 0) k_lo = max(0, q_first - window + 1);
  if (causal) k_hi = min(k_hi, q_last);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi >= k_lo ? k_hi / BK : t_lo - 1;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // previous tile's readers are done
    for (int c = threadIdx.x; c < BK * (HD / 8); c += NTHREADS) {
      const int row = c / (HD / 8), col = (c % (HD / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + row < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (k0 + row) * kv_row + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + (k0 + row) * kv_row + col);
      }
      *reinterpret_cast<uint4*>(sK + row * LD + col) = kv4;
      *reinterpret_cast<uint4*>(sV + row * LD + col) = vv4;
    }
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows × BK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc) {
      if constexpr (QS) {
        const __nv_bfloat16* qr = sQ + (warp * 16 + g) * LD + kc * 16 + t4 * 2;
        const uint32_t qf[4] = {*reinterpret_cast<const uint32_t*>(qr),
                                *reinterpret_cast<const uint32_t*>(qr + 8 * LD),
                                *reinterpret_cast<const uint32_t*>(qr + 8),
                                *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* kr = sK + (n * 8 + g) * LD + kc * 16 + t4 * 2;
          mma_16x8x16(s[n], qf, *reinterpret_cast<const uint32_t*>(kr),
                      *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* kr = sK + (n * 8 + g) * LD + kc * 16 + t4 * 2;
          mma_16x8x16(s[n], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
                      *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    }

    // scale, softcap, mask; row maxima over this tile
    float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[n][e] = ok ? x : NEG_INF;
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

    // P = exp(S - m), masked lanes exactly 0; per-thread partial row sums
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][0] > 0.5f * NEG_INF ? expf(s[n][0] - mn0) : 0.f;
      s[n][1] = s[n][1] > 0.5f * NEG_INF ? expf(s[n][1] - mn0) : 0.f;
      s[n][2] = s[n][2] > 0.5f * NEG_INF ? expf(s[n][2] - mn1) : 0.f;
      s[n][3] = s[n][3] > 0.5f * NEG_INF ? expf(s[n][3] - mn1) : 0.f;
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }

    // O += P V: S's accumulator layout is P's A-fragment layout
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* v0 = sV + (kc * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* vr = v0 + d * 8;
        mma_16x8x16(acc[d], pa, pack_raw(vr[0], vr[LD]), pack_raw(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  // finish: full row sums across the quad, normalize, store bf16 pairs
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + t4 * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) = pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) = pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int Hkv, int causal, int window, float softcap, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int smem = dyn_smem_bytes<HD>();
  if constexpr (smem > 48 * 1024) {
    static cudaError_t opted = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opted != cudaSuccess) return opted;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, Hkv,
      causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. q, o: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd);
// all contiguous bf16, 16-byte aligned. window <= 0 and softcap <= 0 mean
// "none". Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int Sq, int Sk, int H, int Hkv, int hd,
                                        int causal, int window, float softcap, int q_offset,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, softcap, q_offset, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, softcap, q_offset, scale, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, softcap, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
