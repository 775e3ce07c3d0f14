// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax
// statistics and accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel): blockwise online-softmax GQA
// attention with causal and sliding-window masks, tanh softcap and q_offset,
// skipping fully masked key tiles.
//
// What bounds it on an H100: operations. At prefill lengths each (q, k)
// pair costs 4·hd FLOP while each row of Q, K, V and O crosses device memory
// once (2·hd bytes): a 1024-token causal prefill at Mixtral's widths does
// ~440 FLOP a byte, above the card's ~295 FLOP-per-byte ridge. The kernel
// must keep the tensor cores fed: only wgmma reaches their full rate, the
// loads must never stall them, and the softmax between the two products
// must not leave them idle.
//
// The design:
//   * one block owns one (batch·head, 128-row q tile) and has three
//     warpgroups: two consumers of 64 q rows each and a producer.
//     setmaxnreg moves registers from the producer (24 a thread) to the
//     consumers (240), which hold O (hd/2 fp32 a thread) and S in registers;
//   * one producer thread loads through TMA: Q once, then K and V tiles into
//     a two-stage ring in shared memory. K and V complete on mbarriers of
//     their own, and the consumers release K as soon as S is done and V as
//     soon as P·V is done, so the next K is in flight before this V retires;
//   * tensor maps are 4-D over the model's (B, S, H, hd) layout, i.e.
//     (hd, heads, S, B), built on the host in the C entry with
//     cuTensorMapEncodeTiled (reached through the runtime's driver entry
//     point) and passed as __grid_constant__ parameters. Boxes are 64 bf16
//     wide (128 bytes) with the 128-byte swizzle that wgmma reads; hd 128
//     takes 2 boxes a tile, hd 256 four. TMA's out-of-bounds zero fill
//     covers the ragged ends of Sq and Sk, so there are no padding copies;
//   * S = Q·Kᵀ is wgmma with both operands in shared memory (K-major); P
//     is S's accumulator rounded to bf16 in registers, whose layout is
//     wgmma's A-fragment layout, and O += P·V reads V from shared memory
//     through the descriptor's transpose bit (V is never transposed);
//   * FlashAttention-3's pipeline inside each consumer: iteration i issues
//     S_i and then P_{i-1}·V_{i-1}, and runs tile i's softmax while the
//     second product is on the tensor cores (S, P and O all stay in
//     registers: 0 spills at every head dim). At hd 64/128 the two consumers
//     also take turns issuing their products (ping-pong on named barriers),
//     so one's softmax overlaps the other's products; at hd 256 the turns
//     measured 1-5% slower and are off;
//   * the block walks only the key tiles the causal and window bounds admit
//     (computed up front from the tile's first and last q position); within
//     them only tiles that straddle the causal diagonal, the window edge or
//     the end of Sk run the masked softmax (each row's admitted keys as one
//     [lo, hi] range), interior tiles carry no mask code. The softcap is a
//     template parameter, so the plain kernels carry no softcap code either;
//   * softmax runs in the log2 domain (scale prescaled by log2 e, ex2.approx);
//     the softcap's tanh is 1 - 2/(1 + e^2y) from ex2.approx, accurate to
//     ~1e-6 absolute where tanh.approx.f32 would cost up to 2^-11 relative;
//   * q tiles launch heaviest first (reversed tile index, tile index the
//     slow grid axis), so the causal tail does not sit alone on a few SMs.
// Tiles: BQ 128 always; BK 128 at hd 64/128 (Q 32 KB + 2 × 64 KB of K/V at
// hd 128), BK 64 at hd 256 (Q 64 KB + 2 × 64 KB); one block per SM.
// Not here yet: a persistent tile scheduler and a TMA store of O (O is
// stored from registers as bf16 pairs).

#include <cuda.h>
#include <cuda_runtime.h>

#include <limits>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;                    // q rows per block (two consumer warpgroups)
constexpr int NTHREADS = 3 * 128;          // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int STAGES = 2;                  // K/V ring depth (3 measured no faster at hd 128)
constexpr int BOX = 64;                    // bf16 columns per TMA box (128 bytes, the swizzle width)
constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

template <int HD>
__host__ __device__ constexpr int block_k() { return HD > 128 ? 64 : 128; }

template <int HD>
struct Smem {
  static constexpr int BK = block_k<HD>();
  static constexpr int NBOX = HD / BOX;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;          // one K or one V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES);  // mbarriers
  static constexpr int ALLOC = BYTES + 1024;            // room to align the base to 1024
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the kernel ------------------------------------------------------------

struct Params {
  int Sq, Sk, H, Hkv, causal, window, q_offset;
  float scale_log2;        // hd^-0.5 · log2(e)
  float cap_scale;         // hd^-0.5 / softcap (softcap kernels only)
  float cap_log2;          // softcap · log2(e)
};

// Named barriers 1 and 2 (256 threads: both consumers) make the consumers
// take turns at the tensor cores: consumer w waits on barrier 1 + w before
// issuing its products and lets the other go once it has issued them.
// ON = false turns both into no-ops (hd 256, where the turns measured slower).
template <bool ON>
__device__ __forceinline__ void wait_turn(int wg) {
  if constexpr (ON) {
    if (wg == 0)
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    else
      asm volatile("bar.sync 2, 256;\n" ::: "memory");
  }
}
template <bool ON>
__device__ __forceinline__ void pass_turn(int wg) {
  if constexpr (ON) {
    if (wg == 0)
      asm volatile("bar.arrive 2, 256;\n" ::: "memory");
    else
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
}

// S = Q·Kᵀ for one warpgroup's 64 rows: hd/16 wgmmas, both operands K-major
// in 128-byte-swizzled boxes of 64 columns (8-row groups 1024 bytes apart)
template <int HD, int BK>
__device__ __forceinline__ void issue_s(float (&sacc)[BK / 2], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const uint32_t off = (kc % 4) * 32;  // k16 step inside a 128-byte swizzle row
    const uint64_t da = desc_sw128(q_base + (kc / 4) * BQ * 128 + off, 16, 1024);
    const uint64_t db = desc_sw128(k_base + (kc / 4) * BK * 128 + off, 16, 1024);
    if (kc == 0)
      wgmma_ss_zero(sacc, da, db);
    else
      wgmma_ss(sacc, da, db);
  }
}

// O += P·V: V MN-major (transposed), boxes of 64 columns BK·128 bytes apart,
// 16 keys (two 8-row groups, 2048 bytes) a k-step
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2], uint32_t (&pa)[BK / 16][4], uint32_t v_base) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs(acc, pa[kc], desc_sw128(v_base + kc * 2048, BK * 128, 1024));
}

// One consumer thread's online-softmax state for its rows r and r + 8
struct RowState {
  float m0, m1, l0, l1;  // running max (log2 domain) and partial sums
  float alpha0, alpha1;  // rescale of O owed for the last tile's new max
  int lo0, hi0, lo1, hi1;  // admitted keys of each row: lo <= k <= hi
};

// Tile softmax: leaves 2^(x·c - m) in sacc, where x is the score (CAP: the
// softcapped score in log2 units, c = 1; else the raw score, c = scale·log2
// e); updates the running max and sums. EDGE tiles mask keys outside each
// row's [lo, hi]; interior tiles carry no mask code at all.
template <int BK, bool EDGE, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2], RowState& st, const Params& p, int k0,
                                             int t4) {
  const float c = CAP ? 1.f : p.scale_log2;
  // row bounds relative to this thread's first column in the tile
  const int off = k0 + 2 * t4;
  const int a0 = st.lo0 - off, b0 = st.hi0 - off, a1 = st.lo1 - off, b1 = st.hi1 - off;
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sacc[4 * j + e];
      if constexpr (CAP) {
        const float y = ex2(x * p.cap_scale * 2.8853900817779268f);  // e^(2·s·scale/cap)
        x = p.cap_log2 * (1.f - __fdividef(2.f, 1.f + y));          // cap·tanh(s·scale/cap)·log2 e
      }
      if constexpr (EDGE) {
        const int col = 8 * j + (e & 1);
        const bool ok = e < 2 ? (col >= a0 && col <= b0) : (col >= a1 && col <= b1);
        x = ok ? x : NEG_INF;
      }
      sacc[4 * j + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float mn0 = fmaxf(st.m0, mx0 * c), mn1 = fmaxf(st.m1, mx1 * c);
  // a row with no admitted key yet keeps m = -inf: exponentiate against 0
  const float base0 = mn0 == NEG_INF ? 0.f : mn0, base1 = mn1 == NEG_INF ? 0.f : mn1;
  st.alpha0 = ex2(st.m0 - base0);
  st.alpha1 = ex2(st.m1 - base1);
  st.m0 = mn0;
  st.m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sacc[4 * j] = ex2(fmaf(sacc[4 * j], c, -base0));
    sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], c, -base0));
    sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], c, -base1));
    sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], c, -base1));
    ps0 += sacc[4 * j] + sacc[4 * j + 1];
    ps1 += sacc[4 * j + 2] + sacc[4 * j + 3];
  }
  st.l0 = st.l0 * st.alpha0 + ps0;
  st.l1 = st.l1 * st.alpha1 + ps1;
}

// P as bf16 A fragments: S's accumulator layout is wgmma's A-fragment layout
template <int BK>
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[BK / 16][4], const float (&sacc)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kc][r] = pack_bf16(sacc[8 * kc + 2 * r], sacc[8 * kc + 2 * r + 1]);
}

template <int HD>
__device__ __forceinline__ void rescale(float (&acc)[HD / 2], const RowState& st) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[4 * j] *= st.alpha0;
    acc[4 * j + 1] *= st.alpha0;
    acc[4 * j + 2] *= st.alpha1;
    acc[4 * j + 3] *= st.alpha1;
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                 const Params p) {
  using L = Smem<HD>;
  constexpr int BK = L::BK;
  constexpr int NBOX = L::NBOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q_OFF, sK = base + L::K_OFF, sV = base + L::V_OFF;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  const uint32_t bar_q = base + L::BAR_OFF;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar_q + 8u * (1 + 3 * STAGES + s); };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest q tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);

  // key tiles the block's q rows can attend to, fixed up front
  const int q_first = qt * BQ + p.q_offset;
  const int q_last = min(qt * BQ + BQ, p.Sq) - 1 + p.q_offset;
  int k_lo = 0, k_hi = p.Sk - 1;
  if (p.window > 0) k_lo = max(0, q_first - p.window + 1);
  if (p.causal) k_hi = min(k_hi, q_last);
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform by construction (a shuffle from lane 0), so the compiler
  // keeps what derives from it (descriptors, addresses) in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < NBOX; ++c) tma_load_4d(sQ + c * BQ * 128, &tm_q, bar_q, c * BOX, h, qt * BQ, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = (t_lo + i) * BK;
        const uint32_t parity = ((i / STAGES) - 1) & 1;
        if (i >= STAGES) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int c = 0; c < NBOX; ++c)
          tma_load_4d(sK + s * L::KV_BYTES + c * BK * 128, &tm_k, k_full(s), c * BOX, kvh, k0, b);
        if (i >= STAGES) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int c = 0; c < NBOX; ++c)
          tma_load_4d(sV + s * L::KV_BYTES + c * BK * 128, &tm_v, v_full(s), c * BOX, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int row0 = qt * BQ + wg * 64 + warp * 16 + lane / 4;  // this thread's rows row0, row0 + 8
    const int w_first = qt * BQ + wg * 64 + p.q_offset;          // this warpgroup's q positions
    const int w_last = min(qt * BQ + wg * 64 + 64, p.Sq) - 1 + p.q_offset;
    const uint32_t q_base = sQ + wg * 64 * 128;
    // only tiles on the causal diagonal, the window edge or the end of Sk are masked
    auto edge = [&](int k0) {
      return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > w_first) ||
             (p.window > 0 && k0 <= w_last - p.window);
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    RowState st{NEG_INF, NEG_INF, 0.f, 0.f, 1.f, 1.f, 0, 0, 0, 0};
    {
      const int q0 = row0 + p.q_offset, q1 = q0 + 8;
      st.lo0 = p.window > 0 ? q0 - p.window + 1 : 0;
      st.lo1 = p.window > 0 ? q1 - p.window + 1 : 0;
      st.hi0 = p.causal ? min(q0, p.Sk - 1) : p.Sk - 1;
      st.hi1 = p.causal ? min(q1, p.Sk - 1) : p.Sk - 1;
    }
    auto softmax = [&](float (&sacc)[BK / 2], int k0) {
      if (edge(k0))
        softmax_tile<BK, true, CAP>(sacc, st, p, k0, t4);
      else
        softmax_tile<BK, false, CAP>(sacc, st, p, k0, t4);
    };
    float sacc[BK / 2];
    uint32_t pa[BK / 16][4];

    // Software pipeline, FlashAttention-3's: iteration i issues S_i, then
    // P_{i-1}·V_{i-1}, and runs tile i's softmax while the second product is
    // on the tensor cores. At hd <= 128 the two consumers also take turns
    // issuing (ping-pong), so one's softmax overlaps the other's products;
    // each issues n_tiles times, consumer 1 passes first and skips its last
    // pass, so every wait on a turn is matched by exactly one pass.
    constexpr bool PP = HD <= 128;
    if (n_tiles > 0) {
      if (wg == 1) pass_turn<PP>(wg);  // consumer 0 issues first
      mbar_wait(bar_q, 0);
      mbar_wait(k_full(0), 0);
      wait_turn<PP>(wg);
      wgmma_fence();
      issue_s<HD, BK>(sacc, q_base, sK);
      wgmma_commit();
      if (wg == 0 || n_tiles > 1) pass_turn<PP>(wg);
      wgmma_wait<0>();
      fence_regs(sacc);
      release(k_empty(0));
      softmax(sacc, t_lo * BK);
      to_bf16<BK>(pa, sacc);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES, k0 = (t_lo + i) * BK;
      mbar_wait(k_full(s), (i / STAGES) & 1);
      wait_turn<PP>(wg);
      wgmma_fence();
      issue_s<HD, BK>(sacc, q_base, sK + s * L::KV_BYTES);
      wgmma_commit();
      rescale<HD>(acc, st);  // O to tile i-1's max, while S_i runs
      mbar_wait(v_full(sp), ((i - 1) / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<HD, BK>(acc, pa, sV + sp * L::KV_BYTES);
      wgmma_commit();
      if (wg == 0 || i < n_tiles - 1) pass_turn<PP>(wg);
      wgmma_wait<1>();  // S_i done
      fence_regs(sacc);
      release(k_empty(s));
      softmax(sacc, k0);
      wgmma_wait<0>();  // P_{i-1}·V_{i-1} done
      fence_regs(acc);
      fence_regs(pa);  // the product read pa until here
      release(v_empty(sp));
      to_bf16<BK>(pa, sacc);
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % STAGES;
      rescale<HD>(acc, st);
      mbar_wait(v_full(sp), ((n_tiles - 1) / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<HD, BK>(acc, pa, sV + sp * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(v_empty(sp));
    }

    // finish: full row sums across the quad, normalise, store bf16 pairs
    float l0 = st.l0, l1 = st.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const size_t q_row = static_cast<size_t>(p.H) * HD;
    __nv_bfloat16* ob = o + (static_cast<size_t>(b) * p.Sq) * q_row + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (row0 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * q_row + c) = pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (row0 + 8 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * q_row + c) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <int HD, bool CAP>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o, dim3 grid,
                   const Params& p, cudaStream_t stream) {
  constexpr int smem = Smem<HD>::ALLOC;
  static cudaError_t opted =
      cudaFuncSetAttribute(flash_fwd_kernel<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return opted;
  flash_fwd_kernel<HD, CAP><<<grid, NTHREADS, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
                   int Hkv, int causal, int window, float softcap, int q_offset, float scale,
                   cudaStream_t stream) {
  if (encode_fn() == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_bshd_map(&mq, q, B, Sq, H, HD, BQ) || !make_bshd_map(&mk, k, B, Sk, Hkv, HD, block_k<HD>()) ||
      !make_bshd_map(&mv, v, B, Sk, Hkv, HD, block_k<HD>()))
    return cudaErrorInvalidValue;
  constexpr float LOG2E = 1.4426950408889634f;
  const Params p{Sq, Sk, H, Hkv, causal, window, q_offset, scale * LOG2E,
                 softcap > 0.f ? scale / softcap : 0.f, softcap * LOG2E};
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  return softcap > 0.f ? launch<HD, true>(mq, mk, mv, o, grid, p, stream)
                       : launch<HD, false>(mq, mk, mv, o, grid, p, stream);
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
