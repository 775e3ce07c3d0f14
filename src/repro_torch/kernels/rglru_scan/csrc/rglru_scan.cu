// RG-LRU linear-recurrence scan for Hopper (sm_90a), fp32 in and out:
//   s_t = a_t ⊙ s_{t-1} + b_t,  s_{-1} = 0,  a, b, s: (B, S, W) contiguous.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py
// (rglru_scan_pallas, body _rglru_kernel). The TPU kernel tiles (time,
// width) into VMEM blocks and carries the state across a sequential time
// grid axis in VMEM scratch; GPU blocks run in no order, so nothing can be
// carried between them. Here the carry lives in a register: each lane
// (b, w) belongs to one thread that walks the whole time axis.
//
// What bounds it on an H100: bytes. 12 bytes move per element (a and b read,
// s written once) against two flops: 3·B·S·W·4 B at the H100 SXM's published
// 3.35 TB/s is 0.030 ms at the served prefill (2, 1024, 4096). The serial
// chain is one dependent multiply and add per step, a few thousand cycles
// for 1,024 steps, well below that. What the card needs is enough bytes in
// flight to cover HBM's latency, and the served prefill has only 8,192
// lanes: one thread per lane that loads its own steps a few ahead (the
// first kernel here) kept too few in flight and reached 26% of the bound
// (PERF.md: NVIDIA H100 80GB HBM3, 700 W). So:
//   * a block owns L = 32 or 64 lanes of one batch row (the wrapper picks L
//     so that the blocks cover the SMs: lane_plan in ops.py), one consumer
//     warp per 32 lanes and one producer warp;
//   * the producer fills a ring of (32 steps × L lanes) tiles of a and b in
//     shared memory, 64 KB per block, on mbarriers: one thread issues 3-D
//     TMA loads over the (W, S, B) tensors (zeros past S and W). Where TMA
//     cannot address the tensors (W not a multiple of 4, or a pointer not
//     16-byte aligned) the producer warp's lanes copy the same tiles with
//     4-byte cp.async, zero-filled past the edges, into the same ring;
//   * each consumer warp moves its tile's a and b from shared memory into
//     registers, frees the stage at once, and runs the steps with its carry
//     h in a register across tiles; the stores of s are coalesced, 128 bytes
//     per warp per step, and nothing is stored past S or W.
// No chunked prefix-product scan: it would reassociate the products and
// lose bit equality with the plain loop, and the chain is not the limit.
//
// Numerics: the multiply and the add round separately (__fmul_rn,
// __fadd_rn, no fused multiply-add), as the plain PyTorch loop does, so the
// kernel and the plain version agree bit for bit on the card.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int T = 32;           // time steps per tile
constexpr int RING_BYTES = 65536;  // a and b tiles in flight per block

template <int L>  // lanes per block: 32 or 64
struct Ring {
  static constexpr int NCWARPS = L / 32;              // consumer warps
  static constexpr int NTHREADS = (NCWARPS + 1) * 32;  // + the producer warp
  static constexpr int TILE = T * L * 4;              // one tile of a or b, bytes
  static constexpr int STAGES = RING_BYTES / (2 * TILE);
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = STAGES * TILE;
  static constexpr int BAR_OFF = 2 * STAGES * TILE;   // full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR_OFF + 16 * STAGES + 128;  // room to align the base to 128
};

// TMA: one thread loads a tile of each tensor from 3-D maps over (W, S, B)
struct TmaLoader {
  CUtensorMap ma, mb;
  static constexpr uint32_t FULL_COUNT = 1;
  template <int L>
  __device__ __forceinline__ void load(int lane, uint32_t da, uint32_t db, uint32_t full, int b, int w0,
                                       int t0, int, int) const {
    if (lane != 0) return;
    mbar_expect_tx(full, 2 * Ring<L>::TILE);
    tma_load_3d(da, &ma, full, w0, t0, b);
    tma_load_3d(db, &mb, full, w0, t0, b);
  }
};

// any W: the warp's lanes copy 4-byte elements, zero past S and W, and each
// lane counts its copies on the barrier
struct CopyLoader {
  const float* a;
  const float* b;
  static constexpr uint32_t FULL_COUNT = 32;
  template <int L>
  __device__ __forceinline__ void load(int lane, uint32_t da, uint32_t db, uint32_t full, int bi, int w0,
                                       int t0, int S, int W) const {
#pragma unroll 4
    for (int i = lane; i < T * L; i += 32) {
      const int t = t0 + i / L, w = w0 + i % L;
      const bool in = t < S && w < W;
      const size_t off = in ? (static_cast<size_t>(bi) * S + t) * W + w : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(da + 4 * i), "l"(a + off),
                   "r"(in ? 4 : 0));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(db + 4 * i), "l"(b + off),
                   "r"(in ? 4 : 0));
    }
    cp_async_mbar_arrive(full);
  }
};

template <int L, class Loader>
__global__ void __launch_bounds__(Ring<L>::NTHREADS)
rglru_scan_kernel(const __grid_constant__ Loader ld, float* __restrict__ s, int S, int W) {
  using R = Ring<L>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  auto full = [&](int st) { return base + R::BAR_OFF + 8u * st; };
  auto empty = [&](int st) { return base + R::BAR_OFF + 8u * (R::STAGES + st); };
  const float* tiles = reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)));

  const int w0 = blockIdx.x * L, b = blockIdx.y;
  const int ntiles = (S + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < R::STAGES; ++st) {
      mbar_init(full(st), Loader::FULL_COUNT);
      mbar_init(empty(st), R::NCWARPS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == R::NCWARPS) {
    // ---- producer: fills the ring ----
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % R::STAGES;
      if (i >= R::STAGES) mbar_wait(empty(st), ((i / R::STAGES) - 1) & 1);
      ld.template load<L>(lane, base + R::A_OFF + st * R::TILE, base + R::B_OFF + st * R::TILE, full(st), b, w0,
                          i * T, S, W);
    }
    return;
  }

  // ---- consumers: one lane each, the carry in a register ----
  const int col = warp * 32 + lane, w = w0 + col;
  float* sp = s + static_cast<size_t>(b) * S * W + w;
  float h = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % R::STAGES;
    mbar_wait(full(st), (i / R::STAGES) & 1);
    const float* ta = tiles + (R::A_OFF + st * R::TILE) / 4 + col;
    const float* tb = tiles + (R::B_OFF + st * R::TILE) / 4 + col;
    float av[T], bv[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      av[u] = ta[u * L];
      bv[u] = tb[u * L];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // the stage is in registers: refill it
    const int t0 = i * T, n = min(T, S - t0);
    if (w < W) {
      float* out = sp + static_cast<size_t>(t0) * W;
      if (n == T) {
#pragma unroll
        for (int u = 0; u < T; ++u) {
          h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
          out[static_cast<size_t>(u) * W] = h;
        }
      } else {
#pragma unroll
        for (int u = 0; u < T; ++u) {
          if (u < n) {
            h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
            out[static_cast<size_t>(u) * W] = h;
          }
        }
      }
    }
  }
}

// (B, S, W) fp32 as a 3-D map over (W, S, B), box (L, T, 1), zeros past the edges
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int W, int L) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4, static_cast<cuuint64_t>(S) * W * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L), T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int L, class Loader>
cudaError_t launch(const Loader& ld, float* s, int B, int S, int W, cudaStream_t stream) {
  constexpr int smem = Ring<L>::ALLOC;
  static cudaError_t opted =
      cudaFuncSetAttribute(rglru_scan_kernel<L, Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((W + L - 1) / L, B);
  rglru_scan_kernel<L, Loader><<<grid, Ring<L>::NTHREADS, smem, stream>>>(ld, s, S, W);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch(const float* a, const float* b, float* s, int B, int S, int W, cudaStream_t stream) {
  const bool tma = W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 && encode_fn() != nullptr;
  if (!tma) return launch<L>(CopyLoader{a, b}, s, B, S, W, stream);
  TmaLoader ld;
  if (!make_map(&ld.ma, a, B, S, W, L) || !make_map(&ld.mb, b, B, S, W, L)) return cudaErrorInvalidValue;
  return launch<L>(ld, s, B, S, W, stream);
}

}  // namespace

// Plain C entry for ctypes. a, b, s: (B, S, W) contiguous fp32; lanes (32
// or 64) per block, the wrapper's lane plan. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int rglru_scan_fwd_f32(const void* a, const void* b, void* s, int B, int S, int W, int lanes,
                                  void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* sf = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 32:
      return launch<32>(af, bf, sf, B, S, W, st);
    case 64:
      return launch<64>(af, bf, sf, B, S, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}
