// One-token GQA flash-decode for Hopper (sm_90a), bf16 in and out, fp32
// softmax statistics and accumulation. One source, two entry points that
// share the whole body and differ only in how a tile of keys is loaded:
//
//   decode_attention_bf16        dense cache (B, Skv, Hkv, hd), TMA loads
//   paged_decode_attention_bf16  page pool (P, ps, Hkv, hd) + table (B, NP),
//                                TMA loads of whole pages through the table
//                                (cp.async for page sizes TMA cannot tile)
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
// operations a byte at which the tensor cores would bind. At the served
// shapes the caches are small (4 MB at RecurrentGemma's widths), so a
// launch, a block's first load and the merge of the splits cost as much as
// the bytes; at long caches the bytes decide, and the card must keep
// enough of them in flight on every SM through whole waves of blocks.
// The design:
//   * the G query heads of a KV head (G <= 16) are the 16 rows of an
//     mma.sync m16n8k16 tile (rows past G are zero), so K and V are read
//     once for all G heads and S = Q·Kᵀ and O += P·V run on the tensor
//     cores with fp32 accumulation (P rounded to bf16, as in the prefill
//     kernel). wgmma would need 64 rows, four times what decode has;
//   * dense: the KV axis is split across the blocks of thread-block
//     clusters of up to 8 (the portable size) per (slot, KV head): block
//     (split, b·Hkv + kvh) owns `chunk` positions. After the loop each block
//     merges its 4 consumer warps in shared memory, the cluster
//     synchronises, and every block merges a share of the output from all
//     the cluster's blocks through distributed shared memory (log-sum-exp
//     weights). Up to 8 splits that is the whole call: one launch, no fp32
//     partials in device memory. A few (slot, KV head) pairs over a long
//     cache need more blocks than 8 a pair to keep the card's bytes busy,
//     so a call may have up to 128 clusters of 8 per pair: each cluster
//     then writes its normalised fp32 output and log-sum-exp to a
//     workspace, and the last cluster of the pair to count itself in (an
//     atomicAdd on the pair's counter after a fence) merges them, writes o
//     and sets the counter back to 0, so the counters are 0 between calls
//     and under CUDA-graph replay (the wrapper keeps them per device and
//     stream). Still one launch. Blocks whose chunk starts past kv_len load
//     nothing, contribute an empty (max -inf, sum 0) partial and only take
//     part in the merges. The host's split plan (ops.py split_plan) reads
//     the resident blocks per cluster size from CUDA
//     (decode_attention_resident): a block streams only about 1/90 of the
//     card's bytes per second (NVIDIA H100 80GB HBM3, 700 W) and a cluster
//     must fit one GPC, so short caches get few splits of at least 2
//     tiles, long caches the fewest splits that keep the card's bytes busy
//     in whole waves (measurements in PERF.md, from kernel_ab.py --splits);
//   * paged: the slots' lengths differ and live on the device, so a split
//     plan sized on the host would give the longest slot the same few
//     blocks as the shortest and leave most blocks empty. Each block
//     instead builds the call's work list from kv_len when it starts (a
//     scan over the slots; nothing is read on the host, so a captured CUDA
//     graph stays right when the lengths change): slot b holds T_b =
//     ceil(len_b / 64) tiles per KV head, the call's Hkv·Σ T_b tiles are
//     cut into items of at most per = max(ceil(total / blocks), 2) tiles
//     (`blocks` from the host, ops.py paged_plan), and each (slot, KV head)
//     gets ceil(T_b / per) items of near-equal whole-tile ranges: a long
//     slot gets many blocks, an empty slot none ("lean attention", the
//     stream-K decomposition of ragged decode). Block i takes item i; the
//     grid holds blocks + B·Hkv blocks, more than the items can number, and
//     blocks past the last item return at once. A pair that is one item
//     writes o; a pair of several merges through the workspace as the
//     dense clusters do (the last item to count itself in merges and
//     resets the counter). Block b < B writes slot b's zero output when it
//     has no admitted key. ops.py paged_work_items is the plain mirror of
//     the partition (the CPU tests hold it to its rule);
//   * a block's producer warp fills a ring of K/V stages of 64 keys (96 KB:
//     6 stages at hd 64, 3 at hd 128, 3 of twice the size at hd 256) on
//     mbarriers; each consumer warp waits on the stage's full barrier and
//     frees it on its empty barrier: no block-wide barrier per tile. Two
//     blocks fit an SM at hd <= 128, one at hd 256. Dense: one thread
//     issues TMA loads of 64-key boxes from a 4-D tensor map over (hd, Hkv,
//     Skv, B) with the 128-byte swizzle (positions past Skv read as zeros);
//     rows past kv_len inside Skv hold whatever the cache holds, so the
//     warp that owns them zeroes its V rows before P·V and masks their
//     scores. Paged: where the page size is a multiple of 8 that divides 64
//     (or a multiple of 64), lane q of the producer warp loads the tile's
//     q-th piece of whole-page rows by TMA from a map over the pool into
//     the same swizzled layout; for other page sizes its 32 lanes copy rows
//     through the table with cp.async (zero-filled past kv_len) and count
//     their copies on the full barrier (cp.async.mbarrier.arrive). K and V
//     fragments come from shared memory by ldmatrix, following the swizzle.

#include <cooperative_groups.h>
#include <math.h>

#include "sm90_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int BK = 64;        // keys per tile, 16 per consumer warp
constexpr int NCWARPS = 4;    // consumer warps; warp NCWARPS is the producer
constexpr int NCTHREADS = NCWARPS * 32;
constexpr int NTHREADS = NCTHREADS + 32;
constexpr int MROWS = 16;     // query-head rows of the mma tile (G <= 16)
constexpr int CLUSTER = 8;      // blocks of one cluster at most (the portable limit)
constexpr int MAX_CLUSTERS = 128;  // clusters of one (slot, KV head) at most
constexpr int MIN_TILES = 2;       // a paged work item's tiles at least (where the call has them)
constexpr int MAX_BLOCKS = 1024;   // a paged call's `blocks` at most: no pair has more items
constexpr float NEG_INF = -1.0e30f;

constexpr int RING_BYTES = 98304;  // K and V stages of one block, at least 3 of them

template <int HD>
struct Layout {
  static constexpr int NBOX = HD / 64;             // 128-byte boxes per row
  static constexpr int CPR = HD / 8;               // 16-byte chunks per row
  static constexpr int TILE = BK * HD * 2;         // one K or V tile, bytes
  static constexpr int STAGES = RING_BYTES / (2 * TILE) < 3 ? 3 : RING_BYTES / (2 * TILE);  // 6, 3, 3
  static constexpr int LDQ = HD + 8;               // padded Q row (bf16)
  static constexpr int LDA = HD + 4;               // padded fp32 row of the warp merge
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = STAGES * TILE;
  static constexpr int Q_OFF = 2 * STAGES * TILE;
  static constexpr int BAR_OFF = Q_OFF + MROWS * LDQ * 2;  // full[STAGES], empty[STAGES]
  static constexpr int STAT_OFF = BAR_OFF + 16 * STAGES;    // the block's row max and sum [2][MROWS]
  static constexpr int BYTES = STAT_OFF + 2 * MROWS * 4;
  static constexpr int ALLOC = BYTES + 1024;               // room to align the base to 1024
  // after the loop the ring holds the warps' accumulators, row statistics
  // and weights, the block's unnormalised output (which the cluster's merge
  // reads) and the cluster's row statistics and weights
  static constexpr int ACC_OFF = 0;                                  // [NCWARPS][MROWS][LDA] fp32
  static constexpr int WSTAT_OFF = NCWARPS * MROWS * LDA * 4;        // [3][NCWARPS][MROWS] fp32
  static constexpr int O_OFF = WSTAT_OFF + 3 * NCWARPS * MROWS * 4;  // [MROWS][HD] fp32
  static constexpr int CSTAT_OFF = O_OFF + MROWS * HD * 4;           // [2][CLUSTER][MROWS] fp32
  static_assert(CSTAT_OFF + 2 * CLUSTER * MROWS * 4 <= 2 * STAGES * TILE, "the merge buffers must fit the ring");
  // the merge of a pair's clusters or work items, once no block reads this
  // one's shared memory: their weights at the ring's start
  static constexpr int GW_OFF = 0;  // [MAX_CLUSTERS or MAX_BLOCKS][MROWS] fp32
  static_assert(MAX_BLOCKS * MROWS * 4 <= 2 * STAGES * TILE && MAX_CLUSTERS <= MAX_BLOCKS,
                "the partials' weights must fit the ring");
};

struct Params {
  const __nv_bfloat16* q;  // (B, H, hd)
  const int* kv_len;       // (B,)
  __nv_bfloat16* o;        // (B, H, hd)
  float* ws;               // more than one cluster a pair: (B·Hkv, clusters, G, hd) outputs, then their
                           // (B·Hkv, clusters, G) log-sum-exps
  int* count;              // (B·Hkv,) clusters or items of the pair done so far, 0 between calls
  int H, Hkv, G, cap, chunk;  // chunk: a dense split's positions
  float scale, softcap;
  int B, blocks;           // paged: slots, and the work list's blocks (items of at most ceil(tiles / blocks))
};

// byte offset of 16-byte chunk j of tile row r in the 128-byte-swizzled
// layout TMA writes: 64-column boxes of BK rows, chunk index XOR (row % 8)
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>((j >> 3) * BK * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4));
}

// the ring's barriers: full[STAGES], then empty[STAGES]
template <int STAGES>
struct Bars {
  uint32_t base;
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8u * (STAGES + s); }
};

// dense cache: one thread loads both tiles of every stage through TMA;
// positions past Skv read as zeros
struct DenseLoader {
  CUtensorMap mk, mv;
  static constexpr uint32_t FULL_COUNT = 1;
  static constexpr bool WORKLIST = false;  // cluster splits (the paged loaders: the work list)
  template <int HD>
  __device__ __forceinline__ void produce(int lane, uint32_t sK, uint32_t sV, Bars<Layout<HD>::STAGES> bar,
                                          int b, int kvh, int start, int /*end*/, int ntiles) const {
    using L = Layout<HD>;
    if (lane != 0) return;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % L::STAGES, pos0 = start + t * BK;
      if (t >= L::STAGES) mbar_wait(bar.empty(s), ((t / L::STAGES) - 1) & 1);
      mbar_expect_tx(bar.full(s), 2 * L::TILE);
#pragma unroll
      for (int c = 0; c < L::NBOX; ++c) {
        tma_load_4d(sK + s * L::TILE + c * BK * 128, &mk, bar.full(s), c * 64, kvh, pos0, b);
        tma_load_4d(sV + s * L::TILE + c * BK * 128, &mv, bar.full(s), c * 64, kvh, pos0, b);
      }
    }
  }
};

// page pool through TMA, where the page size allows it: a 64-key tile is
// 64 / R pieces of R = min(ps, 64) rows that each lie in one page, and
// lane q of the producer warp loads piece q from a 4-D map over the pool
// (hd, Hkv, ps, P), one box per 64 columns. R is a multiple of 8, so every
// piece starts on a 128-byte-swizzle atom and the tile's layout is the
// dense one. Pieces past kv_len are not loaded (their rows are masked and,
// in V, zeroed by the consumers); the table entries of the next tile are
// loaded while the warp waits for its stage to be freed
struct PagedTmaLoader {
  CUtensorMap mk, mv;
  const int* table;  // (B, NP)
  int NP, ps, P, R;
  static constexpr uint32_t FULL_COUNT = 1;
  static constexpr bool WORKLIST = true;

  template <int HD>
  __device__ __forceinline__ void produce(int lane, uint32_t sK, uint32_t sV, Bars<Layout<HD>::STAGES> bar,
                                          int b, int kvh, int start, int end, int ntiles) const {
    using L = Layout<HD>;
    const int npieces = BK / R;
    auto fetch = [&](int pos0) {
      const int pos = pos0 + lane * R;
      return lane < npieces && pos < end ? table[static_cast<size_t>(b) * NP + pos / ps] : 0;
    };
    int entry = fetch(start);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % L::STAGES, pos0 = start + t * BK;
      if (t >= L::STAGES) mbar_wait(bar.empty(s), ((t / L::STAGES) - 1) & 1);
      const int nvalid = min(npieces, (end - pos0 + R - 1) / R);
      if (lane == 0) mbar_expect_tx(bar.full(s), nvalid * L::NBOX * 2 * R * 128);
      __syncwarp();
      if (lane < nvalid) {
        const int page = min(max(entry, 0), P - 1), row = (pos0 + lane * R) % ps;
#pragma unroll
        for (int c = 0; c < L::NBOX; ++c) {
          const uint32_t off = s * L::TILE + c * BK * 128 + lane * R * 128;
          tma_load_4d(sK + off, &mk, bar.full(s), c * 64, kvh, row, page);
          tma_load_4d(sV + off, &mv, bar.full(s), c * 64, kvh, row, page);
        }
      }
      if (t + 1 < ntiles) entry = fetch(pos0 + BK);
    }
  }
};

// page pool, any page size: the warp's lanes copy 16-byte chunks through the
// table with cp.async (zero-filled past end) and each lane counts its copies
// on the stage's barrier
struct PagedLoader {
  const __nv_bfloat16* k;  // (P, ps, Hkv, hd)
  const __nv_bfloat16* v;
  const int* table;        // (B, NP)
  int NP, ps, P, Hkv;
  static constexpr uint32_t FULL_COUNT = 32;
  static constexpr bool WORKLIST = true;

  // table entries of rows pos0 + lane and pos0 + 32 + lane (0 past end)
  __device__ __forceinline__ void fetch(int (&entry)[2], int lane, int b, int pos0, int end) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = pos0 + 32 * h + lane;
      entry[h] = pos < end ? table[static_cast<size_t>(b) * NP + pos / ps] : 0;
    }
  }

  template <int HD>
  __device__ __forceinline__ void produce(int lane, uint32_t sK, uint32_t sV, Bars<Layout<HD>::STAGES> bar,
                                          int b, int kvh, int start, int end, int ntiles) const {
    using L = Layout<HD>;
    constexpr int CPR = L::CPR;
    int entry[2];
    fetch(entry, lane, b, start, end);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % L::STAGES, pos0 = start + t * BK;
      if (t >= L::STAGES) mbar_wait(bar.empty(s), ((t / L::STAGES) - 1) & 1);
      unsigned long long row[2];  // element offsets of this lane's two rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int page = min(max(entry[h], 0), P - 1);
        row[h] = ((static_cast<unsigned long long>(page) * ps + (pos0 + 32 * h + lane) % ps) * Hkv + kvh) * HD;
      }
      const uint32_t dk = sK + s * L::TILE, dv = sV + s * L::TILE;
#pragma unroll 4
      for (int i = 0; i < BK * CPR / 32; ++i) {
        const int idx = i * 32 + lane, r = idx / CPR, j = idx % CPR;
        // the warp's 32 chunks span 32 / CPR rows, all below or all above row 32
        const unsigned long long off = __shfl_sync(0xffffffffu, r < 32 ? row[0] : row[1], r % 32) + j * 8;
        const int bytes = pos0 + r < end ? 16 : 0;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dk + swz(r, j)),
                     "l"(bytes ? k + off : k), "r"(bytes));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dv + swz(r, j)),
                     "l"(bytes ? v + off : v), "r"(bytes));
      }
      cp_async_mbar_arrive(bar.full(s));
      if (t + 1 < ntiles) fetch(entry, lane, b, pos0 + BK, end);
    }
  }
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCTHREADS) : "memory");
}

template <int STAGES, class Loader>
__device__ __forceinline__ void init_ring(Bars<STAGES> bar) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bar.full(s), Loader::FULL_COUNT);
    mbar_init(bar.empty(s), NCWARPS);  // lane 0 of each consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a paged call's work item: positions [start, end) of slot b, KV head kvh;
// the pair's n items are numbered first, ..., first + n - 1
struct Item {
  int b, kvh, start, end, first, n;
};

__device__ __forceinline__ int slot_tiles(const Params& p, int b) {
  return (min(max(p.kv_len[b], 0), p.cap) + BK - 1) / BK;
}

// The work list, built alike by every block from kv_len (the header's
// rule) by its first warp: lanes take slots 32 at a time, a warp sum gives
// the call's tiles and per, a warp scan numbers the items, and the lane
// whose slot holds item blockIdx.x fills it in. Returns false when the
// block has no item; `empty` is whether slot blockIdx.x (< B) has no
// admitted key. One block barrier in all.
__device__ bool find_item(const Params& p, Item& item, bool& empty) {
  __shared__ Item s_item;
  __shared__ int s_items, s_empty;
  const int id = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int total = 0;
    for (int b0 = 0; b0 < p.B; b0 += 32) total += b0 + lane < p.B ? slot_tiles(p, b0 + lane) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    const int per = max((total * p.Hkv + p.blocks - 1) / p.blocks, MIN_TILES);
    int first = 0;  // items of the slots before this round of 32
    for (int b0 = 0; b0 < p.B; b0 += 32) {
      const int b = b0 + lane;
      const int T = b < p.B ? slot_tiles(p, b) : 0, n = (T + per - 1) / per;
      int incl = n * p.Hkv;  // this slot's items, all KV heads
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const int mine = first + incl - n * p.Hkv;  // this slot's first item
      if (id >= mine && id < mine + n * p.Hkv) {
        const int kvh = (id - mine) / n, j = (id - mine) % n;
        const int len = min(max(p.kv_len[b], 0), p.cap);
        const int t0 = static_cast<int>(static_cast<long long>(j) * T / n);
        const int t1 = static_cast<int>(static_cast<long long>(j + 1) * T / n);
        s_item = Item{b, kvh, t0 * BK, min(t1 * BK, len), mine + kvh * n, n};
      }
      if (b == id) s_empty = T == 0;
      first += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_items = first;
  }
  __syncthreads();
  empty = id < p.B && s_empty;
  if (id >= s_items) return false;  // block-uniform
  item = s_item;
  return true;
}

// o = Σ_c w_c·partial_c over n normalised fp32 partials (G·HD apart) and
// their log-sum-exps (G apart), w_c = exp(lse_c - M) / Σ_c' exp(lse_c' - M),
// M the rows' largest lse; the weights go to sGW ([n][MROWS]). A pair with
// no admitted key: every partial is 0 and its lse -inf, so the weights are
// 1 / n and o = 0. The merge is the last step of a call, after its slowest
// block, so its reads from L2 are issued together: the log-sum-exps once
// into shared memory, the partials 8 at a time
template <int HD>
__device__ __forceinline__ void merge_partials(const Params& p, const float* po, const float* pl, int n,
                                               __nv_bfloat16* ob, float* sGW) {
  for (int i = threadIdx.x; i < n * p.G; i += NTHREADS) sGW[i / p.G * MROWS + i % p.G] = __ldcg(pl + i);
  __syncthreads();
  if (threadIdx.x < p.G) {
    const int r = threadIdx.x;
    float M = NEG_INF, Lsum = 0.f;
    for (int c = 0; c < n; ++c) M = fmaxf(M, sGW[c * MROWS + r]);
    for (int c = 0; c < n; ++c) Lsum += expf(sGW[c * MROWS + r] - M);
    const float inv = 1.f / Lsum;
    for (int c = 0; c < n; ++c) sGW[c * MROWS + r] = expf(sGW[c * MROWS + r] - M) * inv;
  }
  __syncthreads();
  const float4* pv = reinterpret_cast<const float4*>(po);
  const int stride = p.G * HD / 4;
  for (int e4 = threadIdx.x; e4 < stride; e4 += NTHREADS) {
    const int r = 4 * e4 / HD;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& x, int c) {
      const float w = sGW[c * MROWS + r];
      A.x += x.x * w;
      A.y += x.y * w;
      A.z += x.z * w;
      A.w += x.w * w;
    };
    int c = 0;
    for (; c + 8 <= n; c += 8) {  // 8 partials' loads in flight before any is used
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __ldcg(pv + (c + u) * stride + e4);
#pragma unroll
      for (int u = 0; u < 8; ++u) add(x[u], c + u);
    }
    for (; c < n; ++c) add(__ldcg(pv + c * stride + e4), c);
    uint2 packed;
    packed.x = pack_bf16(A.x, A.y);
    packed.y = pack_bf16(A.z, A.w);
    *reinterpret_cast<uint2*>(ob + 4 * e4) = packed;
  }
}

template <int HD, class Loader>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_kernel(const __grid_constant__ Params p, const __grid_constant__ Loader ld) {
  using L = Layout<HD>;
  constexpr int STAGES = L::STAGES;
  constexpr int KCH = HD / 16;  // k16 chunks of the head dim
  constexpr int DT = HD / 8;    // n8 tiles of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  const Bars<STAGES> bar{base + L::BAR_OFF};

  int b, kvh, start, end;
  Item item;  // paged: this block's work item
  if constexpr (Loader::WORKLIST) {
    // the ring's barriers first: find_item's block barriers publish them, and
    // the producer starts as soon as the item is known, while the consumers
    // load Q
    if (threadIdx.x == NCTHREADS) init_ring<STAGES, Loader>(bar);
    bool empty;
    const bool has_item = find_item(p, item, empty);
    if (empty) {  // slot blockIdx.x has no admitted key: it outputs 0
      uint4* ob = reinterpret_cast<uint4*>(p.o + static_cast<size_t>(blockIdx.x) * p.H * HD);
      for (int c = threadIdx.x; c < p.H * HD / 8; c += NTHREADS) ob[c] = make_uint4(0, 0, 0, 0);
    }
    if (!has_item) return;
    b = item.b;
    kvh = item.kvh;
    start = item.start;
    end = item.end;
  } else {  // split blockIdx.x of pair blockIdx.y
    b = blockIdx.y / p.Hkv;
    kvh = blockIdx.y % p.Hkv;
    const int len = min(max(p.kv_len[b], 0), p.cap);
    start = blockIdx.x * p.chunk;
    end = min(start + p.chunk, len);
  }
  const int ntiles = end > start ? (end - start + BK - 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp < NCWARPS) {  // the G query rows of this KV head, zero rows past G
    const __nv_bfloat16* qb = p.q + (static_cast<size_t>(b) * p.H + static_cast<size_t>(kvh) * p.G) * HD;
    for (int c = threadIdx.x; c < MROWS * L::CPR; c += NCTHREADS) {
      const int r = c / L::CPR, col = (c % L::CPR) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < p.G) val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(r) * HD + col);
      *reinterpret_cast<uint4*>(sQ + r * L::LDQ + col) = val;
    }
  } else if (lane == 0 && !Loader::WORKLIST) {
    init_ring<STAGES, Loader>(bar);
  }
  if constexpr (Loader::WORKLIST) {
    if (warp < NCWARPS) consumer_sync();  // Q is in; the producer did not wait for it
  } else {
    __syncthreads();
  }

  float* sAcc = reinterpret_cast<float*>(smem + L::ACC_OFF);
  float* sWM = reinterpret_cast<float*>(smem + L::WSTAT_OFF);  // [NCWARPS][MROWS] each
  float* sWL = sWM + NCWARPS * MROWS;
  float* sWF = sWL + NCWARPS * MROWS;
  float* sO = reinterpret_cast<float*>(smem + L::O_OFF);
  float* sCM = reinterpret_cast<float*>(smem + L::CSTAT_OFF);  // [CLUSTER][MROWS] each
  float* sCW = sCM + CLUSTER * MROWS;
  float* sM = reinterpret_cast<float*>(smem + L::STAT_OFF);    // [MROWS]
  float* sL = sM + MROWS;

  if (warp == NCWARPS) {
    ld.template produce<HD>(lane, sK, sV, bar, b, kvh, start, end, ntiles);  // ---- producer ----
  } else {
    // ---- consumers: 16 keys of every tile each ----
    const int g = lane / 4, t4 = lane % 4;
    const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: this lane's matrix and row in it
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const __nv_bfloat16* q_row = sQ + ((mi & 1) * 8 + r8) * L::LDQ + (mi >> 1) * 8;
    const int krow = warp * 16 + (mi >> 1) * 8 + r8;  // K rows: matrices (keys 0-7 | 8-15) × (lo | hi)
    const int vrow = warp * 16 + (mi & 1) * 8 + r8;   // V rows: matrices (keys 0-7 | 8-15) × (col d | d+1)

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(bar.full(s), (t / STAGES) & 1);
      const int k0 = start + t * BK, kbase = k0 + warp * 16;
      if (kbase < end) {  // warp-uniform: this warp's 16 keys admit at least one
        const uint32_t tk = sK + s * L::TILE, tv = sV + s * L::TILE;
        if (kbase + 16 > end) {
          // rows past kv_len may hold anything (a NaN would survive P = 0):
          // zero this warp's V rows there; only this warp reads them
          const int r_lo = end - k0;
          for (int c = lane; c < (warp * 16 + 16 - r_lo) * L::CPR; c += 32) {
            const int r = r_lo + c / L::CPR;
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(tv + swz(r, c % L::CPR)), "r"(0)
                         : "memory");
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before TMA refills the stage
          __syncwarp();
        }

        // S = Q Kᵀ: 16 query rows × this warp's 16 keys
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KCH; ++kc) {
          uint32_t qf[4], kf[4];
          ldmatrix_x4(qf, q_row + kc * 16);
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(kf[0]), "=r"(kf[1]), "=r"(kf[2]), "=r"(kf[3])
                       : "r"(tk + swz(krow, 2 * kc + (mi & 1))));
          mma_16x8x16(sc[0], qf, kf[0], kf[1]);
          mma_16x8x16(sc[1], qf, kf[2], kf[3]);
        }

        // scale, softcap, mask past kv_len; row maxima over the 16 keys
        float tmax0 = NEG_INF, tmax1 = NEG_INF;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kbase + n * 8 + t4 * 2 + (e & 1);
            float x = sc[n][e] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            sc[n][e] = kpos < end ? x : NEG_INF;
          }
          tmax0 = fmaxf(tmax0, fmaxf(sc[n][0], sc[n][1]));
          tmax1 = fmaxf(tmax1, fmaxf(sc[n][2], sc[n][3]));
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
          sc[n][0] = sc[n][0] > 0.5f * NEG_INF ? expf(sc[n][0] - mn0) : 0.f;
          sc[n][1] = sc[n][1] > 0.5f * NEG_INF ? expf(sc[n][1] - mn0) : 0.f;
          sc[n][2] = sc[n][2] > 0.5f * NEG_INF ? expf(sc[n][2] - mn1) : 0.f;
          sc[n][3] = sc[n][3] > 0.5f * NEG_INF ? expf(sc[n][3] - mn1) : 0.f;
          ps0 += sc[n][0] + sc[n][1];
          ps1 += sc[n][2] + sc[n][3];
        }
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;

        // O = O·alpha + P V: S's accumulator layout is P's A-fragment layout
        const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                                pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t vf[4];
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(vf[0]), "=r"(vf[1]), "=r"(vf[2]), "=r"(vf[3])
                       : "r"(tv + swz(vrow, d + (mi >> 1))));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[d + h][0] *= alpha0;
            acc[d + h][1] *= alpha0;
            acc[d + h][2] *= alpha1;
            acc[d + h][3] *= alpha1;
            mma_16x8x16(acc[d + h], pa, vf[2 * h], vf[2 * h + 1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.empty(s));
    }
    consumer_sync();  // every warp is done with the ring; it now holds the merge buffers

    // merge the 4 warps: row statistics and unnormalised accumulators
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (t4 == 0) {
      sWM[warp * MROWS + g] = m0;
      sWM[warp * MROWS + g + 8] = m1;
      sWL[warp * MROWS + g] = l0;
      sWL[warp * MROWS + g + 8] = l1;
    }
    float* wa = sAcc + warp * MROWS * L::LDA;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + t4 * 2;
      wa[g * L::LDA + c] = acc[d][0];
      wa[g * L::LDA + c + 1] = acc[d][1];
      wa[(g + 8) * L::LDA + c] = acc[d][2];
      wa[(g + 8) * L::LDA + c + 1] = acc[d][3];
    }
    consumer_sync();
    if (threadIdx.x < MROWS) {  // the block's row statistics and each warp's weight
      const int r = threadIdx.x;
      float M = NEG_INF, Lsum = 0.f;
#pragma unroll
      for (int w = 0; w < NCWARPS; ++w) M = fmaxf(M, sWM[w * MROWS + r]);
#pragma unroll
      for (int w = 0; w < NCWARPS; ++w) {
        const float f = expf(sWM[w * MROWS + r] - M);
        sWF[w * MROWS + r] = f;
        Lsum += sWL[w * MROWS + r] * f;
      }
      sM[r] = M;
      sL[r] = Lsum;
    }
    consumer_sync();
    for (int e4 = threadIdx.x; e4 < p.G * HD / 4; e4 += NCTHREADS) {
      const int r = 4 * e4 / HD, c = 4 * e4 % HD;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NCWARPS; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(sAcc + (w * MROWS + r) * L::LDA + c);
        const float f = sWF[w * MROWS + r];
        A.x += x.x * f;
        A.y += x.y * f;
        A.z += x.z * f;
        A.w += x.w * f;
      }
      *reinterpret_cast<float4*>(sO + r * HD + c) = A;
    }
  }

  __shared__ int s_last;
  const size_t pair = static_cast<size_t>(b) * p.Hkv + kvh;
  __nv_bfloat16* ob = p.o + (static_cast<size_t>(b) * p.H + static_cast<size_t>(kvh) * p.G) * HD;
  if constexpr (Loader::WORKLIST) {
    // one item: o from this block's output; several: the normalised output
    // and log-sum-exp to the workspace, and the pair's last item merges them
    __syncthreads();
    const bool alone = item.n == 1;
    float* wo = p.ws + static_cast<size_t>(blockIdx.x) * p.G * HD;
    for (int e4 = threadIdx.x; e4 < p.G * HD / 4; e4 += NTHREADS) {
      const int r = 4 * e4 / HD;
      const float inv = 1.f / sL[r];  // an item admits at least one key
      float4 A = reinterpret_cast<const float4*>(sO)[e4];
      A.x *= inv;
      A.y *= inv;
      A.z *= inv;
      A.w *= inv;
      if (alone) {
        uint2 packed;
        packed.x = pack_bf16(A.x, A.y);
        packed.y = pack_bf16(A.z, A.w);
        *reinterpret_cast<uint2*>(ob + 4 * e4) = packed;
      } else {
        *reinterpret_cast<float4*>(wo + 4 * e4) = A;
      }
    }
    if (alone) return;
    float* ws_lse = p.ws + static_cast<size_t>(gridDim.x) * p.G * HD;
    if (threadIdx.x < p.G) ws_lse[static_cast<size_t>(blockIdx.x) * p.G + threadIdx.x] = sM[threadIdx.x] + logf(sL[threadIdx.x]);
    // one thread's release fence is cumulative over the block's writes that
    // the block barrier ordered before it: the partial, then the count; the
    // last item's acquire fence after the count takes in the others' partials
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      s_last = atomicAdd(p.count + pair, 1) == item.n - 1;
      if (s_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    __syncthreads();
    if (!s_last) return;
    merge_partials<HD>(p, p.ws + static_cast<size_t>(item.first) * p.G * HD,
                       ws_lse + static_cast<size_t>(item.first) * p.G, item.n, ob,
                       reinterpret_cast<float*>(smem + L::GW_OFF));
    if (threadIdx.x == 0) p.count[pair] = 0;  // the next call, or graph replay, starts from 0
    return;
  }

  // merge the cluster's splits through distributed shared memory:
  // o = Σ_s w_s·A_s with w_s = exp(M_s - max M) / Σ_s' exp(M_s' - max M)·L_s',
  // block `rank` writing every csize-th group of 4 output elements
  cg::cluster_group cluster = cg::this_cluster();
  // the grid's x extent is nclus clusters of csize splits
  const int csize = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int nclus = gridDim.x / csize, clus = blockIdx.x / csize;
  cluster.sync();
  if (threadIdx.x < csize * MROWS) {  // the splits' row statistics, one remote read each
    const int s = threadIdx.x / MROWS, r = threadIdx.x % MROWS;
    sCM[threadIdx.x] = *cluster.map_shared_rank(sM + r, s);
    sCW[threadIdx.x] = *cluster.map_shared_rank(sL + r, s);
  }
  __syncthreads();
  float lse = NEG_INF;  // thread r < MROWS: the cluster's log-sum-exp of row r
  if (threadIdx.x < MROWS) {
    const int r = threadIdx.x;
    float M = NEG_INF, Lsum = 0.f;
    for (int s = 0; s < csize; ++s) M = fmaxf(M, sCM[s * MROWS + r]);
    for (int s = 0; s < csize; ++s) Lsum += sCW[s * MROWS + r] * expf(sCM[s * MROWS + r] - M);
    const float inv = Lsum > 0.f ? 1.f / Lsum : 0.f;  // Lsum = 0: no admitted key (kv_len <= 0)
    for (int s = 0; s < csize; ++s) sCW[s * MROWS + r] = expf(sCM[s * MROWS + r] - M) * inv;
    if (Lsum > 0.f) lse = M + logf(Lsum);
  }
  __syncthreads();
  float* wo = p.ws + (pair * nclus + clus) * p.G * HD;  // this cluster's output, more than one cluster
  for (int e4 = rank * NTHREADS + threadIdx.x; e4 < p.G * HD / 4; e4 += csize * NTHREADS) {
    const int r = 4 * e4 / HD;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < CLUSTER; ++s) {
      if (s < csize) {  // the splits' reads are independent: all in flight at once
        const float4 x = *cluster.map_shared_rank(reinterpret_cast<float4*>(sO) + e4, s);
        const float w = sCW[s * MROWS + r];
        A.x += x.x * w;
        A.y += x.y * w;
        A.z += x.z * w;
        A.w += x.w * w;
      }
    }
    if (nclus == 1) {
      uint2 packed;
      packed.x = pack_bf16(A.x, A.y);
      packed.y = pack_bf16(A.z, A.w);
      *reinterpret_cast<uint2*>(ob + 4 * e4) = packed;
    } else {
      *reinterpret_cast<float4*>(wo + 4 * e4) = A;
    }
  }
  if (nclus == 1) {
    cluster.sync();  // no block leaves while another still reads its shared memory
    return;
  }
  float* ws_lse = p.ws + static_cast<size_t>(gridDim.y) * nclus * p.G * HD;
  if (rank == 0 && threadIdx.x < p.G) ws_lse[(pair * nclus + clus) * p.G + threadIdx.x] = lse;
  __threadfence();  // this thread's partial, before the cluster counts itself in
  cluster.sync();

  // merge the pair's clusters: the last one to count itself in reads them all
  if (rank != 0) return;  // block-uniform
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(p.count + pair, 1) == nclus - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_partials<HD>(p, p.ws + pair * nclus * p.G * HD, ws_lse + pair * nclus * p.G, nclus, ob,
                     reinterpret_cast<float*>(smem + L::GW_OFF));
  if (threadIdx.x == 0) p.count[pair] = 0;  // the next call, or graph replay, starts from 0
}

// dense: grid (splits, B·Hkv) in clusters of min(splits, 8); paged: the
// work list's blocks + B·Hkv blocks, no clusters
template <int HD, class Loader>
cudaError_t launch(const Params& p, const Loader& ld, int splits, cudaStream_t stream) {
  constexpr int smem = Layout<HD>::ALLOC;
  static cudaError_t opted =
      cudaFuncSetAttribute(decode_kernel<HD, Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return opted;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits < CLUSTER ? splits : CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = Loader::WORKLIST ? dim3(p.blocks + p.B * p.Hkv) : dim3(splits, p.B * p.Hkv);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = Loader::WORKLIST ? 0 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<HD, Loader>, p, ld);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool bad_heads(const Params& p) {
  return p.B <= 0 || p.Hkv <= 0 || p.G < 1 || p.G > MROWS || p.H != p.Hkv * p.G || p.cap <= 0;
}

bool bad_plan(const Params& p, int splits) {
  return bad_heads(p) || p.B * p.Hkv > 65535 || p.chunk <= 0 || p.chunk % BK != 0 || splits < 1 ||
         (splits > CLUSTER && (splits % CLUSTER != 0 || splits > CLUSTER * MAX_CLUSTERS || !p.ws || !p.count)) ||
         static_cast<long long>(splits) * p.chunk < p.cap;
}

// the work list's tile counts and item numbers must fit an int
bool bad_work(const Params& p) {
  return bad_heads(p) || p.blocks < 1 || p.blocks > MAX_BLOCKS || !p.ws || !p.count ||
         static_cast<long long>(p.B) * p.Hkv * ((p.cap + BK - 1) / BK + 1) > (1LL << 30);
}

template <int HD, class Loader>
int resident(int* blocks) {
  constexpr int smem = Layout<HD>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<HD, Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int s = 1; s <= CLUSTER && err == cudaSuccess; ++s) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(s, 65535);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, decode_kernel<HD, Loader>, &cfg);
    blocks[s - 1] = clusters * s;
  }
  return err;
}

}  // namespace

// Plain C entries for ctypes. q, o: (B, H, hd) bf16; kv_len: (B,) int32;
// chunk is a multiple of 64 with splits·chunk >= the cache's capacity;
// splits <= 8 is one cluster per slot and KV head, more must be a multiple
// of 8 up to 1024 and then needs ws, fp32 of B·Hkv·(splits / 8)·G·(hd + 1)
// elements, and count, B·Hkv int32 zeros (left zero by the call); both may
// be null otherwise. softcap <= 0 means none. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                                     void* ws, int* count, int B, int H, int Hkv, int hd, int Skv, int chunk,
                                     int splits, float softcap, float scale, void* stream) {
  const Params p{static_cast<const __nv_bfloat16*>(q), kv_len, static_cast<__nv_bfloat16*>(o), static_cast<float*>(ws),
                 count, H, Hkv, Hkv > 0 ? H / Hkv : 0, Skv, chunk, scale, softcap, B, 0};
  if (bad_plan(p, splits)) return cudaErrorInvalidValue;
  if (encode_fn() == nullptr) return cudaErrorNotSupported;
  DenseLoader ld;
  if (!make_bshd_map(&ld.mk, k, B, Skv, Hkv, hd, BK) || !make_bshd_map(&ld.mv, v, B, Skv, Hkv, hd, BK))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(p, ld, splits, s);
    case 128:
      return launch<128>(p, ld, splits, s);
    case 256:
      return launch<256>(p, ld, splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// k_pages, v_pages: (P, ps, Hkv, hd) bf16; page_table: (B, NP) int32, the
// slot's physical pages in logical order (entries past the last occupied
// page are never read; the ones read are clipped to [0, P-1]). blocks, 1 to
// 1024, sizes the work list: items of at most max(ceil(tiles / blocks), 2)
// 64-key tiles, launched on blocks + B·Hkv blocks. ws: fp32 of
// (blocks + B·Hkv)·G·(hd + 1) elements; count: B·Hkv int32 zeros (left zero
// by the call).
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                           const int* page_table, const int* kv_len, void* o, void* ws,
                                           int* count, int B, int H, int Hkv, int hd, int P, int ps, int NP,
                                           int blocks, float softcap, float scale, void* stream) {
  if (P <= 0 || ps <= 0 || NP <= 0) return cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(q), kv_len, static_cast<__nv_bfloat16*>(o), static_cast<float*>(ws),
                 count, H, Hkv, Hkv > 0 ? H / Hkv : 0, NP * ps, 0, scale, softcap, B, blocks};
  if (bad_work(p) || (hd != 64 && hd != 128 && hd != 256)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = min(ps, BK);
  if (R % 8 == 0 && (BK % ps == 0 || ps % BK == 0) && encode_fn() != nullptr) {  // pieces of whole pages
    PagedTmaLoader ld;
    ld.table = page_table;
    ld.NP = NP;
    ld.ps = ps;
    ld.P = P;
    ld.R = R;
    if (!make_bshd_map(&ld.mk, k_pages, P, ps, Hkv, hd, R) || !make_bshd_map(&ld.mv, v_pages, P, ps, Hkv, hd, R))
      return cudaErrorInvalidValue;
    return hd == 64 ? launch<64>(p, ld, 0, s) : hd == 128 ? launch<128>(p, ld, 0, s) : launch<256>(p, ld, 0, s);
  }
  const PagedLoader ld{static_cast<const __nv_bfloat16*>(k_pages), static_cast<const __nv_bfloat16*>(v_pages),
                       page_table, NP, ps, P, Hkv};
  return hd == 64 ? launch<64>(p, ld, 0, s) : hd == 128 ? launch<128>(p, ld, 0, s) : launch<256>(p, ld, 0, s);
}

// blocks[s - 1], s = 1..8: the kernel's blocks that the current device holds
// at once when the splits of a (slot, KV head) form clusters of s. A cluster
// must fit one GPC, so this is at most, and for s > 2 less than, the SMs
// times the blocks one SM holds. The paged kernel runs without clusters:
// its plan reads blocks[0].
extern "C" int decode_attention_resident(int hd, int paged, int* blocks) {
  switch (hd) {
    case 64:
      return paged ? resident<64, PagedTmaLoader>(blocks) : resident<64, DenseLoader>(blocks);
    case 128:
      return paged ? resident<128, PagedTmaLoader>(blocks) : resident<128, DenseLoader>(blocks);
    case 256:
      return paged ? resident<256, PagedTmaLoader>(blocks) : resident<256, DenseLoader>(blocks);
    default:
      return cudaErrorInvalidValue;
  }
}
