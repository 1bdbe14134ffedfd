// K5: the quality-stats histogram, for Hopper.
//
// Replaces fastx_toolkit_tpu/kernels/stats_pallas.py::_make_kernel, entered
// through stats_hist_pallas (ASCII bases) and stats_hist_pallas_b2 (the
// 2-bit pack_batch2 bytes, 4 codes a byte, MSB first).  For each read b and
// position x < min(lengths[b], L): hist[x][slot][qbin] += 1, where slot is
// STATS_INDEX[byte] (1..5 for AaCcGgTtNn, 0 for any other byte) or, in the
// 2-bit mode, code + 1; qbin = clamp(q + 15, 0, 108).  Output int32
// [L, 6, 109], zeroed by the caller.  Integer atomics sum in any order to
// the same result.
//
// What bounds it: the bytes read, about 2 per base (the whole [B, L] rows:
// 67 MB per 262,144 reads padded to L = 128, 20 us at 3.35 TB/s), and one
// shared-memory atomic per counted base.  The TPU kernel's factored
// one-hot product on the matrix unit is not carried over: on this card a
// histogram is a tally in shared memory.  The parent design (one lane a
// position, each lane loading its own bytes) spent 0.17 of its 0.23 ms on
// a chain of dependent device loads (length, then bytes) a read.
//
// Design (the one-tile kernel, L <= LMAX and W <= LMAX):
//   * One block an SM owns the whole histogram of its reads as 16-bit
//     counters, two bins to a 32-bit word: 327 words a position, laid out
//     [word][position] with the position stride P = L rounded up to 32
//     (167,424 B at L = 128, 209,280 B at L = 160).  A base adds 1 or
//     65,536 to the word of its bin pair.  A block takes at most CAP =
//     65,535 reads, so no half can carry into the other.
//   * A block's reads are one contiguous span of codes, one of quals and
//     one of lengths.  A producer warp streams them into a ring of STAGES
//     shared-memory stages with TMA bulk copies (cp.async.bulk, completing
//     on an mbarrier a stage; bytes outside the array's 16-byte chunks go
//     one at a time), and refills a stage when the 31 tally warps have
//     arrived on its "empty" mbarrier.  No block-wide barrier, and no
//     device-memory load in the tally loop.
//   * The tally: a read a warp, a position a lane, so the 32 lanes hit 32
//     different words in 32 different banks whatever bins they hit; a read
//     costs its length compare in shared memory and one pass of the warp
//     per 32 positions it has (no pass for positions past its length).
//     What holds it: the shared-memory atomics, about 2 bases a clock an
//     SM on an H100.
//   * The flush: a cluster of CLUSTER blocks on neighbouring SMs sums its
//     tiles through distributed shared memory, each block a quarter of the
//     words, and adds the non-zero sums to the output with global atomics:
//     a quarter of the atomics one block per SM would send.  Reads of the
//     tiles run along positions (conflict-free).
//   * The slot table (STATS_INDEX, core/records.py) lives in __constant__
//     memory and is staged into shared memory, premultiplied by 109.
// Beyond LMAX (or a 2-bit row wider than LMAX bytes) the tiled kernel
// takes the batch: position tiles of 32 in 83,712 B of 32-bit counters,
// two blocks an SM, each lane loading its own bytes from device memory
// (the port's first design, kept for long reads).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NBINS = 109;            // quality values -15..93
constexpr int F = 6 * NBINS;          // bins a position
constexpr int FW = F / 2;             // 16-bit bin pairs a position
constexpr int MIN_Q = -15;

// one-tile kernel
constexpr int LMAX = 160;             // widest L (and 2-bit row) it takes
constexpr int CAP = 65535;            // most reads a block tallies
constexpr int WARPS = 31;             // tally warps, then one producer warp
constexpr int THREADS = 32 * (WARPS + 1);
constexpr int STAGES = 2;             // ring stages
constexpr int RMAX = 256;             // most reads a stage
constexpr int MIN_PER = 64;           // fewest reads worth a block
constexpr int CLUSTER = 4;            // blocks that sum their tiles
constexpr int LUT_BYTES = 256 * 2;    // the slot table, then the barriers
constexpr int HEAD_BYTES = LUT_BYTES + 16 * STAGES;

// tiled kernel
constexpr int TP = 32;                // positions a tile (= lanes of a warp)
constexpr int T_THREADS = 512;
constexpr int T_WARPS = T_THREADS / 32;
constexpr int TU = 4;                 // reads a warp loads before tallying
constexpr size_t T_SMEM = (size_t)TP * F * sizeof(int32_t);

// core/records.py BaseCode.STATS_INDEX: A/a 1, C/c 2, G/g 3, T/t 4, N/n 5
__constant__ uint8_t c_stats_index[256] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 5, 0,
    0, 0, 0, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 5, 0,
    0, 0, 0, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
};

// ---------------------------------------------------------------- one tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-aligned)
// into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A stage's copy of bytes [lo, hi) of the n-byte array src: dst receives
// the 16-byte chunks that hold the span, byte lo at dst[(src + lo) & 15].
// The chunks that lie wholly inside the array go by one TMA bulk copy,
// which lane 0 issues (`bulk` bytes from `from` to dst + `at`); the lanes
// of the producer warp copy the bytes of the span outside them one at a
// time (at most 15 at each end, where the array starts or ends off a
// 16-byte boundary; the whole span when no chunk of it lies inside).
struct Span {
  unsigned bulk;
  unsigned at;
  const void* from;
};

__device__ __forceinline__ Span stage_span(uint8_t* dst, const uint8_t* src,
                                           size_t n, size_t lo, size_t hi,
                                           int lane) {
  const uintptr_t first = (uintptr_t)src;
  const uintptr_t a0 = (first + lo) & ~(uintptr_t)15;
  const uintptr_t a1 = (first + hi + 15) & ~(uintptr_t)15;
  uintptr_t b0 = (first + 15) & ~(uintptr_t)15;
  uintptr_t b1 = (first + n) & ~(uintptr_t)15;
  b0 = b0 > a0 ? b0 : a0;
  b1 = b1 < a1 ? b1 : a1;
  if (b1 <= b0) b0 = b1 = a1;
  const size_t h1 = b0 - first < hi ? b0 - first : hi;  // head [lo, h1)
  const size_t t0 = b1 - first > lo ? b1 - first : lo;  // tail [t0, hi)
  for (size_t k = lo + lane; k < h1; k += 32) dst[first + k - a0] = src[k];
  for (size_t k = t0 + lane; k < hi; k += 32) dst[first + k - a0] = src[k];
  return Span{(unsigned)(b1 - b0), (unsigned)(b0 - a0), (const void*)b0};
}

struct Plan {
  int blocks;   // grid (a multiple of CLUSTER)
  int per;      // reads a block (<= CAP)
  int R;        // reads a stage
  int P;        // position stride of the tile (L rounded up to 32)
  int stage_c;  // bytes of a stage: codes, quals, lengths
  int stage_q;
  int stage_l;
  size_t smem;  // dynamic shared memory a block
};

__host__ __device__ inline int align16(long long x) {
  return (int)((x + 15) & ~15LL);
}

// codes [B, W] (ASCII, W = L; or 2-bit bytes, 4W >= L); quals [B, L].
// Warps 0..WARPS-1 tally, warp WARPS streams the stages.
template <bool B2>
__global__ void __launch_bounds__(THREADS, 1)
stats_tile_kernel(const uint8_t* __restrict__ codes,
                  const int8_t* __restrict__ quals,
                  const int32_t* __restrict__ lengths, int B, int L, int W,
                  Plan plan, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = plan.P;
  uint32_t* tile = (uint32_t*)smem;                          // [FW][P]
  int16_t* lut = (int16_t*)(smem + (size_t)FW * P * 4);      // slot * 109
  uint64_t* full = (uint64_t*)((uint8_t*)lut + LUT_BYTES);   // [STAGES]
  uint64_t* empty = full + STAGES;                           // [STAGES]
  uint8_t* ring = (uint8_t*)(empty + STAGES);
  const int stage = plan.stage_c + plan.stage_q + plan.stage_l;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  uint4* t4 = (uint4*)tile;
  for (int i = threadIdx.x; i < FW * P / 4; i += THREADS)
    t4[i] = make_uint4(0, 0, 0, 0);
  if (!B2)
    for (int i = threadIdx.x; i < 256; i += THREADS)
      lut[i] = (int16_t)(c_stats_index[i] * NBINS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int r0 = min(B, blockIdx.x * plan.per);
  const int r1 = min(B, r0 + plan.per);
  const int nst = (r1 - r0 + plan.R - 1) / plan.R;
  if (warp == WARPS) {
    // the producer: stage s into slot s % STAGES once the tally warps are
    // done with the stage that held it
    for (int s = 0; s < nst; ++s) {
      const int slot = s % STAGES;
      if (s >= STAGES) mbar_wait(&empty[slot], ((s / STAGES) - 1) & 1);
      const size_t ra = (size_t)(r0 + s * plan.R);
      const size_t rb = (size_t)min(r1, r0 + (s + 1) * plan.R);
      uint8_t* bc = ring + (size_t)slot * stage;
      uint8_t* bq = bc + plan.stage_c;
      uint8_t* bl = bq + plan.stage_q;
      const Span sc = stage_span(bc, codes, (size_t)B * W, ra * W, rb * W,
                                 lane);
      const Span sq = stage_span(bq, (const uint8_t*)quals, (size_t)B * L,
                                 ra * L, rb * L, lane);
      const Span sl = stage_span(bl, (const uint8_t*)lengths, (size_t)B * 4,
                                 ra * 4, rb * 4, lane);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[slot], sc.bulk + sq.bulk + sl.bulk);
        if (sc.bulk) bulk_copy(bc + sc.at, sc.from, sc.bulk, &full[slot]);
        if (sq.bulk) bulk_copy(bq + sq.at, sq.from, sq.bulk, &full[slot]);
        if (sl.bulk) bulk_copy(bl + sl.at, sl.from, sl.bulk, &full[slot]);
      }
    }
  } else {
    // the tally: a read a warp, a position a lane; no device-memory load
    for (int s = 0; s < nst; ++s) {
      const int slot = s % STAGES;
      mbar_wait(&full[slot], (s / STAGES) & 1);
      const int ra = r0 + s * plan.R;
      const int nr = min(plan.R, r1 - ra);
      const uint8_t* buf = ring + (size_t)slot * stage;
      const uint8_t* sc = buf + ((uintptr_t)(codes + (size_t)ra * W) & 15);
      const int8_t* sq = (const int8_t*)(buf + plan.stage_c) +
                         ((uintptr_t)(quals + (size_t)ra * L) & 15);
      const int32_t* sl =
          (const int32_t*)(buf + plan.stage_c + plan.stage_q +
                           ((uintptr_t)(lengths + ra) & 15));
      for (int i = warp; i < nr; i += WARPS) {
        const int len = min(sl[i], L);
        const uint8_t* c = sc + i * W;
        const int8_t* q = sq + i * L;
#pragma unroll 2
        for (int p = lane; p < len; p += 32) {
          int id = B2 ? (((c[p >> 2] >> (6 - 2 * (p & 3))) & 3) + 1) * NBINS
                      : (int)lut[c[p]];
          id += min(max((int)q[p] - MIN_Q, 0), NBINS - 1);
          atomicAdd(&tile[(id >> 1) * P + p], 1u << ((id & 1) << 4));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }

  // flush: the cluster's tiles summed, each block a slice of the words
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const uint32_t* peer[CLUSTER];
#pragma unroll
  for (int k = 0; k < CLUSTER; ++k) peer[k] = cluster.map_shared_rank(tile, k);
  const int w0 = FW * rank / CLUSTER;
  const int w1 = FW * (rank + 1) / CLUSTER;
  for (int i = w0 * P + threadIdx.x; i < w1 * P; i += THREADS) {
    const int w = i / P;
    const int p = i - w * P;
    if (p >= L) continue;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < CLUSTER; ++k) {
      const uint32_t v = peer[k][i];
      lo += v & 0xffffu;
      hi += v >> 16;
    }
    int32_t* o = out + (size_t)p * F + 2 * w;
    if (lo) atomicAdd(o, (int32_t)lo);
    if (hi) atomicAdd(o + 1, (int32_t)hi);
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

// Stage and tile sizes for L and W, and the grid for B reads with `active`
// clusters resident at once; false if the ring cannot hold one read a stage.
bool make_plan(int B, int L, int W, int active, int optin, Plan* pl) {
  pl->P = (L + 31) / 32 * 32;
  const long long head = (long long)FW * pl->P * 4 + HEAD_BYTES;
  const long long ring = optin - head;
  int R = RMAX;
  auto stage = [&](int r) {
    return (long long)align16((long long)r * W + 31) +
           align16((long long)r * L + 31) + align16(4LL * r + 31);
  };
  while (R > 0 && STAGES * stage(R) > ring) --R;
  if (R < 1) return false;
  if (R >= WARPS) R -= R % WARPS;  // every warp the same reads a stage
  int blocks = active * CLUSTER;
  const int want = (B + MIN_PER - 1) / MIN_PER;
  if (blocks > want) blocks = want;
  if (blocks < 1) blocks = 1;
  int per = (B + blocks - 1) / blocks;
  if (per > CAP) per = CAP;
  if (per < 1) per = 1;
  blocks = (B + per - 1) / per;
  blocks = (blocks + CLUSTER - 1) / CLUSTER * CLUSTER;
  if (R > per) R = per;
  pl->blocks = blocks;
  pl->per = per;
  pl->R = R;
  pl->stage_c = align16((long long)R * W + 31);
  pl->stage_q = align16((long long)R * L + 31);
  pl->stage_l = align16(4LL * R + 31);
  pl->smem = (size_t)head +
             (size_t)STAGES * (pl->stage_c + pl->stage_q + pl->stage_l);
  return true;
}

bool tile_ok(int L, int W) { return L <= LMAX && W <= LMAX; }

// The cluster launch of the one-tile kernel with a block's whole opt-in
// shared memory (one block an SM), the clusters resident at once, and that
// memory's size.  Looked up once a device and mode: the occupancy query
// costs more host time than a launch.
struct TileConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active;
  int optin;
};

template <bool B2>
cudaError_t tile_config(TileConfig* tc) {
  constexpr int MAX_DEVICES = 64;
  static TileConfig cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && cache[dev].active > 0) {
    *tc = cache[dev];
    tc->cfg.attrs = &tc->attr;
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&tc->optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(stats_tile_kernel<B2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           tc->optin);
  if (e != cudaSuccess) return e;
  tc->cfg = cudaLaunchConfig_t{};
  tc->cfg.gridDim = dim3(CLUSTER);
  tc->cfg.blockDim = dim3(THREADS);
  tc->cfg.dynamicSmemBytes = tc->optin;
  tc->attr.id = cudaLaunchAttributeClusterDimension;
  tc->attr.val.clusterDim.x = CLUSTER;
  tc->attr.val.clusterDim.y = 1;
  tc->attr.val.clusterDim.z = 1;
  tc->cfg.attrs = &tc->attr;
  tc->cfg.numAttrs = 1;
  tc->active = 0;
  e = cudaOccupancyMaxActiveClusters(&tc->active, stats_tile_kernel<B2>,
                                     &tc->cfg);
  if (e != cudaSuccess) return e;
  if (tc->active < 1) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) cache[dev] = *tc;
  return cudaSuccess;
}

template <bool B2>
cudaError_t launch_tile(const void* codes, const void* quals,
                        const void* lengths, int B, int L, int W, void* out,
                        cudaStream_t s) {
  TileConfig tc;
  cudaError_t e = tile_config<B2>(&tc);
  if (e != cudaSuccess) return e;
  Plan pl;
  if (!make_plan(B, L, W, tc.active, tc.optin, &pl))
    return cudaErrorInvalidValue;
  tc.cfg.gridDim = dim3(pl.blocks);
  tc.cfg.dynamicSmemBytes = pl.smem;
  tc.cfg.stream = s;
  e = cudaLaunchKernelEx(&tc.cfg, stats_tile_kernel<B2>,
                         (const uint8_t*)codes, (const int8_t*)quals,
                         (const int32_t*)lengths, B, L, W, pl, (int32_t*)out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------------------ tiled kernel

// codes: ASCII [B, W] (W = L) or 2-bit bytes [B, W] (W >= ceil(L/4));
// quals [B, L]; grid (ceil(L/TP), ranges), each range reads_per_block reads.
template <bool B2>
__global__ void __launch_bounds__(T_THREADS, 2)
stats_tiled_kernel(const uint8_t* __restrict__ codes,
                   const int8_t* __restrict__ quals,
                   const int32_t* __restrict__ lengths, int B, int L, int W,
                   int reads_per_block, int32_t* __restrict__ out) {
  extern __shared__ int32_t ttile[];  // [F][TP]
  __shared__ uint8_t tlut[256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos0 = blockIdx.x * TP;
  const int pos = pos0 + lane;
  for (int i = threadIdx.x; i < F * TP; i += T_THREADS) ttile[i] = 0;
  if (!B2)
    for (int i = threadIdx.x; i < 256; i += T_THREADS)
      tlut[i] = c_stats_index[i];
  __syncthreads();

  const int r0 = blockIdx.y * reads_per_block;
  const int r1 = min(B, r0 + reads_per_block);
  int32_t* col = ttile + lane;
  for (int r = r0 + warp; r < r1; r += T_WARPS * TU) {
    int id[TU];
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const int b = r + u * T_WARPS;
      id[u] = -1;
      if (b < r1 && pos < L && pos < lengths[b]) {
        int slot;
        if (B2) {
          const int byte = codes[(size_t)b * W + (pos >> 2)];
          slot = ((byte >> (6 - 2 * (pos & 3))) & 3) + 1;
        } else {
          slot = tlut[codes[(size_t)b * W + pos]];
        }
        int q = (int)quals[(size_t)b * L + pos] - MIN_Q;
        q = q < 0 ? 0 : (q > NBINS - 1 ? NBINS - 1 : q);
        id[u] = slot * NBINS + q;
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (id[u] >= 0) atomicAdd(&col[id[u] * TP], 1);
  }
  __syncthreads();

  // flush the non-zero bins, position-major (neighbouring global addresses)
  const int npos = min(TP, L - pos0);
  for (int i = threadIdx.x; i < npos * F; i += T_THREADS) {
    const int p = i / F;
    const int f = i - p * F;
    const int v = ttile[f * TP + p];
    if (v != 0) atomicAdd(&out[(size_t)(pos0 + p) * F + f], v);
  }
}

template <bool B2>
cudaError_t launch_tiled(const void* codes, const void* quals,
                         const void* lengths, int B, int L, int W, int sms,
                         void* out, cudaStream_t s) {
  const int tiles = (L + TP - 1) / TP;
  int ranges = (2 * sms + tiles - 1) / tiles;
  const int most = (B + T_WARPS - 1) / T_WARPS;  // at least a read per warp
  if (ranges > most) ranges = most;
  const int per = (B + ranges - 1) / ranges;
  ranges = (B + per - 1) / per;
  cudaError_t e = cudaFuncSetAttribute(
      stats_tiled_kernel<B2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T_SMEM);
  if (e != cudaSuccess) return e;
  stats_tiled_kernel<B2><<<dim3(tiles, ranges), T_THREADS, T_SMEM, s>>>(
      (const uint8_t*)codes, (const int8_t*)quals, (const int32_t*)lengths,
      B, L, W, per, (int32_t*)out);
  return cudaGetLastError();
}

}  // namespace

// codes [B, W] uint8 (ASCII bases with W = L, or with b2 != 0 the 2-bit
// bytes with 4 * W >= L), quals [B, L] int8, lengths [B] int32, out
// [L, 6, 109] int32 zeroed; sms: the card's SM count.  L <= 160 and W <=
// 160 take the one-tile kernel, any other shape the tiled kernel.
// Returns cudaGetLastError() after the launch.
extern "C" int fx_stats_hist(const void* codes, const void* quals,
                             const void* lengths, int B, int L, int W, int b2,
                             int sms, void* out, void* stream) {
  if (B < 0 || L < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (b2 ? 4LL * W < L : W != L) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (tile_ok(L, W))
    e = b2 ? launch_tile<true>(codes, quals, lengths, B, L, W, out, s)
           : launch_tile<false>(codes, quals, lengths, B, L, W, out, s);
  else
    e = b2 ? launch_tiled<true>(codes, quals, lengths, B, L, W, sms, out, s)
           : launch_tiled<false>(codes, quals, lengths, B, L, W, sms, out, s);
  return (int)e;
}

// The one-tile kernel's plan for a launch of fx_stats_hist on this device:
// plan[0..7] = route (1 one-tile, 0 tiled), clusters resident, blocks,
// reads a block, reads a stage, position stride, shared memory a block,
// the device's opt-in shared memory limit.  Returns a CUDA error code.
extern "C" int fx_stats_hist_plan(int B, int L, int W, int b2, int* plan) {
  for (int i = 0; i < 8; ++i) plan[i] = 0;
  TileConfig tc;
  const cudaError_t e = b2 ? tile_config<true>(&tc) : tile_config<false>(&tc);
  if (e != cudaSuccess) return (int)e;
  plan[1] = tc.active;
  plan[7] = tc.optin;
  if (B < 1 || L < 1 || !tile_ok(L, W)) return (int)cudaSuccess;
  Plan pl;
  if (!make_plan(B, L, W, tc.active, tc.optin, &pl))
    return (int)cudaErrorInvalidValue;
  plan[0] = 1;
  plan[2] = pl.blocks;
  plan[3] = pl.per;
  plan[4] = pl.R;
  plan[5] = pl.P;
  plan[6] = (int)pl.smem;
  return (int)cudaSuccess;
}
