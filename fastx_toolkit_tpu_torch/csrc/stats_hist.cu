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
// Design.  The TPU kernel's factored one-hot product on the matrix unit is
// not carried over: on this card a histogram is a tally in shared memory.
//   * A block owns a tile of P = 32 positions x 654 bins of int32 in dynamic
//     shared memory (83,712 B, above the 48 KB default, so the launcher
//     raises the limit), laid out [bin][position].  The 32 lanes of a warp
//     take the 32 consecutive positions of one read, so they hit 32
//     different banks: no bank conflict and no two lanes on one address,
//     however few quality values a lane sees (NovaSeq writes four).
//   * A warp's loads of one read are 32 neighbouring bytes of bases and of
//     qualities (coalesced).  Each warp issues the loads of U = 4 reads
//     before it tallies them, so that four loads are in flight: the chain
//     of dependent loads (length, then bytes) is what a warp waits on.
//   * The flush is the trap.  Each block adds its tile to the output with
//     global atomics, only the non-zero bins, in position-major order so
//     that neighbouring threads hit neighbouring addresses.  With many
//     blocks per position tile the flush's atomics would outnumber the bases
//     tallied, so the grid holds about two blocks per SM in all (2 x 132 on
//     an H100, which is also what the shared memory admits: two tiles an
//     SM): ceil(L / 32) position tiles x ceil(2 x SMs / tiles) read ranges.
//     At 262,144 reads of 100 bp that is 4 x 66 blocks; a tile of Illumina
//     reads has about 200 non-zero bins a position (5 slots x ~41 quality
//     values), so about 1.7M flush atomics against 26M bases tallied.
//   * The slot table (STATS_INDEX, core/records.py) lives in __constant__
//     memory and is staged into shared memory by each block: the lanes of a
//     warp read different entries, which constant memory serialises, while
//     the ten letters fall in eight different shared-memory banks.
// What bounds it: the bytes read, about 2 per base (52 MB per 262,144 reads
// of 100 bp, 16 us at 3.35 TB/s), and one shared-memory atomic per base;
// the launch, the zeroing and the flush add a few microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 32;                 // positions a tile (= lanes of a warp)
constexpr int NBINS = 109;            // quality values -15..93
constexpr int F = 6 * NBINS;          // bins a position
constexpr int MIN_Q = -15;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;                  // reads a warp loads before tallying
constexpr size_t SMEM = (size_t)P * F * sizeof(int32_t);

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

// codes: ASCII [B, W] (W = L) or 2-bit bytes [B, W] (W >= ceil(L/4));
// quals [B, L]; grid (ceil(L/P), ranges), each range reads_per_block reads.
template <bool B2>
__global__ void __launch_bounds__(THREADS, 2)
stats_hist_kernel(const uint8_t* __restrict__ codes,
                  const int8_t* __restrict__ quals,
                  const int32_t* __restrict__ lengths, int B, int L, int W,
                  int reads_per_block, int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];  // [F][P]
  __shared__ uint8_t lut[256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos0 = blockIdx.x * P;
  const int pos = pos0 + lane;
  for (int i = threadIdx.x; i < F * P; i += THREADS) tile[i] = 0;
  if (!B2)
    for (int i = threadIdx.x; i < 256; i += THREADS) lut[i] = c_stats_index[i];
  __syncthreads();

  const int r0 = blockIdx.y * reads_per_block;
  const int r1 = min(B, r0 + reads_per_block);
  int32_t* col = tile + lane;
  for (int r = r0 + warp; r < r1; r += WARPS * U) {
    int id[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = r + u * WARPS;
      id[u] = -1;
      if (b < r1 && pos < L && pos < lengths[b]) {
        int slot;
        if (B2) {
          const int byte = codes[(size_t)b * W + (pos >> 2)];
          slot = ((byte >> (6 - 2 * (pos & 3))) & 3) + 1;
        } else {
          slot = lut[codes[(size_t)b * W + pos]];
        }
        int q = (int)quals[(size_t)b * L + pos] - MIN_Q;
        q = q < 0 ? 0 : (q > NBINS - 1 ? NBINS - 1 : q);
        id[u] = slot * NBINS + q;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (id[u] >= 0) atomicAdd(&col[id[u] * P], 1);
  }
  __syncthreads();

  // flush the non-zero bins, position-major (neighbouring global addresses)
  const int npos = min(P, L - pos0);
  for (int i = threadIdx.x; i < npos * F; i += THREADS) {
    const int p = i / F;
    const int f = i - p * F;
    const int v = tile[f * P + p];
    if (v != 0) atomicAdd(&out[(size_t)(pos0 + p) * F + f], v);
  }
}

template <bool B2>
cudaError_t launch(dim3 grid, const void* codes, const void* quals,
                   const void* lengths, int B, int L, int W, int per,
                   void* out, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      stats_hist_kernel<B2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  stats_hist_kernel<B2><<<grid, THREADS, SMEM, s>>>(
      (const uint8_t*)codes, (const int8_t*)quals, (const int32_t*)lengths,
      B, L, W, per, (int32_t*)out);
  return cudaGetLastError();
}

}  // namespace

// codes [B, W] uint8 (ASCII bases with W = L, or with b2 != 0 the 2-bit
// bytes with 4 * W >= L), quals [B, L] int8, lengths [B] int32, out
// [L, 6, 109] int32 zeroed; sms: the card's SM count.  Returns
// cudaGetLastError() after the launch.
extern "C" int fx_stats_hist(const void* codes, const void* quals,
                             const void* lengths, int B, int L, int W, int b2,
                             int sms, void* out, void* stream) {
  if (B < 0 || L < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (b2 ? 4LL * W < L : W != L) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return (int)cudaSuccess;
  const int tiles = (L + P - 1) / P;
  int ranges = (2 * sms + tiles - 1) / tiles;
  const int most = (B + WARPS - 1) / WARPS;  // at least a read per warp
  if (ranges > most) ranges = most;
  const int per = (B + ranges - 1) / ranges;
  ranges = (B + per - 1) / per;
  const dim3 grid(tiles, ranges);
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      b2 ? launch<true>(grid, codes, quals, lengths, B, L, W, per, out, s)
         : launch<false>(grid, codes, quals, lengths, B, L, W, per, out, s);
  return (int)e;
}
