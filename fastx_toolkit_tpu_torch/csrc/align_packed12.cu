// K1: the half-local adapter DP on the 2-bit packed upload, for Hopper.
//
// Replaces fastx_toolkit_tpu/kernels/align_pallas.py::_make_kernel_packed12
// (entered through align_batch_pallas_packed with use_p12).  It computes
// what fastx_toolkit_tpu/kernels/align.py::align_batch computes: the exact
// x10-integer DP that carries each cell's path statistics forward, plus
// the tie_fragile flag, bit for bit.  The Pallas body's Hillis-Steele
// scan, scan_window truncation and merged payload word are TPU devices and
// are not carried over.
//
// Design: one thread per read.  The thread walks the columns x of its own
// read (x < min(length, L)); inside a column it walks the adapter rows y
// in order, so the in-column up-chain max is an exact sequential chain
// (the reference's associative combine, applied left to right).  The
// column state lives in registers: for each row a score and two payload
// words, for a compile-time bound of 32 rows (H <= 31):
//   W1: matches (bits 0-7) | mismatches (8-15) | neutral (16-23)
//       | target_start (24-28) | fragile (bit 30)
//   W2: query_start (bits 0-15) | gaps (bits 16-31)
// Any path to row y makes at most y+1 diagonal moves, so each counter is
// <= 31 and an increment never carries into the next field; gaps are
// carried directly (<= L + H), so no derivation is needed at the end.
// The global best is tracked per thread during the fill (first-(x, then
// y) strict max), so no per-row best state and no final reduction exist.
//
// Operands are [words, B] (the engine's transposed layout), so the loads
// b2w[w * B + b] of neighbouring threads are neighbouring words: every
// load is coalesced, and a thread loads one 16-column word per 16
// columns.  Any B is accepted; the ragged edge is masked here.
//
// What bounds it on this card: integer ALU work, about 40 operations per
// DP cell (L x H cells per read), with the operands read once (L/4 bytes
// per read of bases plus L/8 of the N plane) -- far below the memory
// roofline.  Registers bound occupancy (3 x 32 state words per thread);
// rows beyond H are skipped by a branch that is uniform across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GAP = -50;
constexpr int MATCH = 10;
constexpr int MISMATCH = -10;
constexpr int NEUTRAL = 1;
constexpr int NEG = -1000000;
constexpr int NEG_BEST = -10000000;
constexpr int HMAX = 32;

constexpr uint32_t INC_M = 1u;
constexpr uint32_t INC_MM = 1u << 8;
constexpr uint32_t INC_NM = 1u << 16;
constexpr int TS_SHIFT = 24;
constexpr uint32_t FLAG = 1u << 30;
constexpr uint32_t G1 = 1u << 16;  // one gap in W2

struct AdapterCodes {
  unsigned char c[HMAX];  // A0 C1 G2 T3 N4, 5 beyond H
};

__device__ __forceinline__ uint32_t nm_of(uint32_t w1) {
  return (w1 >> 16) & 0xFFu;
}

template <bool HAS_NM, bool TIE>
__global__ void __launch_bounds__(128)
align_packed12_kernel(const uint32_t* __restrict__ b2w,
                      const uint32_t* __restrict__ nmw,
                      const int32_t* __restrict__ lengths,
                      AdapterCodes ad, int H, int L, int B,
                      int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int len = lengths[b];
  if (len > L) len = L;

  int sc[HMAX];
  uint32_t w1[HMAX], w2[HMAX];
#pragma unroll
  for (int y = 0; y < HMAX; ++y) {
    sc[y] = 0;
    w1[y] = 0;
    w2[y] = 0;
  }
  int best = NEG_BEST;
  uint32_t bw1 = 0, bw2 = 0;
  int bx = 0, by = 0;
  bool bfl = false;
  uint32_t wb = 0, wn = 0;

  for (int x = 0; x < len; ++x) {
    if ((x & 15) == 0) wb = b2w[(size_t)(x >> 4) * B + b];
    if (HAS_NM && (x & 31) == 0) wn = nmw[(size_t)(x >> 5) * B + b];
    // codes are MSB-first within a byte, bytes little-endian in the word
    const int code = (wb >> (8 * ((x >> 2) & 3) + 6 - 2 * (x & 3))) & 3;
    const bool qn =
        HAS_NM && ((wn >> (8 * ((x >> 3) & 3) + 7 - (x & 7))) & 1u);
    const bool first = x == 0;

    // previous column's row y-1, read before row y-1 is overwritten
    int up_sc = 0;
    uint32_t up_w1 = 0, up_w2 = 0;
    // running up-chain (cur[y-1]) and the column max over rows < H
    int run_sc = 0;
    uint32_t run_w1 = 0, run_w2 = 0;
    int cmax = 0, cby = 0, ccnt = 0;
    uint32_t cw1 = 0, cw2 = 0;
    bool cany = false;

#pragma unroll
    for (int y = 0; y < HMAX; ++y) {
      if (y < H) {
        const int tc = ad.c[y];
        const bool tn = tc == 4;
        const bool one_n = qn || tn;
        const bool eq = code == tc;
        const int delta =
            (qn && tn) ? 0 : (one_n ? NEUTRAL : (eq ? MATCH : MISMATCH));
        const uint32_t inc = one_n ? INC_NM : (eq ? INC_M : INC_MM);
        const int tb_y = y <= 3 ? 0 : GAP * (y - 3);
        const int tb_ym1 = (y - 1) <= 3 ? 0 : GAP * (y - 4);

        // upper-left candidate; the path starts here at row 0 and in the
        // first column (its source is then a border)
        int ul_sc;
        uint32_t ul_w1, ul_w2;
        if (first || y == 0) {
          ul_sc = (y == 0 ? 0 : tb_ym1) + delta;
          ul_w1 = ((uint32_t)y << TS_SHIFT) + inc;
          ul_w2 = (uint32_t)x;
        } else {
          ul_sc = up_sc + delta;
          ul_w1 = up_w1 + inc;
          ul_w2 = up_w2;
        }

        // left candidate (banned off the diagonal band)
        const bool ban = y > 3 && (y - 3) > x;
        int left_sc;
        uint32_t left_w1, left_w2;
        if (first) {
          left_sc = ban ? NEG : tb_y + GAP;
          left_w1 = (uint32_t)y << TS_SHIFT;
          left_w2 = (uint32_t)x + G1;
        } else {
          left_sc = ban ? NEG : sc[y] + GAP;
          left_w1 = w1[y];
          left_w2 = w2[y] + G1;
        }

        // UL vs LEFT: UL wins ties
        const bool lw = left_sc > ul_sc;
        int e_sc = lw ? left_sc : ul_sc;
        bool e_ul = !lw;
        uint32_t e_w1 = lw ? left_w1 : ul_w1;
        uint32_t e_w2 = lw ? left_w2 : ul_w2;
        if (TIE && left_sc == ul_sc &&
            (nm_of(ul_w1) + nm_of(left_w1) > 0 || ((ul_w1 | left_w1) & FLAG)))
          e_w1 |= FLAG;  // t1

        if (y == 0) {
          // row-0 border-up candidate: beats LEFT ties, loses UL ties
          const bool old_fl = (e_w1 & FLAG) != 0;
          const bool up0 = GAP > e_sc || (GAP == e_sc && !e_ul);
          if (up0) {
            e_sc = GAP;
            e_ul = false;
            e_w1 = 0;
            e_w2 = (uint32_t)x + G1;
          }
          if (TIE) {
            const bool t2 = e_sc == GAP && (nm_of(e_w1) > 0 || old_fl);
            e_w1 = (e_w1 & ~FLAG) | ((!up0 && old_fl) || t2 ? FLAG : 0u);
          }
        }

        // up-chain: the cell's own winner vs the chain from row y-1
        int c_sc = e_sc;
        uint32_t c_w1 = e_w1, c_w2 = e_w2;
        if (y > 0) {
          const int chain_sc = run_sc + GAP;
          const bool ywins = e_sc > chain_sc || (e_sc == chain_sc && e_ul);
          const bool tie =
              TIE && e_sc == chain_sc &&
              (nm_of(run_w1) + nm_of(e_w1) > 0 || ((run_w1 | e_w1) & FLAG));
          if (!ywins) {
            c_sc = chain_sc;
            c_w1 = run_w1;
            c_w2 = run_w2 + G1;
          }
          if (tie) c_w1 |= FLAG;
        }

        up_sc = sc[y];
        up_w1 = w1[y];
        up_w2 = w2[y];
        sc[y] = c_sc;
        w1[y] = c_w1;
        w2[y] = c_w2;
        run_sc = c_sc;
        run_w1 = c_w1;
        run_w2 = c_w2;

        // column max: first y wins, count the rows that tie it
        const bool risky = nm_of(c_w1) > 0 || (c_w1 & FLAG);
        if (y == 0 || c_sc > cmax) {
          cmax = c_sc;
          cby = y;
          cw1 = c_w1;
          cw2 = c_w2;
          ccnt = 1;
          cany = risky;
        } else if (c_sc == cmax) {
          ++ccnt;
          cany = cany || risky;
        }
      }
    }

    const bool improve = cmax > best;
    if (TIE) {
      const bool cfl = (cw1 & FLAG) != 0;
      const bool t5 = ccnt > 1 && cany;
      const bool t4 =
          cmax == best && (nm_of(cw1) + nm_of(bw1) > 0 || cfl || bfl);
      bfl = (improve ? (cfl || t5) : bfl) || t4;
    }
    if (improve) {
      best = cmax;
      bw1 = cw1;
      bw2 = cw2;
      bx = x;
      by = cby;
    }
  }

  out[0 * (size_t)B + b] = bw1 & 0xFFu;                 // matches
  out[1 * (size_t)B + b] = (bw1 >> 8) & 0xFFu;          // mismatches
  out[2 * (size_t)B + b] = bw2 >> 16;                   // gaps
  out[3 * (size_t)B + b] = (bw1 >> 16) & 0xFFu;         // neutral
  out[4 * (size_t)B + b] = bw2 & 0xFFFFu;               // query_start
  out[5 * (size_t)B + b] = bx;                          // query_end
  out[6 * (size_t)B + b] = (bw1 >> TS_SHIFT) & 0x1Fu;   // target_start
  out[7 * (size_t)B + b] = by;                          // target_end
  out[8 * (size_t)B + b] = bfl ? 1 : 0;                 // tie_fragile
}

}  // namespace

// b2w [W16, B] and nmw [W16/2, B] (or null) as uint32 words, lengths [B]
// int32, codes: H adapter codes (host memory), out: [9, B] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int fx_align_packed12(const void* b2w, const void* nmw,
                                 const void* lengths, const unsigned char* codes,
                                 int H, int L, int B, int tie_flag, void* out,
                                 void* stream) {
  if (H < 1 || H > HMAX - 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  AdapterCodes ad;
  for (int y = 0; y < HMAX; ++y) ad.c[y] = y < H ? codes[y] : 5;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* bw = (const uint32_t*)b2w;
  const uint32_t* nw = (const uint32_t*)nmw;
  const int32_t* ln = (const int32_t*)lengths;
  int32_t* o = (int32_t*)out;
  if (nw != nullptr) {
    if (tie_flag)
      align_packed12_kernel<true, true><<<blocks, threads, 0, s>>>(
          bw, nw, ln, ad, H, L, B, o);
    else
      align_packed12_kernel<true, false><<<blocks, threads, 0, s>>>(
          bw, nw, ln, ad, H, L, B, o);
  } else {
    if (tie_flag)
      align_packed12_kernel<false, true><<<blocks, threads, 0, s>>>(
          bw, nw, ln, ad, H, L, B, o);
    else
      align_packed12_kernel<false, false><<<blocks, threads, 0, s>>>(
          bw, nw, ln, ad, H, L, B, o);
  }
  return (int)cudaGetLastError();
}
