// K3: the half-local adapter DP on the 2-bit packed upload, for adapters
// of 32-72 bases and reads over 511 bp, for Hopper.
//
// Replaces fastx_toolkit_tpu/kernels/align_pallas.py::_make_kernel_packed
// (entered through align_batch_pallas_packed when the P12 bounds fail).
// It computes what fastx_toolkit_tpu/kernels/align.py::align_batch
// computes, with the tie_fragile flag, bit for bit.  The Pallas body's
// Hillis-Steele scan, scan window and score floor are TPU devices and are
// not carried over.
//
// What bounds it on this card: int32 issue.  A DP cell (L x H cells a
// read) needs about 20 operations (the score's compares, selects and adds
// and the path statistics' payload); the operands are read once (L/4
// bytes a read of bases, L/8 of the N plane), far below the memory
// roofline.  At the TruSeq shape (262,144 reads x 150 bp, H = 33) that is
// 0.775 ms at 132 SMs x 4 schedulers x 32 lanes a clock.
//
// Design: a lane group per read, the adapter rows in registers, and a
// wavefront over the columns across the lanes.
// - G lanes a read (the least power of two with G x K >= H, so 32 / G
//   reads a warp) and K rows a lane: lane j holds rows j*K .. j*K + K - 1
//   (score, W1, W2 each, in registers) and a byte selector for its adapter
//   code.  The row loop is unrolled, so each row's band test is an
//   immediate.  A cell's score delta and the counter it bumps are two
//   PRMTs from byte tables the lane builds once a column (one byte a row
//   class: A, C, G, T, N), not compares and selects.
// - Rows y >= H (padding) take a delta of 0x80808080 (about -2.1e9) on
//   the upper-left move, so a path into them from row H - 1 goes up
//   (-50) and then left or up (-50 each): it stays strictly below row
//   H - 1's own cell, which reaches the same column by left moves from
//   where the path left it (the left ban grows with y).  With H <= 3 a
//   padding row may also start at the border (-50 at x = 0, then -50 a
//   column), below rows 0-2 (at least -10, -20, -30).  So padding rows
//   never reach nor tie the column max, which takes every row unmasked:
//   a lane takes the max of its K scores, then the first row at it, the
//   count of rows at it and the OR of their W1s (for the risky bit), and
//   merges that behind the rows above.  Every score is at least -10 -
//   50 x 71 (row 0's border move, then up), so the padding rows' sum
//   never wraps.
// - At step s lane j computes column x = s - j for its K rows, then hands
//   lane j + 1 (__shfl_up_sync inside the group) its last row's new
//   (score, W1, W2), the column's partial max (score, W1, W2, and one word
//   with its row, its count of tied rows, its risky bit, and the column's
//   2-bit code and N bit).  Lane j + 1 computes column x one step later:
//   the last row it received seeds its first row's up-chain, and is its
//   first row's upper-left one column on; its column max comes after the
//   one it received (first row wins, ties counted), so the result is the
//   sequential one.  Only lane 0 loads the packed words.  The last lane
//   folds each column max into the read's best and writes the output.
// - Every lane takes part in each shuffle: the loop runs to the warp's
//   longest read plus G - 1 steps; lanes past B or outside their read are
//   predicated off.
// - The first column's borders come from a pseudo column -1 held in the
//   row state before the first step: row y holds (border score of row y,
//   target_start y + 1, query_start 0), so the upper-left move gives the
//   border path, and the left move, which at x = 0 is banned or scores
//   -50 against an upper-left of at least -10, never wins nor ties.
// So each lane's serial chain is K rows, not H; no row state sits in
// shared memory (the one-thread-per-read design it replaces did 3 shared
// loads and 3 stores a cell, 25-55 KB a block, 8-16 warps an SM); and a
// thread holds 3 K state words, not 3 H.
//
// Field widths, checked against the gate (H <= 72, L + H + H_pad < 2^15):
//   W1: matches (bits 0-7) | mismatches (8-15) | neutral (16-23)
//       | target_start (24-30) | fragile (bit 31)
//   W2: query_start (bits 0-15) | gaps (bits 16-31)
// A path to row y makes at most y + 1 <= 72 diagonal moves, so each
// counter stays below 256 and an increment never carries into the next
// field; target_start <= 72 (the pseudo column's y + 1 included) fits 7
// bits; query_start < L < 2^15 and gaps <= L + H < 2^15 fit 16 bits.  The
// handed-off word: row (bits 0-6, < 72), tied rows (7-13, <= 72), risky
// (14), code (15-16), N (17).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GAP = -50;
constexpr int NEG = -1000000;
constexpr int NEG_BEST = -10000000;
constexpr int HMAX = 72;
constexpr int K = 9;          // rows a lane
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;  // per SM, for the register budget
constexpr unsigned FULL = 0xffffffffu;

constexpr int TS_SHIFT = 24;
constexpr uint32_t FLAG = 1u << 31;
constexpr uint32_t RISKY = FLAG | (0xFFu << 16);  // flag or a neutral
constexpr uint32_t G1 = 1u << 16;  // one gap in W2

struct AdapterCodes {
  unsigned char c[HMAX];  // A0 C1 G2 T3 N4, 5 past H
};

__device__ __forceinline__ uint32_t nm_of(uint32_t w1) {
  return (w1 >> 16) & 0xFFu;
}

__device__ __forceinline__ int border(int y) {
  return y <= 3 ? 0 : GAP * (y - 3);
}

// prmt.b32 in its default mode: byte k of the result is byte (nibble k of
// sel) & 7 of {lo, hi}, or that byte's sign repeated when the nibble's
// bit 3 is set
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

template <bool HAS_NM, bool TIE, int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
align_packed_kernel(const uint32_t* __restrict__ b2w,
                    const uint32_t* __restrict__ nmw,
                    const int32_t* __restrict__ lengths, AdapterCodes ad,
                    int H, int L, int B, int32_t* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int j = G == 1 ? 0 : (int)(threadIdx.x & (G - 1));
  const int b = t / G;
  const int y0 = j * K;
  int len = 0;
  if (b < B) len = max(0, min(lengths[b], L));
  const int steps = __reduce_max_sync(FULL, len) + G - 1;

  // row i's class selects its delta and its counter's shift from the
  // column's byte tables: A0 C1 G2 T3 N4 sign-extended, a padding row
  // (y >= H) the table's byte 7 in every byte
  uint32_t sel[K];
  int sc[K];
  uint32_t w1[K], w2[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int y = y0 + i;
    const uint32_t r = y < H ? ad.c[y] : 5;
    sel[i] = r < 5 ? r | (r + 8) << 4 | (r + 8) << 8 | (r + 8) << 12 : 0x7777u;
    sc[i] = border(y);  // the pseudo column -1
    w1[i] = (uint32_t)(y + 1) << TS_SHIFT;
    w2[i] = 0;
  }
  // from the lane above: its last row at this lane's column (in_*, the
  // first row's up-chain) and one column before (pv_*, the first row's
  // upper-left); lane 0's are the row-0 border, set each step (score 0,
  // no counts, starting at x)
  int in_sc = 0, pv_sc = border(y0 - 1);
  uint32_t in_w1 = 0, in_w2 = 0, pv_w1 = (uint32_t)y0 << TS_SHIFT, pv_w2 = 0;
  int in_cmax = 0;
  uint32_t in_cw1 = 0, in_cw2 = 0, in_pk = 0;

  int best = NEG_BEST;
  uint32_t bw1 = 0, bw2 = 0;
  int bx = 0, by = 0;
  bool bfl = false;
  uint32_t wb = 0, wn = 0;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int x = s - j;
    const bool act = x >= 0 && x < len;
    int code;
    bool qn;
    if (j == 0) {
      if (act && (x & 15) == 0) wb = b2w[(size_t)(x >> 4) * B + b];
      if (HAS_NM && act && (x & 31) == 0) wn = nmw[(size_t)(x >> 5) * B + b];
      // codes are MSB-first within a byte, bytes little-endian in the word
      code = (wb >> (8 * ((x >> 2) & 3) + 6 - 2 * (x & 3))) & 3;
      qn = HAS_NM && ((wn >> (8 * ((x >> 3) & 3) + 7 - (x & 7))) & 1u);
      pv_sc = in_sc = 0;
      pv_w1 = in_w1 = 0;
      pv_w2 = in_w2 = (uint32_t)x;
    } else {
      code = (in_pk >> 15) & 3;
      qn = HAS_NM && ((in_pk >> 17) & 1u);
    }
    // the column max so far, from the rows above
    int cmax = in_cmax;
    uint32_t cw1 = in_cw1, cw2 = in_cw2;
    int cby = in_pk & 127, ccnt = (in_pk >> 7) & 127;
    bool cany = TIE && ((in_pk >> 14) & 1u);

    if (act) {
      // the column's tables, a byte a row class: delta (match +10,
      // mismatch -10, one N +1, N/N 0, padding 0x80808080) and the shift
      // of the counter it bumps (matches 0, mismatches 8, neutral 16)
      const uint32_t hit = 8u * (uint32_t)code;
      const uint32_t d_lo = qn ? 0x01010101u : 0xF6F6F6F6u ^ (0xFCu << hit);
      const uint32_t d_hi = qn ? 0x80000000u : 0x80000001u;
      const uint32_t s_lo = qn ? 0x10101010u : 0x08080808u ^ (0x08u << hit);
      const uint32_t s_hi = 0x10u;
      // previous column's row above, read before it is overwritten
      int up_sc = pv_sc;
      uint32_t up_w1 = pv_w1, up_w2 = pv_w2;
      // the up-chain: this column's row above
      int run_sc = in_sc;
      uint32_t run_w1 = in_w1, run_w2 = in_w2;
      const int xr = x + 3 - y0;  // row i is banned from LEFT iff xr < i

#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int delta = (int)prmt(d_lo, d_hi, sel[i]);
        const uint32_t inc = 1u << prmt(s_lo, s_hi, sel[i]);
        const int p_sc = sc[i];
        const uint32_t p_w1 = w1[i], p_w2 = w2[i];

        const int ul_sc = up_sc + delta;
        const uint32_t ul_w1 = up_w1 + inc;
        const int left_sc = xr < i ? NEG : p_sc + GAP;

        // UL vs LEFT: UL wins ties
        const bool lw = left_sc > ul_sc;
        const int e_sc = max(left_sc, ul_sc);
        uint32_t e_w1 = lw ? p_w1 : ul_w1;
        const uint32_t e_w2 = lw ? p_w2 + G1 : up_w2;
        if (TIE && left_sc == ul_sc && ((ul_w1 | p_w1) & RISKY))
          e_w1 |= FLAG;  // t1

        // up-chain: the cell's own winner vs the chain from the row above
        // (at row 0 the border-up move: it beats LEFT ties, loses UL ties)
        const int chain_sc = run_sc + GAP;
        const bool ywins = e_sc > chain_sc || (e_sc == chain_sc && !lw);
        const int c_sc = max(e_sc, chain_sc);
        uint32_t c_w1 = ywins ? e_w1 : run_w1;
        const uint32_t c_w2 = ywins ? e_w2 : run_w2 + G1;
        if (TIE && e_sc == chain_sc && ((run_w1 | e_w1) & RISKY))
          c_w1 |= FLAG;
        // a winning border-up move keeps the fragile bit of the move it
        // beat, and only that (the reference's t2)
        if (TIE && i == 0 && j == 0 && !ywins) c_w1 = e_w1 & FLAG;

        up_sc = p_sc;
        up_w1 = p_w1;
        up_w2 = p_w2;
        sc[i] = c_sc;
        w1[i] = c_w1;
        w2[i] = c_w2;
        run_sc = c_sc;
        run_w1 = c_w1;
        run_w2 = c_w2;
      }
      pv_sc = in_sc;
      pv_w1 = in_w1;
      pv_w2 = in_w2;

      // the column max over this lane's rows (padding rows stay below
      // row H - 1, see the note), then after the rows above: first row
      // wins, tied rows counted, their risk ORed
      int m = sc[0];
#pragma unroll
      for (int i = 1; i < K; ++i) m = max(m, sc[i]);
      int mby = 0, mcnt = 0;
      uint32_t m1 = 0, m2 = 0, mrisk = 0;
#pragma unroll
      for (int i = K - 1; i >= 0; --i) {
        const bool h = sc[i] == m;
        mby = h ? i : mby;
        m1 = h ? w1[i] : m1;
        m2 = h ? w2[i] : m2;
        mcnt += h ? 1 : 0;
        if (TIE) mrisk |= h ? w1[i] : 0u;
      }
      const bool mrisky = TIE && (mrisk & RISKY) != 0;
      if (j == 0 || m > cmax) {
        cmax = m;
        cby = y0 + mby;
        cw1 = m1;
        cw2 = m2;
        ccnt = mcnt;
        cany = mrisky;
      } else if (m == cmax) {
        ccnt += mcnt;
        cany = cany || mrisky;
      }

      if (j == G - 1) {
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
    }

    if (G > 1) {
      const uint32_t pk = (uint32_t)cby | ((uint32_t)ccnt << 7) |
                          (cany ? 1u << 14 : 0u) | ((uint32_t)code << 15) |
                          (qn ? 1u << 17 : 0u);
      in_sc = __shfl_up_sync(FULL, sc[K - 1], 1, G);
      in_w1 = __shfl_up_sync(FULL, w1[K - 1], 1, G);
      in_w2 = __shfl_up_sync(FULL, w2[K - 1], 1, G);
      in_cmax = __shfl_up_sync(FULL, cmax, 1, G);
      in_cw1 = __shfl_up_sync(FULL, cw1, 1, G);
      in_cw2 = __shfl_up_sync(FULL, cw2, 1, G);
      in_pk = __shfl_up_sync(FULL, pk, 1, G);
    }
  }

  if (j == G - 1 && b < B) {
    out[0 * (size_t)B + b] = bw1 & 0xFFu;                 // matches
    out[1 * (size_t)B + b] = (bw1 >> 8) & 0xFFu;          // mismatches
    out[2 * (size_t)B + b] = bw2 >> 16;                   // gaps
    out[3 * (size_t)B + b] = (bw1 >> 16) & 0xFFu;         // neutral
    out[4 * (size_t)B + b] = bw2 & 0xFFFFu;               // query_start
    out[5 * (size_t)B + b] = bx;                          // query_end
    out[6 * (size_t)B + b] = (bw1 >> TS_SHIFT) & 0x7Fu;   // target_start
    out[7 * (size_t)B + b] = by;                          // target_end
    out[8 * (size_t)B + b] = bfl ? 1 : 0;                 // tie_fragile
  }
}

template <bool HAS_NM, bool TIE, int G>
cudaError_t launch(const uint32_t* bw, const uint32_t* nw, const int32_t* ln,
                   const AdapterCodes& ad, int H, int L, int B, int32_t* o,
                   cudaStream_t s) {
  const long long threads = (long long)B * G;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
  align_packed_kernel<HAS_NM, TIE, G><<<blocks, THREADS, 0, s>>>(
      bw, nw, ln, ad, H, L, B, o);
  return cudaGetLastError();
}

template <bool HAS_NM, bool TIE>
cudaError_t launch_g(const uint32_t* bw, const uint32_t* nw,
                     const int32_t* ln, const AdapterCodes& ad, int H, int L,
                     int B, int32_t* o, cudaStream_t s) {
  if (H <= K) return launch<HAS_NM, TIE, 1>(bw, nw, ln, ad, H, L, B, o, s);
  if (H <= 2 * K) return launch<HAS_NM, TIE, 2>(bw, nw, ln, ad, H, L, B, o, s);
  if (H <= 4 * K) return launch<HAS_NM, TIE, 4>(bw, nw, ln, ad, H, L, B, o, s);
  return launch<HAS_NM, TIE, 8>(bw, nw, ln, ad, H, L, B, o, s);
}

static_assert(8 * K >= HMAX, "eight lanes must hold every adapter row");

}  // namespace

// b2w [W16, B] and nmw [W16/2, B] (or null) as uint32 words, lengths [B]
// int32, codes: H adapter codes (host memory), out: [9, B] int32.  The
// caller guarantees 1 <= H <= 72 and L + H + H_pad < 2^15.
// Returns cudaGetLastError() after the launch.
extern "C" int fx_align_packed(const void* b2w, const void* nmw,
                               const void* lengths, const unsigned char* codes,
                               int H, int L, int B, int tie_flag, void* out,
                               void* stream) {
  if (H < 1 || H > HMAX || B < 0 || L < 0 || L >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  AdapterCodes ad;
  for (int y = 0; y < HMAX; ++y) ad.c[y] = y < H ? codes[y] : 5;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* bw = (const uint32_t*)b2w;
  const uint32_t* nw = (const uint32_t*)nmw;
  const int32_t* ln = (const int32_t*)lengths;
  int32_t* o = (int32_t*)out;
  cudaError_t e;
  if (nw != nullptr)
    e = tie_flag ? launch_g<true, true>(bw, nw, ln, ad, H, L, B, o, s)
                 : launch_g<true, false>(bw, nw, ln, ad, H, L, B, o, s);
  else
    e = tie_flag ? launch_g<false, true>(bw, nw, ln, ad, H, L, B, o, s)
                 : launch_g<false, false>(bw, nw, ln, ad, H, L, B, o, s);
  return (int)e;
}
