// K4: the half-local adapter DP over ASCII bases, any adapter bytes, for
// Hopper.
//
// Replaces fastx_toolkit_tpu/kernels/align_pallas.py::_make_kernel
// (entered through align_batch_pallas from ops/clipper._align_dispatch).
// It computes what fastx_toolkit_tpu/kernels/align.py::align_batch
// computes, with the tie_fragile flag, bit for bit: bytes compare exactly
// (so 'a' != 'A'), and the neutral is the byte 'N' (+1 against any other
// byte, 0 against 'N').
//
// What bounds it on this card: int32 issue.  A DP cell (L x H cells a
// read) needs about 20 operations (the score's compares, selects and adds
// and the path statistics' payload); the operands are read once (L bytes
// a read), far below the memory roofline.  At the small-RNA shape
// (262,144 reads x 50 bp, H = 21) that is 0.158 ms at 132 SMs x 4
// schedulers x 32 lanes a clock.
//
// Design: csrc/align_packed.cu's (K3) lane group per read, carried to
// bytes (align_unpacked_kernel, entry fx_align_unpacked).
// - G lanes a read and K rows a lane (score, W1, W2 each, in registers),
//   from the variant's picks: the first with G x K >= H.  Fewer lanes
//   issue fewer instructions a cell (the per-column work and the 7
//   shuffles are shared by more rows, and no wavefront fills), so a read
//   takes one lane while its rows fit the register budget with no spills:
//   H <= 21 in the table variant (17 rows take 87 registers, 21 take
//   108), then 2 x 17, 4 x 18, 8 x 16; the compare variant, which keeps
//   each row's byte and kind too, takes 8 rows a lane.  With G > 1, lane
//   j holds rows j*K .. j*K + K - 1; at step s it computes column x = s -
//   j and hands lane j + 1 (__shfl_up_sync inside the group, 7 a step) its
//   last row's (score, W1, W2) and the column's partial max (score, W1,
//   W2, and a word with its row, its count of tied rows, its risky bit,
//   and the column's byte and class).  Lane j + 1's first row takes the
//   last row it received as its up-chain, and as its upper-left one
//   column on; its column max comes after the one it received (first row
//   wins, ties counted, risk ORed), so the result is the sequential one.
//   The last lane folds each column max into the read's best.  The loop
//   runs to the warp's longest read plus G - 1 steps (every lane takes
//   part in each shuffle); lanes outside their read are predicated off.
//   The first column's borders come from a pseudo column -1 in the row
//   state (row y: border score, target_start y + 1, query_start 0), and
//   the row-0 border-up move is lane 0's row above, reset each step.  The
//   tie_fragile flags are always computed (the flag-free callers drop
//   them), so each variant is one kernel a pick.
// - Only lane 0 reads the bases, a byte a column straight from the [B, L]
//   rows through the read-only cache, one column ahead of its use.
// - The adapter goes by value, as a kernel parameter (AdapterRows): no
//   copy precedes the launch, so the wrapper never waits for the stream.
//   Two variants, picked on the host from the adapter alone.  TABLE (at
//   most 6 distinct non-N bytes: every kit adapter): each row is a class
//   (0-5 its byte's rank in the alphabet, 6 N, 7 a padding row); lane 0
//   finds the column byte's class with 6 compares, and every lane builds
//   the column's two byte tables (delta, and the shift of the counter it
//   bumps, a byte a class) and takes each row's with one PRMT each.
//   Compare (any other adapter): each row keeps its byte in a register,
//   and the delta is compares and selects.
// - Rows y >= H (padding) take a delta of 0x80808080 (about -2.1e9) on the
//   upper-left move, so they never reach nor tie the column max (the
//   argument of csrc/align_packed.cu's note: a path into them goes up from
//   row H - 1 and then left or up, -50 each, and stays strictly below row
//   H - 1's own cell, which reaches the same column by left moves; the
//   left ban grows with y), and they never feed a real row (rows only feed
//   the rows below).  Their pseudo column carries target_start 0, so no
//   padding row sets bit 31 from its target_start.  Every score is at
//   least -50 x (y + 1) (row 0's border-up move, then up), so the padding
//   rows' sum never wraps.
// So each lane's serial chain is K rows, in registers: the one-thread
// design this replaces walked all H rows of a column with 7 int32 words a
// row in shared memory (7 loads and 7 stores a cell, 37,632 B a block at
// H = 21, or a device scratch through L2 for H > 54), loaded the adapter
// byte from global memory and recomputed the borders in every cell, and
// its wrapper uploaded the adapter from pageable memory on every call.
//
// Field widths, checked against the gate (H <= 127, L + H + H_pad < 2^15):
//   W1: matches (bits 0-7) | mismatches (8-15) | neutral (16-23)
//       | target_start (24-30) | fragile (bit 31)
//   W2: query_start (bits 0-15) | gaps (bits 16-31)
// A path to row y < H makes at most y + 1 <= 127 diagonal moves, so each
// counter stays below 256 and an increment never carries into the next
// field; target_start <= H <= 127 (the pseudo column's y + 1 included)
// fits 7 bits; query_start < L < 2^15 and gaps <= L + H < 2^15 fit 16
// bits.  The handed-off word: row (bits 0-7, < 128), tied rows (8-15, <=
// 128), risky (16), class (17-19), byte (24-31).
//
// Beyond the gate (H > 127, or L + H + H_pad >= 2^15; only the Python API
// reaches these shapes, the CLIs cap the adapter at 99 bytes) the batch
// takes the one-thread-per-read design (align_serial_kernel, entry
// fx_align_unpacked_serial): a thread walks its read's columns and, in a
// column, all H rows in order, each path statistic its own int32 word in
// a device scratch [7, H, B] that the wrapper allocates, over [L, B]
// transposed bases and a device copy of the adapter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GAP = -50;
constexpr int MATCH = 10;
constexpr int MISMATCH = -10;
constexpr int NEUTRAL = 1;
constexpr int NEG = -1000000;
constexpr int NEG_BEST = -10000000;
constexpr int NBYTE = 'N';
constexpr int HMAX = 127;      // the lane-group kernel's gate
constexpr int ROWS_MAX = 128;  // the most rows a read is given (G x K)
constexpr int NALPHA = 6;      // the table variant's distinct non-N bytes
constexpr int PAD_ROW = 256;   // the compare variant's padding-row byte
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;  // per SM, for the register budget
constexpr unsigned FULL = 0xffffffffu;

constexpr int TS_SHIFT = 24;
constexpr uint32_t FLAG = 1u << 31;
constexpr uint32_t RISKY = FLAG | (0xFFu << 16);  // flag or a neutral
constexpr uint32_t G1 = 1u << 16;                 // one gap in W2
constexpr int PAD_DELTA = (int)0x80808080u;

// lanes a read and rows a lane, by variant and adapter length: the first
// entry with rows >= H.  The fewest lanes whose rows fit the register
// budget without spills (-Xptxas -v): one lane a read holds up to 21 rows
// in the table variant; the compare variant keeps each row's byte too and
// takes 8 rows a lane
struct Pick {
  int rows, g, k;
};
constexpr int NPICKS = 5;
constexpr Pick TABLE_PICKS[NPICKS] = {
    {17, 1, 17}, {21, 1, 21}, {34, 2, 17}, {72, 4, 18}, {128, 8, 16}};
constexpr Pick COMPARE_PICKS[NPICKS] = {
    {8, 1, 8}, {16, 2, 8}, {32, 4, 8}, {64, 8, 8}, {128, 16, 8}};
static_assert(TABLE_PICKS[NPICKS - 1].rows >= HMAX &&
                  COMPARE_PICKS[NPICKS - 1].rows >= HMAX,
              "the picks cover the gate");

constexpr Pick pick(bool table, int p) {
  return table ? TABLE_PICKS[p] : COMPARE_PICKS[p];
}

struct AdapterRows {
  unsigned char row[ROWS_MAX];  // TABLE: class 0-5, N 6; else the byte
  int alpha[NALPHA];            // TABLE: the class bytes, 256 past the last
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

template <bool TABLE, int G, int K>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
align_unpacked_kernel(const uint8_t* __restrict__ bases,
                      const int32_t* __restrict__ lengths, AdapterRows ad,
                      int H, int L, int B, int32_t* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int j = G == 1 ? 0 : (int)(threadIdx.x & (G - 1));
  const int b = t / G;
  const int y0 = j * K;
  int len = 0;
  if (b < B) len = max(0, min(lengths[b], L));
  const int steps = __reduce_max_sync(FULL, len) + G - 1;
  const uint8_t* read = bases + (size_t)(b < B ? b : 0) * L;

  // TABLE: row i's selector of its delta and counter shift in the
  // column's byte tables (class r sign-extended; a padding row the
  // tables' byte 7 in every byte).  Else row i's byte (PAD_ROW past H).
  uint32_t sel[K];
  int tb[K];
  int sc[K];
  uint32_t w1[K], w2[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int y = y0 + i;
    const uint32_t r = ad.row[y];
    if (TABLE)
      sel[i] = y < H ? r | (r + 8) << 4 | (r + 8) << 8 | (r + 8) << 12
                     : 0x7777u;
    else
      tb[i] = y < H ? (int)r : PAD_ROW;
    sc[i] = border(y);  // the pseudo column -1
    w1[i] = y < H ? (uint32_t)(y + 1) << TS_SHIFT : 0u;
    w2[i] = 0;
  }
  // from the lane above: its last row at this lane's column (in_*, the
  // first row's up-chain) and one column before (pv_*, the first row's
  // upper-left); lane 0's are the row-0 border, set each step (score 0,
  // no counts, starting at x)
  int in_sc = 0, pv_sc = border(y0 - 1);
  uint32_t in_w1 = 0, in_w2 = 0, pv_w2 = 0;
  uint32_t pv_w1 = y0 <= H ? (uint32_t)y0 << TS_SHIFT : 0u;
  int in_cmax = 0;
  uint32_t in_cw1 = 0, in_cw2 = 0, in_pk = 0;

  int best = NEG_BEST;
  uint32_t bw1 = 0, bw2 = 0;
  int bx = 0, by = 0;
  bool bfl = false;
  uint32_t qnext = (j == 0 && len > 0) ? __ldg(read) : 0u;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int x = s - j;
    const bool act = x >= 0 && x < len;
    uint32_t q;
    int cls = 0;
    if (j == 0) {
      q = qnext;
      if (x + 1 < len) qnext = __ldg(read + x + 1);
      if (TABLE) {
        cls = q == (uint32_t)NBYTE ? 6 : 7;
#pragma unroll
        for (int c = 0; c < NALPHA; ++c)
          cls = q == (uint32_t)ad.alpha[c] ? c : cls;
      }
      pv_sc = in_sc = 0;
      pv_w1 = in_w1 = 0;
      pv_w2 = in_w2 = (uint32_t)x;
    } else {
      q = in_pk >> 24;
      if (TABLE) cls = (int)((in_pk >> 17) & 7u);
    }
    const bool qn = TABLE ? cls == 6 : q == (uint32_t)NBYTE;
    // the column max so far, from the rows above
    int cmax = in_cmax;
    uint32_t cw1 = in_cw1, cw2 = in_cw2;
    int cby = in_pk & 255, ccnt = (in_pk >> 8) & 255;
    bool cany = (in_pk >> 16) & 1u;

    if (act) {
      // TABLE: the column's tables, a byte a row class (0-5 the alphabet,
      // 6 N, 7 padding): delta (match +10, mismatch -10, one N +1, N/N 0,
      // padding 0x80) and the shift of the counter it bumps (matches 0,
      // mismatches 8, neutral 16).  Compare: the deltas and shifts of a
      // row whose byte equals the column's, and of one that does not
      uint32_t d_lo = 0, d_hi = 0, s_lo = 0, s_hi = 0;
      int eqd = 0, dq = 0;
      uint32_t eqs = 0, sq = 0;
      if (TABLE) {
        const uint32_t hl = 8u * (uint32_t)(cls & 3);
        const bool lo = cls < 4, hi = (cls & 6) == 4;
        d_lo = qn ? 0x01010101u : 0xF6F6F6F6u ^ (lo ? 0xFCu << hl : 0u);
        d_hi = qn ? 0x80000101u : 0x8001F6F6u ^ (hi ? 0xFCu << hl : 0u);
        s_lo = qn ? 0x10101010u : 0x08080808u ^ (lo ? 0x08u << hl : 0u);
        s_hi = qn ? 0x00101010u : 0x00100808u ^ (hi ? 0x08u << hl : 0u);
      } else {
        eqd = qn ? 0 : MATCH;  // equal bytes: N/N, or a match
        eqs = qn ? 16u : 0u;
        dq = qn ? NEUTRAL : MISMATCH;  // unequal, neither N
        sq = qn ? 16u : 8u;
      }
      // previous column's row above, read before it is overwritten
      int up_sc = pv_sc;
      uint32_t up_w1 = pv_w1, up_w2 = pv_w2;
      // the up-chain: this column's row above
      int run_sc = in_sc;
      uint32_t run_w1 = in_w1, run_w2 = in_w2;
      const int xr = x + 3 - y0;  // row i is banned from LEFT iff xr < i

#pragma unroll
      for (int i = 0; i < K; ++i) {
        int delta;
        uint32_t inc;
        if (TABLE) {
          delta = (int)prmt(d_lo, d_hi, sel[i]);
          inc = 1u << prmt(s_lo, s_hi, sel[i]);
        } else {
          const bool eq = (uint32_t)tb[i] == q;
          const bool tn = tb[i] == NBYTE;
          const int d = eq ? eqd : (tn ? NEUTRAL : dq);
          inc = 1u << (eq ? eqs : (tn ? 16u : sq));
          delta = tb[i] == PAD_ROW ? PAD_DELTA : d;
        }
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
        if (left_sc == ul_sc && ((ul_w1 | p_w1) & RISKY))
          e_w1 |= FLAG;  // t1

        // up-chain: the cell's own winner vs the chain from the row above
        // (at row 0 the border-up move: it beats LEFT ties, loses UL ties)
        const int chain_sc = run_sc + GAP;
        const bool ywins = e_sc > chain_sc || (e_sc == chain_sc && !lw);
        const int c_sc = max(e_sc, chain_sc);
        uint32_t c_w1 = ywins ? e_w1 : run_w1;
        const uint32_t c_w2 = ywins ? e_w2 : run_w2 + G1;
        if (e_sc == chain_sc && ((run_w1 | e_w1) & RISKY))
          c_w1 |= FLAG;
        // a winning border-up move keeps the fragile bit of the move it
        // beat, and only that (the reference's t2)
        if (i == 0 && j == 0 && !ywins) c_w1 = e_w1 & FLAG;

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
        mrisk |= h ? w1[i] : 0u;
      }
      const bool mrisky = (mrisk & RISKY) != 0;
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
        const bool cfl = (cw1 & FLAG) != 0;
        const bool t5 = ccnt > 1 && cany;
        const bool t4 =
            cmax == best && (nm_of(cw1) + nm_of(bw1) > 0 || cfl || bfl);
        bfl = (improve ? (cfl || t5) : bfl) || t4;
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
      const uint32_t pk = (uint32_t)cby | ((uint32_t)ccnt << 8) |
                          (cany ? 1u << 16 : 0u) |
                          (TABLE ? (uint32_t)cls << 17 : 0u) | (q << 24);
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

struct Args {
  const uint8_t* bases;
  const int32_t* lengths;
  AdapterRows ad;
  int H, L, B;
  int32_t* out;
  cudaStream_t s;
};

template <bool TABLE, int G, int K>
cudaError_t launch(const Args& a) {
  static_assert(G * K <= ROWS_MAX && 32 % G == 0, "a pick's lane group");
  const long long threads = (long long)a.B * G;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
  align_unpacked_kernel<TABLE, G, K><<<blocks, THREADS, 0, a.s>>>(
      a.bases, a.lengths, a.ad, a.H, a.L, a.B, a.out);
  return cudaGetLastError();
}

template <bool TABLE, int P = 0>
cudaError_t launch_pick(const Args& a) {
  if constexpr (P + 1 < NPICKS) {
    if (a.H > pick(TABLE, P).rows) return launch_pick<TABLE, P + 1>(a);
  }
  return launch<TABLE, pick(TABLE, P).g, pick(TABLE, P).k>(a);
}

int h_pad(int H) { return H <= 8 ? 8 : (H + 7) / 8 * 8; }

bool lanes_ok(int H, int L) {
  return H >= 1 && H <= HMAX && L >= 0 && L + H + h_pad(H) < (1 << 15);
}

// The one-thread-per-read design, for the shapes beyond the gate: the
// thread walks the columns x < min(length, L) of its read and, inside a
// column, the adapter rows y in order, so the in-column up-chain is the
// reference's associative combine applied left to right, and the global
// best (first x, then y, strict) is tracked during the fill.  The reads
// arrive transposed, [L, B] uint8, so a warp's loads of one column are 32
// neighbouring bytes.  Each path statistic is its own int32: per adapter
// row, 7 words (score, matches, mismatches, neutral with the fragile flag
// in bit 31, gaps, query_start, target_start) at scratch[(k * H + y) * B
// + b] for word k (neighbouring threads on neighbouring words).

constexpr int SERIAL_THREADS = 128;

// one cell's path statistics; nmf = neutral | fragile << 31
struct Cell {
  int sc, m, mm, nmf, g, qs, ts;
};

__device__ __forceinline__ int nmf_count(int nmf) {
  return (int)((uint32_t)nmf & ~FLAG);
}

__device__ __forceinline__ bool fl_of(int nmf) {
  return ((uint32_t)nmf & FLAG) != 0;
}

template <bool TIE>
__global__ void align_serial_kernel(const uint8_t* __restrict__ basesT,
                                    const int32_t* __restrict__ lengths,
                                    const uint8_t* __restrict__ adapter,
                                    int H, int L, int B,
                                    int32_t* __restrict__ scratch,
                                    int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t* st = scratch + b;
  const size_t stride = (size_t)B;
  const size_t kstep = (size_t)H * stride;  // from one word plane to the next

  int len = lengths[b];
  if (len > L) len = L;

  int best = NEG_BEST;
  Cell bc = {0, 0, 0, 0, 0, 0, 0};
  int bx = 0, by = 0;
  bool bfl = false;

  for (int x = 0; x < len; ++x) {
    const int qc = basesT[(size_t)x * B + b];
    const bool qn = qc == NBYTE;
    const bool first = x == 0;

    Cell up = {0, 0, 0, 0, 0, 0, 0};   // previous column, row y-1
    Cell run = {0, 0, 0, 0, 0, 0, 0};  // this column, row y-1
    int cmax = 0, cby = 0, ccnt = 0;
    Cell cw = {0, 0, 0, 0, 0, 0, 0};
    bool cany = false;

    for (int y = 0; y < H; ++y) {
      const int tc = __ldg(adapter + y);
      const bool tn = tc == NBYTE;
      const bool one_n = qn || tn;
      const bool eq = qc == tc;
      const int delta =
          (qn && tn) ? 0 : (one_n ? NEUTRAL : (eq ? MATCH : MISMATCH));
      const int inc_m = (!one_n && eq) ? 1 : 0;
      const int inc_mm = (!one_n && !eq) ? 1 : 0;
      const int inc_nm = one_n ? 1 : 0;
      const int tb_y = y <= 3 ? 0 : GAP * (y - 3);
      const int tb_ym1 = (y - 1) <= 3 ? 0 : GAP * (y - 4);
      int32_t* s = st + (size_t)y * stride;

      Cell p = {0, 0, 0, 0, 0, 0, 0};  // previous column, row y
      if (!first) {
        p.sc = s[0];
        p.m = s[kstep];
        p.mm = s[2 * kstep];
        p.nmf = s[3 * kstep];
        p.g = s[4 * kstep];
        p.qs = s[5 * kstep];
        p.ts = s[6 * kstep];
      }

      // upper-left candidate; the path starts here at row 0 and in the
      // first column (its source is then a border)
      Cell ul;
      if (first || y == 0) {
        ul.sc = (y == 0 ? 0 : tb_ym1) + delta;
        ul.m = inc_m;
        ul.mm = inc_mm;
        ul.nmf = inc_nm;
        ul.g = 0;
        ul.qs = x;
        ul.ts = y;
      } else {
        ul = up;
        ul.sc += delta;
        ul.m += inc_m;
        ul.mm += inc_mm;
        ul.nmf += inc_nm;
      }

      // left candidate (banned off the diagonal band)
      const bool ban = y > 3 && (y - 3) > x;
      Cell left;
      if (first) {
        left.sc = ban ? NEG : tb_y + GAP;
        left.m = left.mm = left.nmf = 0;
        left.g = 1;
        left.qs = x;
        left.ts = y;
      } else {
        left = p;
        left.sc = ban ? NEG : p.sc + GAP;
        left.g += 1;
      }

      // UL vs LEFT: UL wins ties
      const bool lw = left.sc > ul.sc;
      Cell e = lw ? left : ul;
      bool e_ul = !lw;
      if (TIE && left.sc == ul.sc &&
          (nmf_count(ul.nmf) + nmf_count(left.nmf) > 0 || fl_of(ul.nmf) ||
           fl_of(left.nmf)))
        e.nmf |= (int)FLAG;  // t1

      if (y == 0) {
        // row-0 border-up candidate: beats LEFT ties, loses UL ties
        const bool old_fl = fl_of(e.nmf);
        const bool up0 = GAP > e.sc || (GAP == e.sc && !e_ul);
        if (up0) {
          e.sc = GAP;
          e_ul = false;
          e.m = e.mm = e.nmf = 0;
          e.g = 1;
          e.qs = x;
          e.ts = 0;
        }
        if (TIE) {
          const bool t2 = e.sc == GAP && (nmf_count(e.nmf) > 0 || old_fl);
          e.nmf = nmf_count(e.nmf) | ((!up0 && old_fl) || t2 ? (int)FLAG : 0);
        }
      }

      // up-chain: the cell's own winner vs the chain from row y-1
      Cell c = e;
      if (y > 0) {
        const int chain_sc = run.sc + GAP;
        const bool ywins = e.sc > chain_sc || (e.sc == chain_sc && e_ul);
        const bool tie = TIE && e.sc == chain_sc &&
                         (nmf_count(run.nmf) + nmf_count(e.nmf) > 0 ||
                          fl_of(run.nmf) || fl_of(e.nmf));
        if (!ywins) {
          c = run;
          c.sc = chain_sc;
          c.g += 1;
        }
        if (tie) c.nmf |= (int)FLAG;
      }

      up = p;
      s[0] = c.sc;
      s[kstep] = c.m;
      s[2 * kstep] = c.mm;
      s[3 * kstep] = c.nmf;
      s[4 * kstep] = c.g;
      s[5 * kstep] = c.qs;
      s[6 * kstep] = c.ts;
      run = c;

      // column max: first y wins, count the rows that tie it
      const bool risky = nmf_count(c.nmf) > 0 || fl_of(c.nmf);
      if (y == 0 || c.sc > cmax) {
        cmax = c.sc;
        cby = y;
        cw = c;
        ccnt = 1;
        cany = risky;
      } else if (c.sc == cmax) {
        ++ccnt;
        cany = cany || risky;
      }
    }

    const bool improve = cmax > best;
    if (TIE) {
      const bool cfl = fl_of(cw.nmf);
      const bool t5 = ccnt > 1 && cany;
      const bool t4 = cmax == best &&
                      (nmf_count(cw.nmf) + nmf_count(bc.nmf) > 0 || cfl ||
                       bfl);
      bfl = (improve ? (cfl || t5) : bfl) || t4;
    }
    if (improve) {
      best = cmax;
      bc = cw;
      bx = x;
      by = cby;
    }
  }

  out[0 * (size_t)B + b] = bc.m;               // matches
  out[1 * (size_t)B + b] = bc.mm;              // mismatches
  out[2 * (size_t)B + b] = bc.g;               // gaps
  out[3 * (size_t)B + b] = nmf_count(bc.nmf);  // neutral
  out[4 * (size_t)B + b] = bc.qs;              // query_start
  out[5 * (size_t)B + b] = bx;                 // query_end
  out[6 * (size_t)B + b] = bc.ts;              // target_start
  out[7 * (size_t)B + b] = by;                 // target_end
  out[8 * (size_t)B + b] = bfl ? 1 : 0;        // tie_fragile
}

}  // namespace

// The lane-group kernel's gate and pick: G << 8 | K for an adapter of H
// bytes against reads of L columns in the table (table != 0) or compare
// variant, or 0 where the batch must take fx_align_unpacked_serial.
extern "C" int fx_align_unpacked_pick(int H, int L, int table) {
  if (!lanes_ok(H, L)) return 0;
  for (int p = 0; p < NPICKS; ++p) {
    const Pick k = pick(table != 0, p);
    if (H <= k.rows) return k.g << 8 | k.k;
  }
  return 0;
}

// bases [B, L] uint8 (rows contiguous), lengths [B] int32, rows: H bytes
// of host memory (table != 0: each adapter byte's class, 0-5 its rank in
// alpha and 6 for N; else the adapter itself), alpha: n_alpha <= 6
// distinct non-N bytes (table only), out: [9, B] int32, the tie_fragile
// flags always computed.  The caller guarantees fx_align_unpacked_pick(H,
// L, table) != 0.  Returns cudaGetLastError() after the launch.
extern "C" int fx_align_unpacked(const void* bases, const void* lengths,
                                 const unsigned char* rows,
                                 const unsigned char* alpha, int n_alpha,
                                 int H, int L, int B, int table, void* out,
                                 void* stream) {
  if (!lanes_ok(H, L) || B < 0 || n_alpha < 0 || n_alpha > NALPHA)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Args a;
  for (int y = 0; y < ROWS_MAX; ++y) a.ad.row[y] = y < H ? rows[y] : 0;
  for (int c = 0; c < NALPHA; ++c)
    a.ad.alpha[c] = table && c < n_alpha ? (int)alpha[c] : 256;
  if (table)
    for (int y = 0; y < H; ++y)
      if (rows[y] > 6 || (rows[y] < 6 && rows[y] >= n_alpha))
        return (int)cudaErrorInvalidValue;
  a.bases = (const uint8_t*)bases;
  a.lengths = (const int32_t*)lengths;
  a.H = H;
  a.L = L;
  a.B = B;
  a.out = (int32_t*)out;
  a.s = (cudaStream_t)stream;
  return (int)(table ? launch_pick<true>(a) : launch_pick<false>(a));
}

// The one-thread-per-read route: basesT [L, B] uint8, lengths [B] int32,
// adapter [H] uint8 (device memory), scratch [7, H, B] int32, out [9, B]
// int32.  Returns cudaGetLastError() after the launch.
extern "C" int fx_align_unpacked_serial(const void* basesT,
                                        const void* lengths,
                                        const void* adapter, int H, int L,
                                        int B, int tie_flag, void* scratch,
                                        void* out, void* stream) {
  if (H < 1 || B < 0 || L < 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const uint8_t* bt = (const uint8_t*)basesT;
  const int32_t* ln = (const int32_t*)lengths;
  const uint8_t* ad = (const uint8_t*)adapter;
  int32_t* sc = (int32_t*)scratch;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (B + SERIAL_THREADS - 1) / SERIAL_THREADS;
  if (tie_flag)
    align_serial_kernel<true>
        <<<blocks, SERIAL_THREADS, 0, s>>>(bt, ln, ad, H, L, B, sc, o);
  else
    align_serial_kernel<false>
        <<<blocks, SERIAL_THREADS, 0, s>>>(bt, ln, ad, H, L, B, sc, o);
  return (int)cudaGetLastError();
}
