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
// Design: K1's (csrc/align_packed12.cu): one thread per read walks the
// columns x < min(length, L) of its read, and inside a column the adapter
// rows y in order, so the in-column up-chain is the reference's
// associative combine applied left to right.  What changes is where the
// row state lives.  At H <= 72 there are 3 x 72 state words per thread,
// more than the register file gives a thread (K1 already takes 125-139
// registers for 3 x 32), so they live in shared memory, laid out
// [word][row][thread]: neighbouring threads touch neighbouring banks, and
// a cell costs three shared loads and three shared stores.  A block has
// 64 threads; at H = 72 that is 3 x 72 x 64 x 4 B = 55,296 B of dynamic
// shared memory (the launcher raises the 48 KB default once).
//
// Field widths, checked against the gate (H <= 72, L + H + H_pad < 2^15):
//   W1: matches (bits 0-7) | mismatches (8-15) | neutral (16-23)
//       | target_start (24-30) | fragile (bit 31)
//   W2: query_start (bits 0-15) | gaps (bits 16-31)
// A path to row y makes at most y + 1 <= 72 diagonal moves, so each
// counter stays below 256 and an increment never carries into the next
// field; target_start <= 71 fits 7 bits; query_start < L < 2^15 and gaps
// <= L + H < 2^15 fit 16 bits.
//
// What bounds it on this card: integer ALU work, about 40 operations per
// DP cell (L x H cells per read) plus six shared-memory accesses, with
// the operands read once (L/4 bytes per read of bases, L/8 of the N
// plane): far below the memory roofline.  Shared memory per block bounds
// occupancy (4 blocks of 2 warps per SM at H = 72).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GAP = -50;
constexpr int MATCH = 10;
constexpr int MISMATCH = -10;
constexpr int NEUTRAL = 1;
constexpr int NEG = -1000000;
constexpr int NEG_BEST = -10000000;
constexpr int HMAX = 72;
constexpr int THREADS = 64;

constexpr uint32_t INC_M = 1u;
constexpr uint32_t INC_MM = 1u << 8;
constexpr uint32_t INC_NM = 1u << 16;
constexpr int TS_SHIFT = 24;
constexpr uint32_t FLAG = 1u << 31;
constexpr uint32_t G1 = 1u << 16;  // one gap in W2

struct AdapterCodes {
  unsigned char c[HMAX];  // A0 C1 G2 T3 N4
};

__device__ __forceinline__ uint32_t nm_of(uint32_t w1) {
  return (w1 >> 16) & 0xFFu;
}

template <bool HAS_NM, bool TIE>
__global__ void __launch_bounds__(THREADS)
align_packed_kernel(const uint32_t* __restrict__ b2w,
                    const uint32_t* __restrict__ nmw,
                    const int32_t* __restrict__ lengths, AdapterCodes ad,
                    int H, int L, int B, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // row y's score, W1 and W2 at sc[y * T], w1[y * T], w2[y * T]
  const int T = blockDim.x;
  int* sc = (int*)smem + threadIdx.x;
  uint32_t* w1 = smem + (size_t)H * T + threadIdx.x;
  uint32_t* w2 = smem + 2 * (size_t)H * T + threadIdx.x;

  int len = lengths[b];
  if (len > L) len = L;

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
    // running up-chain (cur[y-1]) and the column max
    int run_sc = 0;
    uint32_t run_w1 = 0, run_w2 = 0;
    int cmax = 0, cby = 0, ccnt = 0;
    uint32_t cw1 = 0, cw2 = 0;
    bool cany = false;

    for (int y = 0; y < H; ++y) {
      const int tc = ad.c[y];
      const bool tn = tc == 4;
      const bool one_n = qn || tn;
      const bool eq = code == tc;
      const int delta =
          (qn && tn) ? 0 : (one_n ? NEUTRAL : (eq ? MATCH : MISMATCH));
      const uint32_t inc = one_n ? INC_NM : (eq ? INC_M : INC_MM);
      const int tb_y = y <= 3 ? 0 : GAP * (y - 3);
      const int tb_ym1 = (y - 1) <= 3 ? 0 : GAP * (y - 4);
      const size_t r = (size_t)y * T;
      int p_sc = 0;
      uint32_t p_w1 = 0, p_w2 = 0;
      if (!first) {
        p_sc = sc[r];
        p_w1 = w1[r];
        p_w2 = w2[r];
      }

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
        left_sc = ban ? NEG : p_sc + GAP;
        left_w1 = p_w1;
        left_w2 = p_w2 + G1;
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

      up_sc = p_sc;
      up_w1 = p_w1;
      up_w2 = p_w2;
      sc[r] = c_sc;
      w1[r] = c_w1;
      w2[r] = c_w2;
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
  out[6 * (size_t)B + b] = (bw1 >> TS_SHIFT) & 0x7Fu;   // target_start
  out[7 * (size_t)B + b] = by;                          // target_end
  out[8 * (size_t)B + b] = bfl ? 1 : 0;                 // tie_fragile
}

template <bool HAS_NM, bool TIE>
cudaError_t launch(const uint32_t* bw, const uint32_t* nw, const int32_t* ln,
                   const AdapterCodes& ad, int H, int L, int B, int32_t* o,
                   cudaStream_t s) {
  const size_t smem = (size_t)3 * H * THREADS * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      align_packed_kernel<HAS_NM, TIE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + THREADS - 1) / THREADS;
  align_packed_kernel<HAS_NM, TIE><<<blocks, THREADS, smem, s>>>(
      bw, nw, ln, ad, H, L, B, o);
  return cudaGetLastError();
}

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
    e = tie_flag ? launch<true, true>(bw, nw, ln, ad, H, L, B, o, s)
                 : launch<true, false>(bw, nw, ln, ad, H, L, B, o, s);
  else
    e = tie_flag ? launch<false, true>(bw, nw, ln, ad, H, L, B, o, s)
                 : launch<false, false>(bw, nw, ln, ad, H, L, B, o, s);
  return (int)e;
}
