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
// Design: K1's (csrc/align_packed12.cu) walk, one thread per read: the
// thread walks the columns x < min(length, L) of its read and, inside a
// column, the adapter rows y in order, so the in-column up-chain is the
// reference's associative combine applied left to right, and the global
// best (first x, then y, strict) is tracked during the fill.  The reads
// arrive transposed, [L, B] uint8, so a warp's loads of one column are 32
// neighbouring bytes.
//
// The adapter has no length bound short of the plain version's, and reads
// none short of int32 fields, so each path statistic is its own int32:
// per adapter row, 7 words (score, matches, mismatches, neutral with the
// fragile flag in bit 31, gaps, query_start, target_start).  The row
// state lives at state[(k * H + y) * stride] for word k:
//   * in shared memory, [word][row][thread] with stride = threads per
//     block, when 7 x H x 64 x 4 B fits 96 KB (H <= 54: every adapter of
//     the small-RNA and Illumina kits);
//   * else in a device scratch [7, H, B] that the wrapper allocates, with
//     stride = B (neighbouring threads on neighbouring words, coalesced).
//
// What bounds it on this card: integer ALU work, about 40 operations per
// DP cell (L x H cells per read) plus 14 state accesses per cell, with
// the operands read once (L bytes per read): far below the memory
// roofline while the state stays in shared memory; with the device
// scratch the state traffic (56 B per cell, through L2) bounds it.

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
constexpr int NWORDS = 7;
constexpr uint32_t FLAG = 1u << 31;
constexpr int SMEM_THREADS = 64;
constexpr int SCRATCH_THREADS = 128;
constexpr size_t SMEM_MAX = 96 * 1024;

// one cell's path statistics; nmf = neutral | fragile << 31
struct Cell {
  int sc, m, mm, nmf, g, qs, ts;
};

__device__ __forceinline__ int nm_of(int nmf) {
  return (int)((uint32_t)nmf & ~FLAG);
}

__device__ __forceinline__ bool fl_of(int nmf) {
  return ((uint32_t)nmf & FLAG) != 0;
}

template <bool TIE>
__global__ void align_unpacked_kernel(const uint8_t* __restrict__ basesT,
                                      const int32_t* __restrict__ lengths,
                                      const uint8_t* __restrict__ adapter,
                                      int H, int L, int B,
                                      int32_t* __restrict__ scratch,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t* st;
  size_t stride;
  if (scratch != nullptr) {
    st = scratch + b;
    stride = (size_t)B;
  } else {
    st = smem + threadIdx.x;
    stride = (size_t)blockDim.x;
  }
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
          (nm_of(ul.nmf) + nm_of(left.nmf) > 0 || fl_of(ul.nmf) ||
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
          const bool t2 = e.sc == GAP && (nm_of(e.nmf) > 0 || old_fl);
          e.nmf = nm_of(e.nmf) | ((!up0 && old_fl) || t2 ? (int)FLAG : 0);
        }
      }

      // up-chain: the cell's own winner vs the chain from row y-1
      Cell c = e;
      if (y > 0) {
        const int chain_sc = run.sc + GAP;
        const bool ywins = e.sc > chain_sc || (e.sc == chain_sc && e_ul);
        const bool tie = TIE && e.sc == chain_sc &&
                         (nm_of(run.nmf) + nm_of(e.nmf) > 0 ||
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
      const bool risky = nm_of(c.nmf) > 0 || fl_of(c.nmf);
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
                      (nm_of(cw.nmf) + nm_of(bc.nmf) > 0 || cfl || bfl);
      bfl = (improve ? (cfl || t5) : bfl) || t4;
    }
    if (improve) {
      best = cmax;
      bc = cw;
      bx = x;
      by = cby;
    }
  }

  out[0 * (size_t)B + b] = bc.m;           // matches
  out[1 * (size_t)B + b] = bc.mm;          // mismatches
  out[2 * (size_t)B + b] = bc.g;           // gaps
  out[3 * (size_t)B + b] = nm_of(bc.nmf);  // neutral
  out[4 * (size_t)B + b] = bc.qs;          // query_start
  out[5 * (size_t)B + b] = bx;             // query_end
  out[6 * (size_t)B + b] = bc.ts;          // target_start
  out[7 * (size_t)B + b] = by;             // target_end
  out[8 * (size_t)B + b] = bfl ? 1 : 0;    // tie_fragile
}

template <bool TIE>
cudaError_t launch(const uint8_t* bt, const int32_t* ln, const uint8_t* ad,
                   int H, int L, int B, int32_t* scratch, int32_t* o,
                   cudaStream_t s) {
  int threads;
  size_t smem;
  if (scratch == nullptr) {
    threads = SMEM_THREADS;
    smem = (size_t)NWORDS * H * threads * sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(
        align_unpacked_kernel<TIE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  } else {
    threads = SCRATCH_THREADS;
    smem = 0;
  }
  const int blocks = (B + threads - 1) / threads;
  align_unpacked_kernel<TIE><<<blocks, threads, smem, s>>>(
      bt, ln, ad, H, L, B, scratch, o);
  return cudaGetLastError();
}

}  // namespace

// Whether the row state of an adapter of H bases fits shared memory; when
// it does not, fx_align_unpacked needs a [7, H, B] int32 device scratch.
extern "C" int fx_align_unpacked_smem_ok(int H) {
  return H >= 1 &&
         (size_t)NWORDS * H * SMEM_THREADS * sizeof(int32_t) <= SMEM_MAX;
}

// basesT [L, B] uint8, lengths [B] int32, adapter [H] uint8 (device
// memory), scratch [7, H, B] int32 or null (see above), out [9, B] int32.
// Returns cudaGetLastError() after the launch.
extern "C" int fx_align_unpacked(const void* basesT, const void* lengths,
                                 const void* adapter, int H, int L, int B,
                                 int tie_flag, void* scratch, void* out,
                                 void* stream) {
  if (H < 1 || B < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr && !fx_align_unpacked_smem_ok(H))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const uint8_t* bt = (const uint8_t*)basesT;
  const int32_t* ln = (const int32_t*)lengths;
  const uint8_t* ad = (const uint8_t*)adapter;
  int32_t* sc = (int32_t*)scratch;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = tie_flag ? launch<true>(bt, ln, ad, H, L, B, sc, o, s)
                           : launch<false>(bt, ln, ad, H, L, B, sc, o, s);
  return (int)e;
}
