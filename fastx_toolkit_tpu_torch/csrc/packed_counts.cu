// K2: per-read base counts on the 2-bit packed upload, for Hopper.
//
// Replaces fastx_toolkit_tpu/kernels/counts_pallas.py::_make_kernel
// (entered through packed_counts_pallas).  For each read, over positions
// x < length: the largest single-letter A/C/G/T count ("worst", for
// fastx_artifacts_filter) and the effective-N count (a position whose N
// plane bit is set counts as N, not as its 2-bit letter), for the
// clipper's and fastq_to_fasta's contains-N gates.
//
// What bounds it: device memory traffic, L/4 + L/8 bytes a read read once
// and 8 written (about 12 MB per 262,144 reads of 100 bp, ~4 us at
// 3.35 TB/s), and the launch.
//
// Design: one thread per read, a 16-base word at a time.  Operands are
// [words, B], so neighbouring threads load neighbouring words (coalesced).
//   * A thread issues the loads of U = 8 code words (128 bases) and their 4
//     N-plane words before it counts any, predicated on the read's word
//     count, so that a read of up to 128 bases waits for one round trip.
//     Each N word (32 bases) is loaded once.
//   * Within a word, byte k holds positions 4k..4k+3 MSB first (code of x
//     at bits 8(x>>2 & 3) + 6 - 2(x & 3)); an N word holds x at bit
//     8(x>>3 & 3) + 7 - (x & 7).  Reversing the bits of each byte
//     (BREV, then PRMT back to byte order) puts the code of position y at
//     bits 2y (high) and 2y + 1 (low), and the N bit of position x at bit
//     x; spreading 16 N bits to the even bits aligns them with the codes.
//   * The tail word is masked by the length ((1 << 2n) - 1 over the even
//     bits), and five __popc count the letters left after N (C, G, T and
//     all; A is the rest) and the N positions.
// About 2.5 instructions a base against the one-position-at-a-time loop's
// 10-12.  Any B is accepted; a length beyond the words the operands hold
// is clamped to them, and a length of 0 or less counts nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 8;  // code words (16 bases each) loaded before counting

// The bits of each byte reversed, bytes in place.
__device__ __forceinline__ uint32_t rev_bytes_bits(uint32_t x) {
  return __byte_perm(__brev(x), 0, 0x0123);
}

// Bits 0..15 of x to the even bits 0, 2, ..., 30.
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

template <bool HAS_NM>
__global__ void __launch_bounds__(256)
packed_counts_kernel(const uint32_t* __restrict__ b2w,
                     const uint32_t* __restrict__ nmw,
                     const int32_t* __restrict__ lengths, int W16, int B,
                     int32_t* __restrict__ worst, int32_t* __restrict__ ncnt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int len = lengths[b];
  if (len > W16 * 16) len = W16 * 16;
  const int nw = len > 0 ? (len + 15) >> 4 : 0;
  int c1 = 0, c2 = 0, c3 = 0, cl = 0, cn = 0;  // C, G, T, letters, N
  for (int w0 = 0; w0 < nw; w0 += U) {
    uint32_t wb[U], wn[U / 2];
#pragma unroll
    for (int k = 0; k < U; ++k)
      wb[k] = w0 + k < nw ? b2w[(size_t)(w0 + k) * B + b] : 0u;
#pragma unroll
    for (int k = 0; k < U / 2; ++k)
      wn[k] = HAS_NM && w0 + 2 * k < nw
                  ? nmw[(size_t)((w0 >> 1) + k) * B + b]
                  : 0u;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int n = len - 16 * (w0 + k);  // bases of this word and beyond
      if (n <= 0) break;
      uint32_t v = n >= 16 ? 0x55555555u : ((1u << (2 * n)) - 1) & 0x55555555u;
      const uint32_t r = rev_bytes_bits(wb[k]);
      const uint32_t hi = r & 0x55555555u;
      const uint32_t lo = (r >> 1) & 0x55555555u;
      if (HAS_NM) {
        const uint32_t nb =
            spread16(rev_bytes_bits(wn[k >> 1]) >> (16 * (k & 1)));
        cn += __popc(v & nb);
        v &= ~nb;
      }
      cl += __popc(v);
      c1 += __popc(v & ~hi & lo);
      c2 += __popc(v & hi & ~lo);
      c3 += __popc(v & hi & lo);
    }
  }
  const int c0 = cl - c1 - c2 - c3;
  worst[b] = max(max(c0, c1), max(c2, c3));
  ncnt[b] = cn;
}

}  // namespace

// b2w [W16, B] and nmw [W16/2, B] (or null) as uint32 words, lengths [B]
// int32; worst and ncnt [B] int32.  Returns cudaGetLastError().
extern "C" int fx_packed_counts(const void* b2w, const void* nmw,
                                const void* lengths, int W16, int B,
                                void* worst, void* ncnt, void* stream) {
  if (W16 < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (nmw != nullptr)
    packed_counts_kernel<true><<<blocks, threads, 0, s>>>(
        (const uint32_t*)b2w, (const uint32_t*)nmw, (const int32_t*)lengths,
        W16, B, (int32_t*)worst, (int32_t*)ncnt);
  else
    packed_counts_kernel<false><<<blocks, threads, 0, s>>>(
        (const uint32_t*)b2w, nullptr, (const int32_t*)lengths, W16, B,
        (int32_t*)worst, (int32_t*)ncnt);
  return (int)cudaGetLastError();
}
