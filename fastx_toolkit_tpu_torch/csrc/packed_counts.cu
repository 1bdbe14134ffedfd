// K2: per-read base counts on the 2-bit packed upload, for Hopper.
//
// Replaces fastx_toolkit_tpu/kernels/counts_pallas.py::_make_kernel
// (entered through packed_counts_pallas).  For each read, over positions
// x < length: the largest single-letter A/C/G/T count ("worst", for
// fastx_artifacts_filter) and the effective-N count (a position whose N
// plane bit is set counts as N, not as its 2-bit letter), for the
// clipper's and fastq_to_fasta's contains-N gates.
//
// Design: one thread per read loops over its own word columns up to its
// length.  Operands are [words, B], so the loads of neighbouring threads
// are neighbouring words (coalesced); each thread reads L/4 + L/8 bytes
// and writes 8.  What bounds it on this card: device memory traffic of
// those operands (about 15 MB per 262,144 reads of 100 bp, ~5 us at
// 3.35 TB/s), the latency of each thread's chain of word loads, and the
// launch; the per-position work is a few integer operations.  Any B is accepted; the ragged edge is masked here, and a
// length beyond the words the operands hold is clamped to them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0, cn = 0;
  for (int x0 = 0; x0 < len; x0 += 16) {
    const uint32_t wb = b2w[(size_t)(x0 >> 4) * B + b];
    const uint32_t wn = HAS_NM ? nmw[(size_t)(x0 >> 5) * B + b] : 0u;
    const int n = len - x0 < 16 ? len - x0 : 16;
    for (int j = 0; j < n; ++j) {
      const int x = x0 + j;
      const int code = (wb >> (8 * ((x >> 2) & 3) + 6 - 2 * (x & 3))) & 3;
      if (HAS_NM && ((wn >> (8 * ((x >> 3) & 3) + 7 - (x & 7))) & 1u)) {
        ++cn;
      } else {
        c0 += code == 0;
        c1 += code == 1;
        c2 += code == 2;
        c3 += code == 3;
      }
    }
  }
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
