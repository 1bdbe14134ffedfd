// P: the plane-op probe, for Hopper.
//
// Replaces bench.py::vpu_probe (its pl.pallas_call at bench.py:1274, run by
// `bench.py --vpuprobe`), which measured the TPU's VMEM streaming rate
// with chains of unfused plane operations and so gave the TPU's adapter DP
// its bound.  Here it measures what bounds the port's DP kernels on the
// card: the sustained int32 rate of the DP's add / xor / max / sign-fold
// mix with the state in registers (K1's design) and in shared memory (K3's
// and K4's), whether Hopper's DPX instruction (__viaddmax) changes it, and
// whether int16 pairs move twice the elements a second.
//
// What it computes, bit for bit (kernels/probe.py::plane_probe_plain): an
// [H, B] plane starts at ones; each of K steps, with t = step + 1, runs
//   dependent:   U/4 times: v += t; v ^= k + 1; v = max(v, v - t);
//                v += v >> (bits - 1)
//   independent: 8 chains a_j = v + j, then U/8 - 1 times a_j += t (odd k)
//                or a_j ^= k + 1 (even k), then v = a_0 + ... + a_7
// in wrapping int32 or int16 arithmetic; the output is row 0 of the plane.
// Every column and every row starts equal, so the kernels keep the
// compiler from folding rows or dropping them: rows start at 1 + h * z and
// the other rows are folded into the output under `if (z)`, with z a
// runtime 0.
//
// A 32-bit word holds one int32 element, or two int16 elements of
// neighbouring columns (low half = even column), handled by the packed
// SIMD intrinsics (__vadd2, __vsub2, __vmaxs2, __vcmplts2; xor on the word).
//
// Residences (the TPU's sequential grid becomes a loop inside the thread):
//   reg:  one thread per word column, its H words in registers (H is a
//         template parameter, so the plane is a register array).
//   smem: the plane lives in dynamic shared memory, [row][thread] as K3
//         lays out its row state, 64 threads a block; the independent
//         variant keeps its 8 chains as 8 planes.  Each plane op is one
//         pass over the H rows: a load, the op and a store per element.
//         A compiler memory barrier between passes keeps the compiler
//         from carrying the plane in registers from one op to the next
//         (checked in the SASS by fastx_toolkit_tpu_torch/probe.py).  The
//         launcher may give a block more shared memory than the plane
//         needs, to run at a DP kernel's occupancy (K3: 3 x H x 256 B).
//
// What bounds it: the ALU issue rate (reg) or the shared-memory bandwidth
// (smem); device memory traffic is one word a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int REG_THREADS = 128;
constexpr int SMEM_THREADS = 64;
constexpr int CHAINS = 8;
constexpr int GROUP = 8;  // rows whose 8 chains the reg independent
                          // variant keeps in flight at once

template <bool I16>
struct Ops;

template <>
struct Ops<false> {
  static __device__ __forceinline__ uint32_t splat(int x) {
    return (uint32_t)x;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return a + b;
  }
  // max(v, v - t), with nt = -t
  static __device__ __forceinline__ uint32_t max_sub(uint32_t v, uint32_t t,
                                                     uint32_t) {
    return (uint32_t)max((int)v, (int)(v - t));
  }
  static __device__ __forceinline__ uint32_t max_sub_dpx(uint32_t v,
                                                         uint32_t,
                                                         uint32_t nt) {
    return (uint32_t)__viaddmax_s32((int)v, (int)nt, (int)v);
  }
  // v + (v >> 31), arithmetic shift
  static __device__ __forceinline__ uint32_t fold(uint32_t v) {
    return v + (uint32_t)((int)v >> 31);
  }
};

template <>
struct Ops<true> {
  static __device__ __forceinline__ uint32_t splat(int x) {
    const uint32_t h = (uint32_t)x & 0xFFFFu;
    return (h << 16) | h;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __vadd2(a, b);
  }
  static __device__ __forceinline__ uint32_t max_sub(uint32_t v, uint32_t t,
                                                     uint32_t) {
    return __vmaxs2(v, __vsub2(v, t));
  }
  static __device__ __forceinline__ uint32_t max_sub_dpx(uint32_t v,
                                                         uint32_t,
                                                         uint32_t nt) {
    return __viaddmax_s16x2(v, nt, v);
  }
  // v + (v >> 15) in each half: the compare gives 0xFFFF (-1) where v < 0
  static __device__ __forceinline__ uint32_t fold(uint32_t v) {
    return __vadd2(v, __vcmplts2(v, 0u));
  }
};

template <bool I16, bool DPX>
__device__ __forceinline__ uint32_t max_sub(uint32_t v, uint32_t t,
                                            uint32_t nt) {
  return DPX ? Ops<I16>::max_sub_dpx(v, t, nt) : Ops<I16>::max_sub(v, t, nt);
}

template <int H, bool DEP, bool I16, bool DPX>
__global__ void __launch_bounds__(REG_THREADS)
probe_reg(int W, int K, int U, int z, uint32_t* __restrict__ out) {
  using O = Ops<I16>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  uint32_t v[H];
#pragma unroll
  for (int h = 0; h < H; ++h) v[h] = O::splat(1) + (uint32_t)(h * z);

  for (int s = 0; s < K; ++s) {
    const uint32_t t = O::splat(s + 1), nt = O::splat(-(s + 1));
    if (DEP) {
#pragma unroll 1
      for (int k = 0; k < U / 4; ++k) {
        const uint32_t c = O::splat(k + 1);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          uint32_t x = O::add(v[h], t);
          x ^= c;
          x = max_sub<I16, DPX>(x, t, nt);
          v[h] = O::fold(x);
        }
      }
    } else {
      const int n = U / 8 - 1;
#pragma unroll
      for (int h0 = 0; h0 < H; h0 += GROUP) {
        constexpr int R = GROUP;
        uint32_t a[R][CHAINS];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < CHAINS; ++j)
            if (h0 + r < H) a[r][j] = O::add(v[h0 + r], O::splat(j));
#pragma unroll 1
        for (int k = 0; k + 1 < n; k += 2) {
          const uint32_t c = O::splat(k + 1);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < CHAINS; ++j)
              if (h0 + r < H) a[r][j] = O::add(a[r][j] ^ c, t);
        }
        if (n & 1) {
          const uint32_t c = O::splat(n);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < CHAINS; ++j)
              if (h0 + r < H) a[r][j] ^= c;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (h0 + r < H) {
            uint32_t x = a[r][0];
#pragma unroll
            for (int j = 1; j < CHAINS; ++j) x = O::add(x, a[r][j]);
            v[h0 + r] = x;
          }
        }
      }
    }
  }

  uint32_t r0 = v[0];
  if (z) {
#pragma unroll
    for (int h = 1; h < H; ++h) r0 ^= v[h];
  }
  out[i] = r0;
}

// one plane op as a pass over the H rows of plane p ([row][thread]):
// load, op, store; the barrier after it keeps every element in memory
// between ops
template <int H, class F>
__device__ __forceinline__ void pass(uint32_t* p, F f) {
#pragma unroll
  for (int h = 0; h < H; ++h) p[h * SMEM_THREADS] = f(p[h * SMEM_THREADS]);
  asm volatile("" ::: "memory");
}

template <int H, bool DEP, bool I16, bool DPX>
__global__ void __launch_bounds__(SMEM_THREADS)
probe_smem(int W, int K, int U, uint32_t* __restrict__ out) {
  using O = Ops<I16>;
  extern __shared__ uint32_t smem[];
  const int i = blockIdx.x * SMEM_THREADS + threadIdx.x;
  if (i >= W) return;
  // plane j (chain j of the independent variant; plane 0 is v) at
  // p + j * H * SMEM_THREADS
  uint32_t* p = smem + threadIdx.x;
  constexpr int PS = H * SMEM_THREADS;
  pass<H>(p, [](uint32_t) { return O::splat(1); });

  for (int s = 0; s < K; ++s) {
    const uint32_t t = O::splat(s + 1), nt = O::splat(-(s + 1));
    if (DEP) {
#pragma unroll 1
      for (int k = 0; k < U / 4; ++k) {
        const uint32_t c = O::splat(k + 1);
        pass<H>(p, [t](uint32_t x) { return O::add(x, t); });
        pass<H>(p, [c](uint32_t x) { return x ^ c; });
        pass<H>(p, [t, nt](uint32_t x) { return max_sub<I16, DPX>(x, t, nt); });
        pass<H>(p, [](uint32_t x) { return O::fold(x); });
      }
    } else {
      const int n = U / 8 - 1;
      // a_j = v + j, each its own plane (a_0 in place of v, last)
#pragma unroll
      for (int j = CHAINS - 1; j >= 0; --j) {
        uint32_t* q = p + j * PS;
#pragma unroll
        for (int h = 0; h < H; ++h)
          q[h * SMEM_THREADS] = O::add(p[h * SMEM_THREADS], O::splat(j));
        asm volatile("" ::: "memory");
      }
#pragma unroll 1
      for (int k = 0; k + 1 < n; k += 2) {
        const uint32_t c = O::splat(k + 1);
#pragma unroll
        for (int j = 0; j < CHAINS; ++j)
          pass<H>(p + j * PS, [c](uint32_t x) { return x ^ c; });
#pragma unroll
        for (int j = 0; j < CHAINS; ++j)
          pass<H>(p + j * PS, [t](uint32_t x) { return O::add(x, t); });
      }
      if (n & 1) {
        const uint32_t c = O::splat(n);
#pragma unroll
        for (int j = 0; j < CHAINS; ++j)
          pass<H>(p + j * PS, [c](uint32_t x) { return x ^ c; });
      }
      // v = a_0 + a_1 + ... + a_7, one plane add at a time
#pragma unroll
      for (int j = 1; j < CHAINS; ++j) {
        const uint32_t* q = p + j * PS;
#pragma unroll
        for (int h = 0; h < H; ++h)
          p[h * SMEM_THREADS] = O::add(p[h * SMEM_THREADS],
                                       q[h * SMEM_THREADS]);
        asm volatile("" ::: "memory");
      }
    }
  }
  out[i] = p[0];
}

template <int H, bool DEP, bool I16, bool DPX>
int launch(int smem_res, int W, int K, int U, int smem_bytes, uint32_t* out,
           cudaStream_t s) {
  if (!smem_res) {
    const int blocks = (W + REG_THREADS - 1) / REG_THREADS;
    probe_reg<H, DEP, I16, DPX><<<blocks, REG_THREADS, 0, s>>>(W, K, U, 0,
                                                               out);
    return (int)cudaGetLastError();
  }
  const int need = (DEP ? 1 : CHAINS) * H * SMEM_THREADS * 4;
  if (smem_bytes < need) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      probe_smem<H, DEP, I16, DPX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (W + SMEM_THREADS - 1) / SMEM_THREADS;
  probe_smem<H, DEP, I16, DPX><<<blocks, SMEM_THREADS, smem_bytes, s>>>(
      W, K, U, out);
  return (int)cudaGetLastError();
}

template <int H>
int launch_h(int smem_res, int dep, int i16, int dpx, int W, int K, int U,
             int smem_bytes, uint32_t* out, cudaStream_t s) {
#define FX_PROBE(D, I, X)                                                 \
  if ((dep != 0) == D && (i16 != 0) == I && (dpx != 0) == X)            \
    return launch<H, D, I, X>(smem_res, W, K, U, smem_bytes, out, s);
  FX_PROBE(true, false, false)
  FX_PROBE(true, false, true)
  FX_PROBE(false, false, false)
  FX_PROBE(true, true, false)
  FX_PROBE(true, true, true)
  FX_PROBE(false, true, false)
#undef FX_PROBE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Row 0 of the probe's plane after K steps into out, W 32-bit words (B
// int32 columns, or B int16 columns as B/2 words).  smem_res: 0 = reg,
// 1 = smem (smem_bytes of dynamic shared memory a block, at least the
// planes' 4 x H x 64 bytes, 8 planes for the independent variant).  dpx
// only with dep.  H is one of 17, 21, 24, 32, 33, 72.  Returns
// cudaGetLastError() after the launch.
extern "C" int fx_plane_probe(int smem_res, int dep, int i16, int dpx, int H,
                              int W, int K, int U, int smem_bytes, void* out,
                              void* stream) {
  if (W < 0 || K < 0 || U < 8 || (dpx && !dep))
    return (int)cudaErrorInvalidValue;
  if (W == 0) return (int)cudaSuccess;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 17: return launch_h<17>(smem_res, dep, i16, dpx, W, K, U, smem_bytes, o, s);
    case 21: return launch_h<21>(smem_res, dep, i16, dpx, W, K, U, smem_bytes, o, s);
    case 24: return launch_h<24>(smem_res, dep, i16, dpx, W, K, U, smem_bytes, o, s);
    case 32: return launch_h<32>(smem_res, dep, i16, dpx, W, K, U, smem_bytes, o, s);
    case 33: return launch_h<33>(smem_res, dep, i16, dpx, W, K, U, smem_bytes, o, s);
    case 72: return launch_h<72>(smem_res, dep, i16, dpx, W, K, U, smem_bytes, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
