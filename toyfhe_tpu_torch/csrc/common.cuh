// Device helpers shared by the port's kernels: the Montgomery product, the
// bit-reversal index, the register-radix DIT and DIF stages with lazy or
// fully reduced butterflies, and the launch plumbing.
//
// Residues are canonical 32-bit words in [0, p), p < 2^31, so a sum of two
// fits a uint32. Twiddles are Montgomery-form uint32 tables with the stage of
// half-length h stored at offsets [h, 2h) of one row of N per limb.
//
// Each library is built from one .cu that includes this header once, so the
// extern "C" error-string function below is defined once per library.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace toyfhe {

// REDC(a*b) for a*b < p * 2^32: (x + m p) / 2^32 with m = x * ninv mod 2^32.
// Only b needs to be below p: a may be any residue below 2^32 whose product
// with b stays under p * 2^32 (the hybrid key switch feeds ŷ mod q_i here).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t ninv) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * ninv;
  const uint64_t t = (x + static_cast<uint64_t>(m) * p) >> 32;   // < 2p
  return t >= p ? static_cast<uint32_t>(t - p) : static_cast<uint32_t>(t);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;                // < 2p < 2^32
  return s >= p ? s - p : s;
}

__device__ __forceinline__ int bitrev(int i, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logn));
}

// REDC(a*b) without the closing correction: in [0, 2p) for any 32-bit a when
// b < p < 2^30 (the product plus m p stays under 2^63).
__device__ __forceinline__ uint32_t redc_lazy(uint32_t a, uint32_t b,
                                              uint32_t p, uint32_t ninv) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * ninv;
  return static_cast<uint32_t>((x + static_cast<uint64_t>(m) * p) >> 32);
}

// One DIT butterfly (x, y) <- (x + w y, x - w y), w in Montgomery form.
// kLazy (p < 2^30): values stay in [0, 4p), one conditional subtraction and
// no correction of the product (Harvey's butterfly); the caller reduces once
// at the end. Otherwise every value is canonical in [0, p), p < 2^31.
template <bool kLazy>
__device__ __forceinline__ void dit_butterfly(uint32_t& x, uint32_t& y, uint32_t w,
                                              uint32_t p, uint32_t ninv) {
  if (kLazy) {
    const uint32_t p2 = 2 * p;
    const uint32_t t = redc_lazy(y, w, p, ninv);          // < 2p
    const uint32_t u = x >= p2 ? x - p2 : x;              // < 2p
    x = u + t;
    y = u + p2 - t;
  } else {
    const uint32_t t = mont_mul(y, w, p, ninv);
    const uint32_t u = x;
    x = add_mod(u, t, p);
    y = u >= t ? u - t : u + (p - t);
  }
}

// K DIT stages on 2^K values held in registers. Element e sits at position
// low + e 2^b0 (plus bits above the pass), so the stage of half-length
// h = 2^(b0+s) pairs (e, e + 2^s) with the twiddle tw(h + low + (e mod 2^s)
// 2^b0): 2^K - 1 twiddles a call. tw maps an offset of the limb's packed
// stage-twiddle row to its value.
template <int K, bool kLazy, typename Tw>
__device__ __forceinline__ void radix_stages(uint32_t (&r)[1 << K], Tw tw, int low,
                                             int b0, uint32_t p, uint32_t ninv) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int h = 1 << (b0 + s);
#pragma unroll
    for (int lo = 0; lo < (1 << s); ++lo) {
      const uint32_t w = tw(h + low + (lo << b0));
#pragma unroll
      for (int hi = 0; hi < (1 << (K - 1 - s)); ++hi) {
        const int e = (hi << (s + 1)) + lo;
        dit_butterfly<kLazy>(r[e], r[e + (1 << s)], w, p, ninv);
      }
    }
  }
}

// One DIF (Gentleman-Sande) butterfly (x, y) <- (x + y, (x - y) w), w in
// Montgomery form. kLazy (p < 2^30): values stay in [0, 2p), one conditional
// subtraction on the sum and an uncorrected REDC of x - y + 2p < 4p < 2^32 on
// the difference. Otherwise every value is canonical in [0, p), p < 2^31.
template <bool kLazy>
__device__ __forceinline__ void dif_butterfly(uint32_t& x, uint32_t& y, uint32_t w,
                                              uint32_t p, uint32_t ninv) {
  if (kLazy) {
    const uint32_t p2 = 2 * p;
    const uint32_t s = x + y;                             // < 4p
    const uint32_t d = x + p2 - y;                        // in (0, 4p)
    x = min(s, s - p2);                                   // s - 2p wraps above s when s < 2p
    y = redc_lazy(d, w, p, ninv);
  } else {
    const uint32_t u = x, v = y;
    x = add_mod(u, v, p);
    y = mont_mul(u >= v ? u - v : u + (p - v), w, p, ninv);
  }
}

// K DIF stages on 2^K values held in registers, the mirror of radix_stages:
// element e sits at position low + e 2^b0 (plus bits above the pass), and the
// stages run from the top of the pass downwards, s = K-1 .. 0. The stage of
// half-length h = 2^(b0+s) pairs (e, e + 2^s) with the twiddle tw(h + low +
// (e mod 2^s) 2^b0), the same offsets of the limb's packed forward row that
// radix_stages reads of the inverse row: 2^K - 1 twiddles a call.
template <int K, bool kLazy, typename Tw>
__device__ __forceinline__ void radix_stages_dif(uint32_t (&r)[1 << K], Tw tw, int low,
                                                 int b0, uint32_t p, uint32_t ninv) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const int h = 1 << (b0 + s);
#pragma unroll
    for (int lo = 0; lo < (1 << s); ++lo) {
      const uint32_t w = tw(h + low + (lo << b0));
#pragma unroll
      for (int hi = 0; hi < (1 << (K - 1 - s)); ++hi) {
        const int e = (hi << (s + 1)) + lo;
        dif_butterfly<kLazy>(r[e], r[e + (1 << s)], w, p, ninv);
      }
    }
  }
}

// The same stages on two operands held at the same positions: each twiddle is
// loaded once for two butterflies, and the two dependency chains interleave.
template <int K, bool kLazy, typename Tw>
__device__ __forceinline__ void radix_stages_dif2(uint32_t (&ra)[1 << K],
                                                  uint32_t (&rb)[1 << K], Tw tw, int low,
                                                  int b0, uint32_t p, uint32_t ninv) {
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const int h = 1 << (b0 + s);
#pragma unroll
    for (int lo = 0; lo < (1 << s); ++lo) {
      const uint32_t w = tw(h + low + (lo << b0));
#pragma unroll
      for (int hi = 0; hi < (1 << (K - 1 - s)); ++hi) {
        const int e = (hi << (s + 1)) + lo;
        dif_butterfly<kLazy>(ra[e], ra[e + (1 << s)], w, p, ninv);
        dif_butterfly<kLazy>(rb[e], rb[e + (1 << s)], w, p, ninv);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit when smem exceeds 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace toyfhe

extern "C" const char* toyfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
