// Forward four-step negacyclic NTT from int8 digit matrices, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K2, toyfhe_tpu/ops/ntt_mxu_pallas.py::
// ntt_mxu_pallas (body _fwd_kernel). With N = 128 * n2 and the coefficient
// block of one (limb, row) laid out as X[j1, j2] (128 x n2):
//
//   X  <- X (.) psi                                  psi-twist
//   A[k1, j2] = sum_j1 W1[j1, k1] * X[j1, j2] mod p  stage 1
//   B[k1, j2] = A[k1, j2] * omega^(k1 j2)            twiddle
//   C[k1, k2] = sum_j2 B[k1, j2] * W2[j2, k2] mod p  stage 2
//
// and C is stored in (k1, k2) order. As in the TPU kernel the two modular
// matrix products are exact integer products of balanced base-256 digits
// (int8): the data is split into 4 digit planes, the 16 digit x digit dots
// are summed into 7 diagonal groups (d + e = s) with __dp4a (int8 x 4 ->
// int32) on the CUDA cores, and the groups recombine to the residue by one
// of two forms, chosen by the caller: the 7-term form (each group offset by
// 2^23, seven 32 x 32 -> 64 products) or the paired form (adjacent groups
// folded into int32 with weights 2^16t, offset by 2^31, two products and
// two shifts), both followed by two Montgomery reductions of the 64-bit sum
// and the subtraction of the offsets' sum. The (hi, lo) word pairs of the
// TPU kernel are a native uint64 here. The result is the canonical residue,
// equal to the plain twin and to the radix-2 transform bit for bit.
//
// One thread block per (limb, row), grid (L, R). Shared memory holds two
// sets of four digit planes and no 32-bit tile: the twisted input goes
// straight to the stage-1 planes, transposed to [j2][j1] so that four
// consecutive j1 form one dp4a word; stage 1 writes B's digits to the
// stage-2 planes [k1][j2]. Rows are padded by 4 bytes so that the threads
// of a warp, which walk consecutive rows, hit distinct banks. Both W
// matrices are symmetric Vandermonde matrices, so a row of W holds the four
// consecutive contraction indices a dp4a word needs; they are read from
// global memory (every block of a limb reads the same 128 KB, which stays in
// L2, and the threads of a warp read the same word). Each thread carries a
// strip of 4 outputs x 7 groups in registers, so each data word is loaded
// once for 64 dp4a. Stage 2 writes C as 32-bit words over the stage-1 planes
// and a last pass stores it as int64, coalesced. At N = 2^14 that is 132 KB
// of shared memory per block.
//
// What bounds it on this card: operations. One polynomial of N = 2^14 takes
// 2 * 128^3 * 16 int8 multiply-adds = 16.8 M dp4a on the CUDA cores, against
// 256 KB of input and output; the int8 tensor cores (mma / wgmma s8) are
// where a redesign goes.

#include "common.cuh"

namespace {

using toyfhe::add_mod;
using toyfhe::mont_mul;

constexpr int kN1 = 128;           // stage-1 edge
constexpr int kDigits = 4;
constexpr int kGroups = 2 * kDigits - 1;
constexpr int kStrip = 4;          // outputs per thread strip
constexpr int kStrideA = kN1 + 4;  // bytes per j2 row of a stage-1 plane
constexpr int kWordsA = kStrideA / 4;
constexpr int kScalars = 16;       // uint32 words per limb in the constant table
constexpr uint32_t kOffset = 1u << 23;

struct LimbConsts {
  uint32_t p, ninv, corr, r1m, him, cs32, cs48, corr2;
  uint32_t cs[kGroups];
};

__device__ __forceinline__ LimbConsts load_consts(const uint32_t* sc) {
  LimbConsts c;
  c.p = sc[0]; c.ninv = sc[1]; c.corr = sc[2]; c.r1m = sc[3]; c.him = sc[4];
  c.cs32 = sc[5]; c.cs48 = sc[6]; c.corr2 = sc[7];
  for (int s = 0; s < kGroups; ++s) c.cs[s] = sc[8 + s];
  return c;
}

// The four balanced base-256 digits of v < 2^30, one byte into each plane.
__device__ __forceinline__ void store_digits(int8_t* planes, int plane_bytes,
                                             int off, uint32_t v) {
  int32_t cur = static_cast<int32_t>(v);
#pragma unroll
  for (int d = 0; d < kDigits; ++d) {
    int32_t r = cur & 255;
    r -= (r & 128) << 1;                      // [128, 255] -> [-128, -1]
    planes[d * plane_bytes + off] = static_cast<int8_t>(r);
    cur = (cur - r) >> 8;
  }
}

// sum_s 2^(8s) g[s] mod p from the 7 diagonal groups.
template <bool kPaired>
__device__ __forceinline__ uint32_t combine(const int32_t* g, const LimbConsts& c) {
  uint64_t total;
  uint32_t corr;
  if (kPaired) {
    const uint32_t hp0 = static_cast<uint32_t>(g[0] + g[1] * 256) + 0x80000000u;
    const uint32_t hp1 = static_cast<uint32_t>(g[2] + g[3] * 256) + 0x80000000u;
    const uint32_t hp2 = static_cast<uint32_t>(g[4] + g[5] * 256) + 0x80000000u;
    const uint32_t hp3 = static_cast<uint32_t>(g[6]) + 0x80000000u;
    total = static_cast<uint64_t>(hp0) + (static_cast<uint64_t>(hp1) << 16) +
            static_cast<uint64_t>(hp2) * c.cs32 + static_cast<uint64_t>(hp3) * c.cs48;
    corr = c.corr2;
  } else {
    total = 0;
#pragma unroll
    for (int s = 0; s < kGroups; ++s) {
      total += static_cast<uint64_t>(static_cast<uint32_t>(g[s]) + kOffset) * c.cs[s];
    }
    corr = c.corr;
  }
  const uint32_t t1 = mont_mul(static_cast<uint32_t>(total), c.r1m, c.p, c.ninv);
  const uint32_t t2 = mont_mul(static_cast<uint32_t>(total >> 32), c.him, c.p, c.ninv);
  const uint32_t v = add_mod(t1, t2, c.p);
  return v >= corr ? v - corr : v + (c.p - corr);
}

// acc[t][d + e] += dot4(w[t][d], x[e]) for a strip of `strip` outputs.
__device__ __forceinline__ void strip_dots(int32_t (&acc)[kStrip][kGroups],
                                           const int32_t* w, int row0, int row_stride,
                                           int plane_rows, int cw, int strip,
                                           const int32_t (&xw)[kDigits]) {
#pragma unroll
  for (int t = 0; t < kStrip; ++t) {
    if (t < strip) {
#pragma unroll
      for (int d = 0; d < kDigits; ++d) {
        const int32_t ww = __ldg(&w[(static_cast<size_t>(d) * plane_rows + row0 + t) *
                                      row_stride + cw]);
#pragma unroll
        for (int e = 0; e < kDigits; ++e) {
          acc[t][d + e] = __dp4a(ww, xw[e], acc[t][d + e]);
        }
      }
    }
  }
}

template <bool kPaired>
__global__ void __launch_bounds__(512)
ntt_mxu_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ psis,
               int64_t* __restrict__ out, const int32_t* __restrict__ w1,
               const int32_t* __restrict__ w2, const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ sc, int rows, int n2, int k2pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.x;
  const int r = blockIdx.y;
  const int n = kN1 * n2;
  const int plane_a = n2 * kStrideA;          // bytes, stage-1 plane [j2][j1]
  const int stride_b = k2pad + 4;             // bytes per k1 row, stage-2 plane [k1][j2]
  const int plane_b = kN1 * stride_b;
  int8_t* pa = reinterpret_cast<int8_t*>(smem);
  int8_t* pb = pa + kDigits * plane_a;
  uint32_t* outs = reinterpret_cast<uint32_t*>(smem);   // over the stage-1 planes, in stage 2

  const LimbConsts c = load_consts(sc + l * kScalars);
  const int64_t* xin = x + (static_cast<size_t>(l) * rows + r) * n;
  int64_t* xout = out + (static_cast<size_t>(l) * rows + r) * n;
  const int64_t* psl = psis + static_cast<size_t>(l) * n;
  const uint32_t* twl = tw + static_cast<size_t>(l) * n;

  if (k2pad != n2) {                          // zero the contraction padding of stage 2
    for (int i = threadIdx.x; i < kDigits * plane_b; i += blockDim.x) pb[i] = 0;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j1 = i / n2;
    const int j2 = i - j1 * n2;
    const uint32_t v = mont_mul(static_cast<uint32_t>(xin[i]),
                                static_cast<uint32_t>(psl[i]), c.p, c.ninv);
    store_digits(pa, plane_a, j2 * kStrideA + j1, v);
  }
  __syncthreads();

  // stage 1: strips of 4 k1 for one j2; a warp walks consecutive j2
  {
    const int32_t* w1l = w1 + static_cast<size_t>(l) * kDigits * kN1 * (kN1 / 4);
    const int32_t* pa32 = reinterpret_cast<const int32_t*>(pa);
    const int plane_words = plane_a / 4;
    for (int item = threadIdx.x; item < (kN1 / kStrip) * n2; item += blockDim.x) {
      const int k1g = item / n2;
      const int j2 = item - k1g * n2;
      int32_t acc[kStrip][kGroups] = {};
      for (int cw = 0; cw < kN1 / 4; ++cw) {
        int32_t xw[kDigits];
#pragma unroll
        for (int e = 0; e < kDigits; ++e) xw[e] = pa32[e * plane_words + j2 * kWordsA + cw];
        strip_dots(acc, w1l, k1g * kStrip, kN1 / 4, kN1, cw, kStrip, xw);
      }
#pragma unroll
      for (int t = 0; t < kStrip; ++t) {
        const int k1 = k1g * kStrip + t;
        const uint32_t a = combine<kPaired>(acc[t], c);
        const uint32_t b = mont_mul(a, twl[k1 * n2 + j2], c.p, c.ninv);
        store_digits(pb, plane_b, k1 * stride_b + j2, b);
      }
    }
  }
  __syncthreads();

  // stage 2: strips of up to 4 k2 for one k1; a warp walks consecutive k1
  {
    const int strip = n2 < kStrip ? n2 : kStrip;
    const int kw = k2pad / 4;
    const int32_t* w2l = w2 + static_cast<size_t>(l) * kDigits * n2 * kw;
    const int32_t* pb32 = reinterpret_cast<const int32_t*>(pb);
    const int plane_words = plane_b / 4;
    const int row_words = stride_b / 4;
    for (int item = threadIdx.x; item < (n2 / strip) * kN1; item += blockDim.x) {
      const int k2g = item / kN1;
      const int k1 = item - k2g * kN1;
      int32_t acc[kStrip][kGroups] = {};
      for (int cw = 0; cw < kw; ++cw) {
        int32_t bw[kDigits];
#pragma unroll
        for (int e = 0; e < kDigits; ++e) bw[e] = pb32[e * plane_words + k1 * row_words + cw];
        strip_dots(acc, w2l, k2g * strip, kw, n2, cw, strip, bw);
      }
#pragma unroll
      for (int t = 0; t < kStrip; ++t) {
        if (t < strip) outs[k1 * n2 + k2g * strip + t] = combine<kPaired>(acc[t], c);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xout[i] = static_cast<int64_t>(outs[i]);
  }
}

}  // namespace

extern "C" {

// x / out: int64 [nlimbs, rows, 128, n2]; psis: int64 [nlimbs, 128, n2]
// (Montgomery form). w1: int8 [nlimbs, 4, 128, 128] and w2: int8
// [nlimbs, 4, n2, k2pad] digit matrices, row = output index, the contraction
// index contiguous and zero-padded to k2pad (a multiple of 4). tw: uint32
// [nlimbs, 128, n2]. sc: uint32 [nlimbs, 16] = p, ninv, corr, r1_mont,
// hi_mont, cs32, cs48, corr2, cs[0..7), 0. Returns cudaGetLastError() after
// the launch.
int toyfhe_ntt_mxu(const void* x, const void* psis, void* out, const void* w1,
                   const void* w2, const void* tw, const void* sc, int nlimbs,
                   int rows, int n2, int k2pad, int paired, void* stream) {
  if (nlimbs <= 0 || rows <= 0) return 0;
  const size_t smem = static_cast<size_t>(kDigits) *
                      (static_cast<size_t>(n2) * kStrideA +
                       static_cast<size_t>(kN1) * (k2pad + 4));
  void (*kern)(const int64_t*, const int64_t*, int64_t*, const int32_t*, const int32_t*,
               const uint32_t*, const uint32_t*, int, int, int) =
      paired ? ntt_mxu_kernel<true> : ntt_mxu_kernel<false>;
  const cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = 32 * n2;
  threads = threads < 64 ? 64 : (threads > 512 ? 512 : threads);
  kern<<<dim3(nlimbs, rows), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(psis),
      static_cast<int64_t*>(out), static_cast<const int32_t*>(w1),
      static_cast<const int32_t*>(w2), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(sc), rows, n2, k2pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
