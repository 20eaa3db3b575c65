// Fused negacyclic polynomial product, for Hopper (sm_90a).
//
// Replaces the TPU kernel K4, toyfhe_tpu/ops/ntt_pallas.py::
// polymul_pallas_raw (body _polymul_kernel): for primal a, b of one
// (limb, row),
//
//   out = INTT(NTT(a) (.) NTT(b))   ==   a * b mod (X^N + 1, p)
//
// as psi-twist and DIF stages of both operands (natural in, bit-reversed
// out), the pointwise product mont(mont(da, R^2), db) in bit-reversed order,
// DIT stages with the inverse twiddles (bit-reversed in, natural out) and
// the N^-1 psi^-i untwist. No bit-reversal permutation is applied and no
// transform leaves the chip: each input is read once and the output written
// once.
//
// One thread block per (limb, row) polynomial, limb-major as the [L, R, N]
// operands lie. Up to N = 2^14 both transformed operands sit in shared
// memory as 32-bit words (2N words, 128 KB at N = 2^14). At N = 2^15 two
// rows do not fit in 227 KB: DIF(a) is parked in the block's own output row
// in global memory while b is transformed in the same N words, and read
// back by the threads that wrote it for the pointwise product. The stage
// loops and the Montgomery product are those of common.cuh; the twiddles
// are K1's packed tables (the stage of half-length h at offsets [h, 2h) of
// one row of N per limb), forward and inverse. Every butterfly is fully
// reduced, so the output is canonical and equals the plain twin bit for bit.
//
// What bounds it on this card: each block runs 3 log2 N barrier-separated
// stages over data that fits one SM, and a batch is about one wave of
// blocks, so it is bound by latency, not by device-memory bytes.

#include "common.cuh"

namespace {

using toyfhe::mont_mul;

// Twist one operand into s and run the DIF stages over it.
__device__ __forceinline__ void forward(uint32_t* s, const int64_t* in,
                                        const uint32_t* twistl, const uint32_t* twl,
                                        int n, uint32_t p, uint32_t ninv) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = mont_mul(static_cast<uint32_t>(in[i]), twistl[i], p, ninv);
  }
  __syncthreads();
  toyfhe::dif_stages(s, twl, n, p, ninv);
}

template <bool kPark>
__global__ void polymul_kernel(const int64_t* __restrict__ a,
                               const int64_t* __restrict__ b, int64_t* out,
                               const uint32_t* __restrict__ twist,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ itwist,
                               const uint32_t* __restrict__ itw,
                               const uint32_t* __restrict__ pn,
                               const uint32_t* __restrict__ r2, int rows, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int poly = blockIdx.x;                 // limb-major: poly = l * rows + r
  const int l = poly / rows;
  const uint32_t p = pn[2 * l];
  const uint32_t ninv = pn[2 * l + 1];
  const uint32_t r2l = r2[l];
  const size_t row = static_cast<size_t>(poly) * n;
  const size_t lrow = static_cast<size_t>(l) * n;
  int64_t* xout = out + row;
  uint32_t* sa = s;
  uint32_t* sb = kPark ? s : s + n;

  forward(sa, a + row, twist + lrow, tw + lrow, n, p, ninv);
  if (kPark) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) xout[i] = static_cast<int64_t>(sa[i]);
    __syncthreads();
  }
  forward(sb, b + row, twist + lrow, tw + lrow, n, p, ninv);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t da = kPark ? static_cast<uint32_t>(xout[i]) : sa[i];
    sa[i] = mont_mul(mont_mul(da, r2l, p, ninv), sb[i], p, ninv);
  }
  __syncthreads();

  toyfhe::dit_stages(sa, itw + lrow, n, p, ninv);

  const uint32_t* itwistl = itwist + lrow;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xout[i] = static_cast<int64_t>(mont_mul(sa[i], itwistl[i], p, ninv));
  }
}

}  // namespace

extern "C" {

// a / b / out: int64 [nlimbs, rows, 2^logn] primal residues, limb axis
// first; out must not alias an input. twist / itwist: psi_pow / psi_ipow
// uint32 [nlimbs, 2^logn] (Montgomery form); tw / itw: the packed forward
// and inverse stage twiddles; pn: interleaved (p, ninv) pairs; r2: R^2 mod p
// per limb. park != 0 keeps one row in shared memory and parks DIF(a) in the
// output row (required at N = 2^15). Returns cudaGetLastError() after the
// launch.
int toyfhe_polymul(const void* a, const void* b, void* out, const void* twist,
                   const void* tw, const void* itwist, const void* itw,
                   const void* pn, const void* r2, int nlimbs, int rows, int logn,
                   int park, void* stream) {
  if (nlimbs <= 0 || rows <= 0) return 0;
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(park ? n : 2 * n) * sizeof(uint32_t);
  void (*kern)(const int64_t*, const int64_t*, int64_t*, const uint32_t*, const uint32_t*,
               const uint32_t*, const uint32_t*, const uint32_t*, const uint32_t*, int, int) =
      park ? polymul_kernel<true> : polymul_kernel<false>;
  const cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nlimbs * rows, toyfhe::poly_threads(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(twist),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(itwist),
      static_cast<const uint32_t*>(itw), static_cast<const uint32_t*>(pn),
      static_cast<const uint32_t*>(r2), rows, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
