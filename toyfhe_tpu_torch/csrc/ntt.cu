// Negacyclic NTT / INTT over RNS towers, natural order in and out, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel K1, toyfhe_tpu/ops/ntt_mxu_pallas.py::_mxu_nat
// (bodies _fwd_kernel_nat and _inv_kernel_nat). That kernel runs a four-step
// transform as int8 digit matmuls on the MXU only because the TPU VPU has no
// 32x32->64 multiply. Hopper has one, so this kernel is the plain radix-2
// transform with native 64-bit products, computing the same values:
//
//   forward:  x_i * psi^i (Montgomery twist), bit-reverse, log2 N DIT stages
//             with the per-stage twiddles omega^(j N / len)
//   inverse:  bit-reverse, DIT stages with the inverse twiddles, then the
//             n^-1 psi^-i untwist
//
// One thread block transforms one (row, limb) polynomial with its N residues
// held in shared memory as 32-bit words (16 KB at N = 4096, 32 KB at 2^13,
// 64 KB at 2^14, 128 KB at 2^15; above 48 KB through the dynamic
// shared-memory attribute). Every butterfly is fully reduced, so outputs are
// canonical residues in [0, p) and equal the radix-2 oracle bit for bit
// whatever order the butterflies run in.
//
// What bounds it on this card: at the step's shapes (28 to 196 polynomials of
// N = 2^12..2^13, about 0.9 MB of residues) there are fewer blocks than SMs
// and log2 N barrier-separated stages per block, so the kernel is bound by
// latency and launches, not by device-memory bytes.
//
// Residues arrive and leave as int64 (the port's residue dtype); twiddles are
// uint32 Montgomery-form tables, one row of N per limb, with the stage of
// half-length h stored at offsets [h, 2h). The Montgomery product and the
// stage loop live in common.cuh, shared with the hybrid key switch (K3).

#include "common.cuh"

namespace {

using toyfhe::bitrev;
using toyfhe::mont_mul;

template <bool kInverse>
__global__ void ntt_kernel(const int64_t* __restrict__ x,
                           int64_t* __restrict__ out,
                           const uint32_t* __restrict__ twist,
                           const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ pn,
                           int nlimbs, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int poly = blockIdx.x;
  const int l = poly % nlimbs;
  const uint32_t p = pn[2 * l];
  const uint32_t ninv = pn[2 * l + 1];
  const int64_t* xin = x + static_cast<size_t>(poly) * n;
  int64_t* xout = out + static_cast<size_t>(poly) * n;
  const uint32_t* twl = tw + static_cast<size_t>(l) * n;
  const uint32_t* twistl = twist + static_cast<size_t>(l) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = static_cast<uint32_t>(xin[i]);
    if (!kInverse) v = mont_mul(v, twistl[i], p, ninv);
    s[bitrev(i, logn)] = v;
  }
  __syncthreads();

  toyfhe::dit_stages(s, twl, n, p, ninv);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = s[i];
    if (kInverse) v = mont_mul(v, twistl[i], p, ninv);
    xout[i] = static_cast<int64_t>(v);
  }
}

}  // namespace

extern "C" {

// Transforms `polys` contiguous polynomials of 2^logn int64 residues; limb of
// polynomial r is r % nlimbs. twist is psi_pow (forward) or psi_ipow
// (inverse), tw the packed stage twiddles of that direction, pn the
// interleaved (p, ninv) pairs. Returns cudaGetLastError() after the launch.
int toyfhe_ntt(const void* x, void* out, const void* twist, const void* tw,
               const void* pn, int polys, int nlimbs, int logn, int inverse,
               void* stream) {
  if (polys <= 0) return 0;
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  void (*kern)(const int64_t*, int64_t*, const uint32_t*, const uint32_t*,
               const uint32_t*, int, int) =
      inverse ? ntt_kernel<true> : ntt_kernel<false>;
  const cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<polys, toyfhe::poly_threads(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(twist), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(pn), nlimbs, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
