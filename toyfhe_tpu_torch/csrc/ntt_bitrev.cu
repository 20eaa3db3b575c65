// Forward negacyclic NTT with bit-reversed output, for Hopper (sm_90a).
//
// Replaces the TPU kernel K5, toyfhe_tpu/ops/ntt_pallas.py::
// ntt_pallas_bitrev (body _fwd_kernel): the psi-twist followed by log2 N
// Gentleman–Sande DIF stages, natural order in, bit-reversed order out:
//
//   out[l, r, i] = NTT(x[l, r])[bitrev(i)]
//
// One thread block transforms one (limb, row) polynomial with its N
// residues in shared memory as 32-bit words (32 KB at N = 2^13). The TPU
// kernel took rows_per_block rows per grid step to fill its (8, 128) vector
// tiles; here each block owns one row and the stage loop (dif_stages in
// common.cuh, shared with the fused key switch K6) runs with the block's
// threads over the N/2 butterflies of a stage. The stage twiddles are K1's
// packed table (the stage of half-length h at offsets [h, 2h) of one row of
// N per limb): the same powers as the reference's full-length (L, logN, N)
// tables in logN times fewer bytes. Every butterfly is fully reduced, so the
// output is canonical and equals the plain twin bit for bit.
//
// What bounds it on this card: at the shapes of the key switch (tens to
// hundreds of polynomials of N = 2^13) the grid is about one wave of blocks,
// each running log2 N barrier-separated stages, so it is bound by latency
// and launches, not by device-memory bytes.

#include "common.cuh"

namespace {

using toyfhe::mont_mul;

__global__ void ntt_bitrev_kernel(const int64_t* __restrict__ x,
                                  int64_t* __restrict__ out,
                                  const uint32_t* __restrict__ twist,
                                  const uint32_t* __restrict__ tw,
                                  const uint32_t* __restrict__ pn,
                                  int rows, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int poly = blockIdx.x;                 // limb-major: poly = l * rows + r
  const int l = poly / rows;
  const uint32_t p = pn[2 * l];
  const uint32_t ninv = pn[2 * l + 1];
  const int64_t* xin = x + static_cast<size_t>(poly) * n;
  int64_t* xout = out + static_cast<size_t>(poly) * n;
  const uint32_t* twistl = twist + static_cast<size_t>(l) * n;
  const uint32_t* twl = tw + static_cast<size_t>(l) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = mont_mul(static_cast<uint32_t>(xin[i]), twistl[i], p, ninv);
  }
  __syncthreads();

  toyfhe::dif_stages(s, twl, n, p, ninv);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xout[i] = static_cast<int64_t>(s[i]);
  }
}

}  // namespace

extern "C" {

// x / out: int64 [nlimbs, rows, 2^logn] residues, limb axis first. twist:
// psi_pow uint32 [nlimbs, 2^logn] (Montgomery form); tw: the packed forward
// stage twiddles; pn: interleaved (p, ninv) pairs. Returns
// cudaGetLastError() after the launch.
int toyfhe_ntt_bitrev(const void* x, void* out, const void* twist,
                      const void* tw, const void* pn, int nlimbs, int rows,
                      int logn, void* stream) {
  if (nlimbs <= 0 || rows <= 0) return 0;
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  const cudaError_t e = toyfhe::allow_smem(ntt_bitrev_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ntt_bitrev_kernel<<<nlimbs * rows, toyfhe::poly_threads(n), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(twist), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(pn), rows, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
