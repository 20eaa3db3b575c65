// Fused hybrid (dnum-gadget) key-switch core for Hopper (sm_90a).
//
// Replaces the TPU kernel K3, toyfhe_tpu/ops/pallas_hybrid_ks.py::
// FusedHybridKS.__call__ (body _fused_kernel). For each batch row r and each
// limb t of the expanded tower Q_t ∪ P it computes
//
//   acc1[r,t] = Σ_j NTT_t( Σ_i ŷ[r, lo_j + i] · [Q_j/q_i]_{p_t} ) ⊙ kd[j,t]
//   acc2[r,t] = Σ_j NTT_t( Σ_i ŷ[r, lo_j + i] · [Q_j/q_i]_{p_t} ) ⊙ km[j,t]
//
// with kd / km the key's masked / mask duals pre-multiplied by 2^32 mod p_t,
// so that one Montgomery product gives the plain product. The output is in
// natural dual order and canonical, equal to the unfused pipeline (digit
// tensor, radix-2 NTT, key contraction) bit for bit.
//
// Design: one thread block per (r, t) output row, looping over the digits j.
// For each digit the block builds the fast-base-conversion row in shared
// memory (already ψ-twisted and in bit-reversed position), runs the DIT
// stages of K1 (common.cuh) on it, multiplies by the two key rows and adds
// into its own output rows. The TPU kernel carried the sum across a
// sequential grid axis j; here the loop over j inside the block takes that
// place, and since each block owns its two output rows no atomics are needed.
// The [dnum, T, N] digit tensor never exists in device memory.
//
// ŷ is a residue mod q_i used as a REDC operand mod p_t without reduction:
// ŷ < 2^31 and the constant is below p_t, so the product stays under
// p_t · 2^32, which is all REDC needs.
//
// What bounds it on this card: at the serving shapes (R · T = 40 to 44 rows
// of N = 2^13) the grid has fewer blocks than SMs, and each block runs dnum
// transforms of log2 N barrier-separated stages one after another, so it is
// bound by latency, not by device-memory bytes: the ŷ rows it re-reads for
// every output limb (T times) are a few MB and stay in the 50 MB L2.

#include "common.cuh"

namespace {

using toyfhe::add_mod;
using toyfhe::bitrev;
using toyfhe::mont_mul;

__global__ void hybrid_ks_kernel(const int64_t* __restrict__ y,
                                 int64_t* __restrict__ out1,
                                 int64_t* __restrict__ out2,
                                 const uint32_t* __restrict__ twist,
                                 const uint32_t* __restrict__ tw,
                                 const uint32_t* __restrict__ pn,
                                 const uint32_t* __restrict__ cst,
                                 const uint32_t* __restrict__ km,
                                 const uint32_t* __restrict__ kd,
                                 const int* __restrict__ bounds,
                                 int lt, int nlimbs, int dnum, int alpha,
                                 int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int t = blockIdx.x % nlimbs;          // output limb of Q_t ∪ P
  const int r = blockIdx.x / nlimbs;          // batch row
  const uint32_t p = pn[2 * t];
  const uint32_t ninv = pn[2 * t + 1];
  const int64_t* yr = y + static_cast<size_t>(r) * lt * n;
  const size_t row = (static_cast<size_t>(r) * nlimbs + t) * n;
  int64_t* o1 = out1 + row;
  int64_t* o2 = out2 + row;
  const uint32_t* twistl = twist + static_cast<size_t>(t) * n;
  const uint32_t* twl = tw + static_cast<size_t>(t) * n;

  for (int j = 0; j < dnum; ++j) {
    const int lo = bounds[2 * j];
    const int width = bounds[2 * j + 1] - lo;
    const uint32_t* c = cst + (static_cast<size_t>(j) * nlimbs + t) * alpha;

    // FBC digit Σ_i ŷ_i · [Q_j/q_i]_{p_t}, ψ-twisted, into bit-reversed place
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t dig = 0;
      for (int a = 0; a < width; ++a) {
        const uint32_t yv = static_cast<uint32_t>(yr[static_cast<size_t>(lo + a) * n + i]);
        dig = add_mod(dig, mont_mul(yv, c[a], p, ninv), p);
      }
      s[bitrev(i, logn)] = mont_mul(dig, twistl[i], p, ninv);
    }
    __syncthreads();

    toyfhe::dit_stages(s, twl, n, p, ninv);

    // key contraction, accumulated into this block's own output rows: the
    // thread that adds to element i is the one that wrote it for digit j-1
    const size_t krow = (static_cast<size_t>(j) * nlimbs + t) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t v = s[i];
      uint32_t a1 = mont_mul(v, kd[krow + i], p, ninv);
      uint32_t a2 = mont_mul(v, km[krow + i], p, ninv);
      if (j > 0) {
        a1 = add_mod(a1, static_cast<uint32_t>(o1[i]), p);
        a2 = add_mod(a2, static_cast<uint32_t>(o2[i]), p);
      }
      o1[i] = static_cast<int64_t>(a1);
      o2[i] = static_cast<int64_t>(a2);
    }
    __syncthreads();          // s is rebuilt for the next digit
  }
}

}  // namespace

extern "C" {

// y: int64 [rows, lt, 2^logn] ŷ residues. out1 / out2: int64
// [rows, nlimbs, 2^logn]. twist / tw / pn: the forward NTT tables of the
// expanded tower (as for toyfhe_ntt). cst: uint32 [dnum, nlimbs, alpha] FBC
// constants (Montgomery form, zero-padded). km / kd: uint32
// [dnum, nlimbs, 2^logn] key duals times 2^32 mod p. bounds: int32 [dnum, 2]
// ct-limb range [lo, hi) of each digit group. Returns cudaGetLastError().
int toyfhe_hybrid_ks(const void* y, void* out1, void* out2, const void* twist,
                     const void* tw, const void* pn, const void* cst,
                     const void* km, const void* kd, const void* bounds,
                     int rows, int lt, int nlimbs, int dnum, int alpha,
                     int logn, void* stream) {
  if (rows <= 0) return 0;
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  const cudaError_t e = toyfhe::allow_smem(hybrid_ks_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  hybrid_ks_kernel<<<rows * nlimbs, toyfhe::poly_threads(n), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(y), static_cast<int64_t*>(out1),
      static_cast<int64_t*>(out2), static_cast<const uint32_t*>(twist),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(pn),
      static_cast<const uint32_t*>(cst), static_cast<const uint32_t*>(km),
      static_cast<const uint32_t*>(kd), static_cast<const int*>(bounds), lt,
      nlimbs, dnum, alpha, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
