// Fused windowed special-prime key switch for Hopper (sm_90a).
//
// Replaces the TPU kernel K6, toyfhe_tpu/ops/pallas_keyswitch.py::
// FusedKeyswitch._call (body _ks_kernel). For each leading row r and each
// limb t of the expanded tower (the Lc ciphertext limbs plus the special
// prime, Le = Lc + 1) it computes
//
//   dig[d]   = (c2[r, d / kpl] >> (w * (d % kpl))) & (2^w - 1),  d < Lc*kpl
//   D[d]     = DIF_t(psi_t * dig[d])                 (bit-reversed dual)
//   acc1     = sum_d D[d] * maskeds[t, d] + c1e[r, t]
//   acc2     = sum_d D[d] * masks[t, d]
//   out1[r,t] = ipsi_t * DIT_t(acc1),  out2[r,t] = ipsi_t * DIT_t(acc2)
//
// with the key rows and c1e bit-reverse-permuted, so the products need no
// permutation, and primal natural-order outputs. The special-prime rescale
// stays with the caller.
//
// Design. The TPU kernel holds all Lc*kpl digit rows of one output limb in
// VMEM at once (28 x 8192 x 4 B = 896 KB at the MNIST width with w = 8),
// four times the 227 KB of shared memory a Hopper block can have. Here one
// block owns one (r, t) output pair and loops over the digits as K3 does:
// one digit row in shared memory (32 KB at N = 2^13) is built, twisted,
// run through the DIF stages (dif_stages, common.cuh, shared with K5),
// converted to Montgomery form with r2 (as the TPU kernel does) and
// multiplied into the block's two accumulator rows. Up to N = 2^14 the
// accumulators live in shared memory beside the digit row (3 rows: 96 KB at
// 2^13, 192 KB at 2^14); above that they live in a global scratch area the
// wrapper allocates, two rows per block, owned by the block. The TPU kernel
// tree-summed over the digit axis; since every sum is reduced mod p the
// running sum here gives the same canonical value. Each block owns its
// output rows, so no atomics are needed, and the digit tensor never exists
// in device memory.
//
// Digits are below 2^w < p, so they need no reduction before the twist,
// and every Montgomery product has both operands below p, so stays under
// p * 2^32.
//
// What bounds it on this card: at the MNIST data width (Le = 8 output limbs
// per row, 28 digits of N = 2^13) the grid has Le blocks per leading row,
// far fewer than the 132 SMs, and each block runs 28 DIF transforms of 13
// barrier-separated stages one after another: latency, not device-memory
// bytes (the key rows it reads, 2 x 28 x 32 KB per block, stream once).

#include "common.cuh"

namespace {

using toyfhe::add_mod;
using toyfhe::mont_mul;

template <bool kSmemAcc>
__global__ void keyswitch_kernel(const int64_t* __restrict__ c2,
                                 const int64_t* __restrict__ c1e,
                                 int64_t* __restrict__ out1,
                                 int64_t* __restrict__ out2,
                                 const uint32_t* __restrict__ psi,
                                 const uint32_t* __restrict__ fwd_tw,
                                 const uint32_t* __restrict__ ipsi,
                                 const uint32_t* __restrict__ inv_tw,
                                 const uint32_t* __restrict__ pnr,
                                 const uint32_t* __restrict__ masks,
                                 const uint32_t* __restrict__ maskeds,
                                 uint32_t* __restrict__ scratch,
                                 int lc, int window, int kpl, int logn) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << logn;
  const int le = lc + 1;
  const int t = blockIdx.x % le;              // output limb of the expanded tower
  const int r = blockIdx.x / le;              // leading row
  const uint32_t p = pnr[3 * t];
  const uint32_t ninv = pnr[3 * t + 1];
  const uint32_t r2 = pnr[3 * t + 2];
  const int ndig = lc * kpl;
  const uint32_t mask = (1u << window) - 1u;

  uint32_t* s = smem;                         // the digit row, then the DIT input
  uint32_t* a1;
  uint32_t* a2;
  if (kSmemAcc) {
    a1 = smem + n;
    a2 = smem + 2 * n;
  } else {
    a1 = scratch + static_cast<size_t>(blockIdx.x) * 2 * n;
    a2 = a1 + n;
  }
  const int64_t* c2r = c2 + static_cast<size_t>(r) * lc * n;
  const size_t limb = static_cast<size_t>(t) * n;
  const size_t row = (static_cast<size_t>(r) * le + t) * n;

  for (int d = 0; d < ndig; ++d) {
    const int64_t* src = c2r + static_cast<size_t>(d / kpl) * n;
    const int shift = window * (d % kpl);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t dig = (static_cast<uint32_t>(src[i]) >> shift) & mask;
      s[i] = mont_mul(dig, psi[limb + i], p, ninv);
    }
    __syncthreads();

    toyfhe::dif_stages(s, fwd_tw + limb, n, p, ninv);

    // key products, accumulated into this block's own rows: the thread that
    // adds to element i is the one that wrote it for digit d - 1
    const size_t krow = (static_cast<size_t>(t) * ndig + d) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t v = mont_mul(s[i], r2, p, ninv);      // Montgomery form
      uint32_t x1 = mont_mul(v, maskeds[krow + i], p, ninv);
      uint32_t x2 = mont_mul(v, masks[krow + i], p, ninv);
      if (d > 0) {
        x1 = add_mod(x1, a1[i], p);
        x2 = add_mod(x2, a2[i], p);
      }
      a1[i] = x1;
      a2[i] = x2;
    }
    __syncthreads();          // s is rebuilt for the next digit
  }

  // acc1 + c1e, then the inverse transforms of both rows (bit-reversed in,
  // natural out) and the n^-1 psi^-i untwist
  const int64_t* c1r = c1e + row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = add_mod(a1[i], static_cast<uint32_t>(c1r[i]), p);
  }
  __syncthreads();
  toyfhe::dit_stages(s, inv_tw + limb, n, p, ninv);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out1[row + i] = static_cast<int64_t>(mont_mul(s[i], ipsi[limb + i], p, ninv));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = a2[i];
  __syncthreads();
  toyfhe::dit_stages(s, inv_tw + limb, n, p, ninv);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out2[row + i] = static_cast<int64_t>(mont_mul(s[i], ipsi[limb + i], p, ninv));
  }
}

// Largest N whose digit row and two accumulator rows fit a block's shared
// memory (3 x 2^14 x 4 B = 192 KB of the 227 KB).
constexpr int kMaxSmemAccLogN = 14;

}  // namespace

extern "C" {

// Bytes of global scratch toyfhe_keyswitch needs for `rows` leading rows
// (0 when the accumulators fit shared memory).
long long toyfhe_keyswitch_scratch_bytes(int rows, int lc, int logn) {
  if (logn <= kMaxSmemAccLogN) return 0;
  return static_cast<long long>(rows) * (lc + 1) * 2 * (1LL << logn) *
         static_cast<long long>(sizeof(uint32_t));
}

// c2: int64 [rows, lc, 2^logn] primal. c1e: int64 [rows, lc + 1, 2^logn]
// bit-reversed dual. out1 / out2: int64 [rows, lc + 1, 2^logn] primal.
// psi / fwd_tw: the forward twist and packed stage twiddles of the expanded
// tower; ipsi / inv_tw: the inverse ones. pnr: uint32 [lc + 1, 3] rows of
// (p, ninv, r2). masks / maskeds: uint32 [lc + 1, lc * kpl, 2^logn]
// bit-reversed key duals, limb-major. scratch: uint32, of the size
// toyfhe_keyswitch_scratch_bytes gives (may be null when that is 0).
// Returns cudaGetLastError() after the launch.
int toyfhe_keyswitch(const void* c2, const void* c1e, void* out1, void* out2,
                     const void* psi, const void* fwd_tw, const void* ipsi,
                     const void* inv_tw, const void* pnr, const void* masks,
                     const void* maskeds, void* scratch, int rows, int lc,
                     int window, int kpl, int logn, void* stream) {
  if (rows <= 0) return 0;
  if (window <= 0 || window >= 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n = 1 << logn;
  const bool smem_acc = logn <= kMaxSmemAccLogN;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t) * (smem_acc ? 3 : 1);
  void (*kern)(const int64_t*, const int64_t*, int64_t*, int64_t*,
               const uint32_t*, const uint32_t*, const uint32_t*,
               const uint32_t*, const uint32_t*, const uint32_t*,
               const uint32_t*, uint32_t*, int, int, int, int) =
      smem_acc ? keyswitch_kernel<true> : keyswitch_kernel<false>;
  const cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<rows * (lc + 1), toyfhe::poly_threads(n), smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c2), static_cast<const int64_t*>(c1e),
      static_cast<int64_t*>(out1), static_cast<int64_t*>(out2),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(fwd_tw),
      static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(inv_tw),
      static_cast<const uint32_t*>(pnr), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(maskeds), static_cast<uint32_t*>(scratch),
      lc, window, kpl, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
