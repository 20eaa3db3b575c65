// Forward negacyclic NTT with bit-reversed output, for Hopper (sm_90a).
//
// Replaces the TPU kernel K5, toyfhe_tpu/ops/ntt_pallas.py::
// ntt_pallas_bitrev (body _fwd_kernel): the psi-twist followed by log2 N
// Gentleman-Sande DIF stages, natural order in, bit-reversed order out:
//
//   out[l, r, i] = NTT(x[l, r])[bitrev(i)]
//
// The TPU kernel took rows_per_block rows per grid step to fill its (8, 128)
// vector tiles; here a polynomial is the unit. The stage twiddles are K1's
// packed table (the stage of half-length h at offsets [h, 2h) of one row of
// N per limb): the same powers as the reference's full-length (L, logN, N)
// tables in logN times fewer bytes.
//
// One kernel computes it: ntt_bitrev_radix_kernel, behind
// toyfhe_ntt_bitrev_radix.
//
// What bounds it on this card: not device-memory bytes (the windowed
// rotation hands it 8 polynomials of N = 2^13, half a megabyte in and as
// much out) but what one SM can do for one polynomial: N/2 log2 N butterflies
// through barriers and trips to shared memory, on a launch of far fewer
// blocks than the card has SMs. What the design does about it:
//
//  * Register-radix DIF passes (radix_stages_dif, common.cuh): a thread takes
//    8 residues whose positions differ in three consecutive stage bits and
//    runs three stages on them, so a pass is one barrier and one trip to
//    shared memory where radix-2 paid three. The host's plan
//    (ops/ntt_pallas_cuda.py::forward_plan) gives ceil((log2 N - 3) / 3)
//    passes and a last one over stage bits [0, 3).
//  * The first pass straight from device memory: natural order in means
//    coalesced in, so a thread reads two neighbouring residues as one 16-byte
//    load at each of its positions, twists them in registers, runs the top
//    stages and writes shared memory once, 8 bytes a store. No swizzle.
//  * The last pass holds 8 neighbouring bit-reversed positions a thread,
//    reduces them to canonical and stores them as int64, 16 bytes at a time.
//  * One polynomial over C blocks (C in 1, 2, 4; the host picks C so that
//    polys * C comes near the 132 SMs and a block keeps at least 2048
//    residues). In DIF the cross-block stages come first: block `rank` reads,
//    for each of its positions, the C residues N/C apart (its partners read
//    the same words through L2) and keeps output `rank` of their radix-C
//    butterfly (cross_stages, cluster_pass.cuh). After that the blocks never
//    meet again, and block `rank` ends holding the contiguous outputs
//    [rank N/C, (rank + 1) N/C) of the bit-reversed order. So the split needs
//    no cluster launch, no cluster barrier and no distributed shared memory:
//    the grid is polys * C independent blocks. It is the one kernel of the
//    port where splitting a polynomial costs nothing but the repeated reads.
//  * Lazy butterflies when every prime is below 2^30: values stay in [0, 2p)
//    (dif_butterfly<true>), the twist and every product an uncorrected REDC,
//    one conditional subtraction in the closing store. A tower with a prime
//    in [2^30, 2^31) takes the fully reduced butterflies (the kLazy flag).
//    Both end canonical and equal the plain twin bit for bit.
//  * Both layouts of a batch as they lie: limb-major [L, R, N] (the public
//    contract) and row-major [R, L, N] (what the windowed key switch holds),
//    the limb of a polynomial being poly / R or poly % L.
//
// Measured (chip_smoke.py phase 24, graph-replayed device time, NVIDIA H100
// 80GB HBM3, 700 W): the windowed rotation's 8 polynomials of N = 2^13 take
// 12.0 microseconds at C = 1, 11.0 at C = 2, 7.0 at C = 4 (the host's
// choice), against 16.0 for a one-block radix-2 kernel; 28 polynomials
// 13.0, 11.4 and 7.6 against 16.4 (K1, natural order out, takes 8.0); 128 of
// N = 2^14 29.6, 30.3 and 64.0 against 35.5, so a launch that fills the card
// stays at one block a polynomial. An empty launch takes 2.1 microseconds on this card,
// four times the bound of the rotation's shape: no kernel reaches half of
// that bound. 40 to 74 registers a thread, no spills.

#include "cluster_pass.cuh"

namespace {

using toyfhe::RowTw;
using toyfhe::canonical2;
using toyfhe::cross_stages;
using toyfhe::mul_w;
using toyfhe::radix_stages_dif;

// The load pass: twist, the cross-block stages and the stage bits [m - K, m),
// device memory to shared memory. A thread takes two neighbouring items t,
// t + 1 (t even): 16-byte loads, 8-byte stores. K = 0 only loads.
template <int K, int kLogC, bool kLazy, typename Tw>
__device__ __forceinline__ void load_pass(uint32_t* s, const int64_t* __restrict__ xin,
                                          const uint32_t* __restrict__ twistl, Tw tw, int m,
                                          int rank, uint32_t p, uint32_t ninv) {
  const int b0 = m - K;
  for (int u = threadIdx.x; u < (1 << (b0 - 1)); u += blockDim.x) {
    const int t = 2 * u;
    uint32_t r0[1 << K], r1[1 << K];
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      const int q = t + (e << b0);
      uint32_t v0[1 << kLogC], v1[1 << kLogC];
#pragma unroll
      for (int c = 0; c < (1 << kLogC); ++c) {
        const int i = q + (c << m);
        const longlong2 xv = *reinterpret_cast<const longlong2*>(xin + i);
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(twistl + i));
        v0[c] = mul_w<kLazy>(static_cast<uint32_t>(xv.x), w.x, p, ninv);
        v1[c] = mul_w<kLazy>(static_cast<uint32_t>(xv.y), w.y, p, ninv);
      }
      r0[e] = cross_stages<kLogC, kLazy>(v0, tw, q, m, rank, p, ninv);
      r1[e] = cross_stages<kLogC, kLazy>(v1, tw, q + 1, m, rank, p, ninv);
    }
    radix_stages_dif<K, kLazy>(r0, tw, t, b0, p, ninv);
    radix_stages_dif<K, kLazy>(r1, tw, t + 1, b0, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      *reinterpret_cast<uint2*>(s + t + (e << b0)) = make_uint2(r0[e], r1[e]);
    }
  }
}

// One polynomial over 2^kLogC independent blocks, block `rank` keeping
// positions [rank 2^m, (rank + 1) 2^m), m = logn - kLogC. kl: the load pass's
// stages; fplan: the further DIF passes down to stage bit 3, top pass first
// (base-4 digits ended by 0). limb_mod != 0: the batch is row-major, the limb
// of polynomial `poly` is poly % nlimbs; else limb-major, poly / rows.
template <int kLogC, bool kLazy>
__global__ void __launch_bounds__(toyfhe::kRadixThreads)
ntt_bitrev_radix_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                        const uint32_t* __restrict__ twist, const uint32_t* __restrict__ tw,
                        const uint32_t* __restrict__ pn, int nlimbs, int rows, int limb_mod,
                        int logn, int kl, int fplan) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s = smem;
  const int n = 1 << logn;
  const int m = logn - kLogC;                 // log2 of the residues a block holds
  const int rank = blockIdx.x & ((1 << kLogC) - 1);
  const int poly = blockIdx.x >> kLogC;
  const int l = limb_mod ? poly % nlimbs : poly / rows;
  const uint32_t p = pn[2 * l];
  const uint32_t ninv = pn[2 * l + 1];
  const int64_t* xin = x + static_cast<size_t>(poly) * n;
  int64_t* xout = out + static_cast<size_t>(poly) * n + (static_cast<size_t>(rank) << m);
  const uint32_t* twistl = twist + static_cast<size_t>(l) * n;
  const RowTw twf{tw + static_cast<size_t>(l) * n};

  if (kl == 3) load_pass<3, kLogC, kLazy>(s, xin, twistl, twf, m, rank, p, ninv);
  else if (kl == 2) load_pass<2, kLogC, kLazy>(s, xin, twistl, twf, m, rank, p, ninv);
  else if (kl == 1) load_pass<1, kLogC, kLazy>(s, xin, twistl, twf, m, rank, p, ninv);
  else load_pass<0, kLogC, kLazy>(s, xin, twistl, twf, m, rank, p, ninv);
  __syncthreads();

  int b0 = m - kl;
  for (int pl = fplan; pl; pl >>= 2) {
    const int k = pl & 3;
    b0 -= k;
    if (k == 3) toyfhe::dif_pass<3, kLazy>(s, twf, m, b0, p, ninv);
    else if (k == 2) toyfhe::dif_pass<2, kLazy>(s, twf, m, b0, p, ninv);
    else toyfhe::dif_pass<1, kLazy>(s, twf, m, b0, p, ninv);
    __syncthreads();
  }

  // last pass, stage bits [0, 3): 8 neighbouring positions a thread, reduced
  // to canonical and stored as four 16-byte words
  for (int ti = threadIdx.x; ti < (1 << (m - 3)); ti += blockDim.x) {
    uint32_t v[8];
    toyfhe::load8(s + 8 * ti, v);
    radix_stages_dif<3, kLazy>(v, twf, 0, 0, p, ninv);
    longlong2* o = reinterpret_cast<longlong2*>(xout + 8 * ti);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = make_longlong2(static_cast<long long>(canonical2<kLazy>(v[2 * e], p)),
                            static_cast<long long>(canonical2<kLazy>(v[2 * e + 1], p)));
    }
  }
}

using RadixKernel = void (*)(const int64_t*, int64_t*, const uint32_t*, const uint32_t*,
                             const uint32_t*, int, int, int, int, int, int);

RadixKernel radix_kernel(int logc, int lazy) {
  if (logc == 0) return lazy ? ntt_bitrev_radix_kernel<0, true> : ntt_bitrev_radix_kernel<0, false>;
  if (logc == 1) return lazy ? ntt_bitrev_radix_kernel<1, true> : ntt_bitrev_radix_kernel<1, false>;
  if (logc == 2) return lazy ? ntt_bitrev_radix_kernel<2, true> : ntt_bitrev_radix_kernel<2, false>;
  return nullptr;
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

extern "C" {

// x / out: int64 [nlimbs, rows, 2^logn] residues, limb axis first, or
// [rows, nlimbs, 2^logn] when row_major != 0. twist: psi_pow uint32
// [nlimbs, 2^logn] (Montgomery form); tw: the packed forward stage twiddles;
// pn: interleaved (p, ninv) pairs. cluster: blocks per polynomial (1, 2 or 4,
// with 2^logn / cluster >= 8); lazy: every prime is below 2^30; kl, fplan: the
// DIF plan of ops/ntt_pallas_cuda.py::forward_plan for a row of
// 2^logn / cluster residues. x and out must be 16-byte aligned. Returns
// cudaGetLastError() after the launch.
int toyfhe_ntt_bitrev_radix(const void* x, void* out, const void* twist, const void* tw,
                            const void* pn, int nlimbs, int rows, int logn, int row_major,
                            int cluster, int lazy, int kl, int fplan, void* stream) {
  if (nlimbs <= 0 || rows <= 0) return 0;
  const int logc = log2_exact(cluster);
  const RadixKernel kern = radix_kernel(logc, lazy);
  if (kern == nullptr || logn < 4 || logn - logc < 3 || kl < 0 || kl > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = 1 << (logn - logc);
  const size_t smem = static_cast<size_t>(per_block) * sizeof(uint32_t);
  const cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<nlimbs * rows * cluster, toyfhe::radix_threads(per_block), smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(twist), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(pn), nlimbs, rows, row_major, logn, kl, fplan);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and static shared-memory bytes of one instantiation of
// the register-radix kernel, into attrs[0..2).
int toyfhe_ntt_bitrev_radix_attrs(int cluster, int lazy, void* attrs) {
  const RadixKernel kern = radix_kernel(log2_exact(cluster), lazy);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return toyfhe::kernel_attrs(kern, attrs);
}

}  // extern "C"
