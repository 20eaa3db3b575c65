// Negacyclic NTT / INTT over RNS towers, natural order in and out, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel K1, toyfhe_tpu/ops/ntt_mxu_pallas.py::_mxu_nat
// (bodies _fwd_kernel_nat and _inv_kernel_nat). That kernel runs a four-step
// transform as int8 digit matmuls on the MXU only because the TPU VPU has no
// 32x32->64 multiply. Hopper has one, so this file is the Cooley-Tukey
// transform with native 64-bit products, computing the same values:
//
//   forward:  x_i * psi^i (Montgomery twist), bit-reverse, log2 N DIT stages
//             with the per-stage twiddles omega^(j N / len)
//   inverse:  bit-reverse, DIT stages with the inverse twiddles, then the
//             n^-1 psi^-i untwist
//
// One kernel computes it: ntt_cluster_kernel, behind toyfhe_ntt_cluster.
//
// What bounds it on this card: neither device-memory bytes nor the card's
// arithmetic, but what one SM can do for one polynomial. The launches of the
// serving path carry 8 to 200 polynomials of N = 2^12..2^13, one or two
// megabytes that the card moves in about a microsecond. With one block a
// polynomial most SMs have no block, and the one that has runs N/2 log2 N
// butterflies of about 14 operations each (3 microseconds of that SM's
// arithmetic at N = 2^13) through a chain of barriers, shared-memory trips and twiddle
// loads. What the design does about it:
//
//  * One polynomial per thread-block cluster of C blocks (C in 1, 2, 4, 8,
//    launched with cudaLaunchKernelEx and the cluster-dimension attribute;
//    the host picks 1, 2 or 4 so that polys * C comes near the 132 SMs and a
//    block keeps at least 2048 residues). Block r holds the N / C positions
//    [r N/C, (r+1) N/C) of the bit-reversed sequence in its shared memory.
//    All but the top log2 C DIT stages pair positions inside one block; the
//    top stages read the other blocks' shared memory through the cluster
//    (map_shared_rank). C = 1 is the same kernel launched without the
//    attribute. Measured (chip_smoke.py phase 24, graph-replayed device time,
//    NVIDIA H100 80GB HBM3, 700 W): 28 polynomials of N = 2^13 take 13.0
//    microseconds at C = 1, 9.4 at C = 2, 8.0 at C = 4, 9.9 at C = 8, against
//    19.6 for a one-block radix-2 kernel.
//  * The stages run as radix-8 passes in registers (radix_stages in
//    common.cuh): a thread takes 8 residues whose positions differ in three
//    consecutive stage bits, runs the three stages on them and puts them
//    back, so a pass costs one barrier and one trip to shared memory where
//    radix-2 paid three. The host's plan (ops/ntt_cuda.py::schedule_plan)
//    gives ceil(log2 N / 3) passes: in-place passes over the block's own
//    residues, then one closing pass that takes the top kf <= 3 stages, the
//    cross-block ones among them, straight from shared memory (its own and
//    the cluster's) to device memory. N = 2^13: 6 barriers where a radix-2
//    kernel has 14.
//  * Lazy butterflies (dit_butterfly<true>) when every prime is below 2^30:
//    values stay in [0, 4p) between stages, a butterfly is one uncorrected
//    REDC, one conditional subtraction, an add and a subtract, and the only
//    full reduction is in the closing store. A tower with a prime in
//    [2^30, 2^31) takes the fully reduced butterflies (the kLazy flag of the
//    same kernel, set by the host from the primes). Both end canonical in
//    [0, p), so both equal the radix-2 oracle bit for bit.
//  * Twiddles: a radix-8 item needs 7 where radix-2 loaded 12. The first 512
//    words of the limb's packed row (every stage of half-length below 256,
//    that is the first two or three passes) are copied to shared memory once
//    a block; the later passes read the row through the read-only cache,
//    neighbouring threads on neighbouring words. A block does not walk over
//    the rows of its limb: with one block or cluster a polynomial the rows of
//    a limb run at the same time on neighbouring SMs and share the row in L2,
//    and a walk would take blocks away from a launch that has too few.
//  * Memory traffic. The store is 16 bytes a thread (two int64 residues of
//    neighbouring positions), neighbouring threads on neighbouring addresses,
//    with the inverse's untwist fused in. The load is the bit reversal: block
//    r needs the residues i = C v + bitrev(r), which it reads as 16 bytes a
//    thread when C = 1 and as 8-byte words C apart otherwise (the blocks of
//    the cluster run together and use every sector between them; an exchange
//    through distributed shared memory would cost one more cluster barrier
//    than it saves). Each goes, twisted when forward, to shared-memory word
//    swizzle(bitrev(v)): neighbouring threads differ in the top position
//    bits, which would all fall into one bank, so five of those bits are
//    XORed into the bank bits and a warp's 32 stores hit 32 banks. Every
//    pass addresses through the same swizzle.
//
// Residues arrive and leave as int64 (the port's residue dtype); twiddles are
// uint32 Montgomery-form tables, one row of N per limb, with the stage of
// half-length h stored at offsets [h, 2h).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using toyfhe::bitrev;
using toyfhe::mont_mul;
using toyfhe::radix_stages;
using toyfhe::redc_lazy;

constexpr int kTwShared = 512;      // packed twiddle words copied to shared memory
constexpr int kSwizzleMinLog = 10;  // smaller blocks store unswizzled
constexpr int kMaxThreads = 512;

// a * w in the working range: below 2p when lazy, canonical otherwise.
template <bool kLazy>
__device__ __forceinline__ uint32_t mul_w(uint32_t a, uint32_t w, uint32_t p, uint32_t ninv) {
  return kLazy ? redc_lazy(a, w, p, ninv) : mont_mul(a, w, p, ninv);
}

// One in-place radix-2^K pass over the block's own residues: stage bits
// [b0, b0 + K).
template <int K, bool kLazy, typename Sw, typename Tw>
__device__ __forceinline__ void local_pass(uint32_t* s, Sw sw, Tw tw, int m, int b0,
                                           uint32_t p, uint32_t ninv) {
  for (int t = threadIdx.x; t < (1 << (m - K)); t += blockDim.x) {
    const int low = t & ((1 << b0) - 1);
    const int pos0 = low + ((t >> b0) << (b0 + K));
    uint32_t r[1 << K];
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) r[e] = s[sw(pos0 + (e << b0))];
    radix_stages<K, kLazy>(r, tw, low, b0, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) s[sw(pos0 + (e << b0))] = r[e];
  }
}

// One cluster of 2^logc blocks per polynomial; plan holds the stage bits of
// the local passes as base-4 digits, first pass lowest; the closing pass
// takes the top KF stages.
template <int KF, bool kInverse, bool kLazy>
__global__ void __launch_bounds__(kMaxThreads)
ntt_cluster_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ twist, const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ pn, int nlimbs, int logn, int logc,
                   int plan) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int m = logn - logc;                  // log2 of the residues a block holds
  const int per_block = 1 << m;
  const int nblocks = 1 << logc;
  const int rank = blockIdx.x & (nblocks - 1);
  const int poly = blockIdx.x >> logc;
  const int l = poly % nlimbs;
  const uint32_t p = pn[2 * l];
  const uint32_t ninv = pn[2 * l + 1];
  const int64_t* xin = x + static_cast<size_t>(poly) * n;
  int64_t* xout = out + static_cast<size_t>(poly) * n;
  const uint32_t* twl = tw + static_cast<size_t>(l) * n;
  const uint32_t* twistl = twist + static_cast<size_t>(l) * n;
  uint32_t* s = smem;
  uint32_t* stw = smem + per_block;

  const int shift = m < kSwizzleMinLog ? 31 : (m - 6 > 5 ? m - 6 : 5);
  auto sw = [shift](int q) { return q ^ ((q >> shift) & 31); };
  auto twf = [stw, twl](int i) { return i < kTwShared ? stw[i] : __ldg(twl + i); };

  for (int i = threadIdx.x; i < kTwShared && i < n; i += blockDim.x) stw[i] = twl[i];

  // load: residue i = C v + bitrev(rank) goes to position bitrev(v)
  {
    const int c = logc ? bitrev(rank, logc) : 0;
    for (int u = threadIdx.x; u < per_block / 2; u += blockDim.x) {
      const int v = 2 * u;
      const int i0 = (v << logc) + c;
      const int i1 = i0 + nblocks;
      uint32_t a0, a1;
      if (logc == 0) {
        const longlong2 t = *reinterpret_cast<const longlong2*>(xin + v);
        a0 = static_cast<uint32_t>(t.x);
        a1 = static_cast<uint32_t>(t.y);
      } else {
        a0 = static_cast<uint32_t>(xin[i0]);
        a1 = static_cast<uint32_t>(xin[i1]);
      }
      if (!kInverse) {
        a0 = mul_w<kLazy>(a0, __ldg(twistl + i0), p, ninv);
        a1 = mul_w<kLazy>(a1, __ldg(twistl + i1), p, ninv);
      }
      const int q0 = bitrev(v, m);            // v even: bitrev(v + 1) = q0 + 2^(m-1)
      s[sw(q0)] = a0;
      s[sw(q0 + per_block / 2)] = a1;
    }
  }
  __syncthreads();

  int b0 = 0;
  for (int pl = plan; pl; pl >>= 2) {
    const int k = pl & 3;
    if (k == 3) local_pass<3, kLazy>(s, sw, twf, m, b0, p, ninv);
    else if (k == 2) local_pass<2, kLazy>(s, sw, twf, m, b0, p, ninv);
    else local_pass<1, kLazy>(s, sw, twf, m, b0, p, ninv);
    b0 += k;
    if (logc && (pl >> 2) == 0) cluster.sync();   // the closing pass reads the cluster
    else __syncthreads();
  }

  // closing pass: stage bits [bf, logn). A thread takes two neighbouring
  // bases b, b + 1 (b even): element e of base b is position b + e 2^bf, held
  // by block (b + e 2^bf) >> m, and leaves for out[b + e 2^bf].
  {
    const int bf = logn - KF;
    const int npairs = 1 << (bf - 1);
    const int per = (npairs + nblocks - 1) >> logc;     // pairs a block stores
    const int emask = (1 << (m - bf)) - 1;
    for (int it = threadIdx.x; it < per; it += blockDim.x) {
      const int pair = rank * per + it;
      if (pair >= npairs) break;
      const int b = 2 * pair;
      uint32_t r0[1 << KF], r1[1 << KF];
#pragma unroll
      for (int e = 0; e < (1 << KF); ++e) {
        const uint32_t* src = logc ? cluster.map_shared_rank(s, e >> (m - bf)) : s;
        const int a = sw(b + ((e & emask) << bf));
        r0[e] = src[a];
        r1[e] = src[a ^ 1];
      }
      radix_stages<KF, kLazy>(r0, twf, b, bf, p, ninv);
      radix_stages<KF, kLazy>(r1, twf, b + 1, bf, p, ninv);
#pragma unroll
      for (int e = 0; e < (1 << KF); ++e) {
        const int k = b + (e << bf);
        uint32_t v0 = r0[e], v1 = r1[e];
        if (kInverse) {
          const uint2 t = __ldg(reinterpret_cast<const uint2*>(twistl + k));
          v0 = mul_w<kLazy>(v0, t.x, p, ninv);
          v1 = mul_w<kLazy>(v1, t.y, p, ninv);
        } else if (kLazy) {
          v0 = v0 >= 2 * p ? v0 - 2 * p : v0;
          v1 = v1 >= 2 * p ? v1 - 2 * p : v1;
        }
        if (kLazy) {
          v0 = v0 >= p ? v0 - p : v0;
          v1 = v1 >= p ? v1 - p : v1;
        }
        *reinterpret_cast<longlong2*>(xout + k) =
            make_longlong2(static_cast<long long>(v0), static_cast<long long>(v1));
      }
    }
  }
  if (logc) cluster.sync();     // no block leaves while its shared memory is read
}

using ClusterKernel = void (*)(const int64_t*, int64_t*, const uint32_t*, const uint32_t*,
                               const uint32_t*, int, int, int, int);

template <int KF>
ClusterKernel pick(int inverse, int lazy) {
  if (inverse) return lazy ? ntt_cluster_kernel<KF, true, true> : ntt_cluster_kernel<KF, true, false>;
  return lazy ? ntt_cluster_kernel<KF, false, true> : ntt_cluster_kernel<KF, false, false>;
}

ClusterKernel cluster_kernel(int kf, int inverse, int lazy) {
  if (kf == 1) return pick<1>(inverse, lazy);
  if (kf == 2) return pick<2>(inverse, lazy);
  if (kf == 3) return pick<3>(inverse, lazy);
  return nullptr;
}

}  // namespace

extern "C" {

// Transforms `polys` contiguous polynomials of 2^logn int64 residues; limb of
// polynomial r is r % nlimbs. twist is psi_pow (forward) or psi_ipow
// (inverse), tw the packed stage twiddles of that direction, pn the
// interleaved (p, ninv) pairs. cluster: blocks per polynomial (1, 2, 4 or 8,
// with 2^logn / cluster >= 8); lazy: every prime is below 2^30; plan and kf:
// the pass plan of ops/ntt_cuda.py::schedule_plan. x and out must be 16-byte
// aligned. Returns cudaGetLastError() after the launch.
int toyfhe_ntt_cluster(const void* x, void* out, const void* twist, const void* tw,
                       const void* pn, int polys, int nlimbs, int logn, int inverse,
                       int cluster, int lazy, int plan, int kf, void* stream) {
  if (polys <= 0) return 0;
  int logc = 0;
  while ((1 << logc) < cluster) ++logc;
  const ClusterKernel kern = cluster_kernel(kf, inverse, lazy);
  if (kern == nullptr || (1 << logc) != cluster || logc > 3 || logn - logc < 3 ||
      kf < logc || kf >= logn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = 1 << (logn - logc);
  int threads = per_block / 8;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t smem = static_cast<size_t>(per_block + kTwShared) * sizeof(uint32_t);
  cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(polys) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;    // a cluster of one is a plain launch
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const int64_t*>(x),
                         static_cast<int64_t*>(out), static_cast<const uint32_t*>(twist),
                         static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(pn),
                         nlimbs, logn, logc, plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and static shared-memory bytes of one instantiation of
// the cluster kernel, into attrs[0..2).
int toyfhe_ntt_cluster_attrs(int kf, int inverse, int lazy, void* attrs) {
  const ClusterKernel kern = cluster_kernel(kf, inverse, lazy);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return static_cast<int>(e);
  int* o = static_cast<int*>(attrs);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}

}  // extern "C"
