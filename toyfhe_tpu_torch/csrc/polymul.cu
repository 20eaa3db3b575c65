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
// once. The twiddles are K1's packed tables (the stage of half-length h at
// offsets [h, 2h) of one row of N per limb), forward and inverse. Operands
// are limb-major, [L, R, N], as they lie.
//
// One kernel computes it: polymul_cluster_kernel, behind
// toyfhe_polymul_cluster.
//
// What bounds it on this card: not device-memory bytes (three rows a
// polynomial, microseconds for a whole batch) but what one SM can do for one
// polynomial: 3 log2 N stages of N/2 butterflies through barriers and trips
// to shared memory, with about one wave of blocks a batch. What the design
// does about it:
//
//  * Register-radix passes (radix_stages_dif2 / radix_stages, common.cuh):
//    a thread takes 8 residues whose positions differ in three consecutive
//    stage bits and runs three stages on them, so a pass is one barrier and
//    one trip to shared memory where radix-2 paid three. The host's plan
//    (ops/ntt_pallas_cuda.py::polymul_plan) gives ceil((log2 N - 3) / 3)
//    passes on either side of a fused middle: N = 2^14 runs 8 barriers where
//    a one-block radix-2 kernel has 45.
//  * Both operands in one pass: a thread holds the residues of a and of b at
//    the same positions, so each twiddle is loaded once for two butterflies
//    and the two dependency chains interleave.
//  * No bit-reversal scatter: DIF takes natural order, so the first pass
//    reads its residues 2^(m-K) apart straight from device memory,
//    neighbouring threads on neighbouring words, twists them in registers
//    and writes shared memory once. The twiddles come through the read-only
//    cache (a copy of the low stages in shared memory, as K1 keeps one, made
//    this kernel slower).
//  * The middle needs no shared memory: the last DIF pass and the first DIT
//    pass both cover stage bits [0, 3), so a thread runs the last three DIF
//    stages of a and b, the product and the first three DIT stages on the
//    same registers, with no barrier and no store between. After the product
//    only one row lives on.
//  * One polynomial pair per thread-block cluster of C blocks (C in 1, 2, 4;
//    the host picks C so that polys * C comes near the 132 SMs). Forward,
//    block r needs positions [r N/C, (r+1) N/C) after the top log2 C stages:
//    for each it reads the C residues N/C apart from device memory (its
//    partners read the same words through L2) and keeps output r of their
//    radix-C butterfly, C - 1 half butterflies. Backward, all but the top
//    log2 C stages are local and the closing pass (cluster_pass.cuh) takes
//    the top stages through the partners' shared memory (map_shared_rank),
//    with the untwist fused into 16-byte stores: one cluster.sync() before
//    it and one at the exit. A block holds 2 N / C words until the product,
//    so N = 2^15 fits with C >= 2 and needs no detour through device memory.
//    Measured (chip_smoke.py phase 24, graph-replayed device time, NVIDIA
//    H100 80GB HBM3, 700 W): 128 pairs of N = 2^14 take 54 microseconds at
//    C = 1, 52 at C = 2, 122 at C = 4, against 108 for a one-block radix-2
//    kernel; 28 pairs of N = 2^13 take 23, 15 and 13 against 44. A radix-8 pass compiles
//    to about 15 machine operations a butterfly, 3 of them the multiplies of
//    the uncorrected REDC, so 128 pairs of N = 2^14 on 128 SMs fill 26
//    microseconds of issue slots: the kernel runs at half of that rate, and
//    1024 threads a block changed nothing (55 for 56).
//  * Lazy butterflies when every prime is below 2^30: [0, 2p) forward, the
//    product's operands below 2p, [0, 4p) backward, one full reduction in
//    the closing store. A tower with a prime in [2^30, 2^31) takes the fully
//    reduced butterflies (the kLazy flag). Both end canonical and equal the
//    plain twin bit for bit.

#include "cluster_pass.cuh"

namespace {

using toyfhe::RowTw;
using toyfhe::closing;
using toyfhe::dit_passes;
using toyfhe::mul_w;
using toyfhe::radix_stages;
using toyfhe::radix_stages_dif2;
namespace cg = cooperative_groups;

// Position q of block `rank` after the psi-twist and the top kLogC DIF
// stages: the residues q + e 2^m, e < 2^kLogC, of one operand, twisted, and
// output `rank` of their radix-2^kLogC butterfly (cross_stages,
// cluster_pass.cuh).
template <int kLogC, bool kLazy, typename Tw>
__device__ __forceinline__ uint32_t cross_load(const int64_t* __restrict__ xin,
                                               const uint32_t* __restrict__ twistl, Tw tw,
                                               int q, int m, int rank, uint32_t p,
                                               uint32_t ninv) {
  uint32_t v[1 << kLogC];
#pragma unroll
  for (int e = 0; e < (1 << kLogC); ++e) {
    const int i = q + (e << m);
    v[e] = mul_w<kLazy>(static_cast<uint32_t>(xin[i]), __ldg(twistl + i), p, ninv);
  }
  return toyfhe::cross_stages<kLogC, kLazy>(v, tw, q, m, rank, p, ninv);
}

// The load pass: twist, cross stages and the stage bits [m - K, m) of both
// operands, device memory to shared memory. K = 0 only loads.
template <int K, int kLogC, bool kLazy, typename Tw>
__device__ __forceinline__ void load_pass(uint32_t* sa, uint32_t* sb,
                                          const int64_t* __restrict__ a,
                                          const int64_t* __restrict__ b,
                                          const uint32_t* __restrict__ twistl, Tw tw, int m,
                                          int rank, uint32_t p, uint32_t ninv) {
  const int b0 = m - K;
  for (int t = threadIdx.x; t < (1 << b0); t += blockDim.x) {
    uint32_t ra[1 << K], rb[1 << K];
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      const int q = t + (e << b0);
      ra[e] = cross_load<kLogC, kLazy>(a, twistl, tw, q, m, rank, p, ninv);
      rb[e] = cross_load<kLogC, kLazy>(b, twistl, tw, q, m, rank, p, ninv);
    }
    radix_stages_dif2<K, kLazy>(ra, rb, tw, t, b0, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      sa[t + (e << b0)] = ra[e];
      sb[t + (e << b0)] = rb[e];
    }
  }
}

// One in-place radix-2^K DIF pass over both rows: stage bits [b0, b0 + K).
template <int K, bool kLazy, typename Tw>
__device__ __forceinline__ void dif_pass2(uint32_t* sa, uint32_t* sb, Tw tw, int m, int b0,
                                          uint32_t p, uint32_t ninv) {
  for (int t = threadIdx.x; t < (1 << (m - K)); t += blockDim.x) {
    const int low = t & ((1 << b0) - 1);
    const int pos0 = low + ((t >> b0) << (b0 + K));
    uint32_t ra[1 << K], rb[1 << K];
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      ra[e] = sa[pos0 + (e << b0)];
      rb[e] = sb[pos0 + (e << b0)];
    }
    radix_stages_dif2<K, kLazy>(ra, rb, tw, low, b0, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      sa[pos0 + (e << b0)] = ra[e];
      sb[pos0 + (e << b0)] = rb[e];
    }
  }
}

// The fused middle over stage bits [0, 3): the last DIF stages of both rows,
// the product, and the first DIT stages, 8 neighbouring positions a thread.
template <bool kLazy, typename Tw>
__device__ __forceinline__ void middle_pass(uint32_t* sa, const uint32_t* sb, Tw tw, Tw itw,
                                            int m, uint32_t r2, uint32_t p, uint32_t ninv) {
  for (int t = threadIdx.x; t < (1 << (m - 3)); t += blockDim.x) {
    uint32_t ra[8], rb[8];
    toyfhe::load8(sa + 8 * t, ra);
    toyfhe::load8(sb + 8 * t, rb);
    radix_stages_dif2<3, kLazy>(ra, rb, tw, 0, 0, p, ninv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ra[e] = mul_w<kLazy>(mul_w<kLazy>(ra[e], r2, p, ninv), rb[e], p, ninv);
    }
    radix_stages<3, kLazy>(ra, itw, 0, 0, p, ninv);
    toyfhe::store8(sa + 8 * t, ra);
  }
}

// One cluster of 2^kLogC blocks per polynomial pair. kl: the load pass's
// stages; fplan: the further DIF passes down to stage bit 3, top pass first;
// bplan: the DIT passes from stage bit 3 up, lowest first (both base-4
// digits ended by 0); kf: the closing pass's stages.
template <int kLogC, bool kLazy>
__global__ void __launch_bounds__(toyfhe::kRadixThreads)
polymul_cluster_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                       int64_t* __restrict__ out, const uint32_t* __restrict__ twist,
                       const uint32_t* __restrict__ tw, const uint32_t* __restrict__ itwist,
                       const uint32_t* __restrict__ itw, const uint32_t* __restrict__ pn,
                       const uint32_t* __restrict__ r2, int rows, int logn, int kl, int fplan,
                       int bplan, int kf) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int m = logn - kLogC;                 // log2 of the residues a block holds
  const int rank = blockIdx.x & ((1 << kLogC) - 1);
  const int poly = blockIdx.x >> kLogC;       // limb-major: poly = l * rows + r
  const int l = poly / rows;
  const uint32_t p = pn[2 * l];
  const uint32_t ninv = pn[2 * l + 1];
  const size_t row = static_cast<size_t>(poly) * n;
  const size_t lrow = static_cast<size_t>(l) * n;
  uint32_t* sa = smem;
  uint32_t* sb = smem + (1 << m);
  const RowTw twf{tw + lrow};
  const RowTw itwf{itw + lrow};

  const int64_t* ar = a + row;
  const int64_t* br = b + row;
  const uint32_t* twistl = twist + lrow;
  if (kl == 3) load_pass<3, kLogC, kLazy>(sa, sb, ar, br, twistl, twf, m, rank, p, ninv);
  else if (kl == 2) load_pass<2, kLogC, kLazy>(sa, sb, ar, br, twistl, twf, m, rank, p, ninv);
  else if (kl == 1) load_pass<1, kLogC, kLazy>(sa, sb, ar, br, twistl, twf, m, rank, p, ninv);
  else load_pass<0, kLogC, kLazy>(sa, sb, ar, br, twistl, twf, m, rank, p, ninv);
  __syncthreads();

  int b0 = m - kl;
  for (int pl = fplan; pl; pl >>= 2) {
    const int k = pl & 3;
    b0 -= k;
    if (k == 3) dif_pass2<3, kLazy>(sa, sb, twf, m, b0, p, ninv);
    else if (k == 2) dif_pass2<2, kLazy>(sa, sb, twf, m, b0, p, ninv);
    else dif_pass2<1, kLazy>(sa, sb, twf, m, b0, p, ninv);
    __syncthreads();
  }

  middle_pass<kLazy>(sa, sb, twf, itwf, m, r2[l], p, ninv);
  if (bplan) {
    __syncthreads();
    dit_passes<kLazy>(sa, itwf, m, 3, bplan, p, ninv);
  }
  if (kLogC) cluster.sync();                  // the closing pass reads the cluster
  else __syncthreads();

  closing<kLazy>(kf, cluster, sa, itwf, itwist + lrow, out + row, logn, kLogC, rank, 0, p, ninv);
  if (kLogC) cluster.sync();                  // no block leaves while its row is read
}

using ClusterKernel = void (*)(const int64_t*, const int64_t*, int64_t*, const uint32_t*,
                               const uint32_t*, const uint32_t*, const uint32_t*,
                               const uint32_t*, const uint32_t*, int, int, int, int, int, int);

ClusterKernel cluster_kernel(int logc, int lazy) {
  if (logc == 0) return lazy ? polymul_cluster_kernel<0, true> : polymul_cluster_kernel<0, false>;
  if (logc == 1) return lazy ? polymul_cluster_kernel<1, true> : polymul_cluster_kernel<1, false>;
  if (logc == 2) return lazy ? polymul_cluster_kernel<2, true> : polymul_cluster_kernel<2, false>;
  return nullptr;
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

extern "C" {

// a / b / out: int64 [nlimbs, rows, 2^logn] primal residues, limb axis
// first; out must not alias an input. twist / itwist: psi_pow / psi_ipow
// uint32 [nlimbs, 2^logn] (Montgomery form); tw / itw: the packed forward
// and inverse stage twiddles; pn: interleaved (p, ninv) pairs; r2: R^2 mod p
// per limb. cluster: blocks per polynomial pair (1, 2 or 4, with
// 2^logn / cluster >= 8); lazy: every prime is below 2^30; kl, fplan, bplan,
// kf: the pass plan of ops/ntt_pallas_cuda.py::polymul_plan. out must be
// 16-byte aligned. Returns cudaGetLastError() after the launch.
int toyfhe_polymul_cluster(const void* a, const void* b, void* out, const void* twist,
                           const void* tw, const void* itwist, const void* itw,
                           const void* pn, const void* r2, int nlimbs, int rows, int logn,
                           int cluster, int lazy, int kl, int fplan, int bplan, int kf,
                           void* stream) {
  if (nlimbs <= 0 || rows <= 0) return 0;
  const int logc = log2_exact(cluster);
  const ClusterKernel kern = cluster_kernel(logc, lazy);
  if (kern == nullptr || logn - logc < 3 || logn < 4 || kf < logc || kf < 1 || kf > 3 ||
      kl < 0 || kl > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = 1 << (logn - logc);
  const size_t smem = 2 * static_cast<size_t>(per_block) * sizeof(uint32_t);
  return static_cast<int>(toyfhe::cluster_launch(
      kern, nlimbs * rows * cluster, cluster, toyfhe::radix_threads(per_block), smem,
      static_cast<cudaStream_t>(stream), static_cast<const int64_t*>(a),
      static_cast<const int64_t*>(b), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(twist), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(itwist), static_cast<const uint32_t*>(itw),
      static_cast<const uint32_t*>(pn), static_cast<const uint32_t*>(r2), rows, logn, kl,
      fplan, bplan, kf));
}

// Registers a thread and static shared-memory bytes of one instantiation of
// the cluster kernel, into attrs[0..2).
int toyfhe_polymul_cluster_attrs(int cluster, int lazy, void* attrs) {
  const ClusterKernel kern = cluster_kernel(log2_exact(cluster), lazy);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return toyfhe::kernel_attrs(kern, attrs);
}

}  // extern "C"
