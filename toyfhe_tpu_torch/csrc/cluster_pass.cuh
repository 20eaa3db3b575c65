// Passes shared by the kernels that run register-radix transforms over a row
// in shared memory (K3, csrc/hybrid_ks.cu; K4, csrc/polymul.cu; K5,
// csrc/ntt_bitrev.cu; K6, csrc/keyswitch.cu): the in-place DIF and DIT
// passes, the twiddle lookup, the cross-block DIF stages of a polynomial that
// is split over several blocks, the closing DIT pass of one that is split over
// the blocks of a thread-block cluster, and the cluster launch. Position q of
// a row lives at word q, or at XorSwizzle's word where the row is filled by a
// bit-reversed scatter (K3). A thread that holds 8 neighbouring words moves
// them as two 16-byte accesses (load8 / store8); a row padded by one word in
// 32, conflict-free for word accesses, ran no faster and at N = 2^14 slower.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace toyfhe {

namespace cg = cooperative_groups;

constexpr int kRadixThreads = 512;   // most threads a register-radix block runs

// Threads of a block that runs radix-8 items over n residues.
inline int radix_threads(int n) {
  const int t = n / 8;
  return t < 32 ? 32 : (t > kRadixThreads ? kRadixThreads : t);
}

// a * w in the working range: below 2p when lazy, canonical otherwise.
template <bool kLazy>
__device__ __forceinline__ uint32_t mul_w(uint32_t a, uint32_t w, uint32_t p, uint32_t ninv) {
  return kLazy ? redc_lazy(a, w, p, ninv) : mont_mul(a, w, p, ninv);
}

// a + b in the working range: below 2p when lazy, canonical otherwise.
template <bool kLazy>
__device__ __forceinline__ uint32_t add_w(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return min(s, s - (kLazy ? 2 * p : p));       // s - lim wraps above s when s < lim
}

// [0, 2p) -> [0, p) when lazy; canonical values pass.
template <bool kLazy>
__device__ __forceinline__ uint32_t canonical2(uint32_t v, uint32_t p) {
  return kLazy && v >= p ? v - p : v;
}

// 8 neighbouring words, 32-byte aligned, as two 16-byte accesses: a warp on
// 256 neighbouring words then has 2-way bank conflicts where word accesses
// would have 8-way ones.
__device__ __forceinline__ void load8(const uint32_t* src, uint32_t (&r)[8]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(src);
  const uint4 hi = *reinterpret_cast<const uint4*>(src + 4);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void store8(uint32_t* dst, const uint32_t (&r)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<uint4*>(dst + 4) = make_uint4(r[4], r[5], r[6], r[7]);
}

// A limb's packed twiddle row, read through the read-only cache. (A copy of
// its first 512 words in shared memory, as K1 keeps one, made these kernels
// slower: 19.4 microseconds for 13.8 at 28 products of N = 2^13.)
struct RowTw {
  const uint32_t* twl;
  __device__ __forceinline__ uint32_t operator()(int i) const { return __ldg(twl + i); }
};

// Word of a row that position q lives at. Rows that are filled in natural
// order keep position q at word q.
struct NoSwizzle {
  __device__ __forceinline__ int operator()(int q) const { return q; }
};

// Rows that are filled by a bit-reversed scatter: neighbouring threads differ
// in the top position bits, which would all fall into one bank, so five of
// those bits (m-6 .. m-2 of a row of 2^m words) are XORed into the bank bits
// and a warp's 32 stores hit 32 banks. Rows below 2^10 words stay unswizzled.
struct XorSwizzle {
  int shift;
  __device__ __forceinline__ explicit XorSwizzle(int m)
      : shift(m < 10 ? 31 : (m - 6 > 5 ? m - 6 : 5)) {}
  __device__ __forceinline__ int operator()(int q) const { return q ^ ((q >> shift) & 31); }
};

// The top kLogC DIF stages of a polynomial that is split over 2^kLogC blocks,
// for position q of block `rank` (which keeps positions [rank 2^m,
// (rank + 1) 2^m) from there on): v holds the twisted residues q + e 2^m,
// e < 2^kLogC, and output `rank` of their radix-2^kLogC butterfly comes back.
// The stage of half-length h = 2^(m+s) pairs (e, e + 2^s) with the twiddle
// tw(h + q + e 2^m), e < 2^s, and bit s of rank says which half of the pair
// lives on: 2^kLogC - 1 half butterflies.
template <int kLogC, bool kLazy, typename Tw>
__device__ __forceinline__ uint32_t cross_stages(uint32_t (&v)[1 << kLogC], Tw tw, int q, int m,
                                                 int rank, uint32_t p, uint32_t ninv) {
#pragma unroll
  for (int s = kLogC - 1; s >= 0; --s) {
    const bool odd = (rank >> s) & 1;
#pragma unroll
    for (int e = 0; e < (1 << s); ++e) {
      const uint32_t x = v[e], y = v[e + (1 << s)];
      if (odd) {
        const uint32_t w = tw((1 << (m + s)) + q + (e << m));
        v[e] = kLazy ? redc_lazy(x + 2 * p - y, w, p, ninv)
                     : mont_mul(x >= y ? x - y : x + (p - y), w, p, ninv);
      } else {
        v[e] = add_w<kLazy>(x, y, p);
      }
    }
  }
  return v[0];
}

// One in-place radix-2^K DIF pass over the 2^m residues of s: stage bits
// [b0, b0 + K).
template <int K, bool kLazy, typename Tw>
__device__ __forceinline__ void dif_pass(uint32_t* s, Tw tw, int m, int b0, uint32_t p,
                                         uint32_t ninv) {
  for (int t = threadIdx.x; t < (1 << (m - K)); t += blockDim.x) {
    const int low = t & ((1 << b0) - 1);
    const int pos0 = low + ((t >> b0) << (b0 + K));
    uint32_t r[1 << K];
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) r[e] = s[pos0 + (e << b0)];
    radix_stages_dif<K, kLazy>(r, tw, low, b0, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) s[pos0 + (e << b0)] = r[e];
  }
}

// One in-place radix-2^K DIT pass over the 2^m residues of s: stage bits
// [b0, b0 + K). Position q lives at word sw(q).
template <int K, bool kLazy, typename Sw, typename Tw>
__device__ __forceinline__ void dit_pass(uint32_t* s, Sw sw, Tw tw, int m, int b0, uint32_t p,
                                         uint32_t ninv) {
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

// The in-place DIT passes of `plan` (stage bits as base-4 digits, lowest pass
// first, ended by 0) from stage bit b0 on, a block barrier after each but the
// last. Returns the stage bit the plan ends at.
template <bool kLazy, typename Sw, typename Tw>
__device__ __forceinline__ int dit_passes(uint32_t* s, Sw sw, Tw tw, int m, int b0, int plan,
                                          uint32_t p, uint32_t ninv) {
  for (int pl = plan; pl; pl >>= 2) {
    const int k = pl & 3;
    if (k == 3) dit_pass<3, kLazy>(s, sw, tw, m, b0, p, ninv);
    else if (k == 2) dit_pass<2, kLazy>(s, sw, tw, m, b0, p, ninv);
    else dit_pass<1, kLazy>(s, sw, tw, m, b0, p, ninv);
    b0 += k;
    if (pl >> 2) __syncthreads();
  }
  return b0;
}

template <bool kLazy, typename Tw>
__device__ __forceinline__ int dit_passes(uint32_t* s, Tw tw, int m, int b0, int plan,
                                          uint32_t p, uint32_t ninv) {
  return dit_passes<kLazy>(s, NoSwizzle{}, tw, m, b0, plan, p, ninv);
}

// The closing DIT pass of one polynomial of 2^logn residues held by the
// 2^logc blocks of cluster ranks rank0 .. rank0 + 2^logc - 1, block `rank` of
// them keeping positions [rank 2^m, (rank + 1) 2^m), m = logn - logc, in its
// row s: the top KF >= logc stages, the n^-1 psi^-i untwist and the
// store of canonical int64 residues, 16 bytes a thread. A thread takes two
// neighbouring bases b, b + 1 (b even): element e of base b is position
// b + e 2^bf, bf = logn - KF, held by block (b + e 2^bf) >> m, and leaves for
// xout[b + e 2^bf]. The caller synchronises the cluster (the block when
// logc = 0) before the call, and the cluster after it.
template <int KF, bool kLazy, typename Tw>
__device__ __forceinline__ void closing_pass(cg::cluster_group& cluster, uint32_t* s, Tw tw,
                                             const uint32_t* __restrict__ twistl,
                                             int64_t* __restrict__ xout, int logn, int logc,
                                             int rank, int rank0, uint32_t p, uint32_t ninv) {
  const int m = logn - logc;
  const int bf = logn - KF;
  const int nblocks = 1 << logc;
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
      const uint32_t* src = logc ? cluster.map_shared_rank(s, rank0 + (e >> (m - bf))) : s;
      const int a = b + ((e & emask) << bf);
      r0[e] = src[a];
      r1[e] = src[a + 1];
    }
    radix_stages<KF, kLazy>(r0, tw, b, bf, p, ninv);
    radix_stages<KF, kLazy>(r1, tw, b + 1, bf, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << KF); ++e) {
      const int k = b + (e << bf);
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(twistl + k));
      const uint32_t v0 = canonical2<kLazy>(mul_w<kLazy>(r0[e], t.x, p, ninv), p);
      const uint32_t v1 = canonical2<kLazy>(mul_w<kLazy>(r1[e], t.y, p, ninv), p);
      *reinterpret_cast<longlong2*>(xout + k) =
          make_longlong2(static_cast<long long>(v0), static_cast<long long>(v1));
    }
  }
}

template <bool kLazy, typename Tw>
__device__ __forceinline__ void closing(int kf, cg::cluster_group& cluster, uint32_t* s, Tw tw,
                                        const uint32_t* __restrict__ twistl,
                                        int64_t* __restrict__ xout, int logn, int logc, int rank,
                                        int rank0, uint32_t p, uint32_t ninv) {
  if (kf == 3) closing_pass<3, kLazy>(cluster, s, tw, twistl, xout, logn, logc, rank, rank0, p, ninv);
  else if (kf == 2) closing_pass<2, kLazy>(cluster, s, tw, twistl, xout, logn, logc, rank, rank0, p, ninv);
  else closing_pass<1, kLazy>(cluster, s, tw, twistl, xout, logn, logc, rank, rank0, p, ninv);
}

// Launch kern on `blocks` blocks in clusters of `cluster` (a plain launch
// when that is 1). Returns the launch's error.
template <typename... Params, typename... Args>
inline cudaError_t cluster_launch(void (*kern)(Params...), int blocks, int cluster, int threads,
                                  size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<Params>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Registers a thread and static shared-memory bytes of kern into attrs[0..2).
template <typename Kernel>
inline int kernel_attrs(Kernel kern, void* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(kern));
  if (e != cudaSuccess) return static_cast<int>(e);
  int* o = static_cast<int*>(attrs);
  o[0] = fa.numRegs;
  o[1] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}

}  // namespace toyfhe
