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
// stays with the caller. The digit tensor never exists in device memory.
//
// One kernel computes it: keyswitch_cluster_kernel, behind
// toyfhe_keyswitch_cluster.
//
// What bounds it on this card: not device-memory bytes (the key rows, 2 x 28
// x 32 KB an output limb at the MNIST width, stream once) but the chain of
// Lc*kpl + 2 transforms behind one (row, limb) output pair, on a launch of
// rows * Le pairs, 8 at the MNIST width, against 132 SMs. What the design
// does about it:
//
//  * Digits spread over a thread-block cluster: one (row, limb) pair per
//    cluster of G blocks (G in 1, 2, 4, 8; the host picks G so that rows * Le
//    * G comes near 132), block g taking the digits g, g + G, g + 2G, ...:
//    28 digits are 4 or 3 a block at G = 8. Measured at the MNIST width
//    (chip_smoke.py phase 24, graph-replayed device time, NVIDIA H100 80GB
//    HBM3, 700 W): 290 microseconds at G = 1, 151 at G = 2, 81 at G = 4, 50 at
//    G = 8, against 483 for a one-block loop kernel: about 10 microseconds a digit
//    and 10 for the reduction and the inverse.
//  * Register-radix DIF per digit (radix_stages_dif, common.cuh;
//    ceil((log2 N - 3) / 3) + 1 passes planned by ops/ntt_pallas_cuda.py::
//    forward_plan), the digit built in the first pass: the thread reads c2's
//    limb from device memory, shifts, masks and twists in registers. No
//    separate digit-building pass.
//  * Key products in the last pass: it covers stage bits [0, 3), a thread on
//    8 neighbouring positions, the same for every digit, so after the r2
//    conversion the thread multiplies by the two key rows (bit-reversed
//    order, neighbouring 32-bit n: two 16-byte loads a row) and adds into
//    its accumulators. Up to N = 2^13 the accumulators are registers (one or
//    two items a thread, 16 or 32 n). At N = 2^14 a thread has four items
//    and they live in the block's two partial rows in shared memory, at
//    N = 2^15 in two block-owned rows of the scratch area the wrapper
//    allocates; the thread that adds to a word is the one that wrote it.
//  * Cluster reduction, then the two inverse transforms side by side. Each
//    block leaves its partial rows (shared memory up to N = 2^14, scratch at
//    2^15), the cluster synchronises, and the G blocks split in two halves:
//    blocks [0, G/2) take acc1, blocks [G/2, G) take acc2 (one block takes
//    both in turn when G = 1). Block j of a half sums the G partials of
//    positions [j 2N/G, (j+1) 2N/G) through map_shared_rank (plus c1e on
//    channel 1), runs the local DIT passes, and the closing pass
//    (cluster_pass.cuh) takes the top log2(G/2) stages through the shared
//    memory of its half, with the untwist fused into 16-byte stores. Every
//    partial sum is reduced mod p, so a sum of partial sums equals the TPU
//    kernel's tree sum.
//  * Lazy butterflies when every prime is below 2^30 ([0, 2p) forward and in
//    the accumulators, [0, 4p) backward, one full reduction in the closing
//    store); fully reduced ones otherwise (the kLazy flag). Both end
//    canonical and equal the plain twin bit for bit.
//
// Digits are below 2^w < p, so they need no reduction before the twist.

#include "cluster_pass.cuh"

namespace {

using toyfhe::RowTw;
using toyfhe::add_w;
using toyfhe::mul_w;
using toyfhe::radix_stages_dif;
namespace cg = cooperative_groups;

constexpr int kMaxSmemPartLogN = 14;   // largest N whose three rows fit a block

struct KsArgs {
  const int64_t* c2;
  const int64_t* c1e;
  int64_t* out1;
  int64_t* out2;
  const uint32_t* psi;
  const uint32_t* fwd_tw;
  const uint32_t* ipsi;
  const uint32_t* inv_tw;
  const uint32_t* pnr;
  const uint32_t* masks;
  const uint32_t* maskeds;
  uint32_t* scratch;
  int lc, window, kpl, logn, logg;
  int kl, fplan;          // the DIF passes above stage bit 3: load pass, then top first
  int bplan, kf;          // the DIT passes of one half of the cluster, and its closing pass
};

// The load pass of one digit: build it from c2's limb, twist, and run the
// stage bits [logn - K, logn), device memory to shared memory.
template <int K, bool kLazy, typename Tw>
__device__ __forceinline__ void digit_pass(uint32_t* s, const int64_t* __restrict__ src,
                                           int shift, uint32_t mask,
                                           const uint32_t* __restrict__ psil, Tw tw, int logn,
                                           uint32_t p, uint32_t ninv) {
  const int b0 = logn - K;
  for (int t = threadIdx.x; t < (1 << b0); t += blockDim.x) {
    uint32_t r[1 << K];
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) {
      const int q = t + (e << b0);
      const uint32_t dig = (static_cast<uint32_t>(src[q]) >> shift) & mask;
      r[e] = mul_w<kLazy>(dig, __ldg(psil + q), p, ninv);
    }
    radix_stages_dif<K, kLazy>(r, tw, t, b0, p, ninv);
#pragma unroll
    for (int e = 0; e < (1 << K); ++e) s[t + (e << b0)] = r[e];
  }
}

// kAcc > 0: the accumulators of kAcc items a thread live in registers (the
// block runs 2^(logn-3) / kAcc threads or more). kAcc = 0: they live in the
// block's partial rows.
template <int kAcc, bool kLazy>
__global__ void __launch_bounds__(toyfhe::kRadixThreads)
keyswitch_cluster_kernel(const KsArgs k) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int logn = k.logn;
  const int n = 1 << logn;
  const int le = k.lc + 1;
  const int nblocks = 1 << k.logg;
  const int g = blockIdx.x & (nblocks - 1);
  const int pairi = blockIdx.x >> k.logg;
  const int t = pairi % le;                   // output limb of the expanded tower
  const int r = pairi / le;                   // leading row
  const uint32_t p = k.pnr[3 * t];
  const uint32_t ninv = k.pnr[3 * t + 1];
  const uint32_t r2 = k.pnr[3 * t + 2];
  const int ndig = k.lc * k.kpl;
  const uint32_t mask = (1u << k.window) - 1u;
  const bool smem_parts = logn <= kMaxSmemPartLogN;

  uint32_t* s = smem;                         // the digit row, then the DIT row
  // this block's two partial rows
  uint32_t* part = smem_parts ? smem + n
                              : k.scratch + static_cast<size_t>(blockIdx.x) * 2 * n;
  const size_t limb = static_cast<size_t>(t) * n;
  const size_t row = (static_cast<size_t>(r) * le + t) * n;
  const RowTw twf{k.fwd_tw + limb};
  const RowTw itwf{k.inv_tw + limb};

  const int64_t* c2r = k.c2 + static_cast<size_t>(r) * k.lc * n;
  const int items = n >> 3;
  uint32_t acc1[kAcc ? kAcc : 1][8], acc2[kAcc ? kAcc : 1][8];
#pragma unroll
  for (int it = 0; it < (kAcc ? kAcc : 1); ++it) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc1[it][e] = acc2[it][e] = 0;
  }

  for (int d = g; d < ndig; d += nblocks) {
    const int64_t* src = c2r + static_cast<size_t>(d / k.kpl) * n;
    const int shift = k.window * (d % k.kpl);
    if (k.kl == 3) digit_pass<3, kLazy>(s, src, shift, mask, k.psi + limb, twf, logn, p, ninv);
    else if (k.kl == 2) digit_pass<2, kLazy>(s, src, shift, mask, k.psi + limb, twf, logn, p, ninv);
    else digit_pass<1, kLazy>(s, src, shift, mask, k.psi + limb, twf, logn, p, ninv);
    __syncthreads();
    int b0 = logn - k.kl;
    for (int pl = k.fplan; pl; pl >>= 2) {
      const int kk = pl & 3;
      b0 -= kk;
      if (kk == 3) toyfhe::dif_pass<3, kLazy>(s, twf, logn, b0, p, ninv);
      else if (kk == 2) toyfhe::dif_pass<2, kLazy>(s, twf, logn, b0, p, ninv);
      else toyfhe::dif_pass<1, kLazy>(s, twf, logn, b0, p, ninv);
      __syncthreads();
    }

    // last pass, stage bits [0, 3), and the key products of 8 neighbouring
    // positions: the thread that adds to a word is the one that wrote it
    const size_t krow = (static_cast<size_t>(t) * ndig + d) * n;
    auto item = [&](int ti, uint32_t (&a1)[8], uint32_t (&a2)[8]) {
      uint32_t v[8];
      toyfhe::load8(s + 8 * ti, v);
      radix_stages_dif<3, kLazy>(v, twf, 0, 0, p, ninv);
      const uint4* k1 = reinterpret_cast<const uint4*>(k.maskeds + krow + 8 * ti);
      const uint4* k2 = reinterpret_cast<const uint4*>(k.masks + krow + 8 * ti);
      const uint4 m0 = __ldg(k1), m1 = __ldg(k1 + 1), n0 = __ldg(k2), n1 = __ldg(k2 + 1);
      const uint32_t key1[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const uint32_t key2[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t x = mul_w<kLazy>(v[e], r2, p, ninv);       // Montgomery form
        a1[e] = add_w<kLazy>(a1[e], mul_w<kLazy>(x, key1[e], p, ninv), p);
        a2[e] = add_w<kLazy>(a2[e], mul_w<kLazy>(x, key2[e], p, ninv), p);
      }
    };
    if (kAcc) {
#pragma unroll
      for (int it = 0; it < (kAcc ? kAcc : 1); ++it) {
        const int ti = threadIdx.x + it * blockDim.x;
        if (ti < items) item(ti, acc1[it], acc2[it]);
      }
    } else {
      for (int ti = threadIdx.x; ti < items; ti += blockDim.x) {
        uint32_t a1[8] = {}, a2[8] = {};
        if (d != g) {
          toyfhe::load8(part + 8 * ti, a1);
          toyfhe::load8(part + n + 8 * ti, a2);
        }
        item(ti, a1, a2);
        toyfhe::store8(part + 8 * ti, a1);
        toyfhe::store8(part + n + 8 * ti, a2);
      }
    }
    __syncthreads();          // s is rebuilt for the next digit
  }

  if (kAcc) {
#pragma unroll
    for (int it = 0; it < (kAcc ? kAcc : 1); ++it) {
      const int ti = threadIdx.x + it * blockDim.x;
      if (ti < items) {
        toyfhe::store8(part + 8 * ti, acc1[it]);
        toyfhe::store8(part + n + 8 * ti, acc2[it]);
      }
    }
  }
  if (!smem_parts) __threadfence();
  if (k.logg) cluster.sync();                 // every partial row is complete
  else __syncthreads();

  // blocks [0, H) take channel 1 (acc1 + c1e), blocks [H, 2H) channel 2;
  // one block takes both in turn when the cluster is one block
  const int logh = k.logg ? k.logg - 1 : 0;
  const int m = logn - logh;                  // log2 of the positions a block reduces
  const int sub = g & ((1 << logh) - 1);
  for (int ch = k.logg ? g >> logh : 0; ch < 2; ch += k.logg ? 2 : 1) {
    for (int q = threadIdx.x; q < (1 << m); q += blockDim.x) {
      const int pos = (sub << m) + q;
      uint32_t v = ch ? 0 : static_cast<uint32_t>(k.c1e[row + pos]);
      for (int b = 0; b < nblocks; ++b) {
        const uint32_t* src =
            smem_parts ? (k.logg ? cluster.map_shared_rank(part, b) : part)
                       : part + (static_cast<ptrdiff_t>(b) - g) * 2 * n;
        v = add_w<kLazy>(v, src[ch * n + pos], p);
      }
      s[q] = v;
    }
    __syncthreads();
    toyfhe::dit_passes<kLazy>(s, itwf, m, 0, k.bplan, p, ninv);
    if (k.logg) cluster.sync();               // the closing pass reads its half of the cluster
    else __syncthreads();
    toyfhe::closing<kLazy>(k.kf, cluster, s, itwf, k.ipsi + limb, (ch ? k.out2 : k.out1) + row,
                           logn, logh, sub, ch << logh, p, ninv);
    if (!k.logg) __syncthreads();             // the second channel reuses s
  }
  if (k.logg) cluster.sync();                 // no block leaves while its rows are read
}

using ClusterKernel = void (*)(const KsArgs);

template <int kAcc>
ClusterKernel pick(int lazy) {
  return lazy ? keyswitch_cluster_kernel<kAcc, true> : keyswitch_cluster_kernel<kAcc, false>;
}

// Items a thread keeps in registers at ring degree 2^logn (0: none, the
// accumulators live in the partial rows).
int acc_items(int logn) {
  const int items = 1 << (logn - 3);
  const int per = (items + toyfhe::kRadixThreads - 1) / toyfhe::kRadixThreads;
  return per <= 2 ? per : 0;
}

ClusterKernel cluster_kernel(int logn, int lazy) {
  const int a = acc_items(logn);
  return a == 1 ? pick<1>(lazy) : (a == 2 ? pick<2>(lazy) : pick<0>(lazy));
}

long long cluster_scratch_words(int rows, int lc, int logn, int cluster) {
  if (logn <= kMaxSmemPartLogN) return 0;
  return static_cast<long long>(rows) * (lc + 1) * cluster * 2 *
         (1LL << logn);
}

}  // namespace

extern "C" {

// Bytes of global scratch toyfhe_keyswitch_cluster needs (0 when the partial
// rows fit shared memory).
long long toyfhe_keyswitch_cluster_scratch_bytes(int rows, int lc, int logn, int cluster) {
  return cluster_scratch_words(rows, lc, logn, cluster) * static_cast<long long>(sizeof(uint32_t));
}

// c2: int64 [rows, lc, 2^logn] primal. c1e: int64 [rows, lc + 1, 2^logn]
// bit-reversed dual. out1 / out2: int64 [rows, lc + 1, 2^logn] primal.
// psi / fwd_tw: the forward twist and packed stage twiddles of the expanded
// tower; ipsi / inv_tw: the inverse ones. pnr: uint32 [lc + 1, 3] rows of
// (p, ninv, r2). masks / maskeds: uint32 [lc + 1, lc * kpl, 2^logn]
// bit-reversed key duals, limb-major. cluster: blocks per (row, limb) pair (1,
// 2, 4 or 8, at most lc * kpl, with 2^logn / max(1, cluster / 2) >= 8); lazy:
// every prime is below 2^30; kl, fplan: the DIF plan of ops/ntt_pallas_cuda.py
// ::forward_plan; bplan, kf: the DIT plan of ops/ntt_cuda.py::schedule_plan
// for max(1, cluster / 2) blocks. out1 / out2 must be 16-byte aligned, masks /
// maskeds 16-byte aligned. scratch: uint32, of the size
// toyfhe_keyswitch_cluster_scratch_bytes gives (may be null when that is 0).
// Returns cudaGetLastError() after the launch.
int toyfhe_keyswitch_cluster(const void* c2, const void* c1e, void* out1, void* out2,
                             const void* psi, const void* fwd_tw, const void* ipsi,
                             const void* inv_tw, const void* pnr, const void* masks,
                             const void* maskeds, void* scratch, int rows, int lc, int window,
                             int kpl, int logn, int cluster, int lazy, int kl, int fplan,
                             int bplan, int kf, void* stream) {
  if (rows <= 0) return 0;
  int logg = 0;
  while ((1 << logg) < cluster) ++logg;
  const int logh = logg ? logg - 1 : 0;
  if ((1 << logg) != cluster || logg > 3 || cluster > lc * kpl || window <= 0 || window >= 32 ||
      logn < 4 || logn - logh < 3 || kf < logh || kf < 1 || kf > 3 || kl < 1 || kl > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = 1 << logn;
  const size_t rows_smem = logn <= kMaxSmemPartLogN ? 3 : 1;
  const size_t smem = rows_smem * n * sizeof(uint32_t);
  const KsArgs args = {
      static_cast<const int64_t*>(c2), static_cast<const int64_t*>(c1e),
      static_cast<int64_t*>(out1), static_cast<int64_t*>(out2),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(fwd_tw),
      static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(inv_tw),
      static_cast<const uint32_t*>(pnr), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(maskeds), static_cast<uint32_t*>(scratch),
      lc, window, kpl, logn, logg, kl, fplan, bplan, kf};
  return static_cast<int>(toyfhe::cluster_launch(
      cluster_kernel(logn, lazy), rows * (lc + 1) * cluster, cluster, toyfhe::radix_threads(n),
      smem, static_cast<cudaStream_t>(stream), args));
}

// Registers a thread and static shared-memory bytes of the instantiation of
// the cluster kernel that runs ring degree 2^logn, into attrs[0..2).
int toyfhe_keyswitch_cluster_attrs(int logn, int lazy, void* attrs) {
  return toyfhe::kernel_attrs(cluster_kernel(logn, lazy), attrs);
}

}  // extern "C"
