// Fused hybrid (dnum-gadget) key-switch core for Hopper (sm_90a).
//
// Replaces the TPU kernel K3, toyfhe_tpu/ops/pallas_hybrid_ks.py::
// FusedHybridKS.__call__ (body _fused_kernel). For each batch row r and each
// limb t of the expanded tower Q_t U P it computes
//
//   acc1[r,t] = sum_j NTT_t( sum_i y^[r, lo_j + i] [Q_j/q_i]_{p_t} ) (.) kd[j,t]
//   acc2[r,t] = sum_j NTT_t( sum_i y^[r, lo_j + i] [Q_j/q_i]_{p_t} ) (.) km[j,t]
//
// with kd / km the key's masked / mask duals pre-multiplied by 2^32 mod p_t,
// so that one Montgomery product gives the plain product. The output is in
// natural dual order and canonical, equal to the unfused pipeline (digit
// tensor, radix-2 NTT, key contraction) bit for bit. The TPU kernel carried
// the sum over j across a sequential grid axis; here a loop inside the block
// or a sum across a thread-block cluster takes its place. The [dnum, T, N]
// digit tensor never exists in device memory.
//
// One kernel computes it: hybrid_ks_cluster_kernel, behind
// toyfhe_hybrid_ks_cluster.
//
// What bounds it on this card: not device-memory bytes (the y^ rows that
// every output limb re-reads are a few megabytes and stay in the 50 MB L2,
// the key rows stream once) but the chain of dnum transforms behind one
// (row, limb) output pair, on a launch of R T pairs, 40 to 44 at the serving
// shapes, against 132 SMs. What the design does about it:
//
//  * Register-radix DIT passes (radix_stages, common.cuh), as K1 runs them: a
//    thread takes 8 residues whose positions differ in three consecutive
//    stage bits and runs three stages on them, so a pass is one barrier and
//    one trip to shared memory where radix-2 paid three. The host's plan
//    (ops/ntt_cuda.py::schedule_plan) gives ceil(log2 N / 3) passes: 5
//    barriers a digit at N = 2^13 against 15 for radix-2 stages.
//  * The digit is built in the load pass: a thread reads the y^ residues of
//    two neighbouring coefficients of each of the digit's ct limbs (one
//    16-byte load a limb), forms sum_a y^_a c_a in registers, twists the two
//    sums and stores them to their bit-reversed positions through K1's XOR
//    swizzle (XorSwizzle, cluster_pass.cuh), so a warp's stores hit 32 banks.
//  * Key products in the closing pass, accumulators in registers: the pass
//    that runs the top kf stages holds natural positions b, b + 1 and their
//    strides, the same for every digit, so it multiplies them by the two key
//    rows (8-byte loads) and adds into 2 x 16 registers that live across the
//    digit loop. The int64 output rows are written once, 16 bytes a thread,
//    after the last digit. Blocks that hold more than 2^13 residues keep the
//    two partial rows in shared memory (N = 2^14) or in block-owned scratch
//    (N = 2^15); the thread that adds to a word is the one that wrote it.
//  * More blocks than pairs: one (row, limb) pair per thread-block cluster,
//    spent in one of two ways (the host picks, ops/hybrid_ks_cuda.py::
//    choose_cluster). Digits over the cluster: block g takes the digits g,
//    g + G, ..., parks its accumulators in its two partial rows, and after
//    one cluster barrier block g sums the G partials of positions
//    [g N/G, (g+1) N/G) through map_shared_rank and stores them. Or the
//    polynomial over the cluster, as K1: block r holds the N / C bit-reversed
//    positions [r N/C, (r+1) N/C) of every digit, the closing pass reads the
//    top log2 C stages' operands from its partners' rows, and each block
//    accumulates and stores its own share of the natural positions; two rows
//    a block in turns, so one cluster barrier a digit is enough. Every
//    partial sum is reduced mod p, so any order of summation gives the same
//    canonical result.
//  * Lazy values when every prime of the expanded tower is below 2^30. y^ is
//    a residue mod q_i used as a REDC operand mod p_t without reduction: it
//    is below 2^31 and the constant below p_t, so an uncorrected REDC gives
//    (y^ c + m p) / 2^32 < 2p. The digit sums and their twist stay in [0, 2p),
//    the DIT stages in [0, 4p) (dit_butterfly<true>), and the key product
//    takes the closing pass's [0, 4p) < 2^32 value as it is: REDC needs only
//    its other operand below p, and again gives a value below 2p. The
//    accumulators and the cluster sums stay in [0, 2p); one conditional
//    subtraction in the closing store. A tower with a prime in [2^30, 2^31)
//    takes the fully reduced arithmetic (the kLazy flag), where y^ c < p 2^32
//    is all the corrected REDC needs. Both end canonical and equal the plain
//    twin bit for bit.
//
// Measured (chip_smoke.py phase 24, graph-replayed device time, NVIDIA H100
// 80GB HBM3, 700 W), N = 2^13. The MNIST serving gadget (R = 4, T = 11,
// dnum = 2, 44 pairs): 33.9 microseconds with one block a pair, 21.6 with the
// digits over two blocks (the host's choice), 23.6 with the polynomial over
// two, 28.3 over four, against 52.1 for a one-block radix-2 loop kernel. The
// dnum = 4 gadget (40 pairs): 54.7, 32.5 with the digits over two, 36.6 over
// four (160 blocks for 132 SMs), 37.0 with the polynomial over two, against
// 97.5. Sixteen rows
// of the serving gadget (176 pairs): 67.0, 63.1, 68.6, against 106.6. A digit
// costs a block about 17 microseconds (tools/k3_experiments.py, knock-outs):
// 6.1 the four in-place passes, 1.9 the closing pass, 2.2 the y^ loads (5
// before they were started in batches: read one at a time they were 32 round
// trips to L2 a thread), the rest the digit sums, the scatter and the
// barriers; the cluster sum and store 4.6. The pass plan barely matters
// ((2, 2, 3, 3) + 3 or (3, 3, 3, 2) + 2 for (3, 3, 3, 3) + 1: within 4%). 122 to 128 registers a thread, no spills but in the lazy
// kf = 3 instantiation (24 bytes).

#include "cluster_pass.cuh"

namespace {

using toyfhe::RowTw;
using toyfhe::XorSwizzle;
using toyfhe::add_w;
using toyfhe::bitrev;
using toyfhe::canonical2;
using toyfhe::mul_w;
using toyfhe::radix_stages;
namespace cg = cooperative_groups;

constexpr int kMaxRegAccLog = 13;      // blocks of more residues keep partial rows in memory
constexpr int kMaxSmemPartLogN = 14;   // largest N whose digit row and partial rows fit a block

struct HksArgs {
  const int64_t* y;
  int64_t* out1;
  int64_t* out2;
  const uint32_t* twist;
  const uint32_t* tw;
  const uint32_t* pn;
  const uint32_t* cst;
  const uint32_t* km;
  const uint32_t* kd;
  const int* bounds;
  uint32_t* scratch;
  int lt, nlimbs, dnum, alpha, logn;
  int logg;        // the digits over 2^logg blocks of the cluster
  int logc;        // or the polynomial over 2^logc blocks (one of the two is 0)
  int plan;        // the local DIT passes, base-4 digits, lowest pass first
  int two_rows;    // digit rows a block alternates between: 2 (!= 0) or 1
};

constexpr int kLoadU = 4;   // coefficient pairs a thread builds at once in the load pass
constexpr int kLoadA = 2;   // ct limbs whose residues it has in flight for each

// The load pass of one digit for block `rank` of the 2^logc that share the
// polynomial: coefficient i = C v + bitrev(rank) goes, as the twisted sum
// over the digit's ct limbs, to position bitrev(v) of the block's row. A
// thread takes two neighbouring v at a time, kLoadU such pairs a blockDim
// apart together, and starts the loads of kLoadA limbs of all of them before
// it uses the first: the y^ rows come from L2, and one load at a time would
// make width x N / (2 threads) round trips of it a digit.
template <bool kLazy, typename Sw>
__device__ __forceinline__ void digit_load(uint32_t* s, Sw sw, const int64_t* __restrict__ yr,
                                           const uint32_t* __restrict__ c, int width,
                                           const uint32_t* __restrict__ twistl, int logn, int m,
                                           int logc, int rank, uint32_t p, uint32_t ninv) {
  const size_t n = static_cast<size_t>(1) << logn;
  const int half = 1 << (m - 1);
  const int cb = logc ? bitrev(rank, logc) : 0;
  const int step = 1 << logc;
  for (int u0 = threadIdx.x; u0 < half; u0 += kLoadU * blockDim.x) {
    uint32_t d0[kLoadU], d1[kLoadU];
#pragma unroll
    for (int j = 0; j < kLoadU; ++j) d0[j] = d1[j] = 0;
    for (int a0 = 0; a0 < width; a0 += kLoadA) {
      uint32_t y0[kLoadA][kLoadU], y1[kLoadA][kLoadU];
#pragma unroll
      for (int aa = 0; aa < kLoadA; ++aa) {
        const int64_t* ya = yr + (a0 + aa) * n;
#pragma unroll
        for (int j = 0; j < kLoadU; ++j) {
          const int u = u0 + j * blockDim.x;
          y0[aa][j] = y1[aa][j] = 0;
          if (a0 + aa < width && u < half) {
            const int i0 = ((2 * u) << logc) + cb;
            if (logc == 0) {
              const longlong2 t = *reinterpret_cast<const longlong2*>(ya + i0);
              y0[aa][j] = static_cast<uint32_t>(t.x);
              y1[aa][j] = static_cast<uint32_t>(t.y);
            } else {
              y0[aa][j] = static_cast<uint32_t>(ya[i0]);
              y1[aa][j] = static_cast<uint32_t>(ya[i0 + step]);
            }
          }
        }
      }
#pragma unroll
      for (int aa = 0; aa < kLoadA; ++aa) {
        if (a0 + aa < width) {
          const uint32_t ca = __ldg(c + a0 + aa);
#pragma unroll
          for (int j = 0; j < kLoadU; ++j) {
            d0[j] = add_w<kLazy>(d0[j], mul_w<kLazy>(y0[aa][j], ca, p, ninv), p);
            d1[j] = add_w<kLazy>(d1[j], mul_w<kLazy>(y1[aa][j], ca, p, ninv), p);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadU; ++j) {
      const int u = u0 + j * blockDim.x;
      if (u < half) {
        const int v = 2 * u;
        const int i0 = (v << logc) + cb;
        const int i1 = i0 + step;
        const int q0 = bitrev(v, m);          // v even: bitrev(v + 1) = q0 + 2^(m-1)
        s[sw(q0)] = mul_w<kLazy>(d0[j], __ldg(twistl + i0), p, ninv);
        s[sw(q0 + half)] = mul_w<kLazy>(d1[j], __ldg(twistl + i1), p, ninv);
      }
    }
  }
}

// One cluster of 2^(logg + logc) blocks per (row, limb) pair; KF: the stages
// of the closing pass.
template <int KF, bool kLazy>
__global__ void __launch_bounds__(toyfhe::kRadixThreads)
hybrid_ks_cluster_kernel(const HksArgs k) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kItems = 4 >> (KF - 1);       // closing items a thread keeps in registers
  constexpr int kE = 1 << KF;
  const int logn = k.logn;
  const int n = 1 << logn;
  const int logb = k.logg + k.logc;
  const int crank = blockIdx.x & ((1 << logb) - 1);
  const int pairi = blockIdx.x >> logb;
  const int t = pairi % k.nlimbs;             // output limb of Q_t U P
  const int r = pairi / k.nlimbs;             // batch row
  const int g = k.logg ? crank : 0;           // this block's first digit
  const int gstep = 1 << k.logg;
  const int rank = k.logc ? crank : 0;        // this block's part of the polynomial
  const int nblocks = 1 << k.logc;
  const int m = logn - k.logc;                // log2 of the residues a block holds
  const int per_block = 1 << m;
  const uint32_t p = k.pn[2 * t];
  const uint32_t ninv = k.pn[2 * t + 1];
  const int64_t* yr = k.y + static_cast<size_t>(r) * k.lt * n;
  const size_t row = (static_cast<size_t>(r) * k.nlimbs + t) * n;
  const uint32_t* twistl = k.twist + static_cast<size_t>(t) * n;
  const RowTw twf{k.tw + static_cast<size_t>(t) * n};
  const XorSwizzle sw(m);

  const bool acc_mem = m > kMaxRegAccLog;     // the accumulators live in the partial rows
  const bool parts = acc_mem || k.logg;       // the result goes through the partial rows
  const bool smem_parts = logn <= kMaxSmemPartLogN;
  uint32_t* part = smem_parts ? smem + (k.two_rows ? 2 : 1) * per_block
                              : k.scratch + static_cast<size_t>(blockIdx.x) * 2 * n;

  const int bf = logn - KF;
  const int npairs = 1 << (bf - 1);
  const int per = (npairs + nblocks - 1) >> k.logc;   // closing items of this block
  const int emask = (1 << (m - bf)) - 1;

  uint32_t acc1[kItems][2 * kE], acc2[kItems][2 * kE];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
#pragma unroll
    for (int e = 0; e < 2 * kE; ++e) acc1[it][e] = acc2[it][e] = 0;
  }

  int cur = 0;
  for (int j = g; j < k.dnum; j += gstep) {
    uint32_t* s = smem + cur * per_block;
    const int lo = k.bounds[2 * j];
    const int width = k.bounds[2 * j + 1] - lo;
    const size_t jt = static_cast<size_t>(j) * k.nlimbs + t;
    digit_load<kLazy>(s, sw, yr + static_cast<size_t>(lo) * n, k.cst + jt * k.alpha, width, twistl,
                      logn, m, k.logc, rank, p, ninv);
    __syncthreads();

    int b0 = 0;
    for (int pl = k.plan; pl; pl >>= 2) {
      const int kk = pl & 3;
      if (kk == 3) toyfhe::dit_pass<3, kLazy>(s, sw, twf, m, b0, p, ninv);
      else if (kk == 2) toyfhe::dit_pass<2, kLazy>(s, sw, twf, m, b0, p, ninv);
      else toyfhe::dit_pass<1, kLazy>(s, sw, twf, m, b0, p, ninv);
      b0 += kk;
      if (k.logc && (pl >> 2) == 0) cluster.sync();   // the closing pass reads the cluster
      else __syncthreads();
    }

    // closing pass: stage bits [bf, logn) and the key products. An item takes
    // two neighbouring bases b, b + 1 (b even): element e of base b is
    // position b + e 2^bf, held by block (b + e 2^bf) >> m, and adds into
    // accumulators 2e (base b) and 2e + 1 (base b + 1).
    const uint32_t* kdr = k.kd + jt * n;
    const uint32_t* kmr = k.km + jt * n;
    auto item = [&](int b, uint32_t (&a1)[2 * kE], uint32_t (&a2)[2 * kE]) {
      uint32_t r0[kE], r1[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const uint32_t* src = k.logc ? cluster.map_shared_rank(s, e >> (m - bf)) : s;
        const int a = sw(b + ((e & emask) << bf));
        r0[e] = src[a];
        r1[e] = src[a ^ 1];
      }
      radix_stages<KF, kLazy>(r0, twf, b, bf, p, ninv);
      radix_stages<KF, kLazy>(r1, twf, b + 1, bf, p, ninv);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int pos = b + (e << bf);
        const uint2 d = __ldg(reinterpret_cast<const uint2*>(kdr + pos));
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(kmr + pos));
        a1[2 * e] = add_w<kLazy>(a1[2 * e], mul_w<kLazy>(r0[e], d.x, p, ninv), p);
        a1[2 * e + 1] = add_w<kLazy>(a1[2 * e + 1], mul_w<kLazy>(r1[e], d.y, p, ninv), p);
        a2[2 * e] = add_w<kLazy>(a2[2 * e], mul_w<kLazy>(r0[e], w.x, p, ninv), p);
        a2[2 * e + 1] = add_w<kLazy>(a2[2 * e + 1], mul_w<kLazy>(r1[e], w.y, p, ninv), p);
      }
    };
    if (!acc_mem) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int i = threadIdx.x + it * blockDim.x;
        const int pair = rank * per + i;
        if (i < per && pair < npairs) item(2 * pair, acc1[it], acc2[it]);
      }
    } else {
      for (int i = threadIdx.x; i < per; i += blockDim.x) {
        const int b = 2 * i;
        uint32_t a1[2 * kE], a2[2 * kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          uint2 x1 = make_uint2(0, 0), x2 = make_uint2(0, 0);
          if (j != g) {
            x1 = *reinterpret_cast<const uint2*>(part + b + (e << bf));
            x2 = *reinterpret_cast<const uint2*>(part + n + b + (e << bf));
          }
          a1[2 * e] = x1.x; a1[2 * e + 1] = x1.y;
          a2[2 * e] = x2.x; a2[2 * e + 1] = x2.y;
        }
        item(b, a1, a2);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          *reinterpret_cast<uint2*>(part + b + (e << bf)) = make_uint2(a1[2 * e], a1[2 * e + 1]);
          *reinterpret_cast<uint2*>(part + n + b + (e << bf)) =
              make_uint2(a2[2 * e], a2[2 * e + 1]);
        }
      }
    }
    if (k.two_rows) cur ^= 1;                 // the next digit builds in the other row
    else __syncthreads();                     // or s is rebuilt after every thread has read it
  }

  if (!parts) {
    // one block owns its positions of the pair: store from the registers
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      const int pair = rank * per + i;
      if (i < per && pair < npairs) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const size_t at = row + 2 * pair + (e << bf);
          *reinterpret_cast<longlong2*>(k.out1 + at) = make_longlong2(
              static_cast<long long>(canonical2<kLazy>(acc1[it][2 * e], p)),
              static_cast<long long>(canonical2<kLazy>(acc1[it][2 * e + 1], p)));
          *reinterpret_cast<longlong2*>(k.out2 + at) = make_longlong2(
              static_cast<long long>(canonical2<kLazy>(acc2[it][2 * e], p)),
              static_cast<long long>(canonical2<kLazy>(acc2[it][2 * e + 1], p)));
        }
      }
    }
    if (k.logc) cluster.sync();               // no block leaves while its rows are read
    return;
  }

  if (!acc_mem) {
    // park the accumulators in this block's partial rows
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i < per) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int pos = 2 * i + (e << bf);
          *reinterpret_cast<uint2*>(part + pos) = make_uint2(acc1[it][2 * e], acc1[it][2 * e + 1]);
          *reinterpret_cast<uint2*>(part + n + pos) =
              make_uint2(acc2[it][2 * e], acc2[it][2 * e + 1]);
        }
      }
    }
  }
  if (!smem_parts) __threadfence();
  if (k.logg) cluster.sync();                 // every partial row is complete
  else __syncthreads();

  // block g sums the partials of positions [g N/G, (g+1) N/G), two a thread
  const int share = n >> k.logg;
  for (int q = threadIdx.x; q < share / 2; q += blockDim.x) {
    const int pos = g * share + 2 * q;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      uint32_t v0 = 0, v1 = 0;
      for (int b = 0; b < gstep; ++b) {
        const uint32_t* src =
            smem_parts ? (k.logg ? cluster.map_shared_rank(part, b) : part)
                       : part + (static_cast<ptrdiff_t>(b) - g) * 2 * n;
        const uint2 x = *reinterpret_cast<const uint2*>(src + ch * n + pos);
        v0 = add_w<kLazy>(v0, x.x, p);
        v1 = add_w<kLazy>(v1, x.y, p);
      }
      *reinterpret_cast<longlong2*>((ch ? k.out2 : k.out1) + row + pos) =
          make_longlong2(static_cast<long long>(canonical2<kLazy>(v0, p)),
                         static_cast<long long>(canonical2<kLazy>(v1, p)));
    }
  }
  if (k.logg) cluster.sync();                 // no block leaves while its rows are read
}

using ClusterKernel = void (*)(const HksArgs);

template <int KF>
ClusterKernel pick(int lazy) {
  return lazy ? hybrid_ks_cluster_kernel<KF, true> : hybrid_ks_cluster_kernel<KF, false>;
}

ClusterKernel cluster_kernel(int kf, int lazy) {
  if (kf == 1) return pick<1>(lazy);
  if (kf == 2) return pick<2>(lazy);
  if (kf == 3) return pick<3>(lazy);
  return nullptr;
}

}  // namespace

extern "C" {

// y: int64 [rows, lt, 2^logn] ŷ residues. out1 / out2: int64
// [rows, nlimbs, 2^logn]. twist / tw / pn: the forward NTT tables of the
// expanded tower (as for toyfhe_ntt_cluster). cst: uint32 [dnum, nlimbs,
// alpha] FBC constants (Montgomery form, zero-padded). km / kd: uint32
// [dnum, nlimbs, 2^logn] key duals times 2^32 mod p. bounds: int32 [dnum, 2]
// ct-limb range [lo, hi) of each digit group. digit_blocks: blocks of a
// cluster that share the digits of a pair (1, 2 or 4, at most dnum);
// poly_blocks: blocks that share its polynomial (1, 2 or 4, each keeping
// between 8 and 2^13 residues); one of the two is 1. lazy: every prime of the
// expanded tower is below 2^30; plan and kf: the pass plan of
// ops/ntt_cuda.py::schedule_plan for poly_blocks blocks. scratch: uint32,
// rows * nlimbs * digit_blocks * 2 * 2^logn words when 2^logn > 2^14 and
// poly_blocks is 1 (may be null otherwise). y, out1 / out2 must be 16-byte
// aligned, km / kd 8-byte aligned. Returns cudaGetLastError().
int toyfhe_hybrid_ks_cluster(const void* y, void* out1, void* out2, const void* twist,
                             const void* tw, const void* pn, const void* cst, const void* km,
                             const void* kd, const void* bounds, void* scratch, int rows, int lt,
                             int nlimbs, int dnum, int alpha, int logn, int digit_blocks,
                             int poly_blocks, int lazy, int plan, int kf, void* stream) {
  if (rows <= 0) return 0;
  int logg = 0, logc = 0;
  while ((1 << logg) < digit_blocks) ++logg;
  while ((1 << logc) < poly_blocks) ++logc;
  const ClusterKernel kern = cluster_kernel(kf, lazy);
  const int m = logn - logc;
  if (kern == nullptr || (1 << logg) != digit_blocks || (1 << logc) != poly_blocks ||
      (logg && logc) || logg > 2 || logc > 2 || digit_blocks > dnum || logn < 4 || m < 3 ||
      (logc && m > kMaxRegAccLog) || kf < logc || kf >= logn || plan <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = 1 << logn;
  const int per_block = 1 << m;
  const int two_rows = m <= kMaxRegAccLog;
  const bool parts = m > kMaxRegAccLog || logg;
  if (parts && logn > kMaxSmemPartLogN && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t words = static_cast<size_t>(two_rows ? 2 : 1) * per_block;
  if (parts && logn <= kMaxSmemPartLogN) words += 2 * static_cast<size_t>(n);
  const HksArgs args = {
      static_cast<const int64_t*>(y), static_cast<int64_t*>(out1), static_cast<int64_t*>(out2),
      static_cast<const uint32_t*>(twist), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(pn), static_cast<const uint32_t*>(cst),
      static_cast<const uint32_t*>(km), static_cast<const uint32_t*>(kd),
      static_cast<const int*>(bounds), static_cast<uint32_t*>(scratch),
      lt, nlimbs, dnum, alpha, logn, logg, logc, plan, two_rows};
  const int cluster = digit_blocks * poly_blocks;
  return static_cast<int>(toyfhe::cluster_launch(
      kern, rows * nlimbs * cluster, cluster, toyfhe::radix_threads(per_block),
      words * sizeof(uint32_t), static_cast<cudaStream_t>(stream), args));
}

// Registers a thread and static shared-memory bytes of one instantiation of
// the cluster kernel, into attrs[0..2).
int toyfhe_hybrid_ks_cluster_attrs(int kf, int lazy, void* attrs) {
  const ClusterKernel kern = cluster_kernel(kf, lazy);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return toyfhe::kernel_attrs(kern, attrs);
}

}  // extern "C"
