// Fast base conversion (ModUp) of the dnum-grouped hybrid key switch for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves this step to XLA
// (toyfhe_tpu/core/hybrid.py:148, HybridRaised.hybrid_decompose, a broadcast
// product and a sum that XLA fuses without writing the product). For each
// batch row r, digit group j = [lo, hi) of the ciphertext tower and target row
// t of the expanded tower Q_t U P it computes
//
//   D_j[r, t] = sum_{a in [lo, hi)} y^[r, a] [Q_j/q_a]_{p_t}  mod p_t,
//   y^[r, a]  = x[r, a] [(Q_j/q_a)^-1]_{q_a}                  mod q_a,
//
// canonical, equal bit for bit to ops/fbc_cuda.py::fbc_plain (the torch
// formula of the engine's and the compiled layers' decompositions). The
// constants are Montgomery words (R = 2^32), so one REDC gives each product.
//
// What bounds it on this card: device-memory bytes, nearly all of them the
// output (T rows a digit for lt rows read: at the ResNet's top, T = 66 target
// rows for alpha = 5 ciphertext rows, so 13 times as many bytes are written as
// read). The torch formula it replaces wrote an int64 [.., T, alpha, N]
// product and ran it through four elementwise passes and a reduction. What the
// design does about it:
//
//  * Each residue is read once and each output word written once: a thread
//    takes two neighbouring coefficients of one row and one digit (one 16-byte
//    load a ciphertext row, neighbouring threads on neighbouring pairs),
//    forms y^ in registers (the premultiply fused into the load; a caller that
//    already holds y^ passes premultiply = 0), keeps the digit's alpha pairs
//    in registers and loops over the T targets, storing 16 bytes a target.
//  * 32-bit Montgomery products without the closing correction: y^ < 2^31
//    and the constant below p_t < 2^31, so y^ c + m p_t < 2^64 and the REDC
//    value is below 1.5 p_t. A digit sums at most kMaxA of them in 64 bits
//    (below 12 p_t) and reduces the sum once, by four conditional
//    subtractions. A group wider than kMaxA rows takes kMaxA at a time and
//    adds into the words it stored (below 13 p_t before the reduction).
//  * The digit's constants and the target primes are staged in shared memory
//    once a block: every thread of the block reads the same word at a time.
//  * The output layout is an argument, so no caller copies: digits first
//    [dnum, rows, T, N] (the engine), digits inside [rows, dnum, T, N] (the
//    compiled layers), or digits first without each group's own rows
//    [rows, T - w_j, N] one after the other (skip = 1: the engine's dual
//    decomposition, which takes those rows from x's own dual).
//
// Measured: see PERF.md (chip_smoke.py phase 41).

#include "common.cuh"

namespace {

using toyfhe::mont_mul;
using toyfhe::redc_lazy;

constexpr int kMaxA = 8;          // ciphertext rows of a digit held in registers at once
constexpr int kThreads = 256;     // most threads a block runs

struct FbcArgs {
  const int64_t* x;       // [rows, lt, N] residues (or y^ when premultiply == 0)
  int64_t* out;
  const uint32_t* tab;    // qn [lt, 2] | pn [nt, 2] | inv [lt] | cst [dnum, nt, alpha] | bounds [dnum, 4]
  int rows, lt, nt, dnum, alpha, logn;
  int premultiply;        // form y^ from x in the load
  int digits_inner;       // output [rows, dnum, nt, N] (else digits first)
  int skip;               // leave out each group's own target rows
};

// s < 16 p  ->  s mod p
__device__ __forceinline__ uint64_t reduce16(uint64_t s, uint32_t p) {
  const uint64_t q = p;
  if (s >= 8 * q) s -= 8 * q;
  if (s >= 4 * q) s -= 4 * q;
  if (s >= 2 * q) s -= 2 * q;
  if (s >= q) s -= q;
  return s;
}

__global__ void __launch_bounds__(kThreads) fbc_kernel(const FbcArgs k) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << k.logn;
  const int tiles = (n / 2 + blockDim.x - 1) / blockDim.x;
  const int tile = blockIdx.x % tiles;
  const int j = (blockIdx.x / tiles) % k.dnum;
  const int r = blockIdx.x / tiles / k.dnum;

  const uint32_t* qn = k.tab;
  const uint32_t* pn = qn + 2 * k.lt;
  const uint32_t* inv = pn + 2 * k.nt;
  const uint32_t* cst = inv + k.lt;
  const int* bounds = reinterpret_cast<const int*>(cst + static_cast<size_t>(k.dnum) * k.nt * k.alpha);
  const int lo = bounds[4 * j], hi = bounds[4 * j + 1];
  const int slo = k.skip ? bounds[4 * j + 2] : 0;
  const int shi = k.skip ? bounds[4 * j + 3] : 0;

  uint32_t* s_pn = sm;                       // [nt, 2]
  uint32_t* s_c = sm + 2 * k.nt;             // [nt, alpha] of digit j
  const uint32_t* cj = cst + static_cast<size_t>(j) * k.nt * k.alpha;
  for (int i = threadIdx.x; i < 2 * k.nt; i += blockDim.x) s_pn[i] = pn[i];
  for (int i = threadIdx.x; i < k.nt * k.alpha; i += blockDim.x) s_c[i] = cj[i];
  __syncthreads();

  const int u = tile * blockDim.x + threadIdx.x;      // coefficient pair
  if (2 * u >= n) return;

  size_t base, rstride;
  if (k.digits_inner) {
    base = static_cast<size_t>(j) * k.nt * n;
    rstride = static_cast<size_t>(k.dnum) * k.nt * n;
  } else {
    size_t before = 0;                       // output rows of the digits before j
    for (int i = 0; i < j; ++i) before += k.nt - (k.skip ? bounds[4 * i + 3] - bounds[4 * i + 2] : 0);
    base = before * k.rows * n;
    rstride = static_cast<size_t>(k.nt - (shi - slo)) * n;
  }
  int64_t* out = k.out + base + r * rstride + 2 * u;
  const int64_t* xr = k.x + static_cast<size_t>(r) * k.lt * n + 2 * u;

  for (int a0 = lo; a0 < hi; a0 += kMaxA) {
    const int w = min(kMaxA, hi - a0);
    uint32_t y0[kMaxA], y1[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      y0[a] = y1[a] = 0;
      if (a < w) {
        const longlong2 v = *reinterpret_cast<const longlong2*>(xr + static_cast<size_t>(a0 + a) * n);
        y0[a] = static_cast<uint32_t>(v.x);
        y1[a] = static_cast<uint32_t>(v.y);
      }
    }
    if (k.premultiply) {
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) {
        if (a < w) {
          const uint32_t q = __ldg(qn + 2 * (a0 + a)), qi = __ldg(qn + 2 * (a0 + a) + 1);
          const uint32_t c = __ldg(inv + a0 + a);
          y0[a] = mont_mul(y0[a], c, q, qi);
          y1[a] = mont_mul(y1[a], c, q, qi);
        }
      }
    }
    const uint32_t* ca = s_c + (a0 - lo);
    for (int t = 0; t < k.nt; ++t) {
      if (t >= slo && t < shi) continue;
      const uint32_t p = s_pn[2 * t], ninv = s_pn[2 * t + 1];
      uint64_t s0 = 0, s1 = 0;
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) {
        if (a < w) {
          const uint32_t c = ca[t * k.alpha + a];
          s0 += redc_lazy(y0[a], c, p, ninv);
          s1 += redc_lazy(y1[a], c, p, ninv);
        }
      }
      longlong2* dst = reinterpret_cast<longlong2*>(
          out + static_cast<size_t>(t < slo ? t : t - (shi - slo)) * n);
      if (a0 != lo) {
        const longlong2 prev = *dst;
        s0 += static_cast<uint64_t>(prev.x);
        s1 += static_cast<uint64_t>(prev.y);
      }
      *dst = make_longlong2(static_cast<long long>(reduce16(s0, p)),
                            static_cast<long long>(reduce16(s1, p)));
    }
  }
}

}  // namespace

extern "C" {

// x: int64 [rows, lt, 2^logn], 16-byte aligned. out: int64, 16-byte aligned:
// [dnum, rows, nt, 2^logn] (digits_inner = 0, skip = 0), [rows, dnum, nt,
// 2^logn] (digits_inner = 1), or per digit j in turn [rows, nt - w_j, 2^logn]
// without the target rows [skip_lo_j, skip_hi_j) (skip = 1). tab: uint32, the
// ct primes and -q^-1 mod 2^32 [lt, 2], the target primes and -p^-1 mod 2^32
// [nt, 2], the y^ premultipliers [lt] and the conversion constants [dnum, nt,
// alpha] (both Montgomery form, the constants zero-padded), then int32 bounds
// [dnum, 4]: each group's ct rows [lo, hi) and its own rows among the targets
// [skip_lo, skip_hi). Every prime below 2^31. Returns cudaGetLastError().
int toyfhe_fbc(const void* x, void* out, const void* tab, int rows, int lt, int nt, int dnum,
               int alpha, int logn, int premultiply, int digits_inner, int skip, void* stream) {
  if (rows <= 0 || dnum <= 0) return 0;
  if (logn < 4 || logn > 30 || lt <= 0 || nt <= 0 || alpha <= 0 || (digits_inner && skip)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pairs = 1 << (logn - 1);
  const int threads = pairs < kThreads ? pairs : kThreads;
  const long long blocks =
      static_cast<long long>((pairs + threads - 1) / threads) * dnum * rows;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(nt) * (2 + alpha) * sizeof(uint32_t);
  const cudaError_t e = toyfhe::allow_smem(fbc_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const FbcArgs args = {static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
                        static_cast<const uint32_t*>(tab), rows, lt, nt, dnum, alpha, logn,
                        premultiply, digits_inner, skip};
  fbc_kernel<<<static_cast<unsigned>(blocks), threads, smem,
               static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
