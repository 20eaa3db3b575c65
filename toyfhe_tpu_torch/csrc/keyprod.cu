// Key products of the hybrid key switch for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves this step to XLA
// (toyfhe_tpu/core/rlwe.py, _keyswitch_hybrid and the hoisted rotations'
// key contraction, a broadcast product and a sum over the digit axis). For
// each leading row r, row t of the expanded tower Q_t U P and coefficient n,
// with the digit duals d (dnum of them), the key rows km / kd (mask / masked)
// and an optional permutation pi of the coefficients (a rotation's Galois
// map in the dual domain) it computes
//
//   out[0, r, t, n] = (acc[0, r, t, n] + sum_j kd[j, t, n] d[j, r, t, pi(n)]) mod p_t
//   out[1, r, t, n] = (acc[1, r, t, n] + sum_j km[j, t, n] d[j, r, t, pi(n)]) mod p_t
//
// (acc zero when not given; it may be out itself), canonical, equal bit for
// bit to ops/keyprod_cuda.py::key_products_plain, the torch formula the
// engine's, the compiled layers' and the fused square step's key switches
// ran before this kernel. Every input is canonical below p_t < 2^31.
//
// What bounds it on this card: device-memory bytes. Each digit residue, each
// key word and each output word has to cross once; the work is two 32-bit
// Montgomery products a digit word. The torch formula it replaces wrote the
// int64 [dnum, .., T, N] product twice (once a component), reduced each
// element by two int64 divisions, summed it in a separate reduction, and in
// a rotation first copied the digit tensor through a gather. What the design
// does about it:
//
//  * One block a (row t, leading row r) pair, N / C threads, each holding C
//    coefficients n = tid + i N / C. The digit loop runs inside the block and
//    both components' sums live in 2 C registers across it, so each digit
//    word is read once for both keys and each output word written once.
//    Blocks of one row t are neighbours in the grid, so the key rows, read by
//    every leading row, come from L2 after the first.
//  * 32-bit Montgomery arithmetic with per-row constants: each product is one
//    REDC (k d R^-1, canonical) added mod p into its sum, and the sum leaves
//    the Montgomery scale by one more product with R^2 mod p at the end. No
//    division, no 64-bit product in memory, the keys as they are stored.
//  * The Galois permutation is read in place: the block stages each digit
//    row in shared memory (N 32-bit words, loaded coalesced, the next row's
//    loads in flight while the current one is used) and every thread reads
//    its coefficients at pi(n). For pi(n) = g n + c mod N with g odd (every
//    Galois map) a warp's 32 reads hit 32 banks. Without pi the digits are
//    read straight from device memory.
//  * The digit axis may come first, [dnum, rows, T, N] (the engine), or after
//    the leading axes, [rows, dnum, T, N] (the compiled layers and the fused
//    square step): a stride, so no caller copies.
//
// Measured: see PERF.md (chip_smoke.py phase 42).

#include "common.cuh"

namespace {

using toyfhe::add_mod;
using toyfhe::mont_mul;

constexpr int kMaxThreads = 1024;

struct KpArgs {
  const int64_t* d;       // digit duals, [dnum, rows, nt, N] or [rows, dnum, nt, N]
  const int64_t* km;      // mask key rows [dnum, nt, N]
  const int64_t* kd;      // masked key rows [dnum, nt, N]
  const int64_t* perm;    // [N] source coefficient of each output, or null
  const int64_t* acc;     // [2, rows, nt, N] added to the sums, or null (may be out)
  int64_t* out;           // [2, rows, nt, N]
  const uint32_t* tab;    // [nt, 3]: p, -p^-1 mod 2^32, 2^64 mod p
  int rows, nt, dnum, logn, digits_inner;
};

__device__ __forceinline__ uint32_t ld32(const int64_t* p) {
  return static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

template <int C, bool kPerm>
__global__ void __launch_bounds__(kMaxThreads) keyprod_kernel(const KpArgs k) {
  extern __shared__ uint32_t s_row[];                 // kPerm: one digit row, N words
  const int n = 1 << k.logn;
  const int nthr = n / C;
  const int tid = threadIdx.x;
  const int r = blockIdx.x % k.rows;
  const int t = blockIdx.x / k.rows;
  const uint32_t p = __ldg(k.tab + 3 * t), ninv = __ldg(k.tab + 3 * t + 1);
  const uint32_t r2 = __ldg(k.tab + 3 * t + 2);

  const size_t row_words = static_cast<size_t>(k.nt) * n;
  const size_t jstride = k.digits_inner ? row_words : static_cast<size_t>(k.rows) * row_words;
  const int64_t* dr = k.d + (k.digits_inner ? static_cast<size_t>(r) * k.dnum * row_words
                                            : static_cast<size_t>(r) * row_words)
                      + static_cast<size_t>(t) * n;
  const int64_t* kmr = k.km + static_cast<size_t>(t) * n;
  const int64_t* kdr = k.kd + static_cast<size_t>(t) * n;

  int src[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = tid + i * nthr;
    src[i] = kPerm ? static_cast<int>(__ldg(reinterpret_cast<const long long*>(k.perm) + c)) : c;
  }
  uint32_t a1[C], a2[C], nxt[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    a1[i] = a2[i] = 0;
    if (kPerm) nxt[i] = ld32(dr + tid + i * nthr);
  }

  for (int j = 0; j < k.dnum; ++j) {
    const int64_t* dj = dr + j * jstride;
    uint32_t v[C];
    if (kPerm) {
      __syncthreads();                                // the last row is read
#pragma unroll
      for (int i = 0; i < C; ++i) s_row[tid + i * nthr] = nxt[i];
      __syncthreads();
      if (j + 1 < k.dnum) {
#pragma unroll
        for (int i = 0; i < C; ++i) nxt[i] = ld32(dj + jstride + tid + i * nthr);
      }
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = s_row[src[i]];
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = ld32(dj + src[i]);
    }
    const size_t kj = static_cast<size_t>(j) * row_words;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = tid + i * nthr;
      a1[i] = add_mod(a1[i], mont_mul(ld32(kdr + kj + c), v[i], p, ninv), p);
      a2[i] = add_mod(a2[i], mont_mul(ld32(kmr + kj + c), v[i], p, ninv), p);
    }
  }

  const size_t comp = static_cast<size_t>(k.rows) * row_words;
  const size_t o = static_cast<size_t>(r) * row_words + static_cast<size_t>(t) * n;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const size_t c = o + tid + i * nthr;
    uint32_t x1 = mont_mul(a1[i], r2, p, ninv);       // sum k d R^-1  ->  sum k d
    uint32_t x2 = mont_mul(a2[i], r2, p, ninv);
    if (k.acc != nullptr) {                           // plain loads: acc may be out
      x1 = add_mod(x1, static_cast<uint32_t>(k.acc[c]), p);
      x2 = add_mod(x2, static_cast<uint32_t>(k.acc[comp + c]), p);
    }
    k.out[c] = x1;
    k.out[comp + c] = x2;
  }
}

template <int C>
cudaError_t launch(const KpArgs& a, unsigned blocks, cudaStream_t stream) {
  const int n = 1 << a.logn;
  if (a.perm != nullptr) {
    const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
    const cudaError_t e = toyfhe::allow_smem(keyprod_kernel<C, true>, smem);
    if (e != cudaSuccess) return e;
    keyprod_kernel<C, true><<<blocks, n / C, smem, stream>>>(a);
  } else {
    keyprod_kernel<C, false><<<blocks, n / C, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d: int64 digit duals, [dnum, rows, nt, 2^logn] (digits_inner = 0) or [rows,
// dnum, nt, 2^logn] (digits_inner = 1). km, kd: int64 [dnum, nt, 2^logn].
// perm: int64 [2^logn], a permutation of the coefficients, or null. acc: int64
// [2, rows, nt, 2^logn] or null; it may be out. out: int64 [2, rows, nt,
// 2^logn]. tab: uint32 [nt, 3], each row's prime p < 2^31, -p^-1 mod 2^32 and
// 2^64 mod p. Every residue canonical. Returns cudaGetLastError().
int toyfhe_keyprod(const void* d, const void* km, const void* kd, const void* perm,
                   const void* acc, void* out, const void* tab, int rows, int nt, int dnum,
                   int logn, int digits_inner, void* stream) {
  if (rows <= 0 || nt <= 0) return 0;
  if (logn < 4 || logn > 15 || dnum <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(rows) * nt;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const KpArgs args = {static_cast<const int64_t*>(d), static_cast<const int64_t*>(km),
                       static_cast<const int64_t*>(kd), static_cast<const int64_t*>(perm),
                       static_cast<const int64_t*>(acc), static_cast<int64_t*>(out),
                       static_cast<const uint32_t*>(tab), rows, nt, dnum, logn, digits_inner};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  // C coefficients a thread: N / C threads, at most kMaxThreads
  if (logn <= 13) return static_cast<int>(launch<8>(args, b, s));
  if (logn == 14) return static_cast<int>(launch<16>(args, b, s));
  return static_cast<int>(launch<32>(args, b, s));
}

}  // extern "C"
