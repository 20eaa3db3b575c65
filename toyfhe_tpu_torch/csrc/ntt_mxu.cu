// Forward four-step negacyclic NTT from int8 digit matrices on the int8
// tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel K2, toyfhe_tpu/ops/ntt_mxu_pallas.py::
// ntt_mxu_pallas (body _fwd_kernel). With N = 128 * n2 and the coefficient
// block of one (limb, row) laid out as X[j1, j2] (128 x n2):
//
//   X  <- X (.) psi                                  psi-twist
//   A[k1, j2] = sum_j1 W1[j1, k1] * X[j1, j2] mod p  stage 1
//   B[k1, j2] = A[k1, j2] * omega^(k1 j2)            twiddle
//   C[k1, k2] = sum_j2 B[k1, j2] * W2[j2, k2] mod p  stage 2
//
// and C is stored in (k1, k2) order. As in the TPU kernel the two modular
// matrix products are exact integer products of balanced base-256 digits
// (int8): the data is split into 4 digit planes, the 16 digit x digit
// products are summed into 7 diagonal groups (d + e = s), and the groups
// recombine to the residue by one of two forms, chosen by the caller: the
// 7-term form (each group offset by 2^23, seven 32 x 32 -> 64 products) or
// the paired form (adjacent groups folded into int32 with weights 2^16t,
// offset by 2^31, two products and two shifts), both followed by two
// Montgomery reductions of the 64-bit sum and the subtraction of the offsets'
// sum. The (hi, lo) word pairs of the TPU kernel are a native uint64 here.
// The result is the canonical residue, equal to the plain twin and to the
// radix-2 transform bit for bit.
//
// The digit products are mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32:
// mma.sync and not wgmma, because the 7 diagonal groups of a 16 x 16 warp
// tile are 56 accumulator registers a thread, which sixteen independent
// warps hold without spilling, while a wgmma tile of 64 rows would need 7
// accumulators of 64 x n for one warpgroup and the operands already sit in
// shared memory in the K-contiguous form mma.sync reads with plain 32-bit
// loads. Both stages are  D[k1, n] = sum_k A[k1, k] B[n, k]:
//
//   stage 1: A = W1 (symmetric: row k1 holds its 128 j1 contiguous),
//            B = the X digit planes stored [j2][j1], K = 128;
//   stage 2: A = the B digit planes stored [k1][j2], B = W2 (row k2 holds
//            its j2 contiguous), K = n2 zero-padded to a multiple of 32.
//
// An A fragment register is the 32-bit word of 4 consecutive k at (row g or
// g + 8, k0 + 4 tig or + 16), a B fragment register the word at (row n = g,
// k0 + 4 tig or + 16), with g = lane / 4 and tig = lane % 4; every row is
// padded by 16 bytes so that the 8 rows x 4 words of one fragment load fall
// into 32 different banks. A warp owns a 16 x 16 tile of D at a time: per
// 32-deep step it loads the 4 B digit words of both 8-column halves once and
// runs the 16 (d, e) products of each half into accumulator d + e, 32 mma
// for 32 fragment loads. The accumulators of group s stay below 4 * 128 *
// 2^14 = 2^23 in magnitude.
//
// One block of 16 warps per (limb, chunk of rows); it walks over the rows of
// its chunk (the host sizes the chunks so that the blocks come near the 132
// SMs). Shared memory holds three regions: W1's digit planes (72 KB, loaded
// once a block with cp.async), the stage-1 data planes, and the stage-2 data
// planes. W2's digit planes are copied with cp.async over the stage-1 data
// planes once stage 1 has finished with them, once a row: at N = 2^14 the
// four regions would need 288 KB, and W2 (at most 72 KB, resident in L2) is
// the one whose reload is cheapest. At N = 2^14 that is 216 KB a block. The
// padding of the K and N dimensions needs no zeroing of the data planes: W2
// is stored zero-padded along K, and padded output columns are not stored.
// The twist, the digit extraction, the omega^(k1 j2) twiddle and the
// recombination run on the CUDA cores between the products, and nothing
// goes to device memory between the stages; stage 2 stores int64 residues
// 16 bytes a thread.
//
// What bounds it on this card: no longer the products. One polynomial of
// N = 2^14 is 16,384 mma of 8,192 int8 operations, about 10 microseconds of
// one SM's tensor cores, against 2 * 16,384 recombinations of some 60
// 32-bit operations each on the CUDA cores and the shared-memory traffic
// of the fragment loads, which take as long or longer. Measured
// (chip_smoke.py phase 24, graph-replayed device time, NVIDIA H100 80GB HBM3,
// 700 W): 128 polynomials of N = 2^14, one a block, take 44 to 47
// microseconds in either recombination (the __dp4a kernel this replaces: 319
// to 380 a launch), 124 / 126 registers a thread, no spills. The next step is
// to overlap the products with the recombination (a warp-specialised split)
// rather than a faster product.

#include "common.cuh"

namespace {

using toyfhe::add_mod;
using toyfhe::mont_mul;

constexpr int kN1 = 128;            // stage-1 edge
constexpr int kDigits = 4;
constexpr int kGroups = 2 * kDigits - 1;
constexpr int kRowPad = 16;         // bytes added to every operand row
constexpr int kStrideW = kN1 + kRowPad;   // bytes per row of W1 and of a stage-1 plane
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kScalars = 16;        // uint32 words per limb in the constant table
constexpr uint32_t kOffset = 1u << 23;

struct LimbConsts {
  uint32_t p, ninv, corr, r1m, him, cs32, cs48, corr2;
  uint32_t cs[kGroups];
};

__device__ __forceinline__ LimbConsts load_consts(const uint32_t* sc) {
  LimbConsts c;
  c.p = sc[0]; c.ninv = sc[1]; c.corr = sc[2]; c.r1m = sc[3]; c.him = sc[4];
  c.cs32 = sc[5]; c.cs48 = sc[6]; c.corr2 = sc[7];
  for (int s = 0; s < kGroups; ++s) c.cs[s] = sc[8 + s];
  return c;
}

// sum_s 2^(8s) g[s] mod p from the 7 diagonal groups.
template <bool kPaired>
__device__ __forceinline__ uint32_t combine(const int32_t* g, const LimbConsts& c) {
  uint64_t total;
  uint32_t corr;
  if (kPaired) {
    const uint32_t hp0 = static_cast<uint32_t>(g[0] + g[1] * 256) + 0x80000000u;
    const uint32_t hp1 = static_cast<uint32_t>(g[2] + g[3] * 256) + 0x80000000u;
    const uint32_t hp2 = static_cast<uint32_t>(g[4] + g[5] * 256) + 0x80000000u;
    const uint32_t hp3 = static_cast<uint32_t>(g[6]) + 0x80000000u;
    total = static_cast<uint64_t>(hp0) + (static_cast<uint64_t>(hp1) << 16) +
            static_cast<uint64_t>(hp2) * c.cs32 + static_cast<uint64_t>(hp3) * c.cs48;
    corr = c.corr2;
  } else {
    total = 0;
#pragma unroll
    for (int s = 0; s < kGroups; ++s) {
      total += static_cast<uint64_t>(static_cast<uint32_t>(g[s]) + kOffset) * c.cs[s];
    }
    corr = c.corr;
  }
  const uint32_t t1 = mont_mul(static_cast<uint32_t>(total), c.r1m, c.p, c.ninv);
  const uint32_t t2 = mont_mul(static_cast<uint32_t>(total >> 32), c.him, c.p, c.ninv);
  const uint32_t v = add_mod(t1, t2, c.p);
  return v >= corr ? v - corr : v + (c.p - corr);
}

// The four balanced base-256 digits of v < 2^30, lowest first.
__device__ __forceinline__ void digits_of(uint32_t v, int32_t (&dig)[kDigits]) {
  int32_t cur = static_cast<int32_t>(v);
#pragma unroll
  for (int d = 0; d < kDigits; ++d) {
    int32_t r = cur & 255;
    r -= (r & 128) << 1;                      // [128, 255] -> [-128, -1]
    dig[d] = r;
    cur = (cur - r) >> 8;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// Start the copy of `bytes` (a multiple of 16) from device to shared memory.
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) cp_async16(dst + i, src + i);
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// D (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col).
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word_at(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The 7 diagonal groups of the 16 x 16 tile (rows m0.., columns n0..) of
// sum_k A[row, k] B[col, k] over ksteps steps of 32: acc[half][s][i] is
// fragment register i of the 8-column half `half` of group s. a / b point at
// digit plane 0; planes are plane_a / plane_b bytes apart, rows stride_a /
// stride_b bytes.
__device__ __forceinline__ void tile_groups(int32_t (&acc)[2][kGroups][4],
                                            const unsigned char* a, int plane_a, int stride_a,
                                            const unsigned char* b, int plane_b, int stride_b,
                                            int m0, int n0, int ksteps) {
  const int g = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
  __syncwarp();                               // mma.sync needs the whole warp
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < kGroups; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][s][i] = 0;
  const unsigned char* arow = a + (m0 + g) * stride_a + 4 * tig;
  const unsigned char* brow = b + (n0 + g) * stride_b + 4 * tig;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bf[kDigits][2][2];
#pragma unroll
    for (int e = 0; e < kDigits; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* q = brow + e * plane_b + h * 8 * stride_b + ks * 32;
        bf[e][h][0] = word_at(q);
        bf[e][h][1] = word_at(q + 16);
      }
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      const unsigned char* q = arow + d * plane_a + ks * 32;
      const uint32_t af[4] = {word_at(q), word_at(q + 8 * stride_a), word_at(q + 16),
                              word_at(q + 8 * stride_a + 16)};
#pragma unroll
      for (int e = 0; e < kDigits; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) mma_s8(acc[h][d + e], af, bf[e][h]);
    }
  }
}

template <bool kPaired>
__global__ void __launch_bounds__(kThreads)
ntt_mxu_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ psis,
               int64_t* __restrict__ out, const unsigned char* __restrict__ w1,
               const unsigned char* __restrict__ w2, const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ sc, int rows, int n2, int n2p, int k2pad,
               int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.x;
  const int n = kN1 * n2;
  const int plane_w1 = kN1 * kStrideW;        // bytes, W1 plane [k1][j1]
  const int plane_a = n2p * kStrideW;         // stage-1 data plane [j2][j1]
  const int stride_b = k2pad + kRowPad;       // bytes per row of a stage-2 operand
  const int plane_b = kN1 * stride_b;         // stage-2 data plane [k1][j2]
  const int plane_w2 = n2p * stride_b;        // W2 plane [k2][j2]
  unsigned char* sw1 = smem;
  unsigned char* pa = sw1 + kDigits * plane_w1;
  unsigned char* pb = pa + kDigits * plane_a;
  unsigned char* sw2 = pa;                    // over the stage-1 planes, after stage 1

  const LimbConsts c = load_consts(sc + l * kScalars);
  const int64_t* psl = psis + static_cast<size_t>(l) * n;
  const uint32_t* twl = tw + static_cast<size_t>(l) * n;
  const unsigned char* w2l = w2 + static_cast<size_t>(l) * kDigits * plane_w2;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
  const int ntiles = (kN1 / 16) * (n2p / 16);

  copy_async(sw1, w1 + static_cast<size_t>(l) * kDigits * plane_w1, kDigits * plane_w1);

  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (int r = r0; r < r1; ++r) {
    const int64_t* xin = x + (static_cast<size_t>(l) * rows + r) * n;
    int64_t* xout = out + (static_cast<size_t>(l) * rows + r) * n;

    // twist and digits: a thread takes 4 consecutive j1 of one j2 and stores
    // one 32-bit word a plane; a warp walks consecutive j2
    for (int item = threadIdx.x; item < (kN1 / 4) * n2; item += blockDim.x) {
      const int j1q = item / n2;
      const int j2 = item - j1q * n2;
      uint32_t word[kDigits] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = (4 * j1q + t) * n2 + j2;
        const uint32_t v = mont_mul(static_cast<uint32_t>(xin[i]),
                                    static_cast<uint32_t>(psl[i]), c.p, c.ninv);
        int32_t dig[kDigits];
        digits_of(v, dig);
#pragma unroll
        for (int d = 0; d < kDigits; ++d) word[d] |= static_cast<uint32_t>(dig[d] & 255) << (8 * t);
      }
#pragma unroll
      for (int d = 0; d < kDigits; ++d) {
        *reinterpret_cast<uint32_t*>(pa + d * plane_a + j2 * kStrideW + 4 * j1q) = word[d];
      }
    }
    copy_wait();                              // W1, at the block's first row
    __syncthreads();

    // stage 1: D[k1, j2], then the twiddle and B's digits
    for (int tile = warp; tile < ntiles; tile += kWarps) {
      const int m0 = (tile & 7) * 16;
      const int n0 = (tile >> 3) * 16;
      int32_t acc[2][kGroups][4];
      tile_groups(acc, sw1, plane_w1, kStrideW, pa, plane_a, kStrideW, m0, n0, kN1 / 32);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k1 = m0 + g + (i >> 1) * 8;
          const int j2 = n0 + h * 8 + 2 * tig + (i & 1);
          if (j2 < n2) {
            int32_t grp[kGroups];
#pragma unroll
            for (int s = 0; s < kGroups; ++s) grp[s] = acc[h][s][i];
            const uint32_t a = combine<kPaired>(grp, c);
            const uint32_t b = mont_mul(a, __ldg(twl + k1 * n2 + j2), c.p, c.ninv);
            int32_t dig[kDigits];
            digits_of(b, dig);
#pragma unroll
            for (int d = 0; d < kDigits; ++d) {
              pb[d * plane_b + k1 * stride_b + j2] = static_cast<unsigned char>(dig[d] & 255);
            }
          }
        }
    }
    __syncthreads();                          // every warp is done with the stage-1 planes

    copy_async(sw2, w2l, kDigits * plane_w2);
    copy_wait();
    __syncthreads();

    // stage 2: C[k1, k2], stored as int64, two neighbouring k2 a store
    for (int tile = warp; tile < ntiles; tile += kWarps) {
      const int m0 = (tile & 7) * 16;
      const int n0 = (tile >> 3) * 16;
      int32_t acc[2][kGroups][4];
      tile_groups(acc, pb, plane_b, stride_b, sw2, plane_w2, stride_b, m0, n0, k2pad / 32);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k1 = m0 + g + half * 8;
          const int k2 = n0 + h * 8 + 2 * tig;
          if (k2 < n2) {
            int32_t grp[kGroups];
#pragma unroll
            for (int s = 0; s < kGroups; ++s) grp[s] = acc[h][s][2 * half];
            const uint32_t v0 = combine<kPaired>(grp, c);
            if (k2 + 1 < n2) {
#pragma unroll
              for (int s = 0; s < kGroups; ++s) grp[s] = acc[h][s][2 * half + 1];
              const uint32_t v1 = combine<kPaired>(grp, c);
              *reinterpret_cast<longlong2*>(xout + k1 * n2 + k2) =
                  make_longlong2(static_cast<long long>(v0), static_cast<long long>(v1));
            } else {
              xout[k1 * n2 + k2] = static_cast<int64_t>(v0);
            }
          }
        }
    }
    __syncthreads();                          // the next row overwrites all three planes
  }
  copy_wait();
}

}  // namespace

extern "C" {

// x / out: int64 [nlimbs, rows, 128, n2]; psis: int64 [nlimbs, 128, n2]
// (Montgomery form). w1: int8 [nlimbs, 4, 128, 144] and w2: int8
// [nlimbs, 4, n2p, k2pad + 16] digit matrices, row = output index, the
// contraction index contiguous and zero-padded; n2p = max(n2, 16) output
// rows, k2pad = max(n2, 32). tw: uint32 [nlimbs, 128, n2]. sc: uint32
// [nlimbs, 16] = p, ninv, corr, r1_mont, hi_mont, cs32, cs48, corr2,
// cs[0..7), 0. A block takes rows_per_block rows of one limb. out must be
// 16-byte aligned. Returns cudaGetLastError() after the launch.
int toyfhe_ntt_mxu(const void* x, const void* psis, void* out, const void* w1,
                   const void* w2, const void* tw, const void* sc, int nlimbs,
                   int rows, int n2, int n2p, int k2pad, int rows_per_block, int paired,
                   void* stream) {
  if (nlimbs <= 0 || rows <= 0) return 0;
  if (n2p % 16 || k2pad % 32 || n2p < n2 || k2pad < n2 || k2pad > kN1 || rows_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kDigits) *
                      (static_cast<size_t>(kN1) * kStrideW + static_cast<size_t>(n2p) * kStrideW +
                       static_cast<size_t>(kN1) * (k2pad + kRowPad));
  void (*kern)(const int64_t*, const int64_t*, int64_t*, const unsigned char*,
               const unsigned char*, const uint32_t*, const uint32_t*, int, int, int, int, int) =
      paired ? ntt_mxu_kernel<true> : ntt_mxu_kernel<false>;
  const cudaError_t e = toyfhe::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (rows + rows_per_block - 1) / rows_per_block;
  kern<<<dim3(nlimbs, chunks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(psis),
      static_cast<int64_t*>(out), static_cast<const unsigned char*>(w1),
      static_cast<const unsigned char*>(w2), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(sc), rows, n2, n2p, k2pad, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread of the kernel of one recombination, into attrs[0].
int toyfhe_ntt_mxu_attrs(int paired, void* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e = paired
      ? cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(ntt_mxu_kernel<true>))
      : cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(ntt_mxu_kernel<false>));
  if (e != cudaSuccess) return static_cast<int>(e);
  static_cast<int*>(attrs)[0] = fa.numRegs;
  return 0;
}

}  // extern "C"
