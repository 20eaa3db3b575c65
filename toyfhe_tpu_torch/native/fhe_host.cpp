// Host CRT runtime of toyfhe_tpu_torch, the port's own copy of the
// reference's toyfhe_tpu/native/fhe_host.cpp with the same C ABI: exact
// big-integer work at the host/device seam, the role FLINT/Nemo plays in
// ToyFHE.jl (SURVEY §2.8). The routines cover the host decode paths that
// need a full CRT reconstruction:
//
//   * BFV decode:   round(centered(CRT(x)) / Δ) mod p      (bfv.jl:26-29)
//   * BGV decode:   centered(CRT(x)) mod p                 (bgv.jl:22-25)
//   * CKKS decode:  centered(CRT(x)) as double             (ckksencoding.jl:56-66)
//   * noise meter:  max |centered residue from the Δ lattice| (bfv.jl:136-164)
//
// Fixed-size multiprecision arithmetic (64-bit limbs, up to MAXW words ≈
// 2048-bit moduli), no external dependency, a plain C ABI for ctypes.
// big_to_double folds the words high to low, rounding at every step; the
// decodes keep that rounding so that they return the reference's doubles.
//
// Build: g++ -O3 -shared -fPIC -o libfhe_host.so fhe_host.cpp

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

constexpr int MAXW = 32;   // 32 × 64-bit words = 2048-bit headroom

struct Big {
    uint64_t w[MAXW];
    int n;                 // active words
};

inline void big_zero(Big &a) { std::memset(a.w, 0, sizeof(a.w)); a.n = 1; }

inline void big_from_u64(Big &a, uint64_t v) { big_zero(a); a.w[0] = v; a.n = v ? 1 : 1; }

inline void big_trim(Big &a) {
    while (a.n > 1 && a.w[a.n - 1] == 0) a.n--;
}

inline int big_cmp(const Big &a, const Big &b) {
    int n = a.n > b.n ? a.n : b.n;
    for (int i = n - 1; i >= 0; --i) {
        uint64_t x = i < a.n ? a.w[i] : 0, y = i < b.n ? b.w[i] : 0;
        if (x != y) return x < y ? -1 : 1;
    }
    return 0;
}

inline void big_add(Big &a, const Big &b) {          // a += b
    unsigned __int128 carry = 0;
    int n = a.n > b.n ? a.n : b.n;
    for (int i = 0; i < n; ++i) {
        unsigned __int128 s = (unsigned __int128)a.w[i] + (i < b.n ? b.w[i] : 0) + (uint64_t)carry;
        a.w[i] = (uint64_t)s;
        carry = s >> 64;
    }
    a.n = n;
    if (carry && n < MAXW) { a.w[n] = (uint64_t)carry; a.n = n + 1; }
}

inline void big_sub(Big &a, const Big &b) {          // a -= b  (a >= b)
    __int128 borrow = 0;
    for (int i = 0; i < a.n; ++i) {
        __int128 s = (__int128)a.w[i] - (i < b.n ? b.w[i] : 0) - (int64_t)borrow;
        borrow = s < 0;
        a.w[i] = (uint64_t)(s + (borrow ? ((__int128)1 << 64) : 0));
    }
    big_trim(a);
}

inline void big_mul_u64(Big &out, const Big &a, uint64_t m) {  // out = a*m
    unsigned __int128 carry = 0;
    for (int i = 0; i < a.n; ++i) {
        unsigned __int128 p = (unsigned __int128)a.w[i] * m + (uint64_t)carry;
        out.w[i] = (uint64_t)p;
        carry = p >> 64;
    }
    out.n = a.n;
    if (carry && out.n < MAXW) out.w[out.n++] = (uint64_t)carry;
    for (int i = out.n; i < MAXW; ++i) out.w[i] = 0;
}

inline void big_shl1(Big &a) {
    uint64_t carry = 0;
    for (int i = 0; i < a.n; ++i) {
        uint64_t nc = a.w[i] >> 63;
        a.w[i] = (a.w[i] << 1) | carry;
        carry = nc;
    }
    if (carry && a.n < MAXW) a.w[a.n++] = carry;
}

inline double big_to_double(const Big &a) {
    double r = 0.0;
    for (int i = a.n - 1; i >= 0; --i) r = r * 18446744073709551616.0 + (double)a.w[i];
    return r;
}

// remainder of a by small modulus m
inline uint64_t big_mod_u64(const Big &a, uint64_t m) {
    unsigned __int128 r = 0;
    for (int i = a.n - 1; i >= 0; --i) r = ((r << 64) | a.w[i]) % m;
    return (uint64_t)r;
}

struct CrtCtx {
    int L, nwords;
    Big q;                 // full modulus
    Big half_q;            // floor(q/2)
    Big qhat[64];          // q / q_i
    uint64_t corr[64];     // (q/q_i)^{-1} mod q_i
    uint64_t primes[64];
};

// Reconstruct one coefficient: x = sum_i ((r_i * corr_i) mod q_i) * qhat_i,
// reduced mod q. residues: column-strided access left to caller.
inline void crt_coeff(const CrtCtx &c, const uint64_t *res, Big &x) {
    big_zero(x);
    Big t;
    for (int i = 0; i < c.L; ++i) {
        unsigned __int128 y = (unsigned __int128)res[i] * c.corr[i] % c.primes[i];
        big_mul_u64(t, c.qhat[i], (uint64_t)y);
        big_add(x, t);
    }
    while (big_cmp(x, c.q) >= 0) big_sub(x, c.q);
}

}  // namespace

extern "C" {

// Build a CRT context. primes: L entries (<2^31). Returns 0 on success.
// ctx_buf must be >= sizeof(CrtCtx).
int fhe_crt_init(void *ctx_buf, const uint64_t *primes, int L) {
    if (L > 64) return -1;
    CrtCtx &c = *reinterpret_cast<CrtCtx *>(ctx_buf);
    c.L = L;
    big_from_u64(c.q, 1);
    Big t;
    for (int i = 0; i < L; ++i) {
        c.primes[i] = primes[i];
        big_mul_u64(t, c.q, primes[i]);
        c.q = t;
    }
    if (c.q.n >= MAXW - 2) return -2;
    for (int i = 0; i < L; ++i) {
        // qhat_i = q / q_i: rebuild as product of the other primes
        big_from_u64(c.qhat[i], 1);
        for (int j = 0; j < L; ++j) {
            if (j == i) continue;
            big_mul_u64(t, c.qhat[i], primes[j]);
            c.qhat[i] = t;
        }
        // corr_i = (qhat_i mod q_i)^{-1} mod q_i via Fermat (q_i prime)
        uint64_t h = big_mod_u64(c.qhat[i], primes[i]);
        uint64_t e = primes[i] - 2, b = h % primes[i], r = 1, m = primes[i];
        while (e) {
            if (e & 1) r = (unsigned __int128)r * b % m;
            b = (unsigned __int128)b * b % m;
            e >>= 1;
        }
        c.corr[i] = r;
    }
    c.half_q = c.q;
    // half_q = q >> 1
    for (int i = 0; i < c.half_q.n; ++i) {
        c.half_q.w[i] >>= 1;
        if (i + 1 < c.half_q.n && (c.half_q.w[i + 1] & 1))
            c.half_q.w[i] |= 0x8000000000000000ULL;
    }
    big_trim(c.half_q);
    return (int)sizeof(CrtCtx);
}

size_t fhe_crt_ctx_size() { return sizeof(CrtCtx); }

// BGV/centered-mod-p decode: out[j] = centered(CRT(res[:, j])) mod p.
// residues: uint64[L * n] row-major (limb-major).
void fhe_decode_centered_mod(const void *ctx_buf, const uint64_t *residues,
                             int n, uint64_t p, int64_t *out) {
    const CrtCtx &c = *reinterpret_cast<const CrtCtx *>(ctx_buf);
    Big x;
    uint64_t col[64];
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < c.L; ++i) col[i] = residues[(size_t)i * n + j];
        crt_coeff(c, col, x);
        uint64_t xm = big_mod_u64(x, p);
        if (big_cmp(x, c.half_q) > 0) {
            // centered value = x - q  ->  (x mod p) - (q mod p)
            uint64_t qm = big_mod_u64(c.q, p);
            xm = (xm + p - qm) % p;
        }
        out[j] = (int64_t)xm;
    }
}

// BFV decode: out[j] = round(centered(CRT(res[:, j])) / Δ) mod p.
// Δ given as a word array (little-endian uint64) of ndw words.
void fhe_decode_bfv(const void *ctx_buf, const uint64_t *residues, int n,
                    const uint64_t *delta_words, int ndw, uint64_t p,
                    int64_t *out) {
    const CrtCtx &c = *reinterpret_cast<const CrtCtx *>(ctx_buf);
    Big delta;
    big_zero(delta);
    for (int i = 0; i < ndw && i < MAXW; ++i) delta.w[i] = delta_words[i];
    delta.n = ndw;
    big_trim(delta);
    double ddelta = big_to_double(delta);

    Big x, t, prod;
    uint64_t col[64];
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < c.L; ++i) col[i] = residues[(size_t)i * n + j];
        crt_coeff(c, col, x);
        bool neg = big_cmp(x, c.half_q) > 0;
        if (neg) { t = c.q; big_sub(t, x); x = t; }   // |centered|
        // m ≈ x/Δ (double), then exact correction
        double approx = big_to_double(x) / ddelta;
        int64_t m = (int64_t)(approx + 0.5);
        // r = x - m*Δ, adjust until -Δ/2 < r <= Δ/2 (ties away from zero)
        for (;;) {
            big_mul_u64(prod, delta, (uint64_t)(m < 0 ? 0 : m));
            Big r;
            bool rneg;
            if (big_cmp(x, prod) >= 0) { r = x; big_sub(r, prod); rneg = false; }
            else { r = prod; big_sub(r, x); rneg = true; }
            // compare 2|r| with Δ
            Big r2 = r; big_shl1(r2);
            int cmp = big_cmp(r2, delta);
            if (!rneg) {
                if (cmp > 0 || (cmp == 0)) {          // r >= Δ/2 (ties away -> up)
                    // r == Δ/2 exactly only when 2r == Δ
                    if (cmp == 0) { m += 1; break; }
                    m += 1; continue;
                }
                break;
            } else {
                if (cmp > 0) { m -= 1; continue; }    // r < -Δ/2
                break;                                  // -Δ/2 <= r < 0 fine
            }
        }
        int64_t sm = neg ? -m : m;
        int64_t v = sm % (int64_t)p;
        if (v < 0) v += (int64_t)p;
        out[j] = v;
    }
}

// CKKS decode support: out[j] = centered(CRT(res[:, j])) as double.
void fhe_decode_centered_double(const void *ctx_buf, const uint64_t *residues,
                                int n, double *out) {
    const CrtCtx &c = *reinterpret_cast<const CrtCtx *>(ctx_buf);
    Big x, t;
    uint64_t col[64];
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < c.L; ++i) col[i] = residues[(size_t)i * n + j];
        crt_coeff(c, col, x);
        if (big_cmp(x, c.half_q) > 0) {
            t = c.q; big_sub(t, x);
            out[j] = -big_to_double(t);
        } else {
            out[j] = big_to_double(x);
        }
    }
}

// Invariant-noise meter: returns max over coefficients of the distance
// of CRT(res) from the Δ lattice ("birem", bfv.jl:150-158), as double.
double fhe_noise_worst(const void *ctx_buf, const uint64_t *residues, int n,
                       const uint64_t *delta_words, int ndw) {
    const CrtCtx &c = *reinterpret_cast<const CrtCtx *>(ctx_buf);
    Big delta;
    big_zero(delta);
    for (int i = 0; i < ndw && i < MAXW; ++i) delta.w[i] = delta_words[i];
    delta.n = ndw;
    big_trim(delta);
    double ddelta = big_to_double(delta);

    Big x, prod;
    uint64_t col[64];
    double worst = 1.0;
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < c.L; ++i) col[i] = residues[(size_t)i * n + j];
        crt_coeff(c, col, x);
        // r = x mod Δ via double-guess division + correction
        double approx = big_to_double(x) / ddelta;
        int64_t m = approx < 1.0 ? 0 : (int64_t)approx;
        for (;;) {
            big_mul_u64(prod, delta, (uint64_t)m);
            if (big_cmp(prod, x) > 0) { m -= 1; continue; }
            Big r = x; big_sub(r, prod);
            if (big_cmp(r, delta) >= 0) { m += 1; continue; }
            double rv = big_to_double(r);
            double dv = rv > ddelta / 2 ? ddelta - rv : rv;
            if (dv > worst) worst = dv;
            break;
        }
    }
    return worst;
}

}  // extern "C"
