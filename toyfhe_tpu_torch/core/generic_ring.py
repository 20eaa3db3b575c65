"""Host backend for general (non-power-of-two) cyclotomic rings.

Port of ``toyfhe_tpu/core/generic_ring.py``, which replaces the Nemo/FLINT
backend of ToyFHE.jl (``src/nemo.jl``, SURVEY §2.8): exact ℤq[x]/Φm(x)
arithmetic with Python integers. General cyclotomics are a setup and
compatibility path, not a hot path: power-of-two rings run on the device;
these rings run on the host with schoolbook O(n²) multiplication (they
appear only in the PolyCRT encoding setup and the ``bfv_uint8``
compatibility scenario, at degree ≤ a few hundred). Nothing here touches
torch. Factorisations draw from ``random.Random(seed)`` exactly as the
reference does, so they come out in the same order.

Also a host BFV over such rings (``HostBFV``) with the reference's big-ring
multiply (bfv.jl:34-40): exact integers make the BEHZ machinery unnecessary.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Sequence, Tuple

from ..utils import numtheory as nt


# ---------------------------------------------------------------------------
# polynomial helpers over ℤ/q (dense coefficient lists of Python ints)
# ---------------------------------------------------------------------------

def cyclotomic_poly(m: int) -> List[int]:
    """Coefficients of Φm(x), low-to-high, computed by the divide-out
    recurrence Φm = (x^m − 1) / ∏_{d|m, d<m} Φd."""
    polys = {}
    for d in range(1, m + 1):
        if m % d:
            continue
        num = [0] * (d) + [1]
        num[0] = -1                        # x^d - 1
        for e in range(1, d):
            if d % e == 0:
                num = _poly_divexact(num, polys[e])
        polys[d] = num
    return polys[m]


def _poly_divexact(a: List[int], b: List[int]) -> List[int]:
    a = list(a)
    out = [0] * (len(a) - len(b) + 1)
    for i in range(len(out) - 1, -1, -1):
        c = a[i + len(b) - 1] // b[-1]
        out[i] = c
        for j, bj in enumerate(b):
            a[i + j] -= c * bj
    assert all(x == 0 for x in a[:len(b) - 1]), "inexact division"
    return out


def poly_mod_q(a: Sequence[int], q: int) -> List[int]:
    return [int(x) % q for x in a]


def poly_mulmod(a: Sequence[int], b: Sequence[int], phi: Sequence[int], q: int) -> List[int]:
    """(a·b) mod (Φ, q) — schoolbook then remainder by monic Φ."""
    n = len(phi) - 1
    prod = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                prod[i + j] = (prod[i + j] + ai * bj) % q
    return poly_rem(prod, phi, q)


def poly_rem(a: Sequence[int], phi: Sequence[int], q: int) -> List[int]:
    a = [int(x) % q for x in a]
    n = len(phi) - 1
    assert phi[-1] == 1, "modulus must be monic"
    for i in range(len(a) - 1, n - 1, -1):
        c = a[i]
        if c:
            for j in range(n + 1):
                a[i - n + j] = (a[i - n + j] - c * phi[j]) % q
    out = a[:n]
    out += [0] * (n - len(out))
    return out


def poly_add(a, b, q):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % q
            for i in range(n)]


def poly_sub(a, b, q):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % q
            for i in range(n)]


def poly_scalar(c, a, q):
    return [c * x % q for x in a]


def poly_eval(a, x, phi, q):
    """Evaluate a at a ring element x (Horner), mod (Φ, q)."""
    acc = [0]
    for c in reversed(a):
        acc = poly_mulmod(acc, x, phi, q)
        acc = poly_add(acc, [c], q)
    return acc


def poly_gcd(a, b, p):
    """GCD over 𝔽p (p prime), monic result."""
    a = [x % p for x in a]
    b = [x % p for x in b]
    while any(b):
        a, b = b, _poly_mod_poly(a, b, p)
    return _monic(a, p)


def _trim(a):
    while a and a[-1] == 0:
        a = a[:-1]
    return a


def _monic(a, p):
    a = _trim(a)
    if not a:
        return a
    inv = pow(a[-1], -1, p)
    return [x * inv % p for x in a]


def _poly_mod_poly(a, b, p):
    a = _trim([x % p for x in a])
    b = _trim([x % p for x in b])
    inv = pow(b[-1], -1, p)
    while len(a) >= len(b):
        c = a[-1] * inv % p
        for j in range(len(b)):
            a[len(a) - len(b) + j] = (a[len(a) - len(b) + j] - c * b[j]) % p
        a = _trim(a)
        if not a:
            break
    return a


def _poly_divmod_poly(a, b, p):
    a = _trim([x % p for x in a])
    b = _trim([x % p for x in b])
    inv = pow(b[-1], -1, p)
    quot = [0] * max(1, len(a) - len(b) + 1)
    while a and len(a) >= len(b):
        c = a[-1] * inv % p
        quot[len(a) - len(b)] = c
        for j in range(len(b)):
            a[len(a) - len(b) + j] = (a[len(a) - len(b) + j] - c * b[j]) % p
        a = _trim(a)
    return quot, a


def factor_distinct_degree_fp(f: List[int], p: int) -> List[Tuple[List[int], int]]:
    """Distinct-degree factorization of a squarefree monic f over 𝔽p."""
    out = []
    f = _monic(f, p)
    x = [0, 1]
    h = x[:]
    d = 0
    while len(f) - 1 >= 2 * (d + 1):
        d += 1
        # h = x^(p^d) mod f
        h = _poly_powmod(h, p, f, p)
        g = poly_gcd(poly_sub(h, x, p), f, p)
        if len(g) > 1:
            out.append((g, d))
            f = _poly_divexact_fp(f, g, p)
            h = _poly_mod_poly(h, f, p)
    if len(f) > 1:
        out.append((f, len(f) - 1))
    return out


def _poly_divexact_fp(a, b, p):
    q, r = _poly_divmod_poly(a, b, p)
    assert not _trim(r)
    return _monic(q, p)


def _poly_powmod(a, e, f, p):
    result = [1]
    base = _poly_mod_poly(a, f, p)
    while e:
        if e & 1:
            result = _poly_mod_poly(_poly_mul_fp(result, base, p), f, p)
        base = _poly_mod_poly(_poly_mul_fp(base, base, p), f, p)
        e >>= 1
    return result


def _poly_mul_fp(a, b, p):
    prod = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                prod[i + j] = (prod[i + j] + ai * bj) % p
    return prod


def equal_degree_split_fp(f: List[int], d: int, p: int, rng: random.Random) -> List[List[int]]:
    """Cantor–Zassenhaus equal-degree factorization over 𝔽p."""
    n = len(f) - 1
    if n == d:
        return [f]
    while True:
        a = [rng.randrange(p) for _ in range(n)]
        if not _trim(a):
            continue
        if p == 2:
            # trace map T(a) = a + a^2 + ... + a^(2^(d-1)) mod f
            t = _poly_mod_poly(a, f, p)
            acc = t[:]
            for _ in range(d - 1):
                t = _poly_mod_poly(_poly_mul_fp(t, t, p), f, p)
                acc = poly_add(acc, t, p)
            g = poly_gcd(acc, f, p)
        else:
            e = (p ** d - 1) // 2
            b = _poly_powmod(a, e, f, p)
            g = poly_gcd(poly_sub(b, [1], p), f, p)
        if 1 < len(g) < len(f):
            return (equal_degree_split_fp(g, d, p, rng)
                    + equal_degree_split_fp(_poly_divexact_fp(f, g, p), d, p, rng))


def factor_squarefree_fp(f: List[int], p: int, seed: int = 0) -> List[List[int]]:
    """Full factorization of squarefree monic f over 𝔽p (DDF + CZ).
    FLINT's role at polycrtencoding.jl:34, host-side."""
    rng = random.Random(seed)
    out = []
    for g, d in factor_distinct_degree_fp(f, p):
        out.extend(equal_degree_split_fp(g, d, p, rng))
    return sorted(out)


def hensel_lift_factors(f: List[int], factors: List[List[int]], p: int,
                        k: int) -> List[List[int]]:
    """Lift a pairwise-coprime monic factorization of f from mod p to mod
    p^k (the Hecke/FLINT Hensel role, polycrtencoding.jl:24-86).

    Recursive two-way lifting: split the factor list in half, lift the
    pair (G, H) with G·H ≡ f, recurse.
    """
    if k == 1:
        return [poly_mod_q(g, p) for g in factors]
    if len(factors) == 1:
        return [poly_mod_q(f, p ** k)]

    half = len(factors) // 2
    g = [1]
    for fac in factors[:half]:
        g = _poly_mul_fp(g, fac, p)
    h = [1]
    for fac in factors[half:]:
        h = _poly_mul_fp(h, fac, p)
    G, H = _hensel_pair(f, g, h, p, k)
    q = p ** k
    left = hensel_lift_factors(G, factors[:half], p, k)
    right = hensel_lift_factors(H, factors[half:], p, k)
    return left + right


def _hensel_pair(f, g, h, p, k):
    """Lift f ≡ g·h (mod p), gcd(g,h)=1, to mod p^k (linear lifting)."""
    # Bezout: s·g + t·h ≡ 1 mod p
    s, t = _poly_xgcd_fp(g, h, p)
    q = p
    g = poly_mod_q(g, p)
    h = poly_mod_q(h, p)
    modexp = 1
    while modexp < k:
        q2 = q * p
        # e = f - g*h mod q2
        gh = _poly_mul_int(g, h)
        e = poly_sub(list(f) + [0] * max(0, len(gh) - len(f)), gh, q2)
        # delta_h = (s*e mod h), delta_g = (t*e mod g) over ℤ/q2
        dh = _poly_rem_monic(_poly_mul_int(s, e), h, q2)
        dg = _poly_rem_monic(_poly_mul_int(t, e), g, q2)
        g = poly_add(g, dg, q2)
        h = poly_add(h, dh, q2)
        q = q2
        modexp += 1
    qk = p ** k
    return poly_mod_q(g, qk), poly_mod_q(h, qk)


def _poly_mul_int(a, b):
    prod = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                prod[i + j] += ai * bj
    return prod


def _poly_rem_monic(a, m, q):
    """a mod monic-up-to-unit m over ℤ/q (leading coeff of m must be
    invertible mod q)."""
    a = [x % q for x in a]
    m = _trim([x % q for x in m])
    inv = pow(m[-1], -1, q)
    while len(_trim(a)) >= len(m):
        a = _trim(a)
        c = a[-1] * inv % q
        for j in range(len(m)):
            a[len(a) - len(m) + j] = (a[len(a) - len(m) + j] - c * m[j]) % q
    out = _trim(a)
    return out + [0] * (len(m) - 1 - len(out))


def _poly_xgcd_fp(a, b, p):
    """s, t with s·a + t·b ≡ 1 (mod p) for coprime a, b over 𝔽p."""
    r0, r1 = [x % p for x in a], [x % p for x in b]
    s0, s1 = [1], [0]
    t0, t1 = [0], [1]
    while _trim(r1):
        qt, rem = _poly_divmod_poly(r0, r1, p)
        r0, r1 = r1, rem if rem else [0]
        s0, s1 = s1, poly_sub(s0, _poly_mul_fp(qt, s1, p), p)
        t0, t1 = t1, poly_sub(t0, _poly_mul_fp(qt, t1, p), p)
    r0 = _trim(r0)
    assert len(r0) == 1, "inputs not coprime"
    inv = pow(r0[0], -1, p)
    return poly_scalar(inv, s0, p), poly_scalar(inv, t0, p)


# ---------------------------------------------------------------------------
# generic cyclotomic ring + host RLWE/BFV engine
# ---------------------------------------------------------------------------

class GenericRing:
    """ℤq[x]/Φm(x) — the Nemo backend ring (nemo.jl:6-17)."""

    def __init__(self, m: int, q: int):
        self.m = int(m)
        self.q = int(q)
        self.phi = poly_mod_q(cyclotomic_poly(self.m), self.q)
        self.degree = len(self.phi) - 1

    def zero(self) -> List[int]:
        return [0] * self.degree

    def mul(self, a, b):
        return poly_mulmod(a, b, self.phi, self.q)

    def add(self, a, b):
        return poly_add(a, b, self.q)

    def sub(self, a, b):
        return poly_sub(a, b, self.q)

    def neg(self, a):
        return [(-x) % self.q for x in a]

    def scalar(self, c, a):
        return poly_scalar(c % self.q, a, self.q)

    def sample_uniform(self, rng: random.Random):
        return [rng.randrange(self.q) for _ in range(self.degree)]

    def sample_gaussian(self, rng: random.Random, sigma: float):
        return [round(rng.gauss(0, sigma)) % self.q for _ in range(self.degree)]

    def centered(self, a) -> List[int]:
        return [nt.centered(x, self.q) for x in a]


@dataclasses.dataclass
class HostBFV:
    """Host BFV over a generic cyclotomic ring — the reference's Nemo-
    backend scheme (bfv_uint8.jl usage): big-ring multiply exactly as
    bfv.jl:34-40 with exact integers."""

    ring: GenericRing
    ring_big: GenericRing
    p: int                       # plaintext modulus
    sigma: float = 8.0 / math.sqrt(2 * math.pi)

    def __post_init__(self):
        self.delta = self.ring.q // self.p

    def keygen(self, rng: random.Random):
        ring = self.ring
        mask = ring.sample_uniform(rng)
        secret = ring.sample_gaussian(rng, self.sigma)
        e = ring.sample_gaussian(rng, self.sigma)
        masked = ring.neg(ring.add(ring.mul(mask, secret), e))
        return {"secret": secret, "mask": mask, "masked": masked}

    def encrypt(self, kp, plain_coeffs: Sequence[int], rng: random.Random):
        ring = self.ring
        u = ring.sample_gaussian(rng, self.sigma)
        e1 = ring.sample_gaussian(rng, self.sigma)
        e2 = ring.sample_gaussian(rng, self.sigma)
        c1 = ring.add(ring.mul(kp["masked"], u), e1)
        c2 = ring.add(ring.mul(kp["mask"], u), e2)
        pt = [self.delta * (int(x) % self.p) % ring.q for x in plain_coeffs]
        pt += [0] * (ring.degree - len(pt))
        return (ring.add(c1, pt), c2)

    def decrypt(self, kp, cs) -> List[int]:
        ring = self.ring
        b = cs[0]
        spow = kp["secret"]
        for i in range(1, len(cs)):
            b = ring.add(b, ring.mul(spow, cs[i]))
            if i + 1 < len(cs):
                spow = ring.mul(spow, kp["secret"])
        out = []
        for x in ring.centered(b):
            out.append(nt.divround(x, self.delta) % self.p)
        return out

    def mul(self, cs1, cs2):
        """Tensor product in the big ring then scale by t/q
        (mul_expand/enc_mul/mul_contract, bfv.jl:34-40)."""
        big = self.ring_big
        switch = lambda c: [nt.centered(x, self.ring.q) % big.q for x in c]
        a = [switch(c) for c in cs1]
        b = [switch(c) for c in cs2]
        out = [big.zero() for _ in range(len(a) + len(b) - 1)]
        for i in range(len(a)):
            for j in range(len(b)):
                out[i + j] = big.add(out[i + j], big.mul(a[i], b[j]))
        # multround: round(p·x/q) in centered coords, then back to ring q
        res = []
        for c in out:
            scaled = [nt.divround(nt.centered(x, big.q) * self.p, self.ring.q) % self.ring.q
                      for x in c]
            res.append(scaled)
        return tuple(res)
