"""Host-side number theory for parameter setup.

Port of ``toyfhe_tpu/utils/numtheory.py`` (the prime walks of ToyFHE.jl
``src/crt.jl:282-295`` and the minimal primitive roots of
``src/pow2_cyc_rings.jl:38-44``). Everything here runs once per parameter
set on the host with exact Python integers; the results are uploaded into
device constant tables.
"""

from __future__ import annotations

import math
from typing import List, Sequence

# Deterministic Miller-Rabin witnesses, valid for all n < 3.3e24.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_prime(start: int, interval: int = 1) -> int:
    """Smallest prime p >= start with p ≡ start (mod interval).

    Stepping by ``interval = 2N`` from a start ≡ 1 (mod 2N) yields
    NTT-friendly primes ≡ 1 (mod 2N), as ToyFHE.jl's
    ``nextprime(x; interval=2N)`` walk does.
    """
    p = start
    while not is_prime(p):
        p += interval
    return p


def ntt_prime_chain(n: int, logqs: Sequence[int]) -> List[int]:
    """Pick one NTT-friendly prime (≡ 1 mod 2n) per requested bit size.

    Process sizes in sorted order, walk
    ``nextprime(max(2^logq + 1, last + 2n), interval=2n)``, return the primes
    in the originally requested order. Distinctness is guaranteed by the
    ``last + 2n`` lower bound.
    """
    order = sorted(range(len(logqs)), key=lambda i: logqs[i])
    primes: List[int] = [0] * len(logqs)
    last = 0
    for i in order:
        start = max((1 << logqs[i]) + 1, last + 2 * n)
        # keep the ≡ 1 (mod 2n) class: round start up to the next such value
        rem = (start - 1) % (2 * n)
        if rem:
            start += 2 * n - rem
        p = next_prime(start, interval=2 * n)
        primes[i] = p
        last = p
    return primes


def primitive_root(p: int) -> int:
    """Smallest generator of the multiplicative group of F_p."""
    if p == 2:
        return 1
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"no generator found for {p}")


def _factorize(n: int) -> List[int]:
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def minimal_primitive_root_of_unity(p: int, order: int) -> int:
    """Smallest x in F_p with multiplicative order exactly ``order``.

    The elements of exact order d are ζ^k for gcd(k, d) = 1 with
    ζ = g^((p−1)/d) and g any generator, so take the minimum over those φ(d)
    candidates instead of scanning F_p.
    """
    if (p - 1) % order != 0:
        raise ValueError(f"{order}-th roots of unity do not exist mod {p}")
    if order == 1:
        return 1
    g = primitive_root(p)
    z = pow(g, (p - 1) // order, p)
    best = None
    zk = z
    for k in range(1, order):
        if math.gcd(k, order) == 1 and (best is None or zk < best):
            best = zk
        zk = zk * z % p
    return best


def invmod(a: int, m: int) -> int:
    return pow(a, -1, m)


def centered(x: int, q: int) -> int:
    """Centered representative in (-q/2, q/2]: values strictly greater than
    q ÷ 2 (floor) map down by q."""
    x = x % q
    return x - q if x > q // 2 else x


def frac_to_float(fr) -> float:
    """float(Fraction) robust to bignum numerator and denominator.

    Exact CKKS scale tags accumulate products of many primes; the ratio
    stays moderate but numerator and denominator can each exceed float64
    range. Shift both down to ~64 bits first (±2^-63 relative error); a
    ratio past float64 range returns ±inf."""
    n, d = fr.numerator, fr.denominator
    neg = n < 0
    n = abs(n)
    if n.bit_length() - d.bit_length() > 1024:
        return -math.inf if neg else math.inf
    k = min(n.bit_length(), d.bit_length()) - 64
    if k > 0:
        n >>= k
        d >>= k
    try:
        v = n / d
    except OverflowError:
        v = math.inf
    return -v if neg else v
