"""Reference-literal parameter derivations.

Port of ``toyfhe_tpu/core/refparams.py``: reproduces, digit for digit, the
parameter sets ToyFHE.jl's test suite and MNIST example construct, so the
exact host engine (:mod:`.host_engine`) runs at the reference's own moduli
and records golden vectors. Each function cites the reference lines it
mirrors.

``nextprime(x, 1; interval=s)`` in the reference (Primes.jl) returns the
smallest prime ≥ x in the arithmetic progression x + k·s — our
``nt.next_prime(x, s)``. Starting at 2^b + 1 with interval 2N yields
NTT-friendly primes ≡ 1 (mod 2N).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from ..utils import numtheory as nt

DEFAULT_SIGMA = 8.0 / math.sqrt(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class RefBFVParams:
    """Literal output of the reference BFV param-gen (bfv.jl:47-118)."""
    n: int
    qprime: int          # ciphertext modulus (prime, ≡ 1 mod 2n)
    qprime_large: int    # big-ring modulus for multiply
    delta: int           # Δ = qprime ÷ p
    p: int
    sigma: float
    relin_window: int
    planned_q_bits: float


def bfv_reference_paramgen(p: int, sigma: float = DEFAULT_SIGMA,
                           alpha: float = 9.0, r: int = 1,
                           eval_mult_count: int = 0,
                           relin_window: int = 1) -> RefBFVParams:
    """PALISADE-heuristic parameter generation, exactly bfv.jl:47-118
    INCLUDING its modulus construction (bfv.jl:101-107):
    qPrime      = nextprime(2^(⌈log2 q⌉+1) + 1; interval=2n)
    largebits   = 2·⌈log2 q⌉ + ⌈log2 p⌉ + 3
    qPrimeLarge = nextprime(2^largebits + 1; interval=2n)
    Δ           = qPrime ÷ p

    The float recurrence is the same IEEE-double computation as the
    device path's :func:`.bfv.bfv_params` (which then
    re-plans onto <2^31 RNS limbs instead — SURVEY §7 hard part 1).
    """
    from . import cryptparams

    assert r >= 1
    Berr = sigma * math.sqrt(alpha)
    Bkey = Berr
    delta_fn = lambda n: 2.0 * math.sqrt(n)
    Vnorm = lambda n: Berr * (1 + 2 * delta_fn(n) * Bkey)

    def nRLWE(q):
        return cryptparams.std_ring_dim(
            cryptparams.HEStd_error, cryptparams.HEStd_128_classic,
            math.ceil(math.log2(q)))

    n = 512
    q = 0.0
    if eval_mult_count > 0:
        w = 2.0 ** r
        # NOTE: the reference's Julia ``4 / δ(n)*Bkey`` (bfv.jl:69) parses
        # left-to-right as (4/δ(n))·Bkey — NOT 4/(δ·Bkey). Mirrored
        # literally so qPrime/qPrimeLarge/Δ match the reference digit for
        # digit (the intended-looking grouping yields ceil(log2 q) = 68
        # against the reference's 69 for p=53, emc=2).
        eps1 = lambda nn: 4 / delta_fn(nn) * Bkey
        C1 = lambda nn: (1 + eps1(nn)) * delta_fn(nn) ** 2 * p * Bkey
        C2 = lambda nn, qP: (delta_fn(nn) ** 2 * p * Bkey * (Bkey + p * p)
                             + delta_fn(nn) * (math.floor(math.log2(qP) / r) + 1) * w * Berr)
        qBFV = lambda nn, qP: (p * p + 2 * p * (
            C1(nn) ** eval_mult_count * Vnorm(nn)
            + eval_mult_count * C1(nn) ** (eval_mult_count - 1) * C2(nn, qP)))

        qPrev = 1e6
        q = qBFV(n, qPrev)
        qPrev = q
        while nRLWE(q) > n:
            while nRLWE(q) > n:
                n *= 2
                q = qBFV(n, qPrev)
                qPrev = q
            q = qBFV(n, qPrev)
            while abs(q - qPrev) > 0.001 * q:
                qPrev = q
                q = qBFV(n, qPrev)

    logq = math.ceil(math.log2(q)) if q > 0 else 59
    qprime = nt.next_prime(2 ** (logq + 1) + 1, 2 * n)
    largebits = 2 * logq + math.ceil(math.log2(p)) + 3
    qprime_large = nt.next_prime(2 ** largebits + 1, 2 * n)
    return RefBFVParams(n=n, qprime=qprime, qprime_large=qprime_large,
                        delta=qprime // p, p=p, sigma=sigma,
                        relin_window=relin_window,
                        planned_q_bits=float(math.log2(q)) if q > 0 else float(logq))


def bfv_crt_reference_tower() -> Tuple[int, List[int], List[int]]:
    """test/bfv_crt.jl:8-25 — n=2048; ciphertext tower p1,p2 walking from
    2^50+1 by 2n; big tower p3..p6 continuing the same walk. Returns
    (n, [p1, p2], [p3, p4, p5, p6])."""
    n = 2048
    s = 2 * n
    p1 = nt.next_prime(2 ** 50 + 1, s)
    p2 = nt.next_prime(p1 + s, s)
    p3 = nt.next_prime(p2 + s, s)
    p4 = nt.next_prime(p3 + s, s)
    p5 = nt.next_prime(p4 + s, s)
    p6 = nt.next_prime(p5 + s, s)
    return n, [p1, p2], [p3, p4, p5, p6]


def ckks_modswitch_reference_tower() -> Tuple[int, List[int]]:
    """test/ckks_modswitch.jl:7-11 — N=2^5; q0,q1,ps walking from 2^40+1
    by 2N. Returns (n, [q0, q1, ps])."""
    n = 2 ** 5
    s = 2 * n
    q0 = nt.next_prime(2 ** 40 + 1, s)
    q1 = nt.next_prime(q0 + s, s)
    ps = nt.next_prime(q1 + s, s)
    return n, [q0, q1, ps]


def ckks_rotate_reference_tower() -> Tuple[int, List[int]]:
    """test/ckks_rotate.jl:8-10 — N=2^4; q0, ps from 2^40+1 by 2N."""
    n = 2 ** 4
    s = 2 * n
    q0 = nt.next_prime(2 ** 40 + 1, s)
    ps = nt.next_prime(q0 + s, s)
    return n, [q0, ps]


def ckks_triv_reference_params() -> RefBFVParams:
    """test/ckks_triv.jl:5-13 — CKKS over the ring the BFV estimator
    picks for p=7, eval_mult_count=3 ("use the BFV parameter estimator
    and just copy it over"); scale 2^40."""
    return bfv_reference_paramgen(7, eval_mult_count=3)


def mnist_reference_tower() -> Tuple[int, List[int], int]:
    """examples/encrypted_mnist/infer.jl:97-110 — N=2^13;
    q0 = nextprime(2^60+1; 2N), ps = nextprime(q0+2N; 2N),
    q1..q5 walking from 2^40+1 by 2N. Tower order in the ring is
    (q0, q1..q5, ps). Returns (n, [q0, q1..q5, ps], scale=2^40)."""
    n = 2 ** 13
    s = 2 * n
    q0 = nt.next_prime(2 ** 60 + 1, s)
    ps = nt.next_prime(q0 + s, s)
    q1 = nt.next_prime(2 ** 40 + 1, s)
    q2 = nt.next_prime(q1 + s, s)
    q3 = nt.next_prime(q2 + s, s)
    q4 = nt.next_prime(q3 + s, s)
    q5 = nt.next_prime(q4 + s, s)
    return n, [q0, q1, q2, q3, q4, q5, ps], 2 ** 40


def bgv_palisade_ring() -> Tuple[int, int]:
    """test/bgv_triv.jl:6-10 — the PALISADE m=4096 default ring: the
    literal modulus from cryptparams.jl:24 (PALISADE elementfactory.cpp
    defaults; a published constant): n = 2048, q = 1152921504606830593."""
    n, q = 2048, 1152921504606830593
    assert nt.is_prime(q) and q % (2 * n) == 1
    return n, q
