"""Exact host RLWE engine: the reference engine's semantics over exact
Python-integer rings.

Port of ``toyfhe_tpu/core/host_engine.py``. Two roles:

1. **Golden-vector harness**: run ToyFHE.jl's own literal parameter
   derivations — the same ``nextprime`` walks (``test/bfv_crt.jl:8-25``,
   ``test/ckks_modswitch.jl:8-11``), the same PALISADE param-gen
   (``src/bfv.jl:47-118``), the 60/40-bit MNIST tower
   (``examples/encrypted_mnist/infer.jl:97-110``) — with exact big-integer
   arithmetic, and record decode vectors that the device RNS path must
   reproduce (exactly for BFV/BGV, within documented tolerance for CKKS).
   It is also the oracle the card is held against at serving width.

2. **Ring-generic engine**: keyswitch, eval/galois keys and rotation over
   general cyclotomic rings (:class:`.generic_ring.GenericRing`), as the
   reference's ``rlwe_she.jl:273-360`` works unchanged over Nemo/FLINT rings.

The engine mirrors ``rlwe_she.jl`` exactly: the same sampling order inside
keygen/encrypt (``rlwe_she.jl:155-197``), the same keyswitch decompositions
— power-of-2 digit windows on the CRT-reconstructed value
(``rlwe_she.jl:331-338``) and the RNS-limb SignedMod decomposition
(``rlwe_she.jl:327-330``) — and the same galois-element conventions
(``rlwe_she.jl:300-309``). All arithmetic is exact and nothing here runs on
a device or touches torch. N = 2^13 towers are practical because the
power-of-two ring multiply uses Kronecker substitution (pack the
coefficients into one big integer, one CPython bigint multiply, unpack)
instead of schoolbook O(n²); that multiply is the engine's whole cost.
"""

from __future__ import annotations

import dataclasses
import math
import random
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import numtheory as nt
from .generic_ring import GenericRing


# ---------------------------------------------------------------------------
# Exact power-of-two negacyclic ring with Kronecker-substitution multiply
# ---------------------------------------------------------------------------

class Pow2HostRing:
    """ℤq[x]/(x^N + 1) with exact Python-int coefficients.

    ``moduli`` optionally records an RNS factorization q = ∏ qᵢ (the
    reference's ``CRTEncoded`` limb structure, crt.jl:9-11); it enables the
    RNS-limb keyswitch decomposition and rescale-by-last-prime.
    """

    def __init__(self, n: int, moduli: Sequence[int] = None, q: int = None):
        self.n = int(n)
        if moduli is not None:
            self.moduli = [int(m) for m in moduli]
            self.q = math.prod(self.moduli)
            if q is not None:
                assert q == self.q
        else:
            assert q is not None
            self.moduli = None
            self.q = int(q)
        # Kronecker packing: each unpacked coefficient of a product of two
        # degree-<n polynomials with coefficients in [0, q) is a sum of at
        # most n products < q², so 2^k > n·(q−1)² suffices.
        self._kbits = (self.n * (self.q - 1) ** 2).bit_length() + 1

    @property
    def degree(self) -> int:
        return self.n

    def zero(self) -> List[int]:
        return [0] * self.n

    # -- packing ------------------------------------------------------------
    def _pack(self, a: Sequence[int]) -> int:
        k = self._kbits
        acc = 0
        for i in range(len(a) - 1, -1, -1):
            acc = (acc << k) | a[i]
        return acc

    def _unpack(self, v: int, count: int) -> List[int]:
        k = self._kbits
        mask = (1 << k) - 1
        out = []
        for _ in range(count):
            out.append(v & mask)
            v >>= k
        return out

    def mul(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Negacyclic product via Kronecker substitution: one bigint
        multiply, then fold c[i] − c[i+n] (x^n ≡ −1)."""
        prod = self._pack(a) * self._pack(b)
        c = self._unpack(prod, 2 * self.n - 1) + [0]
        q = self.q
        return [(c[i] - c[i + self.n]) % q for i in range(self.n)]

    def add(self, a, b):
        q = self.q
        return [(x + y) % q for x, y in zip(a, b)]

    def sub(self, a, b):
        q = self.q
        return [(x - y) % q for x, y in zip(a, b)]

    def neg(self, a):
        q = self.q
        return [(-x) % q for x in a]

    def scalar(self, c, a):
        q = self.q
        c = int(c) % q
        return [c * x % q for x in a]

    def centered(self, a) -> List[int]:
        q = self.q
        return [nt.centered(x, q) for x in a]

    # -- sampling (reference distributions, poly.jl:7-23) --------------------
    def sample_uniform(self, rng: random.Random):
        q = self.q
        return [rng.randrange(q) for _ in range(self.n)]

    def sample_gaussian(self, rng: random.Random, sigma: float):
        q = self.q
        return [round(rng.gauss(0.0, sigma)) % q for _ in range(self.n)]

    # -- galois (pow2_cyc_rings.jl:321-329) ----------------------------------
    def galois(self, a: Sequence[int], g: int) -> List[int]:
        """x(X) ↦ x(X^g): coefficient i moves to g·i mod N with a sign
        flip when ⌊g·i/N⌋ is odd."""
        n, q = self.n, self.q
        # g must be odd (a unit of ℤ_{2n}*); an even g aliases indices.
        assert g % 2 == 1, f"galois element must be odd, got {g}"
        out = [0] * n
        for i, ai in enumerate(a):
            gi = g * i
            j = gi % n
            if (gi // n) % 2:
                out[j] = (-ai) % q
            else:
                out[j] = ai % q
        return out

    # -- RNS tower ops -------------------------------------------------------
    def drop_last(self) -> "Pow2HostRing":
        assert self.moduli and len(self.moduli) >= 2
        return Pow2HostRing(self.n, moduli=self.moduli[:-1])

    def rescale(self, a: Sequence[int]) -> Tuple["Pow2HostRing", List[int]]:
        """Exact divide by the last prime (crt.jl:215-220):
        c' = (c − [c]_{q_last}) / q_last over the shorter tower, using the
        RAW [0, q_last) representative of the dropped limb exactly as the
        reference's ``convert(Integer, ct_qk)`` (crt.jl:218) — and as the
        device path (ring.rescale)."""
        assert self.moduli and len(self.moduli) >= 2
        ql = self.moduli[-1]
        sub = Pow2HostRing(self.n, moduli=self.moduli[:-1])
        out = [(x - x % ql) // ql % sub.q for x in a]
        return sub, out


def galois_generic(ring: GenericRing, a: Sequence[int], g: int) -> List[int]:
    """x(X) ↦ x(X^g) over ℤq[x]/Φm(x) — the general-cyclotomic galois
    action the Nemo backend gets from polynomial substitution. g must be
    a unit of ℤm*."""
    from . import generic_ring as GR
    assert math.gcd(g, ring.m) == 1, "galois element must be a unit mod m"
    # x^g mod (Φ, q), then Horner-evaluate a at it.
    xg = [0] * (g % ring.m) + [1]
    xg = GR.poly_rem(xg, ring.phi, ring.q)
    return GR.poly_eval(list(a), xg, ring.phi, ring.q)


# ---------------------------------------------------------------------------
# Scheme params (π / π⁻¹ / 𝒩 / 𝒢 protocol, rlwe_she.jl:9-16)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostParams:
    """Host scheme params. ``scheme`` ∈ {"bfv", "bgv", "ckks"}.

    BFV: Δ-encoder + big-ring multiply (bfv.jl:21-40).
    BGV: plaintext in low digits, noise = p·𝒩 (bgv.jl:21-33).
    CKKS: identity π, scale tracked by the caller (ckks.jl:21-22).
    """

    ring: object                    # Pow2HostRing or GenericRing
    scheme: str = "bfv"
    p: int = 0                      # plaintext modulus (BFV/BGV)
    sigma: float = 8.0 / math.sqrt(2 * math.pi)
    ring_big: Optional[object] = None
    relin_window: int = 0           # 0 = RNS-limb decomposition (crt.jl:298)
    delta: Optional[int] = None     # BFV Δ; default ⌊q/p⌋ (bfv.jl:118)

    def __post_init__(self):
        if self.scheme == "bfv" and self.delta is None:
            self.delta = self.ring.q // self.p

    # π⁻¹ (rlwe_she.jl:190 dispatch targets)
    def encode(self, plain_coeffs: Sequence[int]) -> List[int]:
        ring = self.ring
        if self.scheme == "bfv":
            out = [self.delta * (int(x) % self.p) % ring.q for x in plain_coeffs]
        elif self.scheme == "bgv":
            out = [nt.centered(int(x) % self.p, self.p) % ring.q
                   for x in plain_coeffs]
        elif self.scheme == "ckks":
            out = [int(x) % ring.q for x in plain_coeffs]
        else:
            raise ValueError(self.scheme)
        return out + [0] * (ring.degree - len(out))

    # π (rlwe_she.jl:215 dispatch targets)
    def decode(self, b: Sequence[int], ring=None) -> List[int]:
        ring = ring or self.ring
        if self.scheme == "bfv":
            delta = ring.q // self.p if ring is not self.ring else self.delta
            return [nt.divround(x, delta) % self.p for x in ring.centered(b)]
        if self.scheme == "bgv":
            return [nt.centered(x, self.p) % self.p for x in ring.centered(b)]
        if self.scheme == "ckks":
            return ring.centered(b)
        raise ValueError(self.scheme)

    # 𝒩 / 𝒢
    def sample_noise(self, ring, rng: random.Random):
        e = ring.sample_gaussian(rng, self.sigma)
        if self.scheme == "bgv":                       # 𝒩 = p·𝒢 (bgv.jl:27-33)
            q = ring.q
            return [x * self.p % q if x <= q // 2 else
                    (x - q) * self.p % q for x in e]
        return e

    def sample_secret(self, ring, rng: random.Random):
        return ring.sample_gaussian(rng, self.sigma)


# ---------------------------------------------------------------------------
# Engine (rlwe_she.jl:155-360)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostKeyPair:
    secret: List[int]
    mask: List[int]
    masked: List[int]
    q: int = 0            # modulus the key was generated at (for tower align)


@dataclasses.dataclass
class HostEvalKey:
    """KeySwitchKey (rlwe_she.jl:97-101): per-digit (mask, masked) pairs."""
    masks: List[List[int]]
    maskeds: List[List[int]]
    window: int
    galois_element: Optional[int] = None


def keygen(params: HostParams, rng: random.Random) -> HostKeyPair:
    """rlwe_she.jl:155-166 — sampling order: mask ← 𝒰, secret ← 𝒢, e ← 𝒩."""
    ring = params.ring
    mask = ring.sample_uniform(rng)
    secret = params.sample_secret(ring, rng)
    e = params.sample_noise(ring, rng)
    masked = ring.neg(ring.add(ring.mul(mask, secret), e))
    return HostKeyPair(secret=secret, mask=mask, masked=masked, q=ring.q)


def encrypt(params: HostParams, kp: HostKeyPair, plain_coeffs: Sequence[int],
            rng: random.Random) -> Tuple[List[int], ...]:
    """rlwe_she.jl:176-197 — u ← 𝒢, e₁,e₂ ← 𝒩; c = (masked·u + e₁ + π⁻¹(m),
    mask·u + e₂)."""
    ring = params.ring
    u = params.sample_secret(ring, rng)
    e1 = params.sample_noise(ring, rng)
    e2 = params.sample_noise(ring, rng)
    c1 = ring.add(ring.mul(kp.masked, u), e1)
    c2 = ring.add(ring.mul(kp.mask, u), e2)
    return (ring.add(c1, params.encode(plain_coeffs)), c2)


def decrypt(params: HostParams, kp: HostKeyPair, cs, ring=None) -> List[int]:
    """rlwe_she.jl:199-217 — b = Σ cᵢ·sⁱ, then π. The key auto-aligns to
    a shorter tower (rlwe_she.jl:202-204): the secret has small centered
    coefficients, so centered reduction into the shorter modulus is the
    exact limb-drop re-embedding."""
    ring = ring or params.ring
    return params.decode(decrypt_raw(params, kp, cs, ring), ring)


def decrypt_raw(params: HostParams, kp: HostKeyPair, cs, ring=None) -> List[int]:
    """b = Σ cᵢ·sⁱ without the π decode (rlwe_she.jl:206-212) — the
    noise-budget probe's input (bfv.jl:150-153)."""
    ring = ring or params.ring
    secret = kp.secret
    if kp.q and kp.q != ring.q:
        secret = [nt.centered(x, kp.q) % ring.q for x in secret]
    b = list(cs[0])
    spow = secret
    for i in range(1, len(cs)):
        b = ring.add(b, ring.mul(spow, cs[i]))
        if i + 1 < len(cs):
            spow = ring.mul(spow, secret)
    return b


def invariant_noise_budget(params: HostParams, kp: HostKeyPair, cs
                           ) -> Tuple[float, int]:
    """SEAL invariant noise budget −log2(2‖v‖) at the reference's own
    modulus (bfv.jl:136-164): decrypt raw, measure the worst distance of
    any coefficient from the Δ lattice. Returns (budget_bits, worst) —
    ``worst`` is an exact integer, the recordable golden quantity."""
    b = decrypt_raw(params, kp, cs)
    delta = params.delta
    worst = 1
    for x in b:
        r = int(x) % delta
        r = delta - r if r > delta // 2 else r
        worst = max(worst, r)
    budget = (math.log2(params.ring.q) - math.log2(params.p) - 1
              - math.log2(worst))
    return budget, worst


def ct_add(params: HostParams, a, b):
    ring = params.ring
    la, lb = len(a), len(b)
    out = []
    for i in range(max(la, lb)):
        if i < la and i < lb:
            out.append(ring.add(a[i], b[i]))
        else:
            out.append(list((a if i < la else b)[i]))
    return tuple(out)


def ct_mul(params: HostParams, cs1, cs2):
    """enc_mul (rlwe_she.jl:247-262) with the scheme's expand/contract
    hooks: BFV switches into ℛbig and multrounds back (bfv.jl:34-40);
    BGV/CKKS tensor in place."""
    ring = params.ring
    if params.scheme == "bfv":
        big = params.ring_big
        switch = lambda c: [nt.centered(x, ring.q) % big.q for x in c]
        a = [switch(c) for c in cs1]
        b = [switch(c) for c in cs2]
        out = [big.zero() for _ in range(len(a) + len(b) - 1)]
        for i in range(len(a)):
            for j in range(len(b)):
                out[i + j] = big.add(out[i + j], big.mul(a[i], b[j]))
        res = []
        for c in out:
            res.append([nt.divround(nt.centered(x, big.q) * params.p, ring.q)
                        % ring.q for x in c])
        return tuple(res)
    a, b = list(cs1), list(cs2)
    out = [ring.zero() for _ in range(len(a) + len(b) - 1)]
    for i in range(len(a)):
        for j in range(len(b)):
            out[i + j] = ring.add(out[i + j], ring.mul(a[i], b[j]))
    return tuple(out)


# -- key switching (rlwe_she.jl:273-347) -------------------------------------

def _gadget_factors(moduli: Sequence[int]) -> List[int]:
    """gᵢ = (q/qᵢ)·[(q/qᵢ)⁻¹ mod qᵢ] — the CRTResidual factors
    (crt.jl:60-77): Σ gᵢ·[x]_{qᵢ} ≡ x (mod q)."""
    q = math.prod(moduli)
    out = []
    for qi in moduli:
        qh = q // qi
        out.append(qh * pow(qh % qi, -1, qi) % q)
    return out


def make_eval_key(params: HostParams, old: Sequence[int], kp: HostKeyPair,
                  rng: random.Random,
                  galois_element: Optional[int] = None) -> HostEvalKey:
    """rlwe_she.jl:273-297 — both decompositions.

    window > 0: evalaᵢ = old·2^{i·w} for i = 0..nwindows−1
    (rlwe_she.jl:281-283).
    window = 0: evalaᵢ = old·gᵢ with gᵢ the CRT residual factor
    (rlwe_she.jl:285-287 — ``CRTResidual`` per limb).
    Then evalaᵢ −= mask·s + e with mask ← 𝒰, e ← 𝒩 per digit, in digit
    order (rlwe_she.jl:291-297).
    """
    ring = params.ring
    w = params.relin_window
    if w != 0:
        nwindows = _ndigits(ring.q, 1 << w)
        evala = [ring.scalar(1 << (i * w), old) for i in range(nwindows)]
    else:
        assert getattr(ring, "moduli", None), \
            "RNS decomposition needs an RNS tower"
        evala = [ring.scalar(g, old) for g in _gadget_factors(ring.moduli)]
    masks, maskeds = [], []
    for i in range(len(evala)):
        mask = ring.sample_uniform(rng)
        e = params.sample_noise(ring, rng)
        masks.append(mask)
        maskeds.append(ring.sub(evala[i], ring.add(ring.mul(mask, kp.secret), e)))
    return HostEvalKey(masks=masks, maskeds=maskeds, window=w,
                       galois_element=galois_element)


def _ndigits(q: int, base: int) -> int:
    n = 0
    while q:
        q //= base
        n += 1
    return n


def keygen_eval_mult(params: HostParams, kp: HostKeyPair,
                     rng: random.Random) -> HostEvalKey:
    """EvalMultKey: s² ⇒ s (rlwe_she.jl:299)."""
    s2 = params.ring.mul(kp.secret, kp.secret)
    return make_eval_key(params, s2, kp, rng)


def galois_element_for_steps(n: int, steps: int) -> int:
    """rlwe_she.jl:300-309: 3^(2N−steps) for steps > 0 else 3^(−steps),
    mod 2N."""
    m = 2 * n
    if steps > 0:
        return pow(3, 2 * n - steps, m)
    return pow(3, -steps, m)


def keygen_galois(params: HostParams, kp: HostKeyPair, rng: random.Random,
                  steps: Optional[int] = None,
                  galois_element: Optional[int] = None) -> HostEvalKey:
    ring = params.ring
    if galois_element is None:
        galois_element = galois_element_for_steps(ring.degree, steps)
    if isinstance(ring, GenericRing):
        sg = galois_generic(ring, kp.secret, galois_element)
    else:
        sg = ring.galois(kp.secret, galois_element)
    return make_eval_key(params, sg, kp, rng, galois_element=galois_element)


def keyswitch(params: HostParams, ek: HostEvalKey, cs) -> Tuple[List[int], ...]:
    """rlwe_she.jl:315-347 — len 2 or 3 in, len 2 out; both decompositions."""
    ring = params.ring
    assert len(cs) in (2, 3)
    c1 = list(cs[0])
    c2 = list(cs[1]) if len(cs) == 3 else ring.zero()
    cend = cs[-1]
    if ek.window == 0:
        # RNS limbs: psᵢ = centered lift of [cend]_{qᵢ} (rlwe_she.jl:327-330)
        ps = [[nt.centered(x % qi, qi) % ring.q for x in cend]
              for qi in ring.moduli]
    else:
        w = ek.window
        mask = (1 << w) - 1
        nwindows = _ndigits(ring.q, 1 << w)
        # non-negative digits of the [0, q) representative
        # (rlwe_she.jl:331-338: digits(convert(Integer, x))), peeled
        # incrementally so each coefficient's big int shrinks as we go.
        ps = [[0] * len(cend) for _ in range(nwindows)]
        for j, x in enumerate(cend):
            x = int(x)
            for i in range(nwindows):
                ps[i][j] = x & mask
                x >>= w
    for i, p in enumerate(ps):
        c2 = ring.add(c2, ring.mul(ek.masks[i], p))
        c1 = ring.add(c1, ring.mul(ek.maskeds[i], p))
    return (c1, c2)


def rotate(params: HostParams, gk: HostEvalKey, cs) -> Tuple[List[int], ...]:
    """rlwe_she.jl:355-360: apply σ_g to every component, then keyswitch."""
    ring = params.ring
    g = gk.galois_element
    if isinstance(ring, GenericRing):
        rotated = [galois_generic(ring, c, g) for c in cs]
    else:
        rotated = [ring.galois(c, g) for c in cs]
    return keyswitch(params, gk, rotated)


def modswitch(params: HostParams, cs):
    """CKKS rescale: drop the last prime from every component
    (crt.jl:215-220); returns (params', cs')."""
    ring = params.ring
    sub = None
    out = []
    for c in cs:
        sub, cp = ring.rescale(c)
        out.append(cp)
    new = dataclasses.replace(params, ring=sub, delta=params.delta)
    return new, tuple(out)


# ---------------------------------------------------------------------------
# Host CKKS encode/decode at arbitrary exact scale (ckksencoding.jl:56-97)
# ---------------------------------------------------------------------------

def ckks_encode_host(ring: Pow2HostRing, slots, scale) -> List[int]:
    """Same math as core/ckks_encoding.py::ckks_encode, to exact ints."""
    from .ckks_encoding import zmstar_indices
    n = ring.n
    scale = Fraction(scale)
    slots = np.asarray(slots, dtype=np.complex128)
    assert slots.shape == (n // 2,)
    r1, r2 = zmstar_indices(n)
    cmplx = np.zeros(n, dtype=np.complex128)
    cmplx[r1] = slots
    cmplx[r2] = np.conj(slots)
    ipoints = np.fft.ifft(cmplx)
    k = np.arange(n)
    nipoints = ipoints * np.exp(2j * np.pi * k / (2 * n))
    coeffs = []
    for x in nipoints.real:
        v = Fraction(x) * scale
        m = (2 * v.numerator + v.denominator) // (2 * v.denominator)
        coeffs.append(m % ring.q)
    return coeffs


def ckks_decode_host(ring: Pow2HostRing, coeffs: Sequence[int],
                     scale) -> np.ndarray:
    from .ckks_encoding import zmstar_indices
    n = ring.n
    scale = Fraction(scale)
    vals = np.array([nt.frac_to_float(Fraction(nt.centered(x, ring.q)) / scale)
                     for x in coeffs])
    k = np.arange(n)
    multed = vals * np.exp(-2j * np.pi * k / (2 * n))
    f = np.fft.fft(multed)
    r1, _ = zmstar_indices(n)
    return f[r1]
