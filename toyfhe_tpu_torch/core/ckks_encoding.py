"""CKKS slot encoding.

Port of ``toyfhe_tpu/core/ckks_encoding.py``: ℂ^{N/2} slots via the
conjugate-symmetric embedding with the ψ-twist that makes the FFT
negacyclic, and the ℤm* slot permutation that makes Galois act as a
circular shift. Encode and decode run on the host in float64 with exact
big-integer quantization (as in the reference); the encoded residues are
then placed on the requested device, and decode reads them back through
the exact Python CRT path.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Union

import numpy as np
import torch

from ..utils import numtheory as nt
from . import ring as R
from .ring import RingContext, RingElt
from .rlwe import CipherText

ScaleLike = Union[int, Fraction]


def zmstar_indices(n: int) -> tuple:
    """Rows of the ℤ_{2N}* permutation matrix, already halved: for
    j = 1..N/2, row1[j] = (3^j mod 2N) >> 1 indexes the kept
    (non-conjugate) FFT bin, row2[j] its conjugate partner."""
    m = 2 * n
    r1 = np.empty(n // 2, dtype=np.int64)
    r2 = np.empty(n // 2, dtype=np.int64)
    g = 1
    for j in range(n // 2):
        g = g * 3 % m
        r1[j] = g >> 1
        r2[j] = (m - g) >> 1
    return r1, r2


@dataclasses.dataclass(frozen=True)
class CKKSTag:
    """Decode tag carried on CKKS ciphertexts: tracks the scale exactly."""

    scale: Fraction

    def combine_mul(self, other: "CKKSTag") -> "CKKSTag":
        return CKKSTag(self.scale * other.scale)

    def combine_add(self, other: "CKKSTag") -> "CKKSTag":
        if self.scale != other.scale:
            raise ValueError(f"adding ciphertexts at different scales: "
                             f"{self.scale} vs {other.scale}")
        return self

    def rescale_by(self, prime: int) -> "CKKSTag":
        return CKKSTag(self.scale / prime)

    def decode(self, params, dec: RingElt, ring: RingContext) -> np.ndarray:
        return ckks_decode(ring, dec, self.scale)


@dataclasses.dataclass
class CKKSPlaintext:
    """A slot vector awaiting encryption."""

    ring: RingContext
    slots: np.ndarray          # complex128[N/2]
    scale: Fraction

    def to_ring(self, params, device) -> RingElt:
        return ckks_encode(self.ring, self.slots, self.scale, device)

    def decode_tag(self, params) -> CKKSTag:
        return CKKSTag(Fraction(self.scale))


def make_plaintext(ring: RingContext, values, scale: ScaleLike) -> CKKSPlaintext:
    slots = np.zeros(ring.n // 2, dtype=np.complex128)
    slots[:] = values
    return CKKSPlaintext(ring, slots, Fraction(scale))


def ckks_encode(ring: RingContext, slots, scale: ScaleLike, device) -> RingElt:
    """slots ∈ ℂ^{N/2} → ring element on ``device``: conjugate-symmetrize
    through the ℤm* permutation, inverse FFT, ψ-twist, then exact
    big-integer quantization by the scale."""
    n = ring.n
    scale = Fraction(scale)
    slots = np.asarray(slots, dtype=np.complex128)
    if slots.shape != (n // 2,):
        raise ValueError(f"expected {n // 2} slots, got shape {slots.shape}")
    r1, r2 = zmstar_indices(n)
    cmplx = np.zeros(n, dtype=np.complex128)
    cmplx[r1] = slots
    cmplx[r2] = np.conj(slots)
    ipoints = np.fft.ifft(cmplx)
    k = np.arange(n)
    nipoints = ipoints * np.exp(2j * np.pi * k / (2 * n))
    if not np.allclose(nipoints.imag, 0, atol=1e-9):
        raise ValueError("CKKS encode: non-negligible imaginary part")
    real = nipoints.real
    # Fast path: when the scale is a power of two and the scaled magnitudes
    # fit float64's integer range, ldexp+rint is exact.
    if (scale.denominator == 1 and (scale.numerator & (scale.numerator - 1)) == 0
            and float(np.max(np.abs(real), initial=0.0))
            * nt.frac_to_float(scale) < 2 ** 52):
        ints = np.rint(np.ldexp(real, scale.numerator.bit_length() - 1)).astype(np.int64)
        out = np.stack([np.mod(ints, p) for p in ring.primes])
    else:
        q = ring.modulus
        coeffs = []
        for x in real:
            v = Fraction(x) * scale
            m = (2 * v.numerator + v.denominator) // (2 * v.denominator)  # round half up
            coeffs.append(m % q)
        out = ring.from_bigint(coeffs)
    return RingElt(primal=torch.as_tensor(out, dtype=torch.int64, device=device))


def ckks_decode(ring: RingContext, re: RingElt, scale: ScaleLike) -> np.ndarray:
    """Ring element → slots ∈ ℂ^{N/2}, through the exact CRT on the host."""
    n = ring.n
    scale = Fraction(scale)
    re = R.ensure_primal(ring, re)
    xs = ring.to_bigint(re.primal.cpu().numpy())
    q = ring.modulus
    vals = np.array([nt.frac_to_float(Fraction(nt.centered(x, q)) / scale)
                     for x in xs])
    k = np.arange(n)
    multed = vals * np.exp(-2j * np.pi * k / (2 * n))
    f = np.fft.fft(multed)
    r1, _ = zmstar_indices(n)
    return f[r1]


# ---------------------------------------------------------------------------
# homomorphic plaintext operations (scale-tracked)
# ---------------------------------------------------------------------------

def _ct_scale(c: CipherText) -> Fraction:
    if not isinstance(c.enc, CKKSTag):
        raise ValueError("ciphertext carries no CKKS scale tag")
    return c.enc.scale


def _mul_plain_at(c: CipherText, vec, at_scale: Fraction) -> CipherText:
    scale = _ct_scale(c)
    pe = R.ensure_dual(c.ring, ckks_encode(c.ring, np.asarray(vec, dtype=np.complex128),
                                           at_scale, c.cs[0].device))
    cs = tuple(R.mul(c.ring, x_, pe) for x_ in c.cs)
    return CipherText(c.params, cs, c.ring, enc=CKKSTag(scale * at_scale))


def mul_plain_vector(c: CipherText, vec) -> CipherText:
    """c ·ₚ slot vector, encoded at the ciphertext's scale on its device;
    the result's scale squares."""
    return _mul_plain_at(c, vec, _ct_scale(c))


def mul_plain_vector_at(c: CipherText, vec, at_scale: ScaleLike) -> CipherText:
    """c ·ₚ slot vector quantized at an explicit scale; result scale =
    ct_scale · at_scale."""
    return _mul_plain_at(c, vec, Fraction(at_scale))
