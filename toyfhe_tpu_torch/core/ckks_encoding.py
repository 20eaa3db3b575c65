"""CKKS slot encoding.

Port of ``toyfhe_tpu/core/ckks_encoding.py``: ℂ^{N/2} slots via the
conjugate-symmetric embedding with the ψ-twist that makes the FFT
negacyclic, and the ℤm* slot permutation that makes Galois act as a
circular shift. Encode and decode run on the host in float64 with exact
big-integer quantization (as in the reference); the encoded residues are
then placed on the requested device, and decode reads them back through
the exact Python CRT path.

The plaintext operations keep the reference's exact scale algebra: every
scale tag is a ``Fraction``, and :func:`ct_to` / :func:`mul_plain_scalar_at`
align ciphertexts on different paths to one exact (tower, scale). Inside
:func:`encode_cache` the encodes that are given a key are made once and
kept on the device (the bootstrap's transform diagonals and EvalMod
constants), so a repeated evaluation encodes nothing on the host.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from fractions import Fraction
from typing import Optional, Union

import numpy as np
import torch

from ..utils import numtheory as nt
from . import ring as R
from . import rlwe
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
    big-integer quantization by the scale. On a sharded tower, the rows
    this rank holds."""
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
        out = np.mod(ints[None, :], np.asarray(ring.local.primes, dtype=np.int64)[:, None])
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
    """Ring element → slots ∈ ℂ^{N/2}, through the C++ CRT on the host (the
    centered value as a double, then divided by the scale, as the
    reference's decode), or the exact CRT on a tower it cannot hold."""
    n = ring.n
    scale = Fraction(scale)
    re = R.ensure_primal(ring, re)
    arr = re.primal.cpu().numpy()
    nat = ring.native()
    if nat is not None:
        vals = nat.decode_centered_double(arr) / nt.frac_to_float(scale)
    else:
        vals = np.array([nt.frac_to_float(Fraction(x) / scale) for x in ring.centered_ints(arr)])
    k = np.arange(n)
    multed = vals * np.exp(-2j * np.pi * k / (2 * n))
    f = np.fft.fft(multed)
    r1, _ = zmstar_indices(n)
    return f[r1]


# ---------------------------------------------------------------------------
# encoded plaintexts kept on the device
# ---------------------------------------------------------------------------

# the store of the innermost active encode_cache block (per thread / task)
_store: contextvars.ContextVar = contextvars.ContextVar("encode_store", default=None)


@contextlib.contextmanager
def encode_cache(store: dict):
    """Inside the block, every encode made with a key (the ``key`` argument
    of :func:`mul_plain_vector_at` / :func:`mul_plain_vectors`, and
    :func:`add_plain` of a scalar) is looked up in ``store`` and made, on
    the ciphertext's device, only when missing. The key is the caller's,
    extended by the ring, the device and the exact scale of the encode."""
    token = _store.set(store)
    try:
        yield store
    finally:
        _store.reset(token)


def _encoded(key, make) -> RingElt:
    """``make()`` through the active store when ``key`` is given."""
    store = _store.get()
    if store is None or key is None:
        return make()
    hit = store.get(key)
    if hit is None:
        hit = store[key] = make()
    return hit


# ---------------------------------------------------------------------------
# homomorphic plaintext operations (scale-tracked)
# ---------------------------------------------------------------------------

def _ct_scale(c: CipherText) -> Fraction:
    if not isinstance(c.enc, CKKSTag):
        raise ValueError("ciphertext carries no CKKS scale tag")
    return c.enc.scale


def _mul_plain_at(c: CipherText, vec, at_scale: Fraction, key=None) -> CipherText:
    scale = _ct_scale(c)
    dev = c.cs[0].device
    pe = _encoded(None if key is None else (key, c.ring, dev, at_scale),
                  lambda: RingElt(dual=R.ensure_dual(c.ring, ckks_encode(
                      c.ring, np.asarray(vec, dtype=np.complex128), at_scale, dev)).dual))
    cs = tuple(R.mul(c.ring, x_, pe) for x_ in c.cs)
    return CipherText(c.params, cs, c.ring, enc=CKKSTag(scale * at_scale))


def mul_plain_vector(c: CipherText, vec, key=None) -> CipherText:
    """c ·ₚ slot vector, encoded at the ciphertext's scale on its device;
    the result's scale squares."""
    return _mul_plain_at(c, vec, _ct_scale(c), key)


def mul_plain_vector_at(c: CipherText, vec, at_scale: ScaleLike, key=None) -> CipherText:
    """c ·ₚ slot vector quantized at an explicit scale; result scale =
    ct_scale · at_scale."""
    return _mul_plain_at(c, vec, Fraction(at_scale), key)


def mul_plain_vectors(c: CipherText, vecs, at_scale: Optional[ScaleLike] = None,
                      key=None) -> CipherText:
    """Batched slot-vector multiply: ``vecs[B, d]`` aligns with a batch-B
    ciphertext's leading axis (one plaintext per batch element; further
    leading axes of the ciphertext broadcast). Encoded at the ciphertext's
    scale, or at ``at_scale`` when given — the hook that pins transform
    levels to a target scale instead of letting s → s²/q drift compound."""
    scale = _ct_scale(c)
    at = scale if at_scale is None else Fraction(at_scale)
    dev = c.cs[0].device

    def make():
        vs = np.asarray(vecs, dtype=np.complex128)
        pes = torch.stack([ckks_encode(c.ring, v, at, dev).primal for v in vs], 0)
        return RingElt(dual=R.ensure_dual(c.ring, RingElt(primal=pes)).dual)

    pe = _encoded(None if key is None else (key, c.ring, dev, at), make)
    cs = tuple(R.mul(c.ring, x_, pe) for x_ in c.cs)
    return CipherText(c.params, cs, c.ring, enc=CKKSTag(scale * at))


def mul_plain_scalar(c: CipherText, x: float) -> CipherText:
    """c ·ₚ scalar quantized at the ciphertext's scale; the result's scale
    squares."""
    return mul_plain_scalar_at(c, x, _ct_scale(c))


def mul_plain_scalar_at(c: CipherText, x, at_scale: ScaleLike) -> CipherText:
    """c ·ₚ scalar quantized at an explicit scale: the result's scale is
    exactly ``ct_scale · at_scale`` (quantization error ≤ 1/(2·at_scale)
    relative, absorbed into the noise). The exact-scale primitive behind
    :func:`ct_to` and the Paterson–Stockmeyer evaluator's term alignment."""
    scale = _ct_scale(c)
    at_scale = Fraction(at_scale)
    if at_scale <= 0:
        raise ValueError("at_scale must be positive")
    v = Fraction(x) * at_scale
    m = (2 * v.numerator + v.denominator) // (2 * v.denominator)   # round half up
    s = c.ring.scalar_residues(m % c.ring.modulus)
    cs = tuple(R.scalar_mul(c.ring, s, x_) for x_ in c.cs)
    return CipherText(c.params, cs, c.ring, enc=CKKSTag(scale * at_scale))


def retag(c: CipherText, scale: ScaleLike) -> CipherText:
    """Reinterpret the ciphertext at another exact scale — free and
    noiseless; the decoded value is divided by new/current. The bootstrap
    divides by q₀ this way."""
    return CipherText(c.params, c.cs, c.ring, enc=CKKSTag(Fraction(scale)))


def mul_int(c: CipherText, k: int) -> CipherText:
    """Exact small-integer multiply: scales the value by k, scale tag
    unchanged (the 2·T_a·T_b of the Chebyshev recurrences)."""
    s = c.ring.scalar_residues(int(k) % c.ring.modulus)
    cs = tuple(R.scalar_mul(c.ring, s, x_) for x_ in c.cs)
    return CipherText(c.params, cs, c.ring, enc=c.enc)


def ct_drop_to(c: CipherText, nlimbs: int) -> CipherText:
    """Drop limbs (no rescale) until the tower has ``nlimbs`` limbs."""
    while c.ring.nlimbs > nlimbs:
        c = rlwe.ct_modswitch_drop(c)
    if c.ring.nlimbs != nlimbs:
        raise ValueError(f"cannot raise tower: at {c.ring.nlimbs}, want {nlimbs}")
    return c


def ct_to(c: CipherText, nlimbs: int, scale: ScaleLike) -> CipherText:
    """Bring a CKKS ciphertext to an exact (tower length, scale) target
    using spare levels: limb drops plus, when the scale differs, one scalar
    multiply at the correcting scale r = scale·(∏ dropped p)/cur followed by
    rescales. Uses as many spare levels as it takes to make the ratio
    comfortably quantizable (r ≥ 2^8 when the levels allow, ≥ 2 at least)."""
    scale = Fraction(scale)
    cur = _ct_scale(c)
    if cur == scale:
        return ct_drop_to(c, nlimbs)
    avail = c.ring.nlimbs - nlimbs
    if avail <= 0:
        raise ValueError(
            f"no spare level for scale alignment: at {c.ring.nlimbs} limbs, "
            f"target {nlimbs} with scale {float(scale):g} != {float(cur):g}")
    r = Fraction(0)
    for j in range(1, avail + 1):
        cj = ct_drop_to(c, nlimbs + j)
        r = scale * math.prod(cj.ring.primes[-j:]) / cur
        if r >= (1 << 8) or (j == avail and r >= 2):
            c = mul_plain_scalar_at(cj, 1.0, r)
            for _ in range(j):
                c = rlwe.ct_rescale(c)
            return c
    raise ValueError(f"alignment ratio {float(r):g} too small to quantize "
                     f"({avail} spare levels)")


def add_plain(c: CipherText, vals) -> CipherText:
    """c +ₚ scalar or slot vector (broadcast), encoded at the ciphertext's
    scale. A scalar's encode is kept in the active :func:`encode_cache`."""
    scale = _ct_scale(c)
    dev = c.cs[0].device

    def make():
        slots = np.zeros(c.ring.n // 2, dtype=np.complex128)
        slots[:] = vals
        return R.ensure_dual(c.ring, ckks_encode(c.ring, slots, scale, dev))

    key = ("add_plain", c.ring, dev, scale, complex(vals)) if np.isscalar(vals) else None
    return rlwe.ct_add_ring(c, _encoded(key, make))
