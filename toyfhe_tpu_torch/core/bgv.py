"""BGV scheme (layer L4).

Port of ``toyfhe_tpu/core/bgv.py``. The plaintext rides the low digits: π⁻¹
embeds m directly, the noise is p·𝒩, π is the centered residue mod p.
Leveled BGV (a rescale by q_k multiplies the message by q_k⁻¹ mod p) tracks
that factor in a :class:`BGVTag`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import sampling
from . import ring as R
from .plain import PlainPoly, PlainRing
from .ring import RingContext, RingElt
from .rlwe import SchemeParams, UsageError


@dataclasses.dataclass(frozen=True)
class BGVTag:
    """Leveled-BGV plaintext correction: rescaling by q_k multiplies the
    message by q_k⁻¹ mod p. ``mult`` accumulates the dropped primes mod p;
    decode multiplies the result back by it."""

    p: int
    mult: int = 1

    def rescale_by(self, q: int) -> "BGVTag":
        return BGVTag(self.p, self.mult * (int(q) % self.p) % self.p)

    def drop_limb(self, ring) -> "BGVTag":
        return self                     # a drop without rescale leaves m as it is

    def combine_mul(self, other: "BGVTag") -> "BGVTag":
        if self.p != other.p:
            raise UsageError("BGV plaintext modulus mismatch")
        return BGVTag(self.p, self.mult * other.mult % self.p)

    def combine_add(self, other: "BGVTag") -> "BGVTag":
        if (self.p, self.mult) != (other.p, other.mult):
            raise UsageError(
                "BGV level-factor mismatch on add: rescale both operands "
                "by the same primes first")
        return self

    def decode(self, params, dec: PlainPoly, ring) -> PlainPoly:
        return PlainPoly(dec.ring, dec.coeffs * self.mult % self.p)


class BGVParams(SchemeParams):
    def __init__(self, ring: RingContext, p: int, sigma: float, relin_window: int = 0):
        self._ring = ring
        self.plain = PlainRing(ring.n, p)
        self.sigma = float(sigma)
        self.relin_window = relin_window

    @property
    def ring_cipher(self) -> RingContext:
        return self._ring

    def plaintext_space(self) -> PlainRing:
        return self.plain

    def scheme_name(self):
        return "BGV"

    def encode(self, plaintext: PlainPoly, ring: RingContext = None, *, device) -> RingElt:
        """π⁻¹ on ``ring`` (default the full tower; a raising modifier
        encrypts at a shorter one), on ``device``: the coefficients are below
        p and every q_i, so the embedding is the identity."""
        ring = ring if ring is not None else self._ring
        m = torch.as_tensor(np.asarray(plaintext.coeffs, dtype=np.int64), device=device)
        return RingElt(primal=m[..., None, :].expand(m.shape[:-1] + (ring.nlimbs, ring.n)))

    def decode(self, b: RingElt, ring: RingContext) -> PlainPoly:
        b = R.ensure_primal(ring, b)
        arr = b.primal.cpu().numpy()
        p = self.plain.p
        nat = ring.native()
        if nat is not None:
            return PlainPoly(self.plain, nat.decode_centered_mod(arr, p))
        return PlainPoly(self.plain, np.array([x % p for x in ring.centered_ints(arr)],
                                              dtype=np.int64))

    def noise(self, gen, ring: RingContext, batch=()):
        return RingElt(primal=sampling.discrete_gaussian(
            gen, ring.mp, ring.n, self.sigma, batch, shift=self.plain.p))

    def secret_sampler(self, gen, ring: RingContext, batch=()):
        return RingElt(primal=sampling.discrete_gaussian(
            gen, ring.mp, ring.n, self.sigma, batch))
