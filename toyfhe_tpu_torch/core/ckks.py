"""CKKS scheme (layer L4).

Port of ``toyfhe_tpu/core/ckks.py``. π is the identity (noise lives in the
value); the encoder (:mod:`.ckks_encoding`) handles ℂ^{N/2} ↔ ring
conversion, and the exact scale is a ``fractions.Fraction`` carried as
ciphertext metadata.
"""

from __future__ import annotations

import math

from ..ops import sampling
from .ring import RingContext, RingElt
from .rlwe import SchemeParams

DEFAULT_SIGMA = 8.0 / math.sqrt(2.0 * math.pi)


class CKKSParams(SchemeParams):
    def __init__(self, ring: RingContext, relin_window: int = 0,
                 sigma: float = DEFAULT_SIGMA, secret: str = "gaussian",
                 hamming_weight: int = 0):
        """``secret="sparse"`` draws 𝒢 as a sparse ternary with
        ``hamming_weight`` nonzero ±1 coefficients."""
        self._ring = ring
        self.relin_window = relin_window
        self.sigma = float(sigma)
        if secret not in ("gaussian", "sparse"):
            raise ValueError(f"unknown secret distribution {secret!r}")
        if secret == "sparse" and hamming_weight <= 0:
            raise ValueError("sparse secret requires hamming_weight > 0")
        self.secret = secret
        self.hamming_weight = int(hamming_weight)

    @property
    def ring_cipher(self) -> RingContext:
        return self._ring

    def plaintext_space(self) -> RingContext:
        return self._ring

    def scheme_name(self):
        return "CKKS"

    def encode(self, plaintext: RingElt, ring=None, *, device) -> RingElt:
        return plaintext               # π⁻¹ = identity

    def decode(self, b: RingElt, ring: RingContext) -> RingElt:
        return b                       # π = identity

    def noise(self, gen, ring: RingContext, batch=()):
        return RingElt(primal=sampling.discrete_gaussian(
            gen, ring.mp, ring.n, self.sigma, batch))

    def secret_sampler(self, gen, ring: RingContext, batch=()):
        if self.secret == "sparse":
            return RingElt(primal=sampling.sparse_ternary(
                gen, ring.mp, ring.n, self.hamming_weight, batch))
        return RingElt(primal=sampling.discrete_gaussian(
            gen, ring.mp, ring.n, self.sigma, batch))
