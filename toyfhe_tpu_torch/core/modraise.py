"""Special-prime key switching (SEAL v3.3 "special prime").

Port of ``toyfhe_tpu/core/modraise.py``. The last prime of the tower is
reserved for keys: ciphertexts live one limb short, and key switching
multiplies the ciphertext into the special prime's basis, switches there,
then rescales the noise back down by the special prime.
"""

from __future__ import annotations

import torch

from . import ring as R
from . import rlwe
from .ring import RingContext, RingElt
from .rlwe import CipherText, PassthroughParams, PubKey


class ModulusRaised(PassthroughParams):
    """Scheme modifier: the last CRT prime of the wrapped params is the
    special prime."""

    @property
    def ring_cipher(self) -> RingContext:
        # ciphertexts live in the sub-tower without the special prime
        return self.params.ring_cipher.drop_last()

    @property
    def ring_key(self) -> RingContext:
        return self.params.ring_cipher

    @property
    def special_prime(self) -> int:
        return self.params.ring_cipher.primes[-1]

    def encrypt_zero(self, pub: PubKey, gen: torch.Generator) -> CipherText:
        """Encrypt at the full tower, then drop the special limb."""
        full = self.params.ring_cipher
        c = rlwe._encrypt_zero_at(self, full, pub.key, gen)
        cs = []
        sub = None
        for x in c.cs:
            sub, y = R.modswitch_drop(full, x)
            cs.append(y)
        return CipherText(self, tuple(cs), sub)

    def lift_old_key(self, old: RingElt) -> RingElt:
        """Key-switch keys encrypt ps·old."""
        full = self.params.ring_cipher
        return R.scalar_mul(full, self.special_prime, old)

    def keyswitch_expand(self, ring: RingContext, c: RingElt):
        """A ciphertext component carried into the special prime's basis:
        multiplied by ps, with a zero special limb adjoined (primal)."""
        full = self.params.ring_cipher
        expanded_ring = full.select(list(range(ring.nlimbs)) + [full.nlimbs - 1])
        c = R.ensure_primal(ring, c)
        scaled = R.scalar_mul(ring, self.special_prime, c)
        zerolimb = torch.zeros(c.primal.shape[:-2] + (1, ring.n), dtype=torch.int64,
                               device=c.primal.device)
        return expanded_ring, RingElt(
            primal=torch.cat([scaled.primal, zerolimb], dim=-2))

    def keyswitch_contract(self, ring: RingContext, c: RingElt):
        """Rescale by the special prime. A BGV base takes the p-adapted
        rounding, so the low plaintext digits survive the division (the
        special prime cancels fully: no message factor is left)."""
        t = rlwe.bgv_plain_modulus(self)
        if t is not None:
            return R.rescale_adapted(ring, c, t)
        if c.dual is not None and c.primal is None:
            return R.rescale_dual(ring, c)     # bit-identical to the primal rescale
        return R.rescale(ring, c)
