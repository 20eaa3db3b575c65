"""CKKS tower planning and the HEStd security check of a planned tower.

Port of ``toyfhe_tpu/core/planner.py``. The constraints it encodes:

  * scale ≈ rescale-prime size keeps the scale stable across levels;
  * after consuming ``depth`` rescales, the surviving bottom tower must
    cover scale² · 2^value_bits (the last multiply is not rescaled
    before decryption);
  * primes < 2^30 enable the lazy butterflies of the NTT kernel;
  * one extra limb is reserved as the SEAL-style special prime.
"""

from __future__ import annotations

from typing import Tuple

from .ring import RingContext, make_rns_ring


def plan_ckks_tower(n: int, depth: int, scale_bits: int = 28,
                    value_bits: int = 8,
                    special: bool = True) -> Tuple[Tuple[int, ...], int]:
    """Returns (limb_bits, scale_log2) for a CKKS circuit of ``depth``
    rescales with slot magnitudes up to 2^value_bits.

    limb sizes equal scale_bits (< 30 recommended); bottom limbs are
    added until they cover the final scale² · value range; the last limb
    is the special prime when ``special``.
    """
    if not (20 <= scale_bits <= 29):
        raise ValueError("scale_bits should be in [20, 29] "
                         "(primes < 2^30 keep the fast kernel paths)")
    final_bits = 2 * scale_bits + value_bits + 2     # scale² · |v| · margin
    bottom = max(2, -(-final_bits // scale_bits))
    data_limbs = bottom + depth
    limbs = (scale_bits,) * (data_limbs + (1 if special else 0))
    return limbs, scale_bits


class SecurityWarning(UserWarning):
    """Planned parameters fall short of 128-bit classical security."""


def check_tower_security(n: int, total_bits: float, *,
                         dist=None, what: str = "tower") -> None:
    """Warn (``SecurityWarning``) when a planned tower of ``total_bits``
    at ring dimension ``n`` misses 128-bit classical security per the
    HEStd v1.1 table. A tower larger than EVERY budget in the table is
    the *most* insecure configuration and warns hardest (this used to be
    silently skipped)."""
    import warnings

    from . import cryptparams

    if dist is None:
        dist = cryptparams.HEStd_error
    try:
        max_n = cryptparams.std_ring_dim(
            dist, cryptparams.HEStd_128_classic, total_bits)
    except ValueError:
        warnings.warn(
            f"{what} of {total_bits} bits exceeds the largest "
            f"HomomorphicEncryption.org v1.1 budget at ANY standard ring "
            f"dimension — NOT 128-bit secure at N={n}; shrink the tower "
            f"or accept a non-standard parameter set",
            SecurityWarning, stacklevel=3)
        return
    if max_n > n:
        warnings.warn(
            f"{what} of {total_bits} bits wants N ≥ {max_n} for 128-bit "
            f"classical security (got N={n})",
            SecurityWarning, stacklevel=3)


def plan_ckks_ring(n: int, depth: int, scale_bits: int = 28,
                   value_bits: int = 8, *,
                   check_security: bool = True) -> Tuple[RingContext, int]:
    """Convenience: build the ring for :func:`plan_ckks_tower`. Checks
    the HomomorphicEncryption.org budget (``check_security=False`` opts
    out, e.g. for deliberately-toy test rings)."""
    limbs, s = plan_ckks_tower(n, depth, scale_bits, value_bits)
    if check_security:
        check_tower_security(n, sum(limbs), what="CKKS tower")
    return make_rns_ring(n, limbs), s
