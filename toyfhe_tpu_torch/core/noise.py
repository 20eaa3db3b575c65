"""Noise instrumentation across the three schemes.

Port of ``toyfhe_tpu/core/noise.py``: the BGV noise budget and the CKKS
precision meters (both need the secret key and run the exact host path),
and the analytic CKKS noise estimator, which needs no key.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import ring as R
from .rlwe import CipherText, KeyPair, _gadget_shape, decrypt, decrypt_raw


def bgv_noise_budget(key, c: CipherText) -> float:
    """Bits of headroom before BGV decryption fails: log2(q/2) minus the
    log-magnitude of the centered payload m + p·e."""
    priv = key.priv if isinstance(key, KeyPair) else key
    ring = c.ring
    b = R.ensure_primal(ring, decrypt_raw(priv, c))
    arr = b.primal.cpu().numpy()
    nat = ring.native()
    if nat is not None:
        worst = float(max(np.abs(nat.decode_centered_double(arr)).max(), 1.0))
    else:
        worst = max(max(abs(x) for x in ring.centered_ints(arr)), 1)
    return math.log2(ring.modulus / 2) - math.log2(worst)


def ckks_precision(key, c: CipherText, expected) -> float:
    """Measured CKKS precision in bits: −log2 of the max absolute slot
    error against the expected values (the CKKS half of the noise story —
    scale bookkeeping gives the *budget*, this measures the *actual*)."""
    got = decrypt(key, c)
    err = float(np.abs(np.asarray(got) - np.asarray(expected)).max())
    return -math.log2(max(err, 1e-300))


def ckks_scale_bits(c: CipherText) -> float:
    """Current scale in bits (type-level scale algebra made inspectable)."""
    return math.log2(float(c.enc.scale))


# ---------------------------------------------------------------------------
# Analytic CKKS noise estimator — NO secret key required
# ---------------------------------------------------------------------------
#
# The BFV meter (bfv.invariant_noise_budget) decrypts with the secret
# key. CKKS noise is inseparable from the message even WITH the key, so
# production CKKS tracking is analytic: propagate a high-probability
# bound on the slot-domain error through every op. Conventions:
#
#   * ``eps``  — bound on max |slot error| in MESSAGE units (i.e. after
#     decode at the ciphertext's current scale); invariant under rescale.
#   * ``bound`` — bound on max |slot value| (needed because ct×ct noise
#     is message-dependent: e_ab = e_a·m_b + e_b·m_a + e_a·e_b).
#   * coefficient-domain variance v maps to a slot std of √(N·v) (each
#     slot is an N-term sum with unit-modulus weights); ``_HI`` = 6
#     turns std into a high-probability max bound.

_HI = 6.0


@dataclasses.dataclass
class NoiseEstimate:
    eps: float      # high-prob bound on max |slot error|, message units
    bound: float    # bound on max |slot value|

    @property
    def precision_bits(self) -> float:
        return -math.log2(max(self.eps, 1e-300))


def _base(params):
    """Unwrap PassthroughParams to the scheme params with σ/secret."""
    p = params
    while not hasattr(p, "sigma") and hasattr(p, "params"):
        p = p.params
    return p


def _secret_l2sq(params, n: int) -> float:
    """E[‖s‖₂²]: h for a sparse ternary secret, N·σ² for gaussian."""
    p = _base(params)
    if getattr(p, "secret", "gaussian") == "sparse":
        return float(p.hamming_weight)
    return n * float(p.sigma) ** 2


def _slot_eps(var_coeff: float, n: int, scale) -> float:
    return _HI * math.sqrt(n * var_coeff) / float(scale)


def est_fresh(c: CipherText, bound: float) -> NoiseEstimate:
    """Fresh public-key encryption with |slots| ≤ ``bound``: the error
    polynomial is e₁ + u·e + s·e₂ plus the encode
    rounding (var 1/12 per coefficient)."""
    n = c.ring.n
    s2 = float(_base(c.params).sigma) ** 2
    l2 = _secret_l2sq(c.params, n)
    var = s2 * (1.0 + 2.0 * l2) + 1.0 / 12.0
    return NoiseEstimate(_slot_eps(var, n, c.enc.scale), float(bound))


def est_add(a: NoiseEstimate, b: NoiseEstimate) -> NoiseEstimate:
    return NoiseEstimate(math.hypot(a.eps, b.eps), a.bound + b.bound)


def est_mul(a: NoiseEstimate, b: NoiseEstimate) -> NoiseEstimate:
    """ct×ct (before relinearization/rescale): message-dependent."""
    return NoiseEstimate(a.eps * b.bound + b.eps * a.bound + a.eps * b.eps,
                         a.bound * b.bound)


def est_mul_plain(est: NoiseEstimate, c: CipherText, pbound: float,
                  at_scale) -> NoiseEstimate:
    """Plain-vector/scalar multiply quantized at ``at_scale``
    (mul_plain_vector_at): plaintext quantization ≲ √(N/12)/at_scale in
    slot units multiplies against the message and the error."""
    n = c.ring.n
    delta = _HI * math.sqrt(n / 12.0) / float(at_scale)
    return NoiseEstimate(est.eps * pbound + (est.bound + est.eps) * delta,
                         est.bound * pbound)


def est_rescale(est: NoiseEstimate, c_after: CipherText) -> NoiseEstimate:
    """Rescale by the dropped prime: message units are preserved; the
    rounding adds a (1 + ‖s‖₂²)/12-variance error polynomial at the NEW
    scale."""
    n = c_after.ring.n
    var = (1.0 + _secret_l2sq(c_after.params, n)) / 12.0
    return NoiseEstimate(est.eps + _slot_eps(var, n, c_after.enc.scale),
                         est.bound)


def est_keyswitch(est: NoiseEstimate, c: CipherText) -> NoiseEstimate:
    """Key-switch (relinearize/rotate) noise for the unified gadget, at
    the ciphertext's CURRENT (tower, scale) — pass the ct being switched
    (post-mul, pre-rescale). relin_window = 0: per-limb centered RNS
    digits with var qᵢ²/12; w > 0: RAW (unsigned) base-2^w digits with
    E[d²] ≈ 4^w/3, L·K of them (gadget_decompose). A ModulusRaised
    wrapper divides by the special prime and adds one rescale-style
    rounding term."""
    params, ring, n = c.params, c.ring, c.ring.n
    if getattr(params, "hybrid_decompose", None) is not None:
        return _est_keyswitch_hybrid(est, c)
    sp = None
    q = params
    while q is not None:
        if hasattr(q, "special_prime"):
            sp = int(q.special_prime)
            break
        q = getattr(q, "params", None)
    w = params.relin_window
    s2 = float(_base(params).sigma) ** 2
    if w:
        _, total = _gadget_shape(ring, w)
        var = total * n * (4.0 ** w / 3.0) * s2
    else:
        var = sum((qi * qi / 12.0) * n * s2 for qi in ring.primes)
    eps = _HI * math.sqrt(n * var) / float(c.enc.scale)
    if sp is not None:
        eps /= sp
        eps += _slot_eps((1.0 + _secret_l2sq(params, n)) / 12.0,
                         n, c.enc.scale)
    return NoiseEstimate(est.eps + eps, est.bound)


def _est_keyswitch_hybrid(est: NoiseEstimate, c: CipherText
                          ) -> NoiseEstimate:
    """dnum-grouped hybrid gadget (core/hybrid.py): digit j is the FBC
    lift of group j, |D_j| ≤ α_j·Q_j (E[D²] ≈ α²Q²/3); the accumulator
    divides by P, then k rounding rescales land at the ct scale."""
    params, ring, n = c.params, c.ring, c.ring.n
    s2 = float(_base(params).sigma) ** 2
    a = params.alpha
    var = 0.0
    for j in range(params.dnum):
        grp = ring.primes[j * a:(j + 1) * a]
        if not grp:
            break
        qj = math.prod(grp)
        var += n * (len(grp) ** 2 * qj * qj / 3.0) * s2
    eps = _HI * math.sqrt(n * var) / (float(params.P) * float(c.enc.scale))
    rnd = params.num_special * _slot_eps(
        (1.0 + _secret_l2sq(params, n)) / 12.0, n, c.enc.scale)
    return NoiseEstimate(est.eps + eps + rnd, est.bound)


def est_rotate(est: NoiseEstimate, c: CipherText) -> NoiseEstimate:
    """Rotation = permutation (noise-free) + keyswitch."""
    return est_keyswitch(est, c)
