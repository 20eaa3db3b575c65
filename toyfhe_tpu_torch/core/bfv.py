"""BFV scheme (layer L4).

Port of ``toyfhe_tpu/core/bfv.py``:

  * the ciphertext modulus is an RNS tower of < 2^31 primes; the PALISADE
    parameter generator below emits limb bit-sizes rather than one wide
    prime;
  * multiplication is the exact BEHZ RNS pipeline (:mod:`.behz`);
  * decode CRT-reconstructs on the host through the C++ CRT
    (``RingContext.native``), as the reference does; the invariant noise
    budget takes the exact Python CRT (``RingContext.to_bigint``), since the
    C++ meter rounds near the Δ lattice's midpoints.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import modmath, sampling
from ..utils import numtheory as nt
from . import cryptparams
from . import ring as R
from .behz import BFVMulContext, make_aux_ring
from .plain import PlainPoly, PlainRing
from .ring import RingContext, RingElt
from .rlwe import CipherText, KeyPair, SchemeParams, decrypt_raw

DEFAULT_SIGMA = 8.0 / math.sqrt(2.0 * math.pi)


class BFVParams(SchemeParams):
    """BFV parameter set: ciphertext ring, auxiliary multiply base,
    plaintext ring, gadget window, σ, Δ."""

    def __init__(self, ring: RingContext, aux_ring: Optional[RingContext],
                 plain_ring: PlainRing, relin_window: int, sigma: float,
                 delta: Optional[int] = None):
        self._ring = ring
        self.aux_ring = aux_ring if aux_ring is not None else make_aux_ring(ring)
        self.plain = plain_ring
        self.relin_window = relin_window
        self.sigma = float(sigma)
        self.delta = int(delta) if delta is not None else ring.modulus // plain_ring.p
        self._delta_res = ring.scalar_residues(self.delta)
        self._mulctx: dict = {}          # BEHZ contexts, one per ciphertext tower

    @property
    def ring_cipher(self) -> RingContext:
        return self._ring

    def plaintext_space(self) -> PlainRing:
        return self.plain

    def scheme_name(self):
        return "BFV"

    def encode(self, plaintext: PlainPoly, ring: RingContext = None, *, device) -> RingElt:
        """π⁻¹: Δ·m on ``ring`` (default the full tower; a raising modifier
        encrypts at a shorter tower, where Δ is ⌊q_ring/p⌋), on ``device``."""
        ring = ring if ring is not None else self._ring
        if ring is self._ring:
            delta_res = self._delta_res
        else:
            delta_res = ring.scalar_residues(ring.modulus // self.plain.p)
        m = torch.as_tensor(np.asarray(plaintext.coeffs, dtype=np.int64), device=device)
        m = m[..., None, :].expand(m.shape[:-1] + (ring.nlimbs, ring.n))
        return RingElt(primal=modmath.mul_mod(m, modmath.as_residues(delta_res, device),
                                              ring.mp))

    def decode(self, b: RingElt, ring: RingContext) -> PlainPoly:
        """π: centered round by Δ (at the ciphertext's own tower), then mod p;
        through the C++ CRT on the host (the exact CRT on a tower it cannot
        hold)."""
        b = R.ensure_primal(ring, b)
        p = self.plain.p
        delta = self.delta if ring is self._ring else ring.modulus // p
        arr = b.primal.cpu().numpy()
        nat = ring.native()
        if nat is not None:
            return PlainPoly(self.plain, nat.decode_bfv(arr, delta, p))
        return PlainPoly(self.plain, np.array([nt.divround(x, delta) % p
                                               for x in ring.centered_ints(arr)], dtype=np.int64))

    def noise(self, gen, ring: RingContext, batch=()):
        return RingElt(primal=sampling.discrete_gaussian(gen, ring.mp, ring.n,
                                                         self.sigma, batch))

    def secret_sampler(self, gen, ring: RingContext, batch=()):
        return RingElt(primal=sampling.discrete_gaussian(gen, ring.mp, ring.n,
                                                         self.sigma, batch))

    # multiplication hooks: the BEHZ pipeline, built per ciphertext tower
    # (a raising modifier or a rescale leaves the ciphertext short of the
    # base ring)
    def mul_ctx(self, ring: RingContext = None) -> BFVMulContext:
        ring = ring if ring is not None else self._ring
        key = tuple(ring.primes)
        if key not in self._mulctx:
            aux = self.aux_ring if ring is self._ring else make_aux_ring(ring)
            self._mulctx[key] = BFVMulContext(ring, aux)
        return self._mulctx[key]

    def mul_expand_pair(self, c1: CipherText, c2: CipherText):
        """Both ciphertexts in the extended tower, dual: each component is
        transformed once, not once for every product it enters."""
        ctx = self.mul_ctx(c1.ring)
        ext = ctx.ext_ring
        a = tuple(R.ensure_dual(ext, ctx.expand_component(x)) for x in c1.cs)
        b = tuple(R.ensure_dual(ext, ctx.expand_component(x)) for x in c2.cs)
        return ext, (a, b)

    def mul_contract_pair(self, ring, cs):
        # ``ring`` is the extended tower q ∪ B ∪ {m_sk} of one context
        ctx = next(c for c in self._mulctx.values() if c.ext_ring is ring)
        t = self.plain.p
        return ctx.ring, tuple(ctx.contract_component(w, t) for w in cs)


def bfv_params(p: int, sigma: float = DEFAULT_SIGMA, alpha: float = 9.0,
               r: int = 1, eval_mult_count: int = 0,
               security=cryptparams.HEStd_128_classic,
               relin_window: int = 0,
               limb_bits: int = 28,
               check_security: bool = True) -> BFVParams:
    """Parameter generation after PALISADE's heuristics, re-planned onto an
    RNS tower of ``limb_bits`` primes.

    The heuristic picks n for the requested ``security`` at the minimal q
    budget; the RNS re-planning rounds q up to whole limbs, so the final
    tower is audited again against the HEStd table (a SecurityWarning when
    the slack pushed it over; ``check_security=False`` opts out).
    """
    if r < 1:
        raise ValueError(f"the gadget base exponent r must be at least 1, got {r}")
    Berr = sigma * math.sqrt(alpha)
    Bkey = Berr
    delta_fn = lambda n: 2.0 * math.sqrt(n)
    Vnorm = lambda n: Berr * (1 + 2 * delta_fn(n) * Bkey)

    def nRLWE(q):
        if isinstance(security, cryptparams.StdSecurity):
            return cryptparams.std_ring_dim(
                cryptparams.HEStd_error, security, math.ceil(math.log2(q)))
        return math.log2(q / sigma) / (4 * math.log2(security))

    n = 512
    q = 0.0
    if eval_mult_count > 0:
        w = 2.0 ** r
        # evaluated left to right as PALISADE writes ``4 / δ(n)*Bkey``, so
        # the planned q budget matches digit for digit
        eps1 = lambda n: 4 / delta_fn(n) * Bkey
        C1 = lambda n: (1 + eps1(n)) * delta_fn(n) ** 2 * p * Bkey
        C2 = lambda n, qP: (delta_fn(n) ** 2 * p * Bkey * (Bkey + p * p)
                            + delta_fn(n) * (math.floor(math.log2(qP) / r) + 1) * w * Berr)
        qBFV = lambda n, qP: (p * p + 2 * p * (
            C1(n) ** eval_mult_count * Vnorm(n)
            + eval_mult_count * C1(n) ** (eval_mult_count - 1) * C2(n, qP)))

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

    bits = math.ceil(math.log2(q)) + 1 if q > 0 else 60
    # RNS re-planning: split the q budget into < 2^31 NTT-friendly limbs
    nlimbs = max(1, -(-bits // limb_bits))
    per = -(-bits // nlimbs)
    ring = RingContext(n, nt.ntt_prime_chain(n, (per,) * nlimbs))
    params = BFVParams(ring, make_aux_ring(ring), PlainRing(n, p), relin_window, sigma)
    # the heuristic's minimal q budget in bits, before the RNS re-planning
    # rounded it up to whole limbs (the noise-window tests shift by the slack)
    params.planned_q_bits = float(math.log2(q)) if q > 0 else float(bits)
    if check_security and isinstance(security, cryptparams.StdSecurity):
        from .planner import check_tower_security
        check_tower_security(n, math.log2(ring.modulus), what="BFV tower")
    return params


def invariant_noise_budget(key, c: CipherText) -> float:
    """SEAL's invariant noise budget −log2(2‖v‖): decrypt with the secret key
    and measure each coefficient's distance from the Δ lattice, exactly on
    the host."""
    priv = key.priv if isinstance(key, KeyPair) else key
    params = priv.params
    ring = c.ring
    b = R.ensure_primal(ring, decrypt_raw(priv, c))
    delta = params.delta
    xs = ring.to_bigint(b.primal.cpu().numpy())

    def birem(x):
        r = x % delta
        return delta - r if r > delta // 2 else r

    worst = max(max(birem(x), 1) for x in xs)
    return math.log2(ring.modulus) - math.log2(params.plain.p) - 1 - math.log2(worst)
