"""Exact RNS machinery for BFV multiplication (BEHZ).

Port of ``toyfhe_tpu/core/behz.py``. The tensor product runs at once in the
ciphertext base q and an auxiliary base Bsk = B ∪ {m_sk}, with integer-only
exact base conversions:

  * SmMRq (small Montgomery reduction mod q through an extra modulus
    m̃ = 2^16) converts each input component q → Bsk exactly, on the
    centered representative;
  * the t/q scale-and-round becomes add ⌊q/2⌋, then an RNS floor
    (w − [w]_q)·q⁻¹, whose fast q → Bsk conversion errs by at most
    α ∈ [0, L): negligible additive noise;
  * the Shenoy–Kumaresan conversion (through m_sk) brings the result back
    to base q exactly.

Every step is elementwise Montgomery arithmetic and limb contractions on
``int64[..., L, N]`` tensors, on the device of its input (Bajard, Eynard,
Hasan and Zucca, "A Full RNS Variant of FV-like Somewhat Homomorphic
Encryption Schemes", SAC 2016). The constants are the reference's host
arrays, uploaded once per device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import modmath
from ..ops.modmath import as_residues, canonical_device
from ..utils import numtheory as nt
from . import ring as R
from .ring import RingContext, RingElt

_MTILDE_BITS = 16
_MTILDE = 1 << _MTILDE_BITS
_MT_MASK = _MTILDE - 1


def _mont_col(vals, ps) -> np.ndarray:
    """Column of constants in Montgomery form wrt per-row primes ps."""
    return np.array([[int(v) * (1 << 32) % p] for v, p in zip(vals, ps)],
                    dtype=np.uint64).astype(np.uint32)


class BFVMulContext:
    """Precomputed tables for one (q ring, aux ring) pair.

    ``aux_ring`` holds B ∪ {m_sk}: its last limb plays the m_sk role.
    ``ext_ring`` is the concatenated q ∪ B ∪ {m_sk} tower the tensor
    product runs in.
    """

    def __init__(self, ring: RingContext, aux_ring: RingContext):
        self.ring = ring
        self.aux = aux_ring
        qs = ring.primes
        bsk = aux_ring.primes
        bs, msk = bsk[:-1], bsk[-1]
        self.ext_ring = RingContext(ring.n, qs + bsk, ring.psis + aux_ring.psis)
        L, J = len(qs), len(bsk)
        q = math.prod(qs)
        B = math.prod(bs)

        # ---- q -> Bsk fast base conversion tables ----
        qhat = [q // qi for qi in qs]
        self.qhat_inv_mont_q = _mont_col([pow(h % p, -1, p) for h, p in zip(qhat, qs)], qs)
        # (J, L, 1) Montgomery constants [q/q_i mod bsk_j]
        self.qhat_mont_bsk = np.stack([
            _mont_col([h % pj for h in qhat], [pj] * L) for pj in bsk], axis=0)
        self.mp_bsk = aux_ring.mp
        self.mp_bsk3 = aux_ring.mp.expand()

        # ---- SmMRq (m̃) tables ----
        self.mtilde_mont_q = _mont_col([_MTILDE % qi for qi in qs], qs)
        self.qhat_mod_mtilde = np.array([[h % _MTILDE] for h in qhat], dtype=np.uint32)
        self.neg_qinv_mtilde = (-pow(q % _MTILDE, -1, _MTILDE)) % _MTILDE
        self.q_mont_bsk = _mont_col([q % pj for pj in bsk], bsk)
        self.mtilde_inv_mont_bsk = _mont_col([pow(_MTILDE % pj, -1, pj) for pj in bsk], bsk)

        # ---- t/q floor tables ----
        self.qinv_mont_bsk = _mont_col([pow(q % pj, -1, pj) for pj in bsk], bsk)
        qhalf = (q - 1) // 2
        self.qhalf_res_q = ring.scalar_residues(qhalf)
        self.qhalf_res_bsk = aux_ring.scalar_residues(qhalf)

        # ---- Shenoy–Kumaresan B -> q tables ----
        bhat = [B // bi for bi in bs]
        self.bhat_inv_mont_b = _mont_col([pow(h % p, -1, p) for h, p in zip(bhat, bs)], bs)
        self.bhat_mont_q = np.stack([
            _mont_col([h % pj for h in bhat], [pj] * len(bs)) for pj in qs], axis=0)
        self.bhat_mont_msk = _mont_col([h % msk for h in bhat], [msk] * len(bs))  # (Lb, 1)
        self.binv_mont_msk = _mont_col([pow(B % msk, -1, msk)], [msk])            # (1, 1)
        self.b_res_q = ring.scalar_residues(B % q)
        self.b_mont_q = _mont_col([int(x) for x in self.b_res_q.ravel()], qs)
        self.mp_msk = aux_ring.mp.select([J - 1])
        self.mp_msk3 = self.mp_msk.expand()
        self.mp_b = aux_ring.mp.select(list(range(J - 1)))
        self.mp_q3 = ring.mp.expand()
        self.msk = msk
        self._dev: dict = {}

    def _c(self, name, device, build=None) -> torch.Tensor:
        """The host constant ``name`` (or what ``build()`` gives) as an int64
        tensor on ``device``, uploaded once."""
        key = (name, canonical_device(device))
        if key not in self._dev:
            self._dev[key] = as_residues(build() if build else getattr(self, name), device)
        return self._dev[key]

    # ------------------------------------------------------------------
    def _contract(self, y, consts, mp_target3, mp_target):
        """out_j = Σ_i y_i · consts[j, i] mod p_j.

        y: (..., L, N); consts: (J, L, 1) Montgomery, on y's device;
        returns (..., J, N). y may exceed p_j: the product stays exact.
        """
        prod = modmath.mont_mul(y[..., None, :, :], consts, mp_target3)
        return modmath.mod_sum(prod, mp_target, axis=-2)

    def smmrq_convert(self, xq):
        """Exact centered conversion q -> Bsk of ``int64[..., L, N]`` (SmMRq)."""
        dev = xq.device
        mpq = self.ring.mp
        xm = modmath.mont_mul(xq, self._c("mtilde_mont_q", dev), mpq)      # m̃·x mod q
        y = modmath.mont_mul(xm, self._c("qhat_inv_mont_q", dev), mpq)     # [x̃_i (q/q_i)⁻¹]_{q_i}
        conv_bsk = self._contract(y, self._c("qhat_mont_bsk", dev), self.mp_bsk3, self.mp_bsk)
        # the m̃ channel: every value mod 2^16, masked where the reference's
        # uint32 wraparound and masks reduce it
        conv_mt = (y & _MT_MASK) * self._c("qhat_mod_mtilde", dev)
        conv_mt = conv_mt.sum(dim=-2) & _MT_MASK
        r = (conv_mt * self.neg_qinv_mtilde) & _MT_MASK
        r_c = torch.where(r >= _MTILDE // 2, r - _MTILDE, r)[..., None, :]
        rq = modmath.mont_mul(modmath.from_signed(r_c.expand(conv_bsk.shape), self.mp_bsk),
                              self._c("q_mont_bsk", dev), self.mp_bsk)
        tot = modmath.add_mod(conv_bsk, rq, self.mp_bsk)
        return modmath.mont_mul(tot, self._c("mtilde_inv_mont_bsk", dev), self.mp_bsk)

    def fbc_q_to_bsk(self, xq):
        """Plain fast base conversion (errs by +αq, α ∈ [0, L))."""
        dev = xq.device
        y = modmath.mont_mul(xq, self._c("qhat_inv_mont_q", dev), self.ring.mp)
        return self._contract(y, self._c("qhat_mont_bsk", dev), self.mp_bsk3, self.mp_bsk)

    def rns_floor(self, wq, wbsk):
        """⌊w/q⌋ in base Bsk given w's residues in both bases."""
        conv = self.fbc_q_to_bsk(wq)
        diff = modmath.sub_mod(wbsk, conv, self.mp_bsk)
        return modmath.mont_mul(diff, self._c("qinv_mont_bsk", wq.device), self.mp_bsk)

    def sk_convert(self, ybsk):
        """Exact Shenoy–Kumaresan conversion Bsk -> q of ``int64[..., J, N]``."""
        dev = ybsk.device
        yb = ybsk[..., :-1, :]
        ymsk = ybsk[..., -1:, :]
        z = modmath.mont_mul(yb, self._c("bhat_inv_mont_b", dev), self.mp_b)
        conv_msk = self._contract(z, self._c("bhat_mont_msk", dev)[None], self.mp_msk3,
                                  self.mp_msk)
        alpha = modmath.mont_mul(modmath.sub_mod(conv_msk, ymsk, self.mp_msk),
                                 self._c("binv_mont_msk", dev), self.mp_msk)
        alpha_c = modmath.centered(alpha, self.mp_msk)                       # (..., 1, N)
        out = self._contract(z, self._c("bhat_mont_q", dev), self.mp_q3, self.ring.mp)
        corr = modmath.mont_mul(modmath.from_signed(alpha_c.expand(out.shape), self.ring.mp),
                                self._c("b_mont_q", dev), self.ring.mp)
        return modmath.sub_mod(out, corr, self.ring.mp)

    # ------------------------------------------------------------------
    # scheme hooks
    # ------------------------------------------------------------------
    def expand_component(self, x: RingElt) -> RingElt:
        """A ciphertext component at base q -> an element of the q ∪ Bsk ring."""
        x = R.ensure_primal(self.ring, x)
        xb = self.smmrq_convert(x.primal)
        return RingElt(primal=torch.cat([x.primal, xb], dim=-2))

    def contract_component(self, w: RingElt, t: int) -> RingElt:
        """round(t·w/q) brought back to base q."""
        w = R.ensure_primal(self.ext_ring, w)
        dev = w.primal.device
        L = self.ring.nlimbs
        wq, wbsk = w.primal[..., :L, :], w.primal[..., L:, :]
        wq = modmath.mul_mod(wq, self._c(("t_q", t), dev, lambda: self.ring.scalar_residues(t)),
                             self.ring.mp)
        wbsk = modmath.mul_mod(wbsk, self._c(("t_bsk", t), dev,
                                             lambda: self.aux.scalar_residues(t)), self.mp_bsk)
        wq = modmath.add_mod(wq, self._c("qhalf_res_q", dev), self.ring.mp)
        wbsk = modmath.add_mod(wbsk, self._c("qhalf_res_bsk", dev), self.mp_bsk)
        return RingElt(primal=self.sk_convert(self.rns_floor(wq, wbsk)))


def make_aux_ring(ring: RingContext, extra_bits: int = 0) -> RingContext:
    """Auxiliary base B ∪ {m_sk}: L + 1 (+ extra) ~30-bit limbs continuing
    the prime walk past the ciphertext tower, then m_sk."""
    n = ring.n
    primes = []
    last = max(ring.primes)
    want = ring.nlimbs + 1 + (extra_bits + 29) // 30
    while len(primes) < want + 1:   # +1 for m_sk
        last = nt.next_prime(last + 2 * n, interval=2 * n)
        primes.append(last)
    return RingContext(n, primes)
