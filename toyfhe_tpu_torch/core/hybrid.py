"""dnum-grouped hybrid key switching (the production "dnum" gadget).

Port of ``toyfhe_tpu/core/hybrid.py``. The tower's first L limbs are
partitioned into ``dnum`` groups of α = ⌈L/dnum⌉ limbs:

  * digit j = the group-j residue, fast-base-converted on the device into
    the full Q_t ∪ P accumulation tower (P = product of ``num_special``
    raising primes, which must carry at least α limbs' worth of bits so
    the α·Q_j-sized digits divide away);
  * key component j encrypts P·ĝ_j·old at modulus Q·P, with
    ĝ_j = (Q/Q_j)·[(Q/Q_j)⁻¹]_{Q_j} — ≡ 1 on group-j limbs and ≡ 0
    elsewhere, so the keys stay valid at every tower level (drops only
    shrink the last group);
  * contraction divides the accumulator by each special prime in turn,
    then the untouched base components are added.

Fast base conversion is the plain (uncorrected) FBC: the lift
D_j = Σ_i y_i·(Q_j/q_i) with y ∈ [0, q_i) equals x mod Q_j plus a multiple
u·Q_j, u ∈ [0, α), which P absorbs.

On a limb-sharded tower (``ring.ShardedRing``) each rank computes the
digits, key products and ModDown on the rows of Q_t ∪ P it holds. Two
steps cross limbs, one all-gather over 'rp' each: the decomposition hands
every rank all ŷ rows (site ``keyswitch_digit_share``), and the ModDown
hands every rank the k special rows of the accumulator after their
inverse transform (site ``rescale_broadcast``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops import fbc_cuda, modmath, ntt as nttmod
from ..ops.modmath import const
from ..utils import metrics
from . import ring as R
from .ring import RingContext, RingElt
from .rlwe import CipherText, PassthroughParams, PubKey


def _mont_col(vals, ps) -> np.ndarray:
    """Column of constants in Montgomery form wrt per-row primes ps."""
    return np.array([[int(v) * (1 << 32) % p] for v, p in zip(vals, ps)],
                    dtype=np.uint64).astype(np.uint32)


class HybridRaised(PassthroughParams):
    """Scheme modifier: the last ``num_special`` CRT primes are raising
    primes; key-switch digits are ``dnum`` limb groups (α = ⌈L/dnum⌉).

    ``dnum = L, num_special = 1`` degenerates to per-limb digits with one
    special prime."""

    def __init__(self, params, dnum: int, num_special: int):
        super().__init__(params)
        full = params.ring_cipher
        if num_special < 1 or num_special >= full.nlimbs:
            raise ValueError("num_special out of range")
        self.num_special = int(num_special)
        self.L = full.nlimbs - self.num_special        # ct tower depth
        if not (1 <= dnum <= self.L):
            raise ValueError("dnum out of range")
        self.dnum = int(dnum)
        self.alpha = -(-self.L // self.dnum)
        self.P = math.prod(full.primes[self.L:])
        # the α·Q_j digit bound must divide away under P
        qmax = math.prod(full.primes[:self.alpha])     # largest group
        if self.P < self.alpha * qmax:
            raise ValueError(
                f"special primes too small: P={self.P:.3e} < "
                f"alpha*Q_group={self.alpha * qmax:.3e}; add or widen the "
                f"raising primes")
        self._fbc_cache = {}

    @property
    def ring_cipher(self) -> RingContext:
        return self.params.ring_cipher.select(list(range(self.L)))

    @property
    def ring_key(self) -> RingContext:
        return self.params.ring_cipher

    # --- keygen hooks ---------------------------------------------------

    def hybrid_factors(self) -> List[int]:
        """P·ĝ_j mod (Q·P), one per group, over the full tower."""
        full = self.params.ring_cipher
        qp = full.modulus
        qs = full.primes[:self.L]
        out = []
        for j in range(self.dnum):
            grp = qs[j * self.alpha:(j + 1) * self.alpha]
            qj = math.prod(grp)
            qhat = math.prod(qs) // qj
            g = qhat * pow(qhat % qj, -1, qj)
            out.append(self.P * g % qp)
        return out

    def encrypt_zero(self, pub: PubKey, gen) -> CipherText:
        """Encrypt at the full tower, then drop the raising limbs."""
        from . import rlwe
        full = self.params.ring_cipher
        c = rlwe._encrypt_zero_at(self, full, pub.key, gen)
        cs = []
        sub = None
        for x in c.cs:
            ring = full
            for _ in range(self.num_special):
                ring, x = R.modswitch_drop(ring, x)
            sub = ring
            cs.append(x)
        return CipherText(self, tuple(cs), sub)

    # --- key-switch hooks -------------------------------------------------

    def _tables(self, lt: int):
        """Per-tower-length FBC tables: the expanded ring Q_t ∪ P and, for
        each group j surviving at ``lt`` limbs, (limb slice, ŷ
        premultipliers [a_j, 1], contraction constants [T, a_j, 1] into
        the Lt + k target), host ``uint32`` in Montgomery form."""
        if lt in self._fbc_cache:
            return self._fbc_cache[lt]
        full = self.params.ring_cipher
        exp_ring = full.select(
            list(range(lt)) + list(range(self.L, self.L + self.num_special)))
        tgt = exp_ring.primes
        groups = []
        for j in range(self.dnum):
            lo = j * self.alpha
            hi = min((j + 1) * self.alpha, lt)
            if lo >= hi:
                break
            grp = full.primes[lo:hi]
            qj = math.prod(grp)
            qhat = [qj // qi for qi in grp]
            inv = _mont_col([pow(h % p, -1, p) for h, p in zip(qhat, grp)], grp)
            consts = np.stack(
                [_mont_col([h % pt for h in qhat], [pt] * len(grp))
                 for pt in tgt], axis=0)                      # (T, a, 1)
            groups.append(((lo, hi), inv, consts))
        self._fbc_cache[lt] = (exp_ring, groups)
        return self._fbc_cache[lt]

    def fbc_plan(self, ring: RingContext) -> fbc_cuda.FbcPlan:
        """The fast base conversion's tables for ``ring`` (the ciphertext
        tower, whole or a rank's view) into the expanded tower's rows the
        process holds, cached per tower length and held rows."""
        exp_whole, groups = self._tables(ring.nlimbs)
        exp_ring = R.like(ring, exp_whole)
        key = ("fbc", ring.nlimbs, tuple(R.held(exp_ring)))
        if key not in self._fbc_cache:
            self._fbc_cache[key] = fbc_cuda.make_plan(groups, R.whole(ring).mp, exp_ring.mp,
                                                      R.held(exp_ring))
        return self._fbc_cache[key]

    def _fbc(self, ring: RingContext, x: RingElt, out_of_group: bool = False):
        """(expanded tower, :func:`..ops.fbc_cuda.fbc` of x's primal rows). On
        a sharded tower each rank premultiplies its own rows and one
        all-gather hands every rank all ŷ rows."""
        exp_ring = R.like(ring, self._tables(ring.nlimbs)[0])
        plan = self.fbc_plan(ring)
        xp = R.ensure_primal(ring, x).primal                  # [..., Lt, N]
        if R.whole(ring) is ring:
            return exp_ring, fbc_cuda.fbc(plan, xp, out_of_group=out_of_group)
        y = modmath.mont_mul(xp, const(R.held_rows(ring, plan.inv), xp.device), ring.mp)
        y = R.gather(ring, y, "keyswitch_digit_share")        # [..., Lt, N] whole
        return exp_ring, fbc_cuda.fbc(plan, y, premultiplied=True, out_of_group=out_of_group)

    def hybrid_decompose(self, ring: RingContext, x: RingElt
                         ) -> Tuple[RingContext, torch.Tensor]:
        """x (primal, Lt limbs) → digit tensor int64[dnum_t, ..., Lt+k, N]:
        each group residue fast-base-converted to the full target (the CUDA
        kernel on the card). On a sharded tower: the digits' held rows,
        after one all-gather of ŷ."""
        return self._fbc(ring, x)

    def hybrid_decompose_dual(self, ring: RingContext, x: RingElt
                              ) -> Tuple[RingContext, torch.Tensor]:
        """Digit tensor in the expanded tower's dual domain, transforming
        only the out-of-group rows: digit j satisfies D_j ≡ x (mod q_i) for
        every i in group j exactly, so those dual rows are x's own dual
        rows, and the conversion writes only the others. Saves Lt of the
        dnum·(Lt+k) digit transforms, bit-exactly."""
        exp_ring, outs = self._fbc(ring, x, out_of_group=True)  # [..., T - w_j, N] each
        xd = R.ensure_dual(ring, x).dual                   # [..., Lt, N]
        exp_held = list(R.held(exp_ring))
        digits = xd.new_empty((len(outs),) + xd.shape[:-2] + (len(exp_held), xd.shape[-1]))
        for j, (lo, hi, _) in enumerate(self.digit_rows(ring.nlimbs)):
            sub = R.whole(exp_ring).select([q for q in exp_held if not lo <= q < hi])
            res = nttmod.ntt(sub.tables, outs[j])
            metrics.count("ntt_limb_transform", math.prod(res.shape[:-1]))
            a = R.held_below(exp_ring, lo)
            torch.cat([res[..., :a, :], xd[..., a:R.held_below(ring, hi), :], res[..., a:, :]],
                      dim=-2, out=digits[j])
        return exp_ring, digits

    def digit_rows(self, lt: int) -> List[Tuple[int, int, List[int]]]:
        """Per digit at ``lt`` ciphertext limbs: its group's rows [lo, hi)
        and the rows of the expanded tower Q_t ∪ P outside the group, the
        ones :meth:`hybrid_decompose_dual` transforms."""
        out = []
        for j in range(self.dnum):
            lo, hi = j * self.alpha, min((j + 1) * self.alpha, lt)
            if lo >= hi:
                break
            out.append((lo, hi, list(range(lo)) + list(range(hi, lt + self.num_special))))
        return out

    def hybrid_key_limbs(self, exp_ring: RingContext) -> List[int]:
        """Positions of the expanded tower's limbs inside the key ring."""
        lt = exp_ring.nlimbs - self.num_special
        return list(range(lt)) + list(range(self.L, self.L + self.num_special))

    def hybrid_contract(self, ring: RingContext, a: RingElt
                        ) -> Tuple[RingContext, RingElt]:
        """Divide the accumulator by P: ``num_special`` rounding rescales.

        Dual-domain accumulators (the key-switch hot path) take the fused
        ModDown (:meth:`hybrid_contract_fused`), bit-identical to the
        sequential chain. A BGV base takes the p-adapted rounding
        (``ring.rescale_adapted``) at each step, so the error stays ≡ 0 mod
        p; P cancels fully, leaving no message factor."""
        from . import rlwe
        t = rlwe.bgv_plain_modulus(self)
        if t is None and a.dual is not None and a.primal is None:
            return self.hybrid_contract_fused(ring, a)
        R.require_whole(ring, "the sequential ModDown")
        for _ in range(self.num_special):
            ring, a = (R.rescale_adapted(ring, a, t) if t is not None
                       else R.rescale(ring, a))
        return ring, a

    def _fused_tables(self, exp_ring: RingContext):
        """Cached fold constants for :meth:`hybrid_contract_fused` at this
        expanded tower: unrolling the k sequential raw-residue rescales
        (each drops the last limb) gives, mod each surviving ct prime q_i,

          b ≡ a·P^{-1} − Σ_{s=1..k} l_s·(p_{k-s}···p_0)^{-1}   (mod q_i)

        where l_s is the raw residue of the step-s accumulator mod the
        prime dropped at step s — computable from the k special primal rows
        alone. Returns (ct_ring, sp_ring, pinv, wts, dinvs) with host
        Montgomery columns."""
        key = ("fused", exp_ring)
        if key in self._fbc_cache:
            return self._fbc_cache[key]
        k = self.num_special
        lt = exp_ring.nlimbs - k
        ct_ring = exp_ring.select(range(lt))
        sp_ring = exp_ring.select(range(lt, lt + k))
        spp = sp_ring.primes                          # [p_0 .. p_{k-1}]
        pinv = _mont_col([pow(self.P % p, -1, p) for p in ct_ring.primes],
                         ct_ring.primes)
        # step-s weight: (∏_{t=0..k-s} p_t)^{-1} mod q_i  (s = 1..k)
        wts = []
        for s in range(1, k + 1):
            prod = math.prod(spp[: k - s + 1])
            wts.append(_mont_col([pow(prod % p, -1, p) for p in ct_ring.primes],
                                 ct_ring.primes))
        # special-row update constants: at step s the dropped prime is
        # d_s = p_{k-s}; remaining rows p_0..p_{k-s-1} divide by d_s
        dinvs = []
        for s in range(1, k):
            d = spp[k - s]
            rem = spp[: k - s]
            dinvs.append(_mont_col([pow(d % p, -1, p) for p in rem], rem))
        self._fbc_cache[key] = (ct_ring, sp_ring, pinv, tuple(wts), tuple(dinvs))
        return self._fbc_cache[key]

    def hybrid_contract_fused(self, exp_ring: RingContext, a: RingElt
                              ) -> Tuple[RingContext, RingElt]:
        """Fused ModDown of a dual-domain accumulator [..., Lt+k, N]:
        bit-identical to ``num_special`` sequential :func:`ring.rescale`
        calls (the NTT is linear and exact, so NTT(b) = a_dual·P^{-1} −
        NTT(C) with C the combined correction polynomial). On a sharded
        tower each rank transforms its special rows and one all-gather hands
        all k to every rank, which computes C on its held ciphertext rows."""
        k = self.num_special
        lt = exp_ring.nlimbs - k
        ct_whole, sp_whole, pinv, wts, dinvs = self._fused_tables(R.whole(exp_ring))
        ct_ring, sp_held = R.like(exp_ring, ct_whole), R.like(exp_ring, sp_whole)
        nct = R.held_below(exp_ring, lt)
        dual = a.dual
        dev = dual.device
        sp = nttmod.intt(sp_held.tables, dual[..., nct:, :])  # [..., k, N]
        metrics.count("ntt_limb_transform", math.prod(sp.shape[:-1]))
        sp = R.gather(sp_held, sp, "rescale_broadcast")       # all k rows
        mp_ct = ct_ring.mp
        corr = None
        for s in range(k):
            l = sp[..., -1:, :]                   # raw residue row, [.., 1, N]
            sp = sp[..., :-1, :]
            if sp.shape[-2]:
                mp_rem = sp_whole.mp.select(range(sp.shape[-2]))
                lm = modmath.umod(l, mp_rem.on(dev).p)
                sp = modmath.mont_mul(modmath.sub_mod(sp, lm, mp_rem),
                                      const(dinvs[s], dev), mp_rem)
            term = modmath.mont_mul(modmath.umod(l, mp_ct.on(dev).p),
                                    const(R.held_rows(ct_ring, wts[s]), dev), mp_ct)
            corr = term if corr is None else modmath.add_mod(corr, term, mp_ct)
        corr_dual = nttmod.ntt(ct_ring.tables, corr)
        metrics.count("ntt_limb_transform", math.prod(corr.shape[:-1]))
        out = modmath.sub_mod(
            modmath.mont_mul(dual[..., :nct, :], const(R.held_rows(ct_ring, pinv), dev),
                             mp_ct),
            corr_dual, mp_ct)
        return ct_ring, RingElt(dual=out)
