"""Fused hybrid key-switch core (K3): FBC digit → NTT → key contraction.

Port of ``toyfhe_tpu/ops/pallas_hybrid_ks.py``. Per batch row and per limb
of the expanded tower Q_t ∪ P, :class:`FusedHybridKS` computes the whole
digit pipeline of the dnum-grouped key switch:

    Σ_j  NTT_t( Σ_i ŷ_i·[Q_j/q_i]_{p_t} )  ⊙  key[j, t]

for the key's masked (``acc1``) and mask (``acc2``) components. It replaces
``hybrid_decompose``'s contraction, the digit NTT and the masks/maskeds
products and sums; the ŷ premultiply (:meth:`FusedHybridKS.premultiply`),
the accumulator inverse transforms and the P-division stay outside.

A CUDA tensor goes to the hand-written kernel (:mod:`.hybrid_ks_cuda`,
``csrc/hybrid_ks.cu``), which raises rather than fall back; a CPU tensor
goes to :func:`fused_hybrid_ks_plain`. Both return canonical residues and
agree bit for bit.
"""

from __future__ import annotations

import torch

from . import modmath, ntt as nttmod
from .modmath import as_residues, canonical_device


class FusedHybridKS:
    """Host tables of the fused key switch for one (HybridRaised params,
    eval key, tower length) triple.

    ``__call__(y)``: ŷ int64[..., lt, N] (each ct limb already multiplied by
    [(Q_j/q_i)⁻¹]_{q_i}, :meth:`premultiply`) → (acc1, acc2) natural duals
    int64[..., T, N] over the expanded tower: acc1 = Σ_j maskeds_j ⊙ NTT(D_j),
    acc2 the same with the masks.
    """

    def __init__(self, params, ek, lt: int = None):
        from ..core.rlwe import _hybrid_key_stack

        full = params.ring_cipher
        lt = full.nlimbs if lt is None else lt
        self.exp_ring = params._tables(lt)[0]
        self.lt = lt
        self.ct_ring = full.select(list(range(lt)))

        # FBC constants [dnum_t, T, alpha] (Montgomery form, zero-padded)
        # + the per-ct-limb ŷ premultiply column [(Q_j/q_i)⁻¹]_{q_i}
        plan = params.fbc_plan(self.ct_ring)
        self.dnum_t, self.alpha, self.bounds = plan.dnum, plan.alpha, list(plan.bounds)
        self.cst, self.inv_col = plan.cst, plan.inv

        # key duals over the expanded tower, pre-multiplied by 2^32 mod p
        km, kd = _hybrid_key_stack(params, ek.key, self.exp_ring, self.dnum_t)
        self.km = modmath.to_mont(km, self.exp_ring.mp)        # [dnum_t, T, N]
        self.kd = modmath.to_mont(kd, self.exp_ring.mp)
        self._dev: dict = {}

    def on(self, device) -> dict:
        """``cst`` (int64 [dnum_t, T, alpha]) and the pre-Montgomerized key
        rows ``km`` / ``kd`` on ``device``, moved once."""
        dev = canonical_device(device)
        if dev not in self._dev:
            self._dev[dev] = {"cst": as_residues(self.cst, dev),
                              "km": self.km.to(dev), "kd": self.kd.to(dev)}
        return self._dev[dev]

    def premultiply(self, xp: torch.Tensor) -> torch.Tensor:
        """ct-limb residues int64[..., lt, N] primal → ŷ (per-limb multiply
        by [(Q_{j(i)}/q_i)⁻¹]_{q_i})."""
        return modmath.mont_mul(xp, modmath.const(self.inv_col, xp.device),
                                self.ct_ring.mp)

    def __call__(self, y: torch.Tensor):
        if y.device.type == "cuda":
            from . import hybrid_ks_cuda
            return hybrid_ks_cuda.launch(self, y.contiguous())
        if y.device.type != "cpu":
            raise ValueError(f"no fused hybrid key switch for tensors on {y.device}")
        return fused_hybrid_ks_plain(self, y)


def fused_hybrid_ks_plain(fks: FusedHybridKS, y: torch.Tensor):
    """The kernel's plain torch twin, on any device: per digit group the FBC
    digit over the expanded tower, its radix-2 NTT, and the two key
    products, summed over the digits mod p."""
    d = fks.on(y.device)
    mp = fks.exp_ring.mp
    mp3 = mp.expand()
    acc1 = acc2 = None
    for j, (lo, hi) in enumerate(fks.bounds):
        cj = d["cst"][j, :, :hi - lo, None]                       # [T, a, 1]
        dig = modmath.mod_sum(modmath.mont_mul(y[..., None, lo:hi, :], cj, mp3),
                              mp, axis=-2)                        # [..., T, N]
        dd = nttmod.ntt_plain(fks.exp_ring.tables, dig)
        t1 = modmath.mont_mul(dd, d["kd"][j], mp)
        t2 = modmath.mont_mul(dd, d["km"][j], mp)
        acc1 = t1 if acc1 is None else modmath.add_mod(acc1, t1, mp)
        acc2 = t2 if acc2 is None else modmath.add_mod(acc2, t2, mp)
    return acc1, acc2
