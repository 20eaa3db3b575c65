"""Fused windowed special-prime key switch (K6).

Port of ``toyfhe_tpu/ops/pallas_keyswitch.py``. Per output limb t of the
expanded tower (the Lc ciphertext limbs plus the special prime), the whole
key-switch chain of ``parallel.layers._modraise_keyswitch`` in one pass:

    base-2^w digits of c2 (Lc·kpl rows)  →  ψ-twist + DIF (bit-reversed)
    →  Σ_d key[d]·digit[d]  (+ c1e on the masked channel)
    →  DIT + untwist  →  primal out

Keys and the expanded first component arrive bit-reverse-permuted, so the
pointwise products need no permutation; the outputs are primal and
natural. The special-prime rescale stays with the caller (it needs the
special row of every output).

:class:`FusedKeyswitch` dispatches on the tensor's device: a CUDA tensor
goes to the hand-written kernel (:mod:`.pallas_keyswitch_cuda`,
``csrc/keyswitch.cu``), which raises rather than fall back; a CPU tensor
goes to :func:`fused_keyswitch_plain`. Both return canonical residues and
agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .modmath import canonical_device, mont_mul_raw
from .ntt import NttTables, _bitrev_perm
from .ntt_pallas import PallasNttTables, dif_stages_plain, dit_stages_plain


def _residues(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x).astype(np.int64))


class FusedKeyswitch:
    """Host tables of the fused key switch for one windowed ModulusRaised
    key at one tower level: the DIF/DIT tables of the expanded tower, the
    key duals in bit-reversed order and the per-limb ``(p, ninv, r2)`` rows.

    ``masks_dual`` / ``maskeds_dual``: the key's natural-order duals
    ``(ndig, Le, N)`` (tensors, kept on their device, or arrays), with
    ndig = Lc·kpl and Le = Lc + 1.

    ``__call__(c2p, c1e_dual_brev)``: c2 primal int64 [..., Lc, N] and the
    expanded first component's dual, bit-reversed, [..., Le, N] → the primal
    (out1, out2) [..., Le, N]; out1 carries the maskeds products and c1e,
    out2 the masks products.
    """

    def __init__(self, exp_tables: NttTables, masks_dual, maskeds_dual,
                 window: int, kpl: int, Lc: int):
        assert window > 0, "fused kernel supports windowed gadgets"
        self.pt = PallasNttTables(exp_tables)
        self.window, self.kpl, self.Lc = int(window), int(kpl), int(Lc)
        self.n = exp_tables.n
        self.logn = self.n.bit_length() - 1
        self.brev = _bitrev_perm(self.n)
        masks, maskeds = _residues(masks_dual), _residues(maskeds_dual)
        want = (self.Lc * self.kpl, self.Lc + 1, self.n)
        if tuple(masks.shape) != want or tuple(maskeds.shape) != want:
            raise ValueError(f"key stacks must be {want}, got "
                             f"{tuple(masks.shape)} / {tuple(maskeds.shape)}")
        if len(exp_tables.primes) != self.Lc + 1:
            raise ValueError("exp_tables must hold the Lc + 1 expanded limbs")
        idx = torch.as_tensor(self.brev, device=masks.device)
        self.masks = masks.index_select(-1, idx)                 # (ndig, Le, N)
        self.maskeds = maskeds.index_select(-1, idx)
        self._pn = np.stack([self.pt.p, self.pt.ninv, self.pt.r2], axis=1
                            ).astype(np.uint32)[:, None, :]      # (Le, 1, 3)
        self._dev: dict = {}

    @property
    def ndig(self) -> int:
        return self.Lc * self.kpl

    def keys_on(self, device) -> dict:
        """The bit-reversed key rows limb-major, ``(Le, ndig, N)`` int64 on
        ``device``, moved once."""
        dev = canonical_device(device)
        key = ("keys", dev)
        if key not in self._dev:
            self._dev[key] = {"masks": self.masks.to(dev).transpose(0, 1).contiguous(),
                              "maskeds": self.maskeds.to(dev).transpose(0, 1).contiguous()}
        return self._dev[key]

    def check(self, c2p: torch.Tensor, c1e: torch.Tensor) -> None:
        n, Lc = self.n, self.Lc
        if c2p.dtype != torch.int64 or c1e.dtype != torch.int64:
            raise TypeError("residues must be int64")
        if c2p.dim() < 2 or c2p.shape[-2:] != (Lc, n):
            raise ValueError(f"c2 must be [..., {Lc}, {n}], got {tuple(c2p.shape)}")
        if c1e.shape != c2p.shape[:-2] + (Lc + 1, n):
            raise ValueError(f"c1e must be {tuple(c2p.shape[:-2]) + (Lc + 1, n)}, "
                             f"got {tuple(c1e.shape)}")
        if c1e.device != c2p.device:
            raise ValueError("c2 and c1e on different devices")

    def __call__(self, c2p: torch.Tensor, c1e_dual_brev: torch.Tensor):
        if c2p.device.type == "cuda":
            from . import pallas_keyswitch_cuda
            return pallas_keyswitch_cuda.launch(self, c2p.contiguous(),
                                                c1e_dual_brev.contiguous())
        if c2p.device.type != "cpu":
            raise ValueError(f"no fused key switch for tensors on {c2p.device}")
        return fused_keyswitch_plain(self, c2p, c1e_dual_brev)


def fused_keyswitch_plain(fk: FusedKeyswitch, c2p: torch.Tensor,
                          c1e_dual_brev: torch.Tensor):
    """K6's plain twin, on any device: the digit rows of every limb through
    the DIF twin, the key products (digits to Montgomery form by r2, as the
    TPU kernel does) summed over the digits, + c1e, then the DIT twin and the
    untwist."""
    fk.check(c2p, c1e_dual_brev)
    dev = c2p.device
    d = fk.pt.on(dev)
    keys = fk.keys_on(dev)
    p, rinv = d["p"], d["rinv"]                                  # (Le, 1, 1)
    lead = tuple(c2p.shape[:-2])
    Le, n = fk.Lc + 1, fk.n
    shifts = torch.arange(fk.kpl, device=dev, dtype=torch.int64) * fk.window
    digs = (c2p[..., :, None, :] >> shifts[:, None]) & ((1 << fk.window) - 1)
    digs = digs.reshape(-1, n)                                   # (lead·ndig, N)
    x = mont_mul_raw(digs[None], d["psi_pow"], p, rinv)          # (Le, lead·ndig, N)
    x = dif_stages_plain(x, d["fwd"], p, rinv)
    x = mont_mul_raw(x, d["r2"], p, rinv)                        # to Montgomery form
    x = x.reshape((Le,) + lead + (fk.ndig, n))
    kshape = (Le,) + (1,) * len(lead) + (fk.ndig, n)
    p4 = p.reshape((Le,) + (1,) * (len(lead) + 1))
    rinv4 = rinv.reshape(p4.shape)
    acc = []
    for name in ("maskeds", "masks"):
        prod = mont_mul_raw(x, keys[name].reshape(kshape), p4[..., None], rinv4[..., None])
        acc.append(torch.remainder(prod.sum(dim=-2), p4))       # (Le, *lead, N)
    c1e = torch.movedim(c1e_dual_brev, -2, 0)                    # (Le, *lead, N)
    acc[0] = torch.remainder(acc[0] + c1e, p4)
    outs = []
    for a in acc:
        y = dit_stages_plain(a.reshape(Le, -1, n), d["inv"], p, rinv)
        y = mont_mul_raw(y, d["psi_ipow"], p, rinv).reshape((Le,) + lead + (n,))
        outs.append(torch.movedim(y, 0, -2))
    return outs[0], outs[1]
