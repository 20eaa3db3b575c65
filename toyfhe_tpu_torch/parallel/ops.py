"""The single-device CKKS step: homomorphic square → relinearize → rescale.

Port of the single-chip flavour of ``toyfhe_tpu/parallel/ops.py``
(``_square_relin_rescale_local`` with ``axis_name=None`` and
``make_single_chip_step``) on a batch of NTT-domain ciphertexts. Shapes stay
static: the rescale zeroes the dropped limb instead of removing it, so the
output has the input's shape ``[B, 2, L, N]``.

The transforms go through :func:`..ops.ntt.ntt` / :func:`..ops.ntt.intt`:
the CUDA kernel for CUDA tensors, the plain radix-2 version for CPU tensors.
Everything else is elementwise modular arithmetic in plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import modmath, ntt as nttmod
from ..ops.modmath import MontParams


def full_table_pytree(tables: nttmod.NttTables, device) -> dict:
    """The ring's constants as a plain dict of ``int64`` tensors on
    ``device``: the NTT tables of :meth:`NttTables.on` plus the remaining
    Montgomery constants."""
    d = dict(tables.on(device))
    mp = tables.mp.on(device)
    d.update(ninv=mp.ninv, r2=mp.r2, r1=mp.r1, half=mp.half)
    return d


def _mp_full(tabs: dict) -> MontParams:
    return MontParams(p=tabs["p"], ninv=tabs["ninv"], r2=tabs["r2"],
                      r1=tabs["r1"], half=tabs["half"], rinv=tabs["rinv"])


def _square_relin_rescale_local(c, key_masks, key_maskeds, rescale_inv, tabs,
                                tables):
    """Square → relinearize → rescale on ciphertext duals.

    Shapes:
      c:            int64[B, 2, L, N]   ciphertext duals
      key_masks:    int64[L, L, N]      relin key mask duals (digit-major)
      key_maskeds:  int64[L, L, N]
      rescale_inv:  int64[L, 1]         (q_last^{-1} mod q_j, Montgomery; 0 for the last limb)
      tabs:         :func:`full_table_pytree` on c's device
      tables:       the ring's :class:`NttTables`, which routes the transforms
    Returns int64[B, 2, L, N] rescaled ciphertext duals with the dropped
    limb zeroed.
    """
    fwd = lambda v: nttmod.ntt(tables, v)
    inv = lambda v: nttmod.intt(tables, v)
    mp = _mp_full(tabs)
    c1, c2 = c[:, 0], c[:, 1]
    # --- homomorphic square: tensor product ---
    d1 = modmath.mul_mod(c1, c1, mp)
    mid = modmath.mul_mod(c1, c2, mp)
    d2 = modmath.add_mod(mid, mid, mp)
    d3 = modmath.mul_mod(c2, c2, mp)

    # --- relinearize d3 back onto (d1, d2) ---
    lifts = modmath.centered(inv(d3), mp)                   # signed [B, L, N]
    digs = fwd(modmath.from_signed(lifts[..., :, None, :], mp))   # [B, L, L, N]
    acc1 = modmath.mod_sum(modmath.mul_mod(digs, key_maskeds, mp), mp, axis=-3)
    acc2 = modmath.mod_sum(modmath.mul_mod(digs, key_masks, mp), mp, axis=-3)
    r1 = modmath.add_mod(d1, acc1, mp)
    r2 = modmath.add_mod(d2, acc2, mp)
    outp = inv(torch.stack([r1, r2], dim=1))                # [B, 2, L, N]

    # --- rescale by the last limb, static shapes ---
    last_mod = modmath.umod(outp[..., -1:, :], mp.p)
    res = modmath.mont_mul(modmath.sub_mod(outp, last_mod, mp), rescale_inv, mp)
    res[..., -1, :] = 0                                     # the dropped limb
    return fwd(res)


def rescale_inverses(primes) -> np.ndarray:
    """q_last^{-1} mod q_j in Montgomery form per limb, 0 for the last."""
    qk = primes[-1]
    return np.array([[pow(qk, -1, p) * (1 << 32) % p if p != qk else 0]
                     for p in primes], dtype=np.int64)


def make_single_chip_step(tables: nttmod.NttTables, key_masks: torch.Tensor,
                          key_maskeds: torch.Tensor):
    """The square→relin→rescale step on the keys' device.

    ``key_masks`` / ``key_maskeds`` are the relinearization key stacks
    int64[L, L, N] (dual domain, digit-major). Returns ``step(c)`` on
    int64[B, 2, L, N] ciphertext duals on the same device.
    """
    device = key_masks.device
    if key_maskeds.device != device:
        raise ValueError("key stacks on different devices")
    tabs = full_table_pytree(tables, device)
    rescale_inv = torch.as_tensor(rescale_inverses(tables.primes), device=device)

    def step(c: torch.Tensor) -> torch.Tensor:
        return _square_relin_rescale_local(c, key_masks, key_maskeds,
                                           rescale_inv, tabs, tables)

    return step
