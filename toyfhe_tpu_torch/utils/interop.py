"""Carry keys and ciphertexts between numpy arrays and the port's objects.

A caller exports the reference package's objects as numpy arrays (residue
tensors ``[..., L, N]`` of any integer dtype, e.g. ``np.asarray(x.dual)``)
and builds the port's keys and ciphertexts from them here; the inverse
direction gives ``uint32`` numpy arrays for comparison. Only numpy goes in
and out: this module never imports the reference package. Every function
here takes the ``device`` its tensors go to, with no default.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.ckks_encoding import CKKSTag
from ..core.ring import RingContext, RingElt
from ..core.rlwe import (CipherText, EvalMultKey, GaloisKey, GaloisKeys, KeyComponent,
                         KeyPair, KeySwitchKey, PrivKey, PubKey, SchemeParams)


def tensor(x, device) -> torch.Tensor:
    """Residues as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Residues as a uint32 numpy array (the reference's dtype)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def ring_elt(primal=None, dual=None, *, device) -> RingElt:
    return RingElt(primal=None if primal is None else tensor(primal, device),
                   dual=None if dual is None else tensor(dual, device))


def elt_to_numpy(ring: RingContext, x: RingElt, domain: str = "dual") -> np.ndarray:
    from ..core import ring as R
    x = R.ensure_dual(ring, x) if domain == "dual" else R.ensure_primal(ring, x)
    return to_numpy(x.dual if domain == "dual" else x.primal)


def priv_key(params: SchemeParams, secret, domain: str = "primal", *, device) -> PrivKey:
    return PrivKey(params, ring_elt(**{domain: secret}, device=device))


def pub_key(params: SchemeParams, mask, masked, domain: str = "primal", *,
            device) -> PubKey:
    return PubKey(params, KeyComponent(mask=ring_elt(**{domain: mask}, device=device),
                                       masked=ring_elt(**{domain: masked}, device=device)))


def key_switch_key(params: SchemeParams, masks, maskeds, domain: str = "dual", *,
                   device, ring: Optional[RingContext] = None) -> KeySwitchKey:
    """Key-switching key from the stacks ``masks``/``maskeds`` [ndig, L, N]
    over ``ring`` (default ``params.ring_key``: the full tower, special
    primes included, for the raising modifiers)."""
    ring = ring if ring is not None else params.ring_key
    comps = [KeyComponent(mask=ring_elt(**{domain: m}, device=device),
                          masked=ring_elt(**{domain: md}, device=device))
             for m, md in zip(np.asarray(masks), np.asarray(maskeds))]
    return KeySwitchKey(params, comps, ring)


def eval_mult_key(params: SchemeParams, masks, maskeds, domain: str = "dual", *,
                  device, ring: Optional[RingContext] = None) -> EvalMultKey:
    """Relinearization key from the stacks ``masks``/``maskeds`` [ndig, L, N]."""
    return EvalMultKey(key_switch_key(params, masks, maskeds, domain, device=device,
                                      ring=ring))


def galois_key(params: SchemeParams, element: int, masks, maskeds,
               domain: str = "dual", *, device,
               ring: Optional[RingContext] = None) -> GaloisKey:
    """Rotation key of Galois element ``element`` from its stacks."""
    return GaloisKey(int(element), key_switch_key(params, masks, maskeds, domain,
                                                  device=device, ring=ring))


def galois_keys(params: SchemeParams, elements: Sequence[int], masks, maskeds,
                domain: str = "dual", *, device,
                ring: Optional[RingContext] = None) -> GaloisKeys:
    """A rotation key set from one Galois element and one pair of stacks
    [ndig, L, N] per key (``masks[i]`` / ``maskeds[i]`` belong to
    ``elements[i]``)."""
    return GaloisKeys([galois_key(params, g, m, md, domain, device=device, ring=ring)
                       for g, m, md in zip(elements, masks, maskeds)])


MNIST_PARAM_NAMES = ("conv_w", "conv_b", "w1", "b1", "w2", "b2")


def mnist_params(model_params) -> dict:
    """The reference's MNIST ``model_params`` (any array type) as float64
    numpy arrays."""
    return {k: np.asarray(model_params[k], dtype=np.float64) for k in MNIST_PARAM_NAMES}


def fhe_setup_from_numpy(cfg, secret, pub_mask, pub_masked, ek_masks, ek_maskeds,
                         gk_element: int, gk_masks, gk_maskeds, *, device):
    """The port's MNIST ``FHESetup`` from exported key material: the secret
    and public key primal over the key tower, the relinearization and Galois
    key stacks as duals."""
    from fractions import Fraction

    from ..models import mnist as M

    params = M.make_params(cfg)
    kp = KeyPair(priv_key(params, secret, device=device),
                 pub_key(params, pub_mask, pub_masked, device=device))
    return M.FHESetup(cfg, params, kp,
                      eval_mult_key(params, ek_masks, ek_maskeds, device=device),
                      galois_key(params, gk_element, gk_masks, gk_maskeds, device=device),
                      Fraction(2) ** cfg.scale_log2)


def ciphertext(params: SchemeParams, ring: RingContext, components: Sequence,
               scale=None, domain: str = "dual", *, device) -> CipherText:
    """Ciphertext from its component residue arrays (each [..., L, N]) in
    ``domain``, tagged with a CKKS ``scale`` when one is given."""
    cs = tuple(ring_elt(**{domain: x}, device=device) for x in components)
    enc = None if scale is None else CKKSTag(Fraction(scale))
    return CipherText(params, cs, ring, enc=enc)


def ciphertext_to_numpy(c: CipherText, domain: str = "dual") -> np.ndarray:
    """The components stacked as uint32 [ncomp, ..., L, N]."""
    return np.stack([elt_to_numpy(c.ring, x, domain) for x in c.cs])
