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


def encrypt_with_noise(key, plaintext, u, e1, e2, *, device) -> CipherText:
    """``rlwe.encrypt`` with its randomness given: the ephemeral secret
    ``u`` and the noise ``e1``, ``e2``, each a signed integer array [N].
    The base scheme's samplers are replaced, for this one call, by ones that
    return u, then e₁, then e₂ over the ring they are asked for; the
    encryption itself, modifiers' hooks included, is the real one."""
    from ..core import rlwe

    pub = key.pub if isinstance(key, KeyPair) else key
    base = pub.params
    while hasattr(base, "params"):
        base = base.params
    noise = [e1, e2]

    def elt(x, ring):
        x = np.asarray(x, dtype=np.int64)
        return ring_elt(primal=np.stack([np.mod(x, p) for p in ring.primes]), device=device)

    base.secret_sampler = lambda gen, ring, batch=(): elt(u, ring)
    base.noise = lambda gen, ring, batch=(): elt(noise.pop(0), ring)
    try:
        return rlwe.encrypt(key, plaintext, torch.Generator(device=device))
    finally:
        del base.secret_sampler, base.noise


def ciphertext_to_numpy(c: CipherText, domain: str = "dual") -> np.ndarray:
    """The components stacked as uint32 [ncomp, ..., L, N]."""
    return np.stack([elt_to_numpy(c.ring, x, domain) for x in c.cs])


def bootstrap_context(params: SchemeParams, ek_masks, ek_maskeds, gk_elements: Sequence[int],
                      gk_masks, gk_maskeds, conj_element: int, conj_masks, conj_maskeds, *,
                      K: float, deg: int, plan=None, arcsin: bool = False,
                      double_angle: int = 0, scale_limbs: int = 1, base_scale=None,
                      domain: str = "dual", device):
    """The port's ``BootstrapContext`` from an exported one: the
    relinearization key stacks, one pair of stacks per rotation key with its
    Galois element, the conjugation key's element and stacks (each
    [ndig, L, N] over ``params.ring_key``), and the plan as ``(n, radix)``
    (None for the dense transforms); K, deg, arcsin, double_angle,
    scale_limbs and base_scale as the exported context holds them."""
    from ..core import bootstrap as B
    from ..core import sfft as SF

    return B.BootstrapContext(
        ek=eval_mult_key(params, ek_masks, ek_maskeds, domain, device=device),
        gks=galois_keys(params, gk_elements, gk_masks, gk_maskeds, domain, device=device),
        gk_conj=galois_key(params, conj_element, conj_masks, conj_maskeds, domain,
                           device=device),
        K=float(K), deg=int(deg), plan=None if plan is None else SF.SfftPlan(*plan),
        arcsin=bool(arcsin), double_angle=int(double_angle), scale_limbs=int(scale_limbs),
        base_scale=None if base_scale is None else Fraction(base_scale))


def fhe_setup_bootstrapped_from_numpy(cfg, secret, pub_mask, pub_masked, ek_masks,
                                      ek_maskeds, gk_element: int, gk_masks, gk_maskeds, *,
                                      depth: int, limb_bits: int = 28, scale_log2: int = 28,
                                      hamming_weight: int = 4, scale_limbs: int = 1, device):
    """The key set of ``models.mnist.fhe_setup_bootstrapped`` from exported
    key material (the secret and public key primal over the key tower, the
    relinearization and Galois key stacks as duals), over the parameters of
    ``mnist.make_bootstrapped_params`` with the same arguments."""
    from ..models import mnist as M

    params, composite_log2 = M.make_bootstrapped_params(cfg, depth, limb_bits,
                                                        hamming_weight, scale_limbs)
    kp = KeyPair(priv_key(params, secret, device=device),
                 pub_key(params, pub_mask, pub_masked, device=device))
    return M.FHESetup(cfg, params, kp,
                      eval_mult_key(params, ek_masks, ek_maskeds, device=device),
                      galois_key(params, gk_element, gk_masks, gk_maskeds, device=device),
                      Fraction(2) ** (composite_log2 or scale_log2))


def to_device(obj, device):
    """A copy of a port object with its tensors on ``device``: a ring
    element, a key (component, switching key, relinearization or Galois key
    or key set, private or public key, key pair), a ciphertext or a
    ``BootstrapContext`` (whose encode store starts empty)."""
    import dataclasses

    from ..core.bootstrap import BootstrapContext

    mv = lambda t: None if t is None else t.to(device)
    if isinstance(obj, RingElt):
        return RingElt(primal=mv(obj.primal), dual=mv(obj.dual))
    if isinstance(obj, KeyComponent):
        return KeyComponent(to_device(obj.mask, device), to_device(obj.masked, device))
    if isinstance(obj, KeySwitchKey):
        return KeySwitchKey(obj.params, [to_device(c, device) for c in obj.key], obj.ring)
    if isinstance(obj, EvalMultKey):
        return EvalMultKey(to_device(obj.key, device))
    if isinstance(obj, GaloisKey):
        return GaloisKey(obj.galois_element, to_device(obj.key, device))
    if isinstance(obj, GaloisKeys):
        return GaloisKeys([to_device(k, device) for k in obj.keys])
    if isinstance(obj, PrivKey):
        return PrivKey(obj.params, to_device(obj.secret, device))
    if isinstance(obj, PubKey):
        return PubKey(obj.params, to_device(obj.key, device))
    if isinstance(obj, KeyPair):
        return KeyPair(to_device(obj.priv, device), to_device(obj.pub, device))
    if isinstance(obj, CipherText):
        return CipherText(obj.params, tuple(to_device(x, device) for x in obj.cs), obj.ring,
                          enc=obj.enc)
    if isinstance(obj, BootstrapContext):
        return dataclasses.replace(obj, ek=to_device(obj.ek, device),
                                   gks=to_device(obj.gks, device),
                                   gk_conj=to_device(obj.gk_conj, device), plain_cache={})
    raise TypeError(f"no device copy for {type(obj).__name__}")
