"""Scheme-generic RLWE engine (layer L3).

Port of ``toyfhe_tpu/core/rlwe.py``: keygen, encrypt / decrypt, ciphertext
add, subtract and multiply, the per-limb gadget (``relin_window = 0``: centered RNS
digits; ``relin_window = w > 0``: base-2^w digits of each residue), eval-key
and Galois-key generation, the plain key switch with the special-prime
expand / contract hooks (:mod:`.modraise`) and its dispatch to the
dnum-grouped hybrid key switch (:mod:`.hybrid`), rotations with one key or
a key set, the hoisted rotation schedules (:func:`rotate_many`: one gadget
decomposition shared by several rotations; :func:`rotate_sum`: one
contraction for a sum of rotations), limb drops, the rescale (CKKS, and
BGV's plaintext-adapted rounding, ``ring.rescale_adapted``), and batched
ciphertexts (:func:`ct_stack` / :func:`ct_index`: leading axes run through
every operation). A scheme is a :class:`SchemeParams` subclass supplying
the encoder π⁻¹, decoder π, noise sampler 𝒩 and secret sampler 𝒢;
:class:`PassthroughParams` wraps one to override selected hooks.

Randomness comes from an explicit ``torch.Generator``: keys and ciphertexts
are made on the generator's device.

Placed limb-wise (``parallel.sharding.shard_limbwise``), a ciphertext and its
keys live on ``ring.ShardedRing`` views and every CKKS operation here runs on
each rank's rows as written: the hybrid gadget's cross-limb steps and the
rescale are one collective each, decryption gathers the ciphertext first
(:func:`ct_gather`), and an operation with no sharded form (the windowed and
per-limb gadgets, the BFV and BGV arithmetic) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..ops import keyprod_cuda, modmath, ntt as nttmod, sampling
from ..utils import metrics
from . import ring as R
from .ring import RingContext, RingElt


class UsageError(Exception):
    """Parameter-mixing and invariant violations."""


# ---------------------------------------------------------------------------
# SchemeParams protocol
# ---------------------------------------------------------------------------

class SchemeParams:
    """Base protocol. Subclasses define the four scheme functions."""

    relin_window: int = 0

    @property
    def ring_cipher(self) -> RingContext:
        raise NotImplementedError

    @property
    def ring_key(self) -> RingContext:
        return self.ring_cipher

    def plaintext_space(self):
        raise NotImplementedError

    # π⁻¹ : plaintext -> RingElt in ring_cipher (or ``ring``), on ``device``
    def encode(self, plaintext, ring=None, *, device) -> RingElt:
        raise NotImplementedError

    # π : RingElt -> native plaintext (host side)
    def decode(self, b: RingElt, ring: RingContext):
        raise NotImplementedError

    # 𝒩 : noise sampler over the given ring
    def noise(self, gen: torch.Generator, ring: RingContext, batch=()) -> RingElt:
        raise NotImplementedError

    # 𝒢 : secret/ephemeral sampler
    def secret_sampler(self, gen: torch.Generator, ring: RingContext, batch=()) -> RingElt:
        raise NotImplementedError

    # optional multiplication hooks
    def mul_expand_pair(self, c1: "CipherText", c2: "CipherText"):
        return c1.ring, (c1.cs, c2.cs)

    def mul_contract_pair(self, ring: RingContext, cs: Sequence[RingElt]):
        return ring, tuple(cs)

    def scheme_name(self) -> str:
        return type(self).__name__


class PassthroughParams(SchemeParams):
    """Composable scheme modifier: delegate everything to ``self.params``,
    override selectively. Unknown attributes (scheme fields such as
    ``sigma``) fall through to the wrapped params via ``__getattr__``."""

    def __init__(self, params: SchemeParams):
        self.params = params

    @property
    def parent(self) -> SchemeParams:
        return self.params

    @property
    def ring_cipher(self):
        return self.params.ring_cipher

    @property
    def ring_key(self):
        return self.params.ring_key

    @property
    def relin_window(self):
        return self.params.relin_window

    def plaintext_space(self):
        return self.params.plaintext_space()

    def encode(self, plaintext, ring=None, *, device):
        # encode at the WRAPPER's ciphertext tower: raising modifiers
        # encrypt one or more limbs short of the base scheme's ring
        return self.params.encode(plaintext,
                                  ring=ring if ring is not None
                                  else self.ring_cipher, device=device)

    def decode(self, b, ring):
        return self.params.decode(b, ring)

    def noise(self, gen, ring, batch=()):
        return self.params.noise(gen, ring, batch)

    def secret_sampler(self, gen, ring, batch=()):
        return self.params.secret_sampler(gen, ring, batch)

    def mul_expand_pair(self, c1, c2):
        return self.params.mul_expand_pair(c1, c2)

    def mul_contract_pair(self, ring, cs):
        return self.params.mul_contract_pair(ring, cs)

    def scheme_name(self):
        return self.params.scheme_name()

    def __getattr__(self, name):
        if name == "params":
            raise AttributeError(name)
        return getattr(self.params, name)


# ---------------------------------------------------------------------------
# Key and ciphertext types
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrivKey:
    params: SchemeParams
    secret: RingElt          # lives in ring_key


@dataclasses.dataclass
class KeyComponent:
    mask: RingElt
    masked: RingElt


@dataclasses.dataclass
class PubKey:
    params: SchemeParams
    key: KeyComponent


@dataclasses.dataclass
class KeySwitchKey:
    params: SchemeParams
    key: List[KeyComponent]  # one per gadget digit
    ring: RingContext        # ring the key elements live in


@dataclasses.dataclass
class EvalMultKey:
    key: KeySwitchKey


@dataclasses.dataclass
class GaloisKey:
    galois_element: int
    key: KeySwitchKey


@dataclasses.dataclass
class GaloisKeys:
    """Collection of Galois keys for various rotation steps, addressable by
    Galois element."""

    keys: List[GaloisKey]

    def for_element(self, galois_element: int) -> GaloisKey:
        # lookup through a lazily built index, kept outside the dataclass
        # fields and rebuilt if the key list changed length
        idx = self.__dict__.get("_index")
        if idx is None or len(idx) != len(self.keys):
            idx = {k.galois_element: k for k in self.keys}
            self.__dict__["_index"] = idx
        try:
            return idx[galois_element]
        except KeyError:
            raise KeyError(f"no galois key for element {galois_element}") from None

    def for_steps(self, n: int, steps: int) -> GaloisKey:
        return self.for_element(galois_element_for_steps(n, steps))


@dataclasses.dataclass
class KeyPair:
    priv: PrivKey
    pub: PubKey


@dataclasses.dataclass
class CipherText:
    """Tuple of ring elements + static metadata.

    ``enc`` is the plaintext-encoding tag applied on decryption; ``ring``
    tracks the (possibly rescaled) tower the components live in.
    """
    params: SchemeParams
    cs: Tuple[RingElt, ...]
    ring: RingContext
    enc: Any = None

    def __len__(self):
        return len(self.cs)

    def __getitem__(self, i):
        return self.cs[i]


# Keys and ciphertexts are pytrees (``torch.utils._pytree``): ring elements
# are the leaves; params, rings, the enc tag (its exact ``Fraction`` scale)
# and the Galois element are static metadata, as in the reference, so a
# pipeline written against the public API compiles under
# ``utils.graphs.jit`` and replays bit-equal to the eager call.

def _register(cls, fields, aux_fields):
    def flatten(obj):
        return ([getattr(obj, f) for f in fields],
                tuple(getattr(obj, f) for f in aux_fields))

    def unflatten(children, aux):
        return cls(**dict(zip(aux_fields, aux)), **dict(zip(fields, children)))

    pytree.register_pytree_node(cls, flatten, unflatten)


def _register_list(cls, list_field, aux_fields):
    def flatten(obj):
        return (list(getattr(obj, list_field)),
                tuple(getattr(obj, f) for f in aux_fields))

    def unflatten(children, aux):
        return cls(**dict(zip(aux_fields, aux)), **{list_field: list(children)})

    pytree.register_pytree_node(cls, flatten, unflatten)


_register(PrivKey, ("secret",), ("params",))
_register(KeyComponent, ("mask", "masked"), ())
_register(PubKey, ("key",), ("params",))
_register_list(KeySwitchKey, "key", ("params", "ring"))
_register(EvalMultKey, ("key",), ())
_register(GaloisKey, ("key",), ("galois_element",))
_register_list(GaloisKeys, "keys", ())
_register(KeyPair, ("priv", "pub"), ())
pytree.register_pytree_node(
    CipherText, lambda c: (list(c.cs), (c.params, c.ring, c.enc)),
    lambda cs, aux: CipherText(aux[0], tuple(cs), aux[1], enc=aux[2]))


# ---------------------------------------------------------------------------
# Key generation
# ---------------------------------------------------------------------------

def keygen(params: SchemeParams, gen: torch.Generator) -> KeyPair:
    ring = params.ring_key
    mask = RingElt(primal=sampling.uniform(gen, ring.mp, ring.n))
    secret = params.secret_sampler(gen, ring)
    error = params.noise(gen, ring)
    # masked = -(mask*secret + error)
    masked = R.neg(ring, R.add(ring, R.mul(ring, mask, secret), error))
    return KeyPair(
        PrivKey(params, secret),
        PubKey(params, KeyComponent(mask=mask, masked=masked)))


# ---------------------------------------------------------------------------
# Encryption / decryption
# ---------------------------------------------------------------------------

def encrypt_zero(pub: PubKey, gen: torch.Generator) -> CipherText:
    params = pub.params
    # raising modifiers (HybridRaised) encrypt on their own tower
    hook = getattr(params, "encrypt_zero", None)
    if hook is not None:
        return hook(pub, gen)
    return _encrypt_zero_at(params, params.ring_cipher, pub.key, gen)


def _encrypt_zero_at(params: SchemeParams, ring: RingContext,
                     key: KeyComponent, gen: torch.Generator) -> CipherText:
    u = params.secret_sampler(gen, ring)
    e1 = params.noise(gen, ring)
    e2 = params.noise(gen, ring)
    return CipherText(params, zero_encryption(ring, key, u, e1, e2), ring)


def zero_encryption(ring: RingContext, key: KeyComponent, u: RingElt, e1: RingElt,
                    e2: RingElt) -> Tuple[RingElt, RingElt]:
    """(masked·u + e₁, mask·u + e₂): an encryption of zero under the public
    key ``key`` with the ephemeral secret ``u`` and the noise ``e1``, ``e2``."""
    return (R.add(ring, R.mul(ring, key.masked, u), e1),
            R.add(ring, R.mul(ring, key.mask, u), e2))


def encrypt(key, plaintext, gen: torch.Generator) -> CipherText:
    """encrypt(kp|pub, plaintext) — encode with π⁻¹ then add to a fresh
    encryption of zero, on the generator's device."""
    pub = key.pub if isinstance(key, KeyPair) else key
    params = pub.params
    c = encrypt_zero(pub, gen)
    pt, enc_tag = _encode_with_tag(params, plaintext, gen.device)
    cs = (R.add(c.ring, c.cs[0], pt),) + c.cs[1:]
    return CipherText(params, cs, c.ring, enc=enc_tag)


def _encode_with_tag(params, plaintext, device):
    """Returns (RingElt, decode-tag). Encoding objects know how to encode
    themselves; raw RingElts pass through untagged."""
    if isinstance(plaintext, RingElt):
        return plaintext, None
    if hasattr(plaintext, "to_ring"):
        return plaintext.to_ring(params, device), plaintext.decode_tag(params)
    return params.encode(plaintext, device=device), None


def _aligned_secret(priv: PrivKey, ring: RingContext) -> RingElt:
    """The secret on the ciphertext's tower (drops limbs after rescales)."""
    secret = priv.secret
    skr = priv.params.ring_key
    while skr.nlimbs > ring.nlimbs:
        skr, secret = R.modswitch_drop(skr, secret)
    if skr.primes != ring.primes:
        raise UsageError("secret/ciphertext tower mismatch")
    return secret


def decrypt_raw(key, c: CipherText) -> RingElt:
    """b = Σ cᵢ·sⁱ without π (a sharded ciphertext is gathered first)."""
    priv = key.priv if isinstance(key, KeyPair) else key
    c = ct_gather(c)
    ring = c.ring
    secret = _aligned_secret(priv, ring)
    b = c.cs[0]
    spow = secret
    for i in range(1, len(c.cs)):
        b = R.add(ring, b, R.mul(ring, spow, c.cs[i]))
        if i + 1 < len(c.cs):
            spow = R.mul(ring, spow, secret)
    return b


def decrypt(key, c: CipherText):
    """Σ cᵢ·sⁱ, then π, then the encoding's decode."""
    priv = key.priv if isinstance(key, KeyPair) else key
    with metrics.span("toyfhe.decrypt"):
        c = ct_gather(c)
        with metrics.span("toyfhe.decrypt.raw"):
            raw = decrypt_raw(priv, c)
        dec = priv.params.decode(raw, c.ring)
        if c.enc is not None:
            return c.enc.decode(priv.params, dec, c.ring)
        return dec


# ---------------------------------------------------------------------------
# Homomorphic arithmetic
# ---------------------------------------------------------------------------

def ct_add(c1: CipherText, c2: CipherText) -> CipherText:
    return _ct_addsub(c1, c2, R.add)


def ct_sub(c1: CipherText, c2: CipherText) -> CipherText:
    return _ct_addsub(c1, c2, R.sub)


def _ct_addsub(c1: CipherText, c2: CipherText, op) -> CipherText:
    if c1.params is not c2.params:
        raise UsageError("Attempting to add ciphertexts with differing parameters")
    ring = c1.ring
    n1, n2 = len(c1), len(c2)
    cs = []
    for i in range(max(n1, n2)):
        if i >= n1:
            cs.append(c2.cs[i])
        elif i >= n2:
            cs.append(c1.cs[i])
        else:
            cs.append(op(ring, c1.cs[i], c2.cs[i]))
    enc = c1.enc if c1.enc is not None else c2.enc
    if c1.enc is not None and c2.enc is not None:
        enc = c1.enc.combine_add(c2.enc)
    return CipherText(c1.params, tuple(cs), ring, enc=enc)


def ct_add_ring(c: CipherText, b: RingElt) -> CipherText:
    """c + plaintext ring element."""
    cs = (R.add(c.ring, c.cs[0], b),) + c.cs[1:]
    return CipherText(c.params, cs, c.ring, enc=c.enc)


def tensor_product(ring: RingContext, a: Sequence[RingElt],
                   b: Sequence[RingElt]) -> List[RingElt]:
    """out_k = Σ_{i+j=k} a_i·b_j in ``ring`` (dual domain)."""
    out: List[Optional[RingElt]] = [None] * (len(a) + len(b) - 1)
    for i in range(len(a)):
        for j in range(len(b)):
            t = R.mul(ring, a[i], b[j])
            out[i + j] = t if out[i + j] is None else R.add(ring, out[i + j], t)
    return out


def enc_mul(c1: CipherText, c2: CipherText) -> Tuple[RingContext, Tuple[RingElt, ...]]:
    """Tensor product with the scheme's expand/contract hooks."""
    if c1.params is not c2.params:
        raise UsageError("Attempting to multiply ciphertexts with differing parameters")
    metrics.count("enc_mul")
    params = c1.params
    if bgv_plain_modulus(params) is not None or _base(params).scheme_name() == "BFV":
        R.require_whole(c1.ring, f"the {_base(params).scheme_name()} product")
    ring, (a, b) = params.mul_expand_pair(c1, c2)
    return params.mul_contract_pair(ring, tensor_product(ring, a, b))


def ct_mul(c1: CipherText, c2: CipherText) -> CipherText:
    ring, cs = enc_mul(c1, c2)
    enc = None
    if c1.enc is not None and c2.enc is not None:
        enc = c1.enc.combine_mul(c2.enc)
    return CipherText(c1.params, cs, ring, enc=enc)


# ---------------------------------------------------------------------------
# Gadget decomposition + key switching
# ---------------------------------------------------------------------------

def _gadget_shape(ring: RingContext, window: int) -> Tuple[int, int]:
    """(digits per limb K, total digits L*K) for the unified gadget."""
    if window == 0:
        return 1, ring.nlimbs
    maxbits = max(p.bit_length() for p in ring.primes)
    k = -(-maxbits // window)
    return k, ring.nlimbs * k


def gadget_factors(ring: RingContext, window: int) -> List[int]:
    """Integer factor g_{ik} each key digit is multiplied by:
    (q/q_i)·[(q/q_i)^{-1}]_{q_i} · 2^{w·k}  (mod q)."""
    q = ring.modulus
    out = []
    k, _ = _gadget_shape(ring, window)
    for qi in ring.primes:
        qhat = q // qi
        resid = qhat * pow(qhat % qi, -1, qi) % q
        for kk in range(k):
            out.append(resid * pow(2, window * kk, q) % q if window else resid)
    return out


def gadget_decompose(ring: RingContext, target: RingContext, x: RingElt,
                     window: int, k_per_limb: Optional[int] = None) -> torch.Tensor:
    """Decompose x (in ``ring``) into digit ring elements embedded in
    ``target``'s tower. Returns the primal tensor int64[ndig, ..., Lt, N].

    window == 0: centered RNS digits; window > 0: raw base-2^w digits of
    each residue. ``k_per_limb`` must match the digit count the key was
    generated with."""
    R.require_whole(ring, "the per-limb and windowed RNS gadget")
    p = R.ensure_primal(ring, x).primal        # [..., L, N]
    shape = p.shape[:-2] + (target.nlimbs, ring.n)
    digs = []
    if window == 0:
        for i in range(ring.nlimbs):
            lift = modmath.centered(p[..., i:i + 1, :], ring.mp.select([i]))
            digs.append(modmath.from_signed(lift.expand(shape), target.mp))
    else:
        k = k_per_limb if k_per_limb is not None else _gadget_shape(ring, window)[0]
        mask = (1 << window) - 1
        for i in range(ring.nlimbs):
            xi = p[..., i:i + 1, :]
            for kk in range(k):
                digs.append(((xi >> (window * kk)) & mask).expand(shape))
    return torch.stack(digs, dim=0)


def make_eval_key(gen: torch.Generator, old: RingElt, new: PrivKey,
                  key_params: Optional[SchemeParams] = None) -> KeySwitchKey:
    """Key-switching key old → new.secret; ``old`` is a ring element in
    new's key ring (e.g. s² or σ(s)). A modifier with a ``lift_old_key``
    hook (ModulusRaised: ps·old) applies it here; gadget factors are taken
    over the decomposition ring (the ciphertext tower when modulus-raised)
    and a ``hybrid_factors`` hook (HybridRaised) supplies one factor per
    digit group.

    ``key_params``, when given, supplies the window, the decomposition ring
    and the ``hybrid_factors`` hook, and is what the returned key carries;
    the key ring, ``lift_old_key`` and the noise stay those of
    ``new.params``."""
    params = key_params if key_params is not None else new.params
    gen_params = new.params
    ring = gen_params.ring_key
    hook = getattr(gen_params, "lift_old_key", None)
    if hook is not None:
        old = hook(old)
    dec_ring = params.ring_cipher if _is_modraised(params) else ring
    hfac = getattr(params, "hybrid_factors", None)
    factors = hfac() if hfac is not None else gadget_factors(dec_ring, params.relin_window)
    old = R.ensure_primal(ring, old)
    comps: List[KeyComponent] = []
    for g in factors:
        mask = RingElt(primal=sampling.uniform(gen, ring.mp, ring.n))
        e = gen_params.noise(gen, ring)
        ga = R.scalar_mul(ring, g % ring.modulus, old)
        masked = R.sub(ring, ga, R.add(ring, R.mul(ring, mask, new.secret), e))
        comps.append(KeyComponent(mask=mask, masked=masked))
    return KeySwitchKey(params, comps, ring)


def _is_modraised(params) -> bool:
    from .modraise import ModulusRaised
    return isinstance(params, ModulusRaised)


def keygen_eval_mult(gen: torch.Generator, priv: PrivKey) -> EvalMultKey:
    ring = priv.params.ring_key
    s2 = R.mul(ring, priv.secret, priv.secret)
    return EvalMultKey(make_eval_key(gen, s2, priv))


def galois_element_for_steps(n: int, steps: int) -> int:
    """3^(2N−steps) for steps > 0 else 3^(−steps), mod 2N."""
    m = 2 * n
    if steps > 0:
        return pow(3, 2 * n - steps, m)
    return pow(3, -steps, m)


def keygen_galois(gen: torch.Generator, priv: PrivKey, steps: Optional[int] = None,
                  galois_element: Optional[int] = None) -> GaloisKey:
    """Rotation key for ``steps`` slots (or an explicit Galois element)."""
    if (steps is None) == (galois_element is None):
        raise ValueError("give exactly one of steps and galois_element")
    ring = priv.params.ring_key
    if galois_element is None:
        galois_element = galois_element_for_steps(ring.n, steps)
    sg = R.apply_galois(ring, priv.secret, galois_element)
    return GaloisKey(galois_element, make_eval_key(gen, sg, priv))


def keygen_galois_set(gen: torch.Generator, priv: PrivKey, steps_list) -> GaloisKeys:
    """A set of rotation keys, one per entry of ``steps_list``."""
    return GaloisKeys([keygen_galois(gen, priv, steps=s) for s in steps_list])


def _key_stack(ksk: KeySwitchKey, which: Sequence[int], ndig: int):
    """The first ``ndig`` components' (masks, maskeds) as dual tensors
    [ndig, len(which), N] over the limbs ``which`` of the key ring. Built
    once per key, limb selection and digit count, and kept on the key: a
    key's components do not change after it is made."""
    memo = ksk.__dict__.setdefault("_stacks", {})
    key = (tuple(which), ndig)
    if key not in memo:
        key_ring = ksk.ring
        masks, maskeds = [], []
        for comp in ksk.key[:ndig]:
            _, m = R.limb_select(key_ring, R.ensure_dual(key_ring, comp.mask), which)
            _, md = R.limb_select(key_ring, R.ensure_dual(key_ring, comp.masked), which)
            masks.append(m.dual)
            maskeds.append(md.dual)
        memo[key] = (torch.stack(masks, 0), torch.stack(maskeds, 0))
    return memo[key]


def _downswitch_stack(params, ek: KeySwitchKey, target: RingContext, ndig: int):
    """Key components as dual tensors [ndig, Lt, N] restricted to the
    target tower (downswitch_keyelement): after rescales only the first
    ``ndig`` gadget components apply; the limbs are the target's first Lt
    (modulus-raised: its first Lt−1 and the key ring's special limb)."""
    if _is_modraised(params):
        which = list(range(target.nlimbs - 1)) + [ek.ring.nlimbs - 1]
    else:
        which = list(range(target.nlimbs))
    return _key_stack(ek, which, ndig)


def keyswitch(ek, c: CipherText) -> CipherText:
    """Key switch c's last component back onto the base secret. Handles both
    gadget paths and the ModulusRaised expand / contract hooks."""
    if isinstance(ek, (EvalMultKey, GaloisKey)):
        ek = ek.key
    params = ek.params
    if len(c.cs) not in (2, 3):
        raise UsageError(f"keyswitch takes 2 or 3 components, got {len(c.cs)}")
    if getattr(params, "hybrid_decompose", None) is not None:
        return _keyswitch_hybrid(params, ek, c)
    ring = c.ring
    R.require_whole(ring, "the per-limb and windowed RNS gadget")
    expand = getattr(params, "keyswitch_expand", None)
    contract = getattr(params, "keyswitch_contract", None)
    if expand is not None:
        exp_ring, c1 = expand(ring, c.cs[0])
        c2 = R.zero_like(exp_ring, c1) if len(c.cs) == 2 else expand(ring, c.cs[1])[1]
    else:
        exp_ring, c1 = ring, c.cs[0]
        c2 = c.cs[1] if len(c.cs) == 3 else None

    window = params.relin_window
    key_dec_ring = params.ring_cipher if _is_modraised(params) else ek.ring
    kpl = _gadget_shape(key_dec_ring, window)[0] if window else None
    digits = gadget_decompose(ring, exp_ring, c.cs[-1], window, k_per_limb=kpl)
    metrics.count("keyswitch")
    metrics.count("ntt_limb_transform", int(digits.shape[0]) * exp_ring.nlimbs)
    ddual = nttmod.ntt(exp_ring.tables, digits)              # [ndig, ..., Lt, N]

    masks, maskeds = _downswitch_stack(params, ek, exp_ring, int(digits.shape[0]))
    # batched ciphertexts carry leading axes between the digit and limb
    # axes — insert singleton dims so the key stacks broadcast
    extra = ddual.dim() - 3
    if extra:
        shp = masks.shape[:1] + (1,) * extra + masks.shape[1:]
        masks = masks.reshape(shp)
        maskeds = maskeds.reshape(shp)
    mp = exp_ring.mp
    acc2 = modmath.mod_sum(modmath.mul_mod(masks, ddual, mp), mp, axis=0)
    acc1 = modmath.mod_sum(modmath.mul_mod(maskeds, ddual, mp), mp, axis=0)

    c1 = R.add(exp_ring, R.ensure_dual(exp_ring, c1), RingElt(dual=acc1))
    if c2 is None:
        c2 = RingElt(dual=acc2)
    else:
        c2 = R.add(exp_ring, R.ensure_dual(exp_ring, c2), RingElt(dual=acc2))
    out_ring = exp_ring
    if contract is not None:
        out_ring, c1 = contract(exp_ring, c1)
        _, c2 = contract(exp_ring, c2)
    return CipherText(c.params, (c1, c2), out_ring, enc=c.enc)


def _keyswitch_hybrid(params, ek: KeySwitchKey, c: CipherText) -> CipherText:
    """dnum-grouped hybrid key switch (:mod:`.hybrid`): digits are limb
    groups fast-base-converted into the Q_t ∪ P tower; the accumulator
    alone is divided by P (the base components are never pre-scaled)."""
    ring = c.ring
    metrics.count("keyswitch")
    exp_ring, ddual = params.hybrid_decompose_dual(ring, c.cs[-1])
    masks, maskeds = _hybrid_key_stack(params, ek, exp_ring, int(ddual.shape[0]))
    acc = keyprod_cuda.key_products(ddual, masks, maskeds, exp_ring.mp)

    # one stacked contraction: the fused ModDown's transforms batch over
    # both accumulator components in a single NTT call
    out_ring, a = params.hybrid_contract(exp_ring, RingElt(dual=acc))
    if a.dual is not None:
        a1, a2 = RingElt(dual=a.dual[0]), RingElt(dual=a.dual[1])
    else:                       # the BGV contraction returns the primal form
        a1, a2 = RingElt(primal=a.primal[0]), RingElt(primal=a.primal[1])
    if out_ring is not ring:
        raise UsageError("hybrid contraction left the ciphertext tower")
    c1 = R.add(ring, c.cs[0], a1)
    c2 = a2 if len(c.cs) == 2 else R.add(ring, c.cs[1], a2)
    return CipherText(c.params, (c1, c2), ring, enc=c.enc)


def _hybrid_key_stack(params, ksk: KeySwitchKey, exp_ring: RingContext, ndig: int):
    """A hybrid key's components as dual tensors [ndig, Le, N] restricted
    to the expanded tower."""
    return _key_stack(ksk, params.hybrid_key_limbs(exp_ring), ndig)


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------

def apply_galois_ct(c: CipherText, galois_element: int) -> CipherText:
    cs = tuple(R.apply_galois(c.ring, x, galois_element) for x in c.cs)
    return CipherText(c.params, cs, c.ring, enc=c.enc)


def rotate(gk, c: CipherText, steps: Optional[int] = None) -> CipherText:
    """Slot rotation: Galois automorphism, then the key switch. Accepts a
    GaloisKey, or a GaloisKeys collection with ``steps``."""
    if isinstance(gk, GaloisKeys):
        gk = gk.for_steps(c.ring.n, steps)
    if not isinstance(gk, GaloisKey):
        raise TypeError("rotate takes a GaloisKey or a GaloisKeys collection")
    metrics.count("rotate")
    return keyswitch(gk, apply_galois_ct(c, gk.galois_element))


# Ciphertexts decomposed and key products made by the hoisted schedules
# (a batched ciphertext counts once per ciphertext it holds), and the calls
# that made them.
hoist_counts = {"decompositions": 0, "decompose_calls": 0,
                "key_products": 0, "key_product_calls": 0}


def _count(what: str, calls: str, t: torch.Tensor) -> None:
    hoist_counts[what] += max(1, t[0].numel() // (t.shape[-1] * t.shape[-2]))
    hoist_counts[calls] += 1


class _HoistGadget:
    """Gadget adapter for the hoisted-rotation paths (:func:`rotate_many`
    / :func:`rotate_sum`). Valid only where σ_g commutes with the digit
    map: the hybrid gadget and centered-RNS digits (relin_window == 0 —
    odd primes make the centered lift an odd function, so the signed
    coefficient permutation passes through the decomposition and through
    the ModulusRaised expand, which is a per-coefficient scalar multiply).
    Raw base-2^w windowed digits are unsigned and do not commute — those
    params fall back to per-rotation rotate()."""

    def __init__(self, params, ring: RingContext):
        self.params = params
        self.ring = ring
        self.hybrid = getattr(params, "hybrid_decompose", None) is not None
        self.exp_ring: Optional[RingContext] = None
        self.ndig = 0

    @staticmethod
    def supports(params, c: CipherText) -> bool:
        return len(c.cs) == 2 and (
            getattr(params, "hybrid_decompose", None) is not None
            or getattr(params, "relin_window", None) == 0)

    def decompose_dual(self, elt: RingElt) -> torch.Tensor:
        """[ndig, ..., Le, N] digit tensor in the (expanded) tower's dual
        domain; paid once per hoist batch."""
        if self.hybrid:
            self.exp_ring, ddual = self.params.hybrid_decompose_dual(self.ring, elt)
        else:
            if self.exp_ring is None:
                expand = getattr(self.params, "keyswitch_expand", None)
                # expand a zero element once to learn the raised tower
                self.exp_ring = (expand(self.ring, R.zero_like(self.ring, elt))[0]
                                 if expand is not None else self.ring)
            digits = gadget_decompose(self.ring, self.exp_ring, elt, 0)
            metrics.count("ntt_limb_transform", int(digits.shape[0]) * self.exp_ring.nlimbs)
            ddual = nttmod.ntt(self.exp_ring.tables, digits)
        self.ndig = int(ddual.shape[0])
        _count("decompositions", "decompose_calls", ddual)
        return ddual

    def key_products(self, ksk: KeySwitchKey, ddual: torch.Tensor, perm: torch.Tensor,
                     acc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[2, ..., Le, N]: (Σ_digits maskeds·σ(ddual), Σ_digits
        masks·σ(ddual)) in the raised tower, σ the dual permutation
        ``perm``: the contributions to the first and to the second
        component, added into ``acc`` in place when given."""
        if self.hybrid:
            masks, maskeds = _hybrid_key_stack(self.params, ksk, self.exp_ring, self.ndig)
        else:
            masks, maskeds = _downswitch_stack(self.params, ksk, self.exp_ring, self.ndig)
        _count("key_products", "key_product_calls", ddual)
        return keyprod_cuda.key_products(ddual, masks, maskeds, self.exp_ring.mp, perm=perm,
                                         acc=acc)

    def contract_pair(self, acc: torch.Tensor):
        """ModDown both raised accumulators ``acc`` [2, ..., Le, N] back to
        the base tower in one stacked contraction (a no-op for the plain RNS
        gadget)."""
        elt = RingElt(dual=acc)
        if self.hybrid:
            out_ring, e = self.params.hybrid_contract(self.exp_ring, elt)
        else:
            hook = getattr(self.params, "keyswitch_contract", None)
            if hook is None:
                return RingElt(dual=acc[0]), RingElt(dual=acc[1])
            out_ring, e = hook(self.exp_ring, elt)
        if out_ring.primes != self.ring.primes:
            raise UsageError("the contraction left the ciphertext tower")
        if e.dual is not None:
            return RingElt(dual=e.dual[0]), RingElt(dual=e.dual[1])
        return RingElt(primal=e.primal[0]), RingElt(primal=e.primal[1])


def rotate_many(gks: GaloisKeys, c: CipherText, elements) -> dict:
    """Hoisted rotations: {galois_element: rotated ct} for a batch of
    elements, sharing one gadget decomposition + digit NTT.

    σ_g commutes with the limb / FBC decomposition (per-coefficient linear
    ops commute with the signed coefficient permutation) and acts on the
    dual domain as the pure permutation ``ntt.galois_dual_perm``; so the
    per-rotation cost drops to the key products, which read the digits
    through the permutation (:mod:`..ops.keyprod_cuda`), and the contraction —
    the (ndig·Le)-transform decomposition is paid once. Hybrid-gadget and
    centered-RNS (window 0, incl. ModulusRaised) params take the fast path;
    unsigned windowed digits fall back to rotate()."""
    params = c.params
    if not _HoistGadget.supports(params, c):
        return {g: rotate(gks.for_element(g), c) for g in elements}
    ring = c.ring
    n = ring.n
    gad = _HoistGadget(params, ring)
    ddual = gad.decompose_dual(c.cs[1])                   # [ndig, ..., Le, N]
    c0d = R.ensure_dual(ring, c.cs[0]).dual

    outs = {}
    for g in elements:
        gk = gks.for_element(g)
        metrics.count("rotate")
        metrics.count("keyswitch")
        perm = nttmod.galois_dual_perm_dev(n, g, ddual.device)
        a1, a2 = gad.contract_pair(gad.key_products(gk.key, ddual, perm))
        c0_rot = RingElt(dual=c0d.index_select(-1, perm))
        outs[g] = CipherText(c.params, (R.add(ring, c0_rot, a1), a2), ring, enc=c.enc)
    return outs


def rotate_sum(gks: GaloisKeys, terms) -> CipherText:
    """Σ_g rot_g(term_g) for ``terms`` = [(galois_element | None, ct)]
    (None = identity, no key switch). Lazy ModDown: the per-rotation
    key-switch accumulators are summed in the raised tower and the
    contraction (divide-by-P base conversion) runs once for the whole sum
    instead of once per rotation — the BSGS giant-step loop's workhorse.
    One rounding for the batch also means less contraction noise than the
    rotate-then-add schedule. Valid for the hybrid and centered-RNS
    (window 0, incl. ModulusRaised) gadgets; other params fall back to
    rotate() + ct_add."""
    terms = [(g, t) for (g, t) in terms if t is not None]
    if not terms:
        raise ValueError("rotate_sum of an empty term list")
    params = terms[0][1].params
    rotated_terms = [(g, t) for (g, t) in terms if g is not None and g != 1]
    if not all(_HoistGadget.supports(params, t) for _, t in terms):
        out = None
        for g, t in terms:
            r = t if (g is None or g == 1) else rotate(gks.for_element(g), t)
            out = r if out is None else ct_add(out, r)
        return out

    # Mirror ct_add's checks up front: the fast path tags the output with
    # the first rotated term's enc, which is only sound when every term
    # shares params and a combine_add-compatible enc.
    enc0 = terms[0][1].enc
    for _, t in terms[1:]:
        if t.params is not params:
            raise UsageError("rotate_sum terms carry differing parameters")
        if enc0 is not None and t.enc is not None:
            enc0.combine_add(t.enc)

    c0_ident = None                      # identity terms: plain adds
    for g, t in terms:
        if g is None or g == 1:
            c0_ident = t if c0_ident is None else ct_add(c0_ident, t)
    if not rotated_terms:
        return c0_ident

    ring = rotated_terms[0][1].ring
    n = ring.n
    mp = ring.mp
    gad = _HoistGadget(params, ring)
    accs = None                          # raised-tower accumulators [2, ..., Le, N] (dual)
    c0s = None                           # base-tower Σ σ_g(c0) (dual)
    for g, t in rotated_terms:
        if t.ring is not ring:
            raise UsageError("rotate_sum terms must share one tower")
        gk = gks.for_element(g)
        metrics.count("rotate")
        metrics.count("keyswitch")
        ddual = gad.decompose_dual(t.cs[1])
        perm = nttmod.galois_dual_perm_dev(n, g, ddual.device)
        accs = gad.key_products(gk.key, ddual, perm, accs)     # σ_g ∘ decompose, summed
        c0g = R.ensure_dual(ring, t.cs[0]).dual.index_select(-1, perm)
        c0s = c0g if c0s is None else modmath.add_mod(c0s, c0g, mp)

    a1, a2 = gad.contract_pair(accs)
    t0 = rotated_terms[0][1]
    out = CipherText(params, (R.add(ring, RingElt(dual=c0s), a1), a2), ring, enc=t0.enc)
    return out if c0_ident is None else ct_add(out, c0_ident)


# ---------------------------------------------------------------------------
# Modulus switching and rescale
# ---------------------------------------------------------------------------

def ct_modswitch_drop(c: CipherText) -> CipherText:
    """Drop every component's last limb without rescaling (the scale tag is
    unchanged)."""
    ring = c.ring
    cs = []
    sub = None
    for x in c.cs:
        sub, y = R.modswitch_drop(ring, x)
        cs.append(y)
    enc = (c.enc.drop_limb(ring)
           if c.enc is not None and hasattr(c.enc, "drop_limb") else c.enc)
    return CipherText(c.params, tuple(cs), sub, enc=enc)


def _base(params):
    while isinstance(params, PassthroughParams):
        params = params.params
    return params


def bgv_plain_modulus(params):
    """The plaintext modulus when the (possibly wrapped) base scheme is
    BGV, whose divide-and-round steps must keep the error ≡ 0 mod p
    (``ring.rescale_adapted``); None for every other scheme."""
    base = _base(params)
    return base.plain.p if base.scheme_name() == "BGV" else None


def ct_rescale(c: CipherText) -> CipherText:
    """Modulus switch by the last prime; the tower shrinks to L-1. CKKS: the
    exact divide-and-round of every component and the division of the
    scale tag. BGV: the p-adapted rounding, and the message picks up a
    q_k⁻¹ mod p factor that a ``bgv.BGVTag`` tracks (leveled BGV)."""
    metrics.count("rescale")
    ring = c.ring
    t = bgv_plain_modulus(c.params)
    # every component in one call: on a sharded tower, one collective
    x = RingElt(primal=torch.stack([R.ensure_primal(ring, x).primal for x in c.cs]))
    sub, y = R.rescale_adapted(ring, x, t) if t is not None else R.rescale(ring, x)
    cs = [RingElt(primal=v) for v in y.primal.unbind(0)]
    if t is not None:
        from .bgv import BGVTag
        enc = (c.enc if c.enc is not None else BGVTag(t)).rescale_by(ring.primes[-1])
    else:
        enc = (c.enc.rescale_by(ring.primes[-1])
               if c.enc is not None and hasattr(c.enc, "rescale_by") else c.enc)
    return CipherText(c.params, tuple(cs), sub, enc=enc)


def modswitch(c: CipherText, new_modulus=None) -> CipherText:
    """Generic modulus switch. With no target it is the rescale;
    arbitrary-target switching is not implemented (the reference raises
    too)."""
    if new_modulus is not None:
        raise NotImplementedError("modswitch to an arbitrary modulus")
    return ct_rescale(c)


# ---------------------------------------------------------------------------
# Ciphertext batching (leading axes broadcast through the whole engine)
# ---------------------------------------------------------------------------

def ct_stack(cts) -> CipherText:
    """Stack ciphertexts with identical params, tower and encoding into one
    batched ciphertext (dual domain). Every engine op — add, mul, key switch,
    rotate, rescale — broadcasts over leading axes. The new axis is the one
    just before the tower [L, N]: axis 0 for unbatched ciphertexts, and
    inside any batch axes the inputs already carry (as a ``vmap`` over them
    would place it)."""
    c0 = cts[0]
    for c in cts[1:]:
        if c.params is not c0.params or c.ring is not c0.ring:
            raise UsageError("ct_stack requires identical params and tower")
        if len(c.cs) != len(c0.cs):
            raise UsageError("ct_stack requires equal component counts")
    cs = []
    for i in range(len(c0.cs)):
        duals = [R.ensure_dual(c0.ring, c.cs[i]).dual for c in cts]
        cs.append(RingElt(dual=torch.stack(duals, dim=-3)))
    return CipherText(c0.params, tuple(cs), c0.ring, enc=c0.enc)


def ct_gather(c: CipherText) -> CipherText:
    """The whole ciphertext on every rank from a limb-sharded one (the
    counterpart of reading a global ``jax.Array``): one all-gather over
    'rp' of every component (site ``level_gather``), in the dual domain
    when every component has it. A whole ciphertext as it is."""
    ring = c.ring
    if not isinstance(ring, R.ShardedRing):
        return c
    dual = all(x.dual is not None for x in c.cs)
    t = torch.stack([x.dual if dual else R.ensure_primal(ring, x).primal for x in c.cs])
    g = R.gather(ring, t, "level_gather").unbind(0)
    cs = tuple(RingElt(dual=v) if dual else RingElt(primal=v) for v in g)
    return CipherText(c.params, cs, R.whole(ring), enc=c.enc)


def ct_index(c: CipherText, i: int) -> CipherText:
    """Element i of the stack axis :func:`ct_stack` made (the axis just
    before the tower)."""
    cs = tuple(RingElt(primal=None if x.primal is None else x.primal[..., i, :, :],
                       dual=None if x.dual is None else x.dual[..., i, :, :]) for x in c.cs)
    return CipherText(c.params, cs, c.ring, enc=c.enc)
