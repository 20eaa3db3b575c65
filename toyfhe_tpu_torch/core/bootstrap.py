"""CKKS bootstrapping: refresh an exhausted ciphertext to a deep tower
without the secret key.

Port of ``toyfhe_tpu/core/bootstrap.py``. The primitives, on the engine's
rotation and key-switch machinery:

  * **BSGS homomorphic linear transform** — Enc(v) → Enc(M·v) by the
    diagonal method with baby-step / giant-step batching: the baby
    rotations share one hoisted decomposition (``rlwe.rotate_many``), the
    giant steps one lazy ModDown (``rlwe.rotate_sum``);
  * **slot conjugation** — the Galois element 2N−1;
  * **CoeffToSlot / SlotToCoeff** — dense (d = N/2 diagonals a matrix) or
    factored into ``log_radix(d)`` sparse butterfly levels (:mod:`.sfft`),
    the four CoeffToSlot chains (two SlotToCoeff chains) riding one stacked
    ciphertext so every rotation is shared;
  * **polynomial evaluation** — Horner (:func:`eval_poly`) and the
    Chebyshev-basis Paterson–Stockmeyer evaluator :func:`eval_chebyshev`,
    on the exact-``Fraction`` scale alignment of ``ckks_encoding.ct_to`` /
    ``mul_plain_scalar_at``.

And the refresh (:func:`bootstrap`): ModRaise (:func:`mod_raise`) → retag by
q₀ → CoeffToSlot → EvalMod (a sine, or a cosine seed and double-angle
squarings, with an optional arcsine correction, on both CoeffToSlot halves
stacked into one batch-2 ciphertext) → SlotToCoeff with q₀/Δ folded in.

Leading batch axes run through every function: :func:`bootstrap_batched`
is :func:`bootstrap` on a ``rlwe.ct_stack``'ed batch, the batch axis
outside the stacks the refresh makes itself (``ct_stack`` stacks at the
axis just before the tower). The context keeps each encoded transform
diagonal and EvalMod constant on the device the first time it is made
(``ckks_encoding.encode_cache``), so a warm refresh encodes nothing on the
host.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..ops import modmath
from ..utils import graphs, numtheory as nt
from . import ckks_encoding as CE
from . import ring as R
from . import rlwe
from . import sfft as SF
from .rlwe import CipherText, GaloisKeys, galois_element_for_steps


def bsgs_split(d: int):
    """(baby steps, giant steps) for d diagonals: bs = ⌊√d⌋, gs = ⌈d / bs⌉."""
    bs = max(1, int(math.isqrt(d)))
    gs = (d + bs - 1) // bs
    return bs, gs


# ---------------------------------------------------------------------------
# rotation helpers
# ---------------------------------------------------------------------------

def rotate_steps(gks: GaloisKeys, c: CipherText, steps: int) -> CipherText:
    """Slot rotation by ``steps`` (rot_k(v)[j] = v[(j+k) mod n/2]), the
    Galois key taken from the set. steps ≡ 0 is the identity."""
    n = c.ring.n
    k = steps % (n // 2)
    if k == 0:
        return c
    return rlwe.rotate(gks.for_element(galois_element_for_steps(n, -k)), c)


def rotate_steps_many(gks: GaloisKeys, c: CipherText, steps_list) -> dict:
    """{steps: rotated ct} sharing one hoisted decomposition
    (``rlwe.rotate_many``): the BSGS baby loops' workhorse."""
    n = c.ring.n
    ks = sorted({s % (n // 2) for s in steps_list})
    els = {k: galois_element_for_steps(n, -k) for k in ks if k}
    rotated = rlwe.rotate_many(gks, c, sorted(set(els.values())))
    out = {k: rotated[e] for k, e in els.items()}
    if 0 in ks:
        out[0] = c
    return out


def conjugate(gk_conj, c: CipherText) -> CipherText:
    """Complex conjugation of the slot vector: Galois element 2N−1, then the
    key switch."""
    return rlwe.rotate(gk_conj, c)


def keygen_bootstrap_keys(gen: torch.Generator, priv, bs: int, gs: int):
    """Galois keys for dense BSGS transforms (baby steps 1..bs−1, giant
    steps bs, 2bs, ...) and the conjugation key: (GaloisKeys, conj_key)."""
    n = priv.params.ring_key.n
    steps = sorted({s % (n // 2) for s in range(1, bs)}
                   | {(g * bs) % (n // 2) for g in range(1, gs)} - {0})
    keys = [rlwe.keygen_galois(gen, priv, galois_element=galois_element_for_steps(n, -s))
            for s in steps]
    conj = rlwe.keygen_galois(gen, priv, galois_element=2 * n - 1)
    return GaloisKeys(keys), conj


# ---------------------------------------------------------------------------
# BSGS homomorphic linear transform (diagonal method)
# ---------------------------------------------------------------------------

def linear_transform(gks: GaloisKeys, c: CipherText, M: np.ndarray,
                     key=None) -> CipherText:
    """Enc(v) → Enc(M·v) for M ∈ ℂ^{d×d}, d = N/2 slots:

        M·v = Σ_g rot_{g·bs}( Σ_b rot_{−g·bs}(diag_{g·bs+b}) ⊙ rot_b(v) )

    with diag_k[j] = M[j, (j+k) mod d]. Consumes one multiplicative level
    (output scale = scale²; rescale afterwards). Zero diagonals are skipped.
    ``key`` names M for ``ckks_encoding.encode_cache``."""
    d = c.ring.n // 2
    M = np.asarray(M, dtype=np.complex128)
    if M.shape != (d, d):
        raise ValueError(f"expected a {d}x{d} matrix, got {M.shape}")
    j = np.arange(d)
    diags = {k: M[j, (j + k) % d] for k in range(d)}
    bs, gs = bsgs_split(d)

    need = sorted({k % bs for k in range(d) if np.any(diags[k])})
    baby = rotate_steps_many(gks, c, need)
    n = c.ring.n
    terms = []
    for g in range(gs):
        inner = None
        for b in range(bs):
            k = g * bs + b
            if k >= d:
                break
            dk = diags[k]
            if not np.any(dk):
                continue
            dk_shift = np.roll(dk, g * bs)          # rot_{−g·bs}(diag_k)
            term = CE.mul_plain_vector(baby[b], dk_shift,
                                       key=None if key is None else (key, k))
            inner = term if inner is None else rlwe.ct_add(inner, term)
        if inner is None:
            continue
        k = (g * bs) % d
        terms.append((galois_element_for_steps(n, -k) if k else None, inner))
    if not terms:                                    # M == 0
        return CE.mul_plain_vector(c, np.zeros(d))
    # the giant rotations land in one lazy-ModDown key-switch batch
    return rlwe.rotate_sum(gks, terms)


# ---------------------------------------------------------------------------
# CoeffToSlot / SlotToCoeff
# ---------------------------------------------------------------------------

def decode_matrix(n: int) -> np.ndarray:
    """U ∈ ℂ^{N/2 × N}: slots = U · coeffs (the CKKS decode map at scale 1)."""
    m = 2 * n
    g = 3 ** (np.arange(1, n // 2 + 1, dtype=object)) % m
    g = np.asarray([int(x) for x in g], dtype=np.float64)
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(g, k) / m)


def coeff_to_slot(gks: GaloisKeys, gk_conj, c: CipherText, factor: float = 1.0):
    """Enc(v) → (Enc(c_lo), Enc(c_hi)): the slot vectors become the low and
    high halves of the coefficient vector of the underlying plaintext (each
    divided by the ciphertext scale), times ``factor``:
    c_k = (1/N)·(Σ_j Ū[j,k]·v_j + Σ_j U[j,k]·v̄_j) — BSGS linear transforms
    on (ct, conj(ct)). Consumes one level; rescale after."""
    n = c.ring.n
    h = n // 2
    U = decode_matrix(n)
    f = factor / n
    cbar = conjugate(gk_conj, c)
    key = lambda part: ("c2s_dense", n, part, factor)
    lo = rlwe.ct_add(linear_transform(gks, c, np.conj(U[:, :h]).T * f, key("lo")),
                     linear_transform(gks, cbar, U[:, :h].T * f, key("lo_bar")))
    hi = rlwe.ct_add(linear_transform(gks, c, np.conj(U[:, h:]).T * f, key("hi")),
                     linear_transform(gks, cbar, U[:, h:].T * f, key("hi_bar")))
    return lo, hi


def slot_to_coeff(gks: GaloisKeys, c_lo: CipherText, c_hi: CipherText,
                  factor: float = 1.0) -> CipherText:
    """Inverse of :func:`coeff_to_slot`: slots(out) = A·c_lo + B·c_hi with
    U = [A | B]. ``factor`` folds a constant in (the bootstrap's q₀/scale)."""
    n = c_lo.ring.n
    h = n // 2
    U = decode_matrix(n)
    key = lambda part: ("s2c_dense", n, part, factor)
    return rlwe.ct_add(linear_transform(gks, c_lo, U[:, :h] * factor, key("lo")),
                       linear_transform(gks, c_hi, U[:, h:] * factor, key("hi")))


# ---------------------------------------------------------------------------
# factored (special-FFT) CoeffToSlot / SlotToCoeff
# ---------------------------------------------------------------------------

def _linear_transform_diags(gks: GaloisKeys, c: CipherText, diags: dict,
                            out_scale=None, sl: int = 1, key=None) -> CipherText:
    """Enc(v) → Enc(M·v) for M given as {offset: vec[..., d]} diagonals (the
    vectors' leading axis aligns with the ciphertext's stack axis). BSGS with
    gap-aware step splitting (``sfft.bsgs_split_offsets``). Consumes one
    level (``sl`` limbs); rescale after.

    ``out_scale`` pins the post-rescale scale: the diagonals are encoded at
    out_scale·(∏ last sl primes)/ct_scale instead of at the ciphertext's
    scale — without it a seed mismatch (a retag by a composite q₀ off the
    level equilibrium) doubles in log per level. ``key`` names the level for
    ``ckks_encoding.encode_cache``."""
    d = c.ring.n // 2
    at = None
    if out_scale is not None:
        pprod = math.prod(c.ring.primes[-sl:])
        at = Fraction(out_scale) * pprod / Fraction(c.enc.scale)
        if not at >= 2:
            raise ValueError(f"level scale correction {float(at):g} too small")
    groups = SF.bsgs_split_offsets(diags.keys(), d)
    need = sorted({b for _, items in groups.items() for b, off in items
                   if np.any(np.asarray(diags[off]))})
    baby = rotate_steps_many(gks, c, need)
    n = c.ring.n
    terms = []                    # (galois_element | None, inner_g)
    for g, items in sorted(groups.items()):
        inner = None
        for b, off in items:
            vec = np.asarray(diags[off], dtype=np.complex128)
            if not np.any(vec):
                continue
            term_vec = np.roll(vec, g, axis=-1)          # rot_{−g}(diag)
            k = None if key is None else (key, g, b, off)
            if vec.ndim == 1:
                term = (CE.mul_plain_vector_at(baby[b], term_vec, at, key=k)
                        if at is not None else CE.mul_plain_vector(baby[b], term_vec, key=k))
            else:
                term = CE.mul_plain_vectors(baby[b], term_vec, at_scale=at, key=k)
            inner = term if inner is None else rlwe.ct_add(inner, term)
        if inner is None:
            continue
        k = g % (n // 2)
        terms.append((galois_element_for_steps(n, -k) if k else None, inner))
    if not terms:
        raise ValueError("all-zero diagonal set")
    # the giant rotations land in one lazy-ModDown key-switch batch
    return rlwe.rotate_sum(gks, terms)


def _stack_level(chains, i: int, d: int) -> dict:
    """The i-th level of several chains as {offset: vec[B, d]} (a missing
    diagonal is zero)."""
    levels = [chain[i] for chain in chains]
    offsets = sorted(set().union(*[lv.keys() for lv in levels]))
    z = np.zeros(d, dtype=np.complex128)
    return {o: np.stack([np.asarray(lv.get(o, z)) for lv in levels]) for o in offsets}


def coeff_to_slot_factored(gks: GaloisKeys, gk_conj, c: CipherText, plan,
                           sl: int = 1, out_scale=None):
    """Factored CoeffToSlot: (P·lo, P·hi) in bit-reversed coefficient order —
    the permutation is never applied; SlotToCoeff undoes it (EvalMod between
    them is pointwise). Consumes plan.nlevels levels (each ``sl`` limbs under
    composite scaling). One stacked ciphertext [c, c̄, c, c̄] carries all four
    chains."""
    cbar = conjugate(gk_conj, c)
    x = rlwe.ct_stack([c, cbar, c, cbar])
    for i in range(plan.nlevels):
        diags = _stack_level(plan.c2s_chains, i, plan.d)
        x = _rescale_k(_linear_transform_diags(
            gks, x, diags, out_scale=out_scale, sl=sl,
            key=("c2s", plan.n, plan.radix, i)), sl)
    lo = rlwe.ct_add(rlwe.ct_index(x, 0), rlwe.ct_index(x, 1))
    hi = rlwe.ct_add(rlwe.ct_index(x, 2), rlwe.ct_index(x, 3))
    return lo, hi


def slot_to_coeff_factored(gks: GaloisKeys, c_lo: CipherText, c_hi: CipherText,
                           plan, factor: float = 1.0, sl: int = 1,
                           out_scale=None) -> CipherText:
    """Factored SlotToCoeff on bit-reversed-slot inputs; ``factor`` is folded
    into the first level's diagonals. One stacked ciphertext [lo, hi]."""
    x = rlwe.ct_stack([c_lo, c_hi])
    for i in range(plan.nlevels):
        diags = _stack_level(plan.s2c_chains, i, plan.d)
        if i == 0 and factor != 1.0:
            diags = {k: v * factor for k, v in diags.items()}
        x = _rescale_k(_linear_transform_diags(
            gks, x, diags, out_scale=out_scale, sl=sl,
            key=("s2c", plan.n, plan.radix, i, factor if i == 0 else 1.0)), sl)
    return rlwe.ct_add(rlwe.ct_index(x, 0), rlwe.ct_index(x, 1))


# ---------------------------------------------------------------------------
# homomorphic polynomial evaluation
# ---------------------------------------------------------------------------

def _rescale_k(c: CipherText, k: int) -> CipherText:
    """k successive rescales — one level under composite scaling (scale ≈
    the product of k limb primes).

    Guard: the composite equilibrium scale' = scale²/pair doubles any
    log-deficit per multiplicative level, so an unbalanced tower (pairs
    systematically above 2^(26k)) silently collapses the working scale, and
    the modswitch rounding bias then destroys the refresh. Fail loudly
    instead; the fix is :func:`make_boot_ring`'s balanced level pairs."""
    for _ in range(k):
        c = rlwe.ct_rescale(c)
    s = getattr(c.enc, "scale", None)
    if s is not None and 0 < s < (1 << max(1, 26 * k - 12)):
        raise ValueError(
            f"composite working scale collapsed to 2^{math.log2(float(s)):.1f} "
            f"(level-pair drift compounds geometrically); build the tower with "
            f"balanced level pairs (bootstrap.make_boot_ring)")
    return c


def _mul_rescale(ek, a: CipherText, b: CipherText, sl: int = 1) -> CipherText:
    return _rescale_k(rlwe.keyswitch(ek, rlwe.ct_mul(a, b)), sl)


def eval_poly(ek, c: CipherText, coeffs: Sequence[float]) -> CipherText:
    """Homomorphic p(x) = Σ aᵢxⁱ by Horner's rule:

        r ← a_d;  r ← rescale(r·x) + a_{i}   for i = d−1 … 0

    Every step multiplies by the same x (dropped to r's tower), so the
    scales stay uniform along the one chain. Consumes deg(p) levels."""
    coeffs = [float(a) for a in coeffs]
    deg = len(coeffs) - 1
    if deg < 1:
        raise ValueError("constant polynomial — nothing to evaluate")
    r = CE.add_plain(rlwe.ct_rescale(CE.mul_plain_scalar(c, coeffs[deg])), coeffs[deg - 1])
    for i in range(deg - 2, -1, -1):
        x = c
        while x.ring.nlimbs > r.ring.nlimbs:
            x = rlwe.ct_modswitch_drop(x)
        r = CE.add_plain(_mul_rescale(ek, r, x), coeffs[i])
    return r


_TINY = 1e-13


def _mul_ct(ek, a: CipherText, b: CipherText, sl: int = 1) -> CipherText:
    """ct × ct with tower alignment, relinearization and rescale (sl limbs)."""
    nl = min(a.ring.nlimbs, b.ring.nlimbs)
    a = CE.ct_drop_to(a, nl)
    b = CE.ct_drop_to(b, nl)
    return _rescale_k(rlwe.keyswitch(ek, rlwe.ct_mul(a, b)), sl)


class ChebBasis:
    """Memoized Chebyshev power basis T_i(y) over an encrypted y ∈ [−1, 1].

    T_{a+b} = 2·T_a·T_b − T_{|a−b|} with a = ⌈i/2⌉, b = ⌊i/2⌋ gives every
    index at log₂(i) multiplicative depth; the giant steps T_{k·2^j} fall out
    of the same recursion (a = b → 2T_a² − 1). Every subtraction aligns the
    shallower operand with ``ckks_encoding.ct_to``, so every scale tag stays
    an exact Fraction."""

    def __init__(self, ek, y: CipherText, sl: int = 1):
        self.ek = ek
        self.sl = sl
        self.T = {1: y}

    def get(self, i: int) -> CipherText:
        if i in self.T:
            return self.T[i]
        if i < 1:
            raise ValueError("T_0 is the plain constant 1")
        a, b = (i + 1) // 2, i // 2
        ta, tb = self.get(a), self.get(b)
        two = CE.mul_int(_mul_ct(self.ek, ta, tb, self.sl), 2)
        if a == b:
            out = CE.add_plain(two, -1.0)
        else:                           # a − b = 1
            sub = CE.ct_to(self.get(a - b), two.ring.nlimbs, two.enc.scale)
            out = rlwe.ct_sub(two, sub)
        self.T[i] = out
        return out


def _align_sum(terms, nl=None):
    """Sum ciphertext terms after aligning all to one exact (tower, scale):
    the deepest term sets the target; a same-depth term at another scale
    forces one more level down. ``nl`` caps the target tower length."""
    lo = min(t.ring.nlimbs for t in terms)
    nl = lo if nl is None else min(nl, lo)
    anchors = [t for t in terms if t.ring.nlimbs == nl]
    target_scale = (anchors if anchors else terms)[0].enc.scale
    if any(t.enc.scale != target_scale for t in anchors):
        nl -= 1
    out = None
    for t in terms:
        t = CE.ct_to(t, nl, target_scale)
        out = t if out is None else rlwe.ct_add(out, t)
    return out, nl, target_scale


def _plain_term(t: CipherText, a: float, nlimbs: int, scale, sl: int = 1) -> CipherText:
    """a·t landed exactly at (nlimbs, scale): drop to nlimbs + sl, multiply at
    the correcting plaintext scale, rescale sl limbs."""
    t = CE.ct_drop_to(t, nlimbs + sl)
    p = math.prod(t.ring.primes[-sl:])
    r = Fraction(scale) * p / t.enc.scale
    return _rescale_k(CE.mul_plain_scalar_at(t, a, r), sl)


def _ps_base(basis: ChebBasis, coeffs):
    """Σ_{1≤i<k} aᵢ·Tᵢ as one batch of exactly aligned plain multiplies; the
    constant a₀ is returned apart (the caller adds it in plain)."""
    used = [(i, a) for i, a in enumerate(coeffs) if i >= 1 and abs(a) > _TINY]
    const = float(coeffs[0]) if coeffs else 0.0
    if not used:
        return None, const
    ts = [basis.get(i) for i, _ in used]
    sl = basis.sl
    nl = min(t.ring.nlimbs for t in ts) - sl
    scale = next(t for t in ts if t.ring.nlimbs == nl + sl).enc.scale
    out = None
    for (i, a), t in zip(used, ts):
        term = _plain_term(t, a, nl, scale, sl)
        out = term if out is None else rlwe.ct_add(out, term)
    return out, const


def _ps_recurse(basis: ChebBasis, coeffs, k: int):
    """Recursive Paterson–Stockmeyer split in the Chebyshev basis:
    p = q·T_g + r with g = k·2^{m−1} the largest giant ≤ deg(p), using
    T_i = 2·T_{i−g}·T_g − T_{|i−2g|}. Returns (ct part, constant)."""
    while coeffs and abs(coeffs[-1]) <= _TINY:
        coeffs = coeffs[:-1]
    d = len(coeffs) - 1
    if d < k:
        return _ps_base(basis, coeffs)
    m = 1
    while (k << m) <= d:
        m += 1
    g = k << (m - 1)
    q = [coeffs[g]] + [2.0 * x for x in coeffs[g + 1:]]
    r = list(coeffs[:g])
    for i in range(g + 1, d + 1):
        r[2 * g - i] -= coeffs[i]
    ctq, aq = _ps_recurse(basis, q, k)
    ctr, ar = _ps_recurse(basis, r, k)
    tg = basis.get(g)
    sl = basis.sl

    terms = []
    if ctq is not None:
        terms.append(_mul_ct(basis.ek, ctq, tg, sl))
    if ctr is not None:
        terms.append(ctr)
    if not terms:
        if abs(aq) <= _TINY:
            return None, ar
        nl = tg.ring.nlimbs - sl
        return _plain_term(tg, aq, nl, tg.enc.scale, sl), ar
    # the aq·T_g plain term needs one spare level on T_g itself
    cap = tg.ring.nlimbs - sl if abs(aq) > _TINY else None
    summed, nl, tscale = _align_sum(terms, nl=cap)
    if abs(aq) > _TINY:
        summed = rlwe.ct_add(summed, _plain_term(tg, aq, nl, tscale, sl))
    return summed, ar


def eval_chebyshev(ek, c: CipherText, cheb_coeffs, interval: float,
                   scale_limbs: int = 1, prescaled: bool = False) -> CipherText:
    """Evaluate p(x) = Σ aᵢ·Tᵢ(x/K) homomorphically, K = ``interval``, the
    coefficients in the Chebyshev basis on [−1, 1] (numpy ``chebval``
    convention), with O(√d) ct × ct multiplies and O(log d) depth.
    ``prescaled``: ``c`` already holds x/K (the caller folded 1/K into an
    earlier multiply), so the level of the division is not spent."""
    coeffs = [float(a) for a in np.asarray(cheb_coeffs, dtype=np.float64)]
    d = len(coeffs) - 1
    if d < 1:
        raise ValueError("constant polynomial — nothing to evaluate")
    if prescaled:
        y = c
    else:
        p = math.prod(c.ring.primes[-scale_limbs:])
        y = _rescale_k(CE.mul_plain_scalar_at(c, 1.0 / interval, p), scale_limbs)
    k = max(2, math.isqrt((d + 1) // 2) + 1)
    basis = ChebBasis(ek, y, scale_limbs)
    ct, const = _ps_recurse(basis, coeffs, k)
    if ct is None:
        raise ValueError("polynomial had no ciphertext-dependent part")
    if abs(const) > _TINY:
        ct = CE.add_plain(ct, const)
    return ct


# ---------------------------------------------------------------------------
# ModRaise and the refresh
# ---------------------------------------------------------------------------

def _crt_estimate(y: torch.Tensor, primes) -> torch.Tensor:
    """v = round(Σᵢ yᵢ/qᵢ) over the limb axis (-2) in float32, summed limb
    by limb from the first — the reference's order, so that a v near a
    half-integer rounds the same way."""
    acc = None
    for i, p in enumerate(primes):
        t = y[..., i, :].to(torch.float32) / modmath.const(float(p), y.device, torch.float32)
        acc = t if acc is None else acc + t
    return torch.round(acc).to(torch.int64)


def mod_raise(c: CipherText) -> CipherText:
    """Reinterpret an exhausted ciphertext's residues as integers in the full
    tower Q: decrypting the result gives m + q₀·I + e with
    ‖I‖∞ ≲ (1 + ‖s‖₁)/2 — the overflow the EvalMod phase removes. The scale
    tag is unchanged.

    One limb: the centered lift. Two to four limbs: the device FBC lift
    X = Σᵢ yᵢ·q̂ᵢ − v·q₀ with yᵢ = xᵢ·q̂ᵢ⁻¹ mod qᵢ and v = round(Σ yᵢ/qᵢ)
    estimated in float32 — a wrong v near a half-integer adds ±q₀, i.e. ±1
    to the overflow I, which the sine removes anyway. More limbs: the exact
    host CRT lift. On a sharded tower every rank gathers the short input
    whole (one all-gather, site ``level_gather``) and lifts it into the rows
    of the full tower it holds."""
    ring = c.ring
    if R.whole(ring) is c.params.ring_cipher:
        raise ValueError("ciphertext already at the full tower")
    top = R.like(ring, c.params.ring_cipher)
    tl = top.local                                   # the rows this process lifts into
    xp = R.gather(ring, torch.stack([R.ensure_primal(ring, x).primal for x in c.cs]),
                  "level_gather")                    # [cs, .., L0, N] whole
    ring = R.whole(ring)
    dev = xp.device
    if ring.nlimbs == 1:
        lift = modmath.centered(xp, ring.mp)                         # [.., 1, N]
        arr = modmath.from_signed(lift.expand(xp.shape[:-2] + (tl.nlimbs, ring.n)), tl.mp)
    elif ring.nlimbs <= 4:
        q = list(ring.primes)
        q0 = math.prod(q)
        qhat = [q0 // qi for qi in q]
        inv_col = modmath.const([[pow(h % p, -1, p)] for h, p in zip(qhat, q)], dev)
        y = modmath.mul_mod(xp, inv_col, ring.mp)                    # [.., L0, N]
        consts = modmath.const([[h % pt for pt in tl.primes] for h in qhat], dev)
        prod = modmath.mul_mod(y[..., :, None, :], consts[:, :, None], tl.mp)
        arr = modmath.mod_sum(prod, tl.mp, axis=-3)                  # [.., T, N]
        v = _crt_estimate(y, q)
        q0_res = modmath.const([[q0 % pt] for pt in tl.primes], dev)
        corr = modmath.mul_mod(v[..., None, :], q0_res, tl.mp)
        arr = modmath.sub_mod(arr, corr, tl.mp)
    else:                       # general tower: exact host CRT lift
        if graphs.capturing():
            raise graphs.CaptureError(
                f"mod_raise of a {ring.nlimbs}-limb input lifts on the host: it cannot be "
                "captured (inputs of up to 4 limbs lift on the device)")
        host = xp.cpu().numpy().reshape(-1, ring.nlimbs, ring.n)
        qm = ring.modulus
        rows = [tl.from_bigint([v - qm if v > qm // 2 else v for v in ring.to_bigint(h)])
                for h in host]
        arr = torch.as_tensor(np.stack(rows).reshape(xp.shape[:-2] + (tl.nlimbs, ring.n)),
                              device=dev)
    return CipherText(c.params, tuple(R.RingElt(primal=a) for a in arr.unbind(0)), top,
                      enc=c.enc)


def sine_cheb_coeffs(K: float, deg: int) -> np.ndarray:
    """Chebyshev fit of f(y) = sin(2πKy)/(2π) on [−1, 1]: f(u/K) ≈ u − round(u)
    for |u| ≤ K when the fractional part is small."""
    return np.polynomial.chebyshev.chebinterpolate(
        lambda y: np.sin(2 * np.pi * K * y) / (2 * np.pi), deg)


def cos_cheb_coeffs(K: float, deg: int, r: int) -> np.ndarray:
    """Chebyshev fit of g(y) = cos((2πKy − π/2)/2^r) on [−1, 1] — the
    double-angle EvalMod seed: r applications of c ← 2c² − 1 give
    cos(2πKy − π/2) = sin(2πKy), and the degree needed drops by about 2^r."""
    return np.polynomial.chebyshev.chebinterpolate(
        lambda y: np.cos((2 * np.pi * K * y - np.pi / 2) / (1 << r)), deg)


@dataclasses.dataclass
class BootstrapContext:
    """Keys and EvalMod plan for bootstrapping a parameter set.

    ``K`` must bound the ModRaise overflow: with a sparse ternary secret of
    hamming weight h, K ≥ (1 + h)/2 + 1. ``deg`` is the sine / cosine fit
    degree (the direct sine needs about 2πK + 15; with ``double_angle`` = r
    the cosine seed about 2πK/2^r + 15). ``double_angle`` = r > 0 evaluates
    cos((2πu − π/2)/2^r) and squares r times (c ← 2c² − 1) to reach
    sin(2πu); the 1/(2π) is folded into SlotToCoeff or the arcsine
    correction. ``plan`` (an ``sfft.SfftPlan``) selects the factored
    transforms. ``plain_cache`` holds the encoded transform diagonals and
    EvalMod constants on the keys' device, filled by the first refresh."""

    ek: object
    gks: GaloisKeys
    gk_conj: object
    K: float = 5.0
    deg: int = 46
    plan: object = None
    arcsin: bool = False
    double_angle: int = 0
    scale_limbs: int = 1
    base_scale: Optional[Fraction] = None
    plain_cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.double_angle:
            self.cheb = cos_cheb_coeffs(self.K, self.deg, self.double_angle)
        else:
            self.cheb = sine_cheb_coeffs(self.K, self.deg)


class _Shared:
    """A reference in pytree metadata that compares by the identity of what
    it holds: every copy of a context unflattened from its leaves shares the
    original's plain cache."""

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _Shared) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


# Keys are leaves; the EvalMod plan and the scale algebra are static, as in
# the reference (its plain cache carried by reference), so
# ``utils.graphs.jit(bootstrap)`` compiles the whole refresh.
pytree.register_pytree_node(
    BootstrapContext,
    lambda ctx: ([ctx.ek, ctx.gks, ctx.gk_conj],
                 (ctx.K, ctx.deg, ctx.plan, ctx.arcsin, ctx.double_angle,
                  ctx.scale_limbs, ctx.base_scale, _Shared(ctx.plain_cache))),
    lambda ch, aux: BootstrapContext(
        ek=ch[0], gks=ch[1], gk_conj=ch[2], K=aux[0], deg=aux[1], plan=aux[2],
        arcsin=aux[3], double_angle=aux[4], scale_limbs=aux[5], base_scale=aux[6],
        plain_cache=aux[7].obj))


def _arcsin_correct(ek, s: CipherText, sl: int = 1) -> CipherText:
    """First arcsine term: EvalMod's sine gives s = sin(2πε)/2π; the message
    is ε ≈ s + (2π)²/6 · s³. Costs 2 ct × ct levels."""
    s2 = _mul_ct(ek, s, s, sl)
    s3 = _mul_ct(ek, s2, s, sl)
    c3 = (2.0 * math.pi) ** 2 / 6.0
    t3 = _plain_term(s3, c3, s3.ring.nlimbs - sl, s3.enc.scale, sl)
    t1 = CE.ct_to(s, t3.ring.nlimbs, t3.enc.scale)
    return rlwe.ct_add(t1, t3)


def _arcsin_correct_from_sin(ek, v: CipherText, sl: int = 1) -> CipherText:
    """Arcsine correction of the unnormalized sine v = sin(2πε) (the
    double-angle output): ε ≈ v/(2π) + v³/(12π), the 1/(2π) folded into the
    correction's plain multiplies."""
    v2 = _mul_ct(ek, v, v, sl)
    v3 = _mul_ct(ek, v2, v, sl)
    t3 = _plain_term(v3, 1.0 / (12.0 * math.pi), v3.ring.nlimbs - sl, v3.enc.scale, sl)
    t1 = _plain_term(v, 1.0 / (2.0 * math.pi), t3.ring.nlimbs, t3.enc.scale, sl)
    return rlwe.ct_add(t1, t3)


def make_boot_ring(n: int, L: int = 46, num_special: int = 11, base_bits: int = 29,
                   level_bits: int = 26, special_bits: int = 29) -> R.RingContext:
    """Composite-scale bootstrap tower with balanced level pairs:
    (base, base) + L level limbs in (above, below)-2^level_bits pairs +
    num_special raising primes (``numtheory.balanced_pair_primes``: the
    composite equilibrium doubles any pair deficit per level)."""
    if L % 2:
        raise ValueError("composite tower needs an even level-limb count")
    bs = nt.ntt_prime_chain(n, (base_bits, base_bits) + (special_bits,) * num_special)
    base, spec = bs[:2], bs[2:]
    levels = nt.balanced_pair_primes(n, L // 2, level_bits, avoid=bs)
    return R.RingContext(n, tuple(base) + tuple(levels) + tuple(spec))


def setup_bootstrap(gen: torch.Generator, priv, K: float = 5.0, deg: int = 46,
                    radix: int = 0, arcsin: bool = False, double_angle: int = 0,
                    scale_limbs: int = 1, base_scale=None) -> BootstrapContext:
    """Rotation, conjugation and relinearization keys (on the generator's
    device) and the EvalMod polynomial for :func:`bootstrap`.

    ``radix`` = 0: dense BSGS CoeffToSlot / SlotToCoeff (one level a phase,
    d plaintext diagonals — small rings). ``radix`` ≥ 2: the special-FFT
    factored transforms (:mod:`.sfft`), log_radix(d) levels a phase with
    O(radix·log) diagonals and O(√radix·log) rotation keys — the
    production-N configuration. Composite-base ciphertexts (scale_limbs ≥ 2)
    spend about one unit of the margin K in :func:`mod_raise`'s float32
    estimate: keep K ≥ ‖I‖∞ + 1 for them."""
    n = priv.params.ring_key.n
    plan = None
    if radix:
        plan = SF.SfftPlan(n, radix)
        elements = [galois_element_for_steps(n, -s) for s in sorted(plan.rotation_steps())]
        gks = GaloisKeys([rlwe.keygen_galois(gen, priv, galois_element=e) for e in elements])
        gk_conj = rlwe.keygen_galois(gen, priv, galois_element=2 * n - 1)
    else:
        bs, gs = bsgs_split(n // 2)
        gks, gk_conj = keygen_bootstrap_keys(gen, priv, bs, gs)
    ek = rlwe.keygen_eval_mult(gen, priv)
    return BootstrapContext(ek=ek, gks=gks, gk_conj=gk_conj, K=K, deg=deg, plan=plan,
                            arcsin=arcsin, double_angle=double_angle,
                            scale_limbs=scale_limbs,
                            base_scale=None if base_scale is None else Fraction(base_scale))


def bootstrap(ctx: BootstrapContext, c: CipherText) -> CipherText:
    """Full CKKS refresh of an exhausted ciphertext, without the secret key:

        ModRaise → retag to q₀ → CoeffToSlot → EvalMod (both halves as one
        batch-2 ciphertext) → SlotToCoeff (×q₀/Δ)

    The division by q₀ is a retag — a free, noiseless reinterpretation of
    the scale — so the slot values entering EvalMod are coeff/q₀ + I, of size
    ≤ K, with full-precision transform matrices. Leading batch axes of ``c``
    run through (see :func:`bootstrap_batched`)."""
    lo, hi = bootstrap_phase1(ctx, c)
    ev = bootstrap_phase2(ctx, lo, hi)
    return bootstrap_phase3(ctx, ev, *_phase3_statics(ctx, c))


def bootstrap_phase1(ctx: BootstrapContext, c: CipherText):
    """ModRaise → retag → CoeffToSlot: the two halves (lo, hi)."""
    sl = ctx.scale_limbs
    q0 = c.ring.modulus                # composite when sl > 1 (sl limbs)
    scale = Fraction(c.enc.scale)
    cr = CE.retag(mod_raise(c), q0)
    pin = scale if sl > 1 else None    # pin the levels to the base scale
    with CE.encode_cache(ctx.plain_cache):
        if ctx.plan is not None:
            return coeff_to_slot_factored(ctx.gks, ctx.gk_conj, cr, ctx.plan,
                                          sl=sl, out_scale=pin)
        lo, hi = coeff_to_slot(ctx.gks, ctx.gk_conj, cr)
    return _rescale_k(lo, sl), _rescale_k(hi, sl)


def bootstrap_phase2(ctx: BootstrapContext, lo: CipherText, hi: CipherText) -> CipherText:
    """EvalMod: the batched Chebyshev evaluation, then the double-angle
    squarings and / or the arcsine correction."""
    sl = ctx.scale_limbs
    with CE.encode_cache(ctx.plain_cache):
        both = rlwe.ct_stack([lo, hi])
        ev = eval_chebyshev(ctx.ek, both, ctx.cheb, ctx.K, scale_limbs=sl)
        if ctx.double_angle:
            for _ in range(ctx.double_angle):      # cos(θ) → cos(2^r·θ)
                ev = CE.add_plain(CE.mul_int(_mul_ct(ctx.ek, ev, ev, sl), 2), -1.0)
            if ctx.arcsin:                         # ev = sin(2πu); ε via arcsin
                ev = _arcsin_correct_from_sin(ctx.ek, ev, sl)
        elif ctx.arcsin:
            ev = _arcsin_correct(ctx.ek, ev, sl)
    return ev


def _phase3_statics(ctx: BootstrapContext, c: CipherText):
    """(factor, pin) for phase 3, from the input ciphertext's modulus and
    scale tag."""
    q0 = c.ring.modulus
    scale = Fraction(c.enc.scale)
    factor = nt.frac_to_float(Fraction(q0) / scale)
    if ctx.double_angle and not ctx.arcsin:    # fold 1/(2π) into S2C
        factor /= 2.0 * math.pi
    pin = scale if ctx.scale_limbs > 1 else None
    return factor, pin


def bootstrap_phase3(ctx: BootstrapContext, ev: CipherText, factor: float,
                     pin) -> CipherText:
    """SlotToCoeff (×q₀/Δ)."""
    sl = ctx.scale_limbs
    lo2, hi2 = rlwe.ct_index(ev, 0), rlwe.ct_index(ev, 1)
    with CE.encode_cache(ctx.plain_cache):
        if ctx.plan is not None:
            # the factored S2C rescales after every level itself
            return slot_to_coeff_factored(ctx.gks, lo2, hi2, ctx.plan, factor=factor,
                                          sl=sl, out_scale=pin)
        out = slot_to_coeff(ctx.gks, lo2, hi2, factor=factor)
    return _rescale_k(out, sl)


def bootstrap_batched(ctx: BootstrapContext, cb: CipherText) -> CipherText:
    """Refresh a batch of exhausted ciphertexts (``rlwe.ct_stack``'ed along a
    leading axis) in one pass: the batch is a leading axis through the whole
    engine, keys shared, and each element equals its own single refresh bit
    for bit. Recover elements with ``rlwe.ct_index``."""
    return bootstrap(ctx, cb)
