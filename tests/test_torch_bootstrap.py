"""The port's bootstrapping functions against the reference, bit for bit.

On the reference's bootstrap ``setup`` shape (N = 32, a 30-bit and five
26-bit limbs, windowed digits) with the reference's keys carried across as
numpy (torch cannot replay ``jax.random``): conjugation, rotations by steps
(one at a time and hoisted), the dense BSGS linear transform, CoeffToSlot /
SlotToCoeff dense and factored (radix 4 and 16, with and without a pinned
scale), ``mod_raise`` in its three branches (one limb, the float32 FBC lift
at two to four limbs — with estimates v next to a half-integer — and the
host CRT lift), and on a deeper 30-bit tower the Chebyshev basis,
``eval_chebyshev`` at a low degree, Horner ``eval_poly`` and both arcsine
corrections (test_torch_bootstrap_eval.py). Every output has the
reference's residues, tower and exact scale tag. The whole refresh is held
in test_torch_bootstrap_parity.py.
"""

import math
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.core import ckks_encoding as RCE
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu.core import sfft as RS
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE
from toyfhe_tpu_torch.core import sfft as TS
from toyfhe_tpu_torch.utils import interop as I

from .test_torch_ckks_surface import assert_same, carry_ct

torch.set_num_threads(1)

N = 32
H = N // 2
TOWER = (30, 26, 26, 26, 26, 26)


def key_stacks(key_ring, ksk):
    """A reference key-switching key's (masks, maskeds) duals as numpy."""
    dual = lambda x: np.asarray(rr.ensure_dual(key_ring, x).dual)
    return [dual(c.mask) for c in ksk.key], [dual(c.masked) for c in ksk.key]


def carry_galois_keys(params, tparams, keys):
    st = [key_stacks(params.ring_key, k.key) for k in keys]
    return I.galois_keys(tparams, [k.galois_element for k in keys],
                         [m for m, _ in st], [md for _, md in st], device="cpu")


def carry_eval_key(params, tparams, ek):
    return I.eval_mult_key(tparams, *key_stacks(params.ring_key, ek.key), device="cpu")


def carry_context(params, tparams, ctx, device="cpu"):
    """A reference ``BootstrapContext`` as the port's, through
    ``interop.bootstrap_context``."""
    kr = params.ring_key
    gst = [key_stacks(kr, k.key) for k in ctx.gks.keys]
    plan = None if ctx.plan is None else (ctx.plan.n, ctx.plan.radix)
    return I.bootstrap_context(
        tparams, *key_stacks(kr, ctx.ek.key), [k.galois_element for k in ctx.gks.keys],
        [m for m, _ in gst], [md for _, md in gst], ctx.gk_conj.galois_element,
        *key_stacks(kr, ctx.gk_conj.key), K=ctx.K, deg=ctx.deg, plan=plan, arcsin=ctx.arcsin,
        double_angle=ctx.double_angle, scale_limbs=ctx.scale_limbs,
        base_scale=ctx.base_scale, device=device)


@pytest.fixture(scope="module")
def fx():
    ring = F.make_rns_ring(N, TOWER)
    params = F.CKKSParams(ring, 4, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(21), 5)
    kp = F.keygen(params, ks[0])
    bs, gs = RB.bsgs_split(H)
    gks, gk_conj = RB.keygen_bootstrap_keys(ks[2], kp.priv, bs, gs)
    # the radix-4 plan also rotates by 14
    gks = F.GaloisKeys(gks.keys + [F.keygen_galois(ks[4], kp.priv, steps=-14)])
    rng = np.random.default_rng(7)
    vals = rng.uniform(-1, 1, H) + 1j * rng.uniform(-1, 1, H)
    c = F.encrypt(kp, F.make_plaintext(ring, vals, Fraction(2) ** 26), ks[3])
    tparams = T.CKKSParams(T.make_rns_ring(N, TOWER), 4, 3.2)
    return dict(params=params, tparams=tparams, gks=gks, gk_conj=gk_conj, c=c,
                tgks=carry_galois_keys(params, tparams, gks.keys),
                tconj=carry_galois_keys(params, tparams, [gk_conj]).keys[0],
                tc=carry_ct(tparams, c), rng=rng)


def test_conjugate_and_rotate_steps(fx):
    c, tc = fx["c"], fx["tc"]
    assert_same(RB.conjugate(fx["gk_conj"], c), TB.conjugate(fx["tconj"], tc))
    for k in (1, 3, 12, 16, -4):
        assert_same(RB.rotate_steps(fx["gks"], c, k), TB.rotate_steps(fx["tgks"], tc, k))
    ref = RB.rotate_steps_many(fx["gks"], c, [0, 1, 2, 3, 20])
    got = TB.rotate_steps_many(fx["tgks"], tc, [0, 1, 2, 3, 20])
    assert sorted(got) == sorted(ref) == [0, 1, 2, 3, 4]
    for k in ref:
        assert_same(ref[k], got[k])


def test_linear_transform(fx):
    rng = fx["rng"]
    M = rng.uniform(-1, 1, (H, H)) + 1j * rng.uniform(-1, 1, (H, H))
    M[:, :] *= np.abs(np.arange(H)[:, None] - np.arange(H)[None, :]) % 5 != 2  # zero diagonals
    assert_same(RB.linear_transform(fx["gks"], fx["c"], M),
                TB.linear_transform(fx["tgks"], fx["tc"], M))


def test_coeff_to_slot_and_back(fx):
    lo, hi = RB.coeff_to_slot(fx["gks"], fx["gk_conj"], fx["c"])
    tlo, thi = TB.coeff_to_slot(fx["tgks"], fx["tconj"], fx["tc"])
    assert_same(lo, tlo)
    assert_same(hi, thi)
    lo, hi = F.ct_rescale(lo), F.ct_rescale(hi)
    tlo, thi = T.ct_rescale(tlo), T.ct_rescale(thi)
    assert_same(RB.slot_to_coeff(fx["gks"], lo, hi, factor=0.5),
                TB.slot_to_coeff(fx["tgks"], tlo, thi, factor=0.5))


@pytest.mark.parametrize("radix,pin", [(16, False), (4, False), (4, True)])
def test_factored_transforms(fx, radix, pin):
    rplan, tplan = RS.SfftPlan(N, radix), TS.SfftPlan(N, radix)
    c, tc = fx["c"], fx["tc"]
    out = Fraction(2) ** 25 if pin else None
    lo, hi = RB.coeff_to_slot_factored(fx["gks"], fx["gk_conj"], c, rplan, out_scale=out)
    tlo, thi = TB.coeff_to_slot_factored(fx["tgks"], fx["tconj"], tc, tplan, out_scale=out)
    assert_same(lo, tlo)
    assert_same(hi, thi)
    ref = RB.slot_to_coeff_factored(fx["gks"], lo, hi, rplan, factor=1.5, out_scale=out)
    got = TB.slot_to_coeff_factored(fx["tgks"], tlo, thi, tplan, factor=1.5, out_scale=out)
    assert_same(ref, got)


def _raise_case(params, tparams, limbs, residues):
    """The same ciphertext in both packages at ``limbs`` limbs from primal
    residues [2, limbs, N], scale 2^20."""
    ring = params.ring_cipher.select(range(limbs))
    ref = F.CipherText(params, tuple(F.RingElt(primal=jax.numpy.asarray(r.astype(np.uint32)))
                                     for r in residues), ring,
                       enc=F.CKKSTag(Fraction(2) ** 20))
    got = I.ciphertext(tparams, tparams.ring_cipher.select(range(limbs)), residues,
                       Fraction(2) ** 20, domain="primal", device="cpu")
    return ref, got


def _near_half(primes, count, rng):
    """Residues x whose float32 CRT estimate Σ yᵢ/qᵢ (yᵢ = xᵢ·q̂ᵢ⁻¹) lies
    within about 1e-7 of k + 1/2, where float32 rounding decides v."""
    q0 = math.prod(primes)
    qhat = [q0 // p for p in primes]
    ys = [rng.integers(0, p, count) for p in primes[1:]]
    frac = sum(y / p for y, p in zip(ys, primes[1:])) % 1.0
    y0 = np.round(((0.5 - frac) % 1.0) * primes[0]).astype(np.int64) % primes[0]
    y = [y0] + ys
    exact = [sum(Fraction(int(yi[j]), p) for yi, p in zip(y, primes)) % 1 for j in range(count)]
    assert max(abs(float(e) - 0.5) for e in exact) < 1e-6
    return np.stack([(yi * (h % p)) % p for yi, h, p in zip(y, qhat, primes)])


@pytest.mark.parametrize("limbs", [1, 2, 3, 4, 5])
def test_mod_raise(fx, limbs):
    """One limb: the centered lift; 2–4: the float32 FBC lift, half of the
    coefficients made to sit next to a half-integer estimate; 5: the exact
    host CRT lift."""
    params, tparams, rng = fx["params"], fx["tparams"], fx["rng"]
    primes = params.ring_cipher.primes[:limbs]
    comps = []
    for _ in range(2):
        x = np.stack([rng.integers(0, p, N) for p in primes])
        if 2 <= limbs <= 4:
            x[:, ::2] = _near_half(primes, H, rng)
        comps.append(x)
    ref, got = _raise_case(params, tparams, limbs, np.stack(comps))
    assert_same(RB.mod_raise(ref), TB.mod_raise(got))
    if limbs == 2:       # leading batch axes run through
        both = TB.mod_raise(T.ct_stack([got, got]))
        assert_same(RB.mod_raise(ref), T.ct_index(both, 1))
    top = np.stack([rng.integers(0, p, N) for p in params.ring_cipher.primes])
    with pytest.raises(ValueError, match="full tower"):
        TB.mod_raise(_raise_case(params, tparams, len(TOWER), np.stack([top, top]))[1])


def test_cheb_coefficients_equal():
    np.testing.assert_array_equal(TB.sine_cheb_coeffs(5.0, 46), RB.sine_cheb_coeffs(5.0, 46))
    np.testing.assert_array_equal(TB.cos_cheb_coeffs(5.0, 24, 2), RB.cos_cheb_coeffs(5.0, 24, 2))
    ctx = TB.BootstrapContext(ek=None, gks=None, gk_conj=None, K=6.0, deg=30, double_angle=2)
    np.testing.assert_array_equal(ctx.cheb, RB.cos_cheb_coeffs(6.0, 30, 2))
