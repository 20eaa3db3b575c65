"""toyfhe_tpu_torch leveled BGV against the reference, on the CPU.

* ``ring.rescale_adapted`` bit-equal for t ∈ {2, 257, 65537, 2^20 − 3};
* shared tensors (the reference's keys carried across, the same u, e₁, e₂):
  square → key switch → ``ct_rescale`` twice under ``ModulusRaised`` and
  under ``HybridRaised``, bit-equal at every step, with equal decodes, equal
  ``BGVTag`` factors and equal ``bgv_noise_budget`` readings;
* ``BGVTag``'s guards, ``InsecureDebug`` and the limb drop.

The levels on the card against the CPU are a ``cuda`` test of
``test_torch_exact_golden.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import ring as ref_ring
from toyfhe_tpu_torch.core import rlwe as trlwe
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

from .test_torch_bfv import (assert_same_ct, carry_keys, noise_vectors, ref_encrypt,
                             ref_exact_meters)

torch.set_num_threads(1)

N = 64
TOWER = (28,) * 4 + (30, 30)
P = 257


@pytest.mark.parametrize("t", [2, 257, 65537, (1 << 20) - 3])
def test_rescale_adapted(t):
    rring, tring = F.make_rns_ring(N, TOWER), T.make_rns_ring(N, TOWER)
    rng = np.random.default_rng(t)
    x = np.stack([rng.integers(0, p, (2, N)) for p in tring.primes], axis=-2)
    rsub, want = ref_ring.rescale_adapted(rring, F.RingElt(primal=jnp.asarray(x, jnp.uint32)), t)
    tsub, got = T.ringops.rescale_adapted(tring, T.RingElt(primal=torch.as_tensor(x)), t)
    assert tsub.primes == list(rsub.primes)
    np.testing.assert_array_equal(got.primal.numpy(), np.asarray(want.primal).astype(np.int64))
    # the correction is ≡ 0 mod t: a multiple of t before the division stays one after it
    q = tring.modulus
    k = np.array([(int(v) * t) % q for v in rng.integers(0, 1 << 40, N)], dtype=object)
    mult = np.stack([np.array([int(v) % p for v in k]) for p in tring.primes])
    _, out = T.ringops.rescale_adapted(tring, T.RingElt(primal=torch.as_tensor(mult)), t)
    back = tsub.to_bigint(out.primal.numpy())
    assert all(nt.centered(v, tsub.modulus) % t == 0 for v in back)


def test_rescale_adapted_range():
    ring = T.make_rns_ring(N, TOWER)
    x = T.RingElt(primal=torch.zeros(len(TOWER), N, dtype=torch.int64))
    for t in (1, 1 << 20):
        with pytest.raises(ValueError):
            T.ringops.rescale_adapted(ring, x, t)


WRAPS = {"modraised": (F.ModulusRaised, T.ModulusRaised),
         "hybrid": (lambda p: F.HybridRaised(p, 2, 2), lambda p: T.HybridRaised(p, 2, 2))}


@pytest.mark.parametrize("wrap", sorted(WRAPS))
def test_two_levels_shared_tensors(wrap, monkeypatch):
    ref_exact_meters(monkeypatch)
    rwrap, twrap = WRAPS[wrap]
    rparams = rwrap(F.BGVParams(F.make_rns_ring(N, TOWER), P, 3.2))
    tparams = twrap(T.BGVParams(T.make_rns_ring(N, TOWER), P, 3.2))
    ks = jax.random.split(jax.random.PRNGKey(41), 2)
    kp = F.keygen(rparams, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    tkp, tek = carry_keys(rparams, tparams, kp, ek)
    slots = np.random.default_rng(42).integers(0, P, N)
    u, e1, e2 = noise_vectors(N, 43, shift=P)
    c = ref_encrypt(kp, F.slot_encode(rparams.plaintext_space(), slots), u, e1, e2)
    tc = I.encrypt_with_noise(tkp, T.slot_encode(tparams.plaintext_space(), slots, device="cpu"),
                              u, e1, e2, device="cpu")
    assert_same_ct(c, tc)
    want = slots
    budgets = [T.bgv_noise_budget(tkp, tc)]
    for level in range(2):
        sq, tsq = F.ct_mul(c, c), T.ct_mul(tc, tc)
        assert_same_ct(sq, tsq)
        sw, tsw = F.keyswitch(ek, sq), T.keyswitch(tek, tsq)
        assert_same_ct(sw, tsw)
        c, tc = F.ct_rescale(sw), T.ct_rescale(tsw)
        assert_same_ct(c, tc)
        assert tc.enc == T.BGVTag(c.enc.p, c.enc.mult)
        want = want * want % P
        got = T.slot_decode(T.decrypt(tkp, tc), device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, F.slot_decode(F.decrypt(kp, c)))
        budget = T.bgv_noise_budget(tkp, tc)
        assert budget == pytest.approx(F.bgv_noise_budget(kp, c), rel=1e-12)
        budgets.append(budget)
    assert tc.ring.nlimbs == tparams.ring_cipher.nlimbs - 2
    assert all(b > 0 for b in budgets)


def test_bgv_tag_guards():
    a = T.BGVTag(257).rescale_by(12289)
    assert a == T.BGVTag(257, 12289 % 257) and a.drop_limb(None) is a
    assert a.combine_mul(a).mult == a.mult ** 2 % 257
    with pytest.raises(T.UsageError):
        a.combine_add(T.BGVTag(257))
    with pytest.raises(T.UsageError):
        a.combine_mul(T.BGVTag(65537))


def test_bgv_plain_modulus_through_wrappers():
    base = T.BGVParams(T.make_rns_ring(N, TOWER), P, 3.2)
    for params in (base, T.ModulusRaised(base), T.InsecureDebug(T.HybridRaised(base, 2, 2))):
        assert trlwe.bgv_plain_modulus(params) == P
    assert trlwe.bgv_plain_modulus(T.CKKSParams(base.ring_cipher, 0, 3.2)) is None


def test_insecure_debug():
    """Zero noise: a CKKS decrypt carries only the encode rounding, and a BGV
    square decodes with the whole budget left but the product's own bits."""
    from fractions import Fraction

    ring = T.make_rns_ring(32, (30, 29))
    params = T.InsecureDebug(T.CKKSParams(ring, 4, 3.2))
    assert params.scheme_name() == "Insecure CKKS"
    gen = torch.Generator().manual_seed(0)
    kp = T.keygen(params, gen)
    vals = np.linspace(1, 2, 16)
    c = T.encrypt(kp, T.make_plaintext(ring, vals, Fraction(2) ** 40), gen)
    assert np.abs(T.decrypt(kp, c).real - vals).max() < 1e-10

    bgv = T.InsecureDebug(T.BGVParams(T.make_rns_ring(N, TOWER), P, 3.2))
    kp = T.keygen(bgv, gen)
    c = T.encrypt(kp, T.scalar_encode(bgv.plaintext_space(), 7), gen)
    assert T.decrypt(kp, c)[0] == 7 and T.decrypt(kp, T.ct_mul(c, c))[0] == 49
    q = bgv.ring_cipher.modulus
    assert T.bgv_noise_budget(kp, c) == pytest.approx(np.log2(q / 2) - np.log2(7))


def test_limb_drop_keeps_the_message():
    params = T.BGVParams(T.cryptparams.palisade_ring(4096), 256, 3.2)
    gen = torch.Generator().manual_seed(1)
    kp = T.keygen(params, gen)
    c = T.encrypt(kp, T.scalar_encode(params.plaintext_space(), 7), gen)
    assert T.decrypt(kp, c)[0] == 7
    d = T.ct_modswitch_drop(c)
    assert d.ring.nlimbs == 1 and d.enc is None
