"""toyfhe_tpu_torch Galois maps, rotations and the special-prime
(ModulusRaised) key switch against the reference.

The Galois tables and automorphisms equal the reference's for several N
and elements; ``rotate`` with a reference Galois key carried across as
numpy is bit-equal to ``toyfhe_tpu.rotate`` under ModulusRaised at windows
0 and 8 and under HybridRaised; the modulus-raised square → relinearize →
rescale is bit-equal at both windows; and the golden ``ckks_modraise``
scenario decodes within the reference's bound.
"""

import json
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu.ops import modmath as ref_mm
from toyfhe_tpu.ops import ntt as ref_ntt
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import rlwe as trlwe
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

N = 32


@pytest.mark.parametrize("n", [16, 64, 512, 4096])
def test_galois_tables_and_maps(n):
    rng = np.random.default_rng(n)
    primes = T.make_rns_ring(n, (30, 28)).primes
    mp, tmp = ref_mm.MontParams.make(primes), T.make_ring(n, primes).mp
    x = np.stack([rng.integers(0, p, (3, n)) for p in primes], axis=-2).astype(np.uint32)
    steps = (1, 4, -3, n // 4)
    assert [T.galois_element_for_steps(n, s) for s in steps] == \
        [F.galois_element_for_steps(n, s) for s in steps]
    for g in [F.galois_element_for_steps(n, s) for s in steps] + [2 * n - 1]:
        src, neg = tntt.galois_perm_tables(n, g)
        rsrc, rneg = ref_ntt.galois_perm_tables(n, g)
        np.testing.assert_array_equal(src, rsrc)
        np.testing.assert_array_equal(neg, rneg)
        np.testing.assert_array_equal(tntt.galois_dual_perm(n, g), ref_ntt.galois_dual_perm(n, g))
        got = tntt.apply_galois(tmp, I.tensor(x, "cpu"), src, neg)
        want = ref_ntt.apply_galois(mp, jnp.asarray(x), rsrc, rneg)
        np.testing.assert_array_equal(I.to_numpy(got), np.asarray(want))


def test_ring_galois_and_zero():
    """ring.apply_galois from either domain, the dual permutation identity
    NTT(σ(x)) = NTT(x)[perm], and zero / zero_like."""
    n = 64
    ring = T.make_rns_ring(n, (30, 29))
    rng = np.random.default_rng(1)
    x = I.tensor(np.stack([rng.integers(0, p, n) for p in ring.primes]), "cpu")
    g = T.galois_element_for_steps(n, 3)
    got = T.ringops.apply_galois(ring, T.RingElt(dual=tntt.ntt(ring.tables, x)), g)
    assert torch.equal(got.primal, T.ringops.apply_galois(ring, T.RingElt(primal=x), g).primal)
    perm = torch.as_tensor(tntt.galois_dual_perm(n, g))
    assert torch.equal(tntt.ntt(ring.tables, got.primal),
                       tntt.ntt(ring.tables, x).index_select(-1, perm))
    assert ring.galois_tables(g) is ring.galois_tables(g)
    z = T.ringops.zero(ring, (2,), device="cpu")
    assert z.primal.shape == (2, 2, n) and not z.primal.any() and z.dual is None
    zl = T.ringops.zero_like(ring, got)
    assert zl.primal.shape == zl.dual.shape == (2, n) and not zl.dual.any()


def carry_galois(params, tparams, gk):
    kr = params.ring_key
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    return I.galois_key(tparams, gk.galois_element, [dual(c.mask) for c in gk.key.key],
                        [dual(c.masked) for c in gk.key.key], device="cpu")


def carry_eval(params, tparams, ek):
    kr = params.ring_key
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    return I.eval_mult_key(tparams, [dual(c.mask) for c in ek.key.key],
                           [dual(c.masked) for c in ek.key.key], device="cpu")


def carry_secret(params, tparams, kp):
    return I.priv_key(tparams, np.asarray(rr.ensure_primal(params.ring_key,
                                                           kp.priv.secret).primal), device="cpu")


def ct_duals(c):
    return np.stack([np.asarray(rr.ensure_dual(c.ring, x).dual) for x in c.cs])


def make_params(pkg, kind):
    if kind == "hybrid":
        ring = pkg.make_rns_ring(N, (28,) * 6 + (30, 30))
        return pkg.HybridRaised(pkg.CKKSParams(ring, 0, 3.2), 3, 2)
    ring = pkg.make_rns_ring(N, (30, 29, 28, 29))
    return pkg.ModulusRaised(pkg.CKKSParams(ring, 8 if kind == "window8" else 0, 3.2))


@pytest.fixture(scope="module", params=["window0", "window8", "hybrid"])
def fx(request):
    kind = request.param
    params, tparams = make_params(F, kind), make_params(T, kind)
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    gk = F.keygen_galois(ks[2], kp.priv, steps=4)
    scale = Fraction(2) ** 26
    vals = np.linspace(0.5, 4.0, N // 2)
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, scale), ks[3])
    tc = I.ciphertext(tparams, tparams.ring_cipher, ct_duals(c), scale, device="cpu")
    return dict(kind=kind, params=params, tparams=tparams, kp=kp, ek=ek, gk=gk, c=c, tc=tc,
                tkp=carry_secret(params, tparams, kp), tek=carry_eval(params, tparams, ek),
                tgk=carry_galois(params, tparams, gk), vals=vals)


def test_rotate_matches_reference(fx):
    out = F.rotate(fx["gk"], fx["c"])
    tout = T.rotate(fx["tgk"], fx["tc"])
    assert tout.ring.primes == out.ring.primes
    np.testing.assert_array_equal(I.ciphertext_to_numpy(tout), ct_duals(out))
    np.testing.assert_allclose(T.decrypt(fx["tkp"], tout).real, np.roll(fx["vals"], 4),
                               atol=1e-3)
    with pytest.raises(TypeError):
        T.rotate(fx["tek"], fx["tc"])


def test_square_relin_rescale_matches_reference(fx):
    """keyswitch / ct_rescale of a square, and of the same after one limb
    drop (the digit count pinned to the key's decomposition ring)."""
    c, tc = fx["c"], fx["tc"]
    for _ in range(2):
        out = F.ct_rescale(F.keyswitch(fx["ek"], F.ct_mul(c, c)))
        tout = T.ct_rescale(T.keyswitch(fx["tek"], T.ct_mul(tc, tc)))
        np.testing.assert_array_equal(I.ciphertext_to_numpy(tout), ct_duals(out))
        np.testing.assert_allclose(T.decrypt(fx["tkp"], tout).real, fx["vals"] ** 2, atol=1e-3)
        c, tc = F.ct_modswitch_drop(c), T.ct_modswitch_drop(tc)


def test_keyswitch_components_of_a_rotation(fx):
    """The 2-component key switch alone (zero_like second channel, the
    dual-domain contract) on the Galois-applied ciphertext."""
    g = F.apply_galois_ct(fx["c"], fx["gk"].galois_element)
    tg = T.apply_galois_ct(fx["tc"], fx["tgk"].galois_element)
    np.testing.assert_array_equal(
        I.ciphertext_to_numpy(tg, "primal"),
        np.stack([np.asarray(rr.ensure_primal(g.ring, x).primal) for x in g.cs]))
    out, tout = F.keyswitch(fx["gk"], g), T.keyswitch(fx["tgk"], tg)
    np.testing.assert_array_equal(I.ciphertext_to_numpy(tout), ct_duals(out))
    if fx["kind"] != "hybrid":
        assert all(x.primal is None for x in tout.cs)      # contracted in the dual


def test_port_made_galois_key():
    """Keys made by the port alone: a ModulusRaised key pair and Galois key
    rotate the slots; steps and element together are refused."""
    tparams = make_params(T, "window0")
    gen = torch.Generator().manual_seed(11)
    kp = T.keygen(tparams, gen)
    gk = T.keygen_galois(gen, kp.priv, steps=3)
    assert gk.galois_element == T.galois_element_for_steps(N, 3)
    assert len(gk.key.key) == tparams.ring_cipher.nlimbs and gk.key.ring is tparams.ring_key
    vals = np.linspace(-1.0, 1.0, N // 2)
    c = T.encrypt(kp, T.make_plaintext(tparams.ring_cipher, vals, Fraction(2) ** 26), gen)
    np.testing.assert_allclose(T.decrypt(kp, T.rotate(gk, c)).real, np.roll(vals, 3), atol=1e-3)
    with pytest.raises(ValueError):
        T.keygen_galois(gen, kp.priv, steps=3, galois_element=gk.galois_element)


def test_make_eval_key_lifts_and_factors():
    """make_eval_key under ModulusRaised: the old key is lifted by ps and the
    gadget factors are taken over the ciphertext tower."""
    n = 16
    ring = T.make_rns_ring(n, (30, 29, 28))
    tparams = T.ModulusRaised(T.CKKSParams(ring, 0, 3.2))
    assert trlwe._is_modraised(tparams) and not trlwe._is_modraised(tparams.params)
    gen = torch.Generator().manual_seed(2)
    kp = T.keygen(tparams, gen)
    ek = T.make_eval_key(gen, kp.priv.secret, kp.priv)
    assert len(ek.key) == 2 and ek.ring is ring
    # masked + mask·s = ps·g_i·s − e: the ps·g_i·s term, recovered up to noise
    s = kp.priv.secret
    factors = trlwe.gadget_factors(tparams.ring_cipher, 0)
    for g, comp in zip(factors, ek.key):
        got = T.ringops.add(ring, comp.masked, T.ringops.mul(ring, comp.mask, s))
        want = T.ringops.scalar_mul(ring, tparams.special_prime * g % ring.modulus, s)
        diff = T.ringops.ensure_primal(ring, T.ringops.sub(ring, got, want)).primal
        lifted = torch.where(diff > ring.mp.on("cpu").half, diff - ring.mp.on("cpu").p, diff)
        assert int(lifted.abs().max()) < 40


def test_golden_ckks_modraise():
    """The reference's golden ``ckks_modraise`` scenario: a ModulusRaised
    key switch round trip at N = 32, bit-equal to the reference's key switch
    on carried keys and within its 2e-8 bound of the golden decode."""
    path = os.path.join(os.path.dirname(__file__), "golden", "reference_vectors.json")
    with open(path) as f:
        g = json.load(f)["scenarios"]["ckks_modraise"]
    n = g["params"]["n"]
    want = np.array([complex(r, i) for r, i in g["checks"]["roundtrip"]])
    ring, tring = F.make_rns_ring(n, (30, 29, 29)), T.make_rns_ring(n, (30, 29, 29))
    params = F.ModulusRaised(F.CKKSParams(ring, 0, 3.2))
    tparams = T.ModulusRaised(T.CKKSParams(tring, 0, 3.2))
    scale = Fraction(2) ** 40
    vals = np.arange(1, n // 2 + 1, dtype=np.float64)
    ks = jax.random.split(jax.random.PRNGKey(9), 3)
    kp = F.keygen(params, ks[0])
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, scale), ks[1])
    ek = F.make_eval_key(ks[2], kp.priv.secret, kp.priv)
    out = F.keyswitch(ek, c)
    tkp = carry_secret(params, tparams, kp)
    tek = carry_eval(params, tparams, F.EvalMultKey(ek))
    tc = I.ciphertext(tparams, tparams.ring_cipher, ct_duals(c), scale, device="cpu")
    tout = T.keyswitch(tek, tc)
    np.testing.assert_array_equal(I.ciphertext_to_numpy(tout), ct_duals(out))
    assert np.max(np.abs(T.decrypt(tkp, tout) - want)) < 2e-8
    # the port's own key for the same switch decodes within the same bound
    gen = torch.Generator().manual_seed(9)
    own = T.EvalMultKey(T.make_eval_key(gen, tkp.secret, tkp))
    assert np.max(np.abs(T.decrypt(tkp, T.keyswitch(own, tc)) - want)) < 2e-8
