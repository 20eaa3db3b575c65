"""toyfhe_tpu_torch hoisted rotations against the reference.

The cases of tests/test_hybrid_gadget.py's hoisting tests on shared tensors:
with the reference's Galois key set and ciphertext carried across as numpy,
``rotate_many`` and ``rotate_sum`` are bit-equal to the reference's under
the hybrid, the ModulusRaised window-0 and the plain centered-RNS gadgets
(the fast path, pinned) and under unsigned windowed digits (the fallback),
and decode to the rotated slots; the scale-mismatch guard raises; key sets
made by the port alone rotate the slots.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import ring as rr
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import rlwe as trlwe
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

N = 32
H = N // 2
SCALE = Fraction(2) ** 26
STEPS = [1, 2, 5]
KINDS = ["hybrid", "modraise", "plain-rns", "window8"]
FAST = ["hybrid", "modraise", "plain-rns"]


def make_params(pkg, kind):
    if kind == "hybrid":
        ring = pkg.make_rns_ring(N, (28,) * 8 + (30,) * 2)
        return pkg.HybridRaised(pkg.CKKSParams(ring, 0, 3.2), 4, 2)
    ring = pkg.make_rns_ring(N, (28,) * 6 + (30,))
    if kind == "plain-rns":
        return pkg.CKKSParams(ring, 0, 3.2)
    return pkg.ModulusRaised(pkg.CKKSParams(ring, 8 if kind == "window8" else 0, 3.2))


def ct_duals(c):
    return np.stack([np.asarray(rr.ensure_dual(c.ring, x).dual) for x in c.cs])


def carry_keys(params, tparams, gks):
    kr = params.ring_key
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    return I.galois_keys(tparams, [k.galois_element for k in gks.keys],
                         [[dual(c.mask) for c in k.key.key] for k in gks.keys],
                         [[dual(c.masked) for c in k.key.key] for k in gks.keys], device="cpu")


@pytest.fixture(scope="module", params=KINDS)
def fx(request):
    kind = request.param
    params, tparams = make_params(F, kind), make_params(T, kind)
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    kp = F.keygen(params, ks[0])
    rng = np.random.default_rng(7)
    vals = (rng.uniform(-1, 1, H) + 1j * rng.uniform(-1, 1, H)) * 0.8
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, SCALE), ks[3])
    gks = F.keygen_galois_set(jax.random.PRNGKey(11), kp.priv, STEPS)
    els = [F.galois_element_for_steps(N, s) for s in STEPS]
    tkp = I.priv_key(tparams, np.asarray(rr.ensure_primal(params.ring_key,
                                                          kp.priv.secret).primal), device="cpu")
    return dict(kind=kind, params=params, tparams=tparams, kp=kp, tkp=tkp, c=c, vals=vals,
                tc=I.ciphertext(tparams, tparams.ring_cipher, ct_duals(c), SCALE, device="cpu"),
                gks=gks, tgks=carry_keys(params, tparams, gks), els=els)


def _no_fallback(*a, **k):
    raise AssertionError("hoisted path fell back to rotate()")


def test_key_set_lookup(fx):
    tgks = fx["tgks"]
    assert [k.galois_element for k in tgks.keys] == fx["els"]
    for s, g in zip(STEPS, fx["els"]):
        assert tgks.for_steps(N, s) is tgks.for_element(g)
        assert T.galois_element_for_steps(N, s) == g
    with pytest.raises(KeyError):
        tgks.for_element(2 * N - 1)
    out = T.rotate(tgks, fx["tc"], steps=STEPS[1])
    want = F.rotate(fx["gks"], fx["c"], steps=STEPS[1])
    np.testing.assert_array_equal(I.ciphertext_to_numpy(out), ct_duals(want))


def test_rotate_many_matches_reference(fx, monkeypatch):
    want = F.rotate_many(fx["gks"], fx["c"], fx["els"])
    if fx["kind"] in FAST:
        monkeypatch.setattr(trlwe, "rotate", _no_fallback)
    before = dict(trlwe.hoist_counts)
    got = T.rotate_many(fx["tgks"], fx["tc"], fx["els"])
    monkeypatch.undo()
    fast = fx["kind"] in FAST
    assert trlwe.hoist_counts["decompositions"] - before["decompositions"] == (1 if fast else 0)
    assert trlwe.hoist_counts["key_products"] - before["key_products"] == (3 if fast else 0)
    assert sorted(got) == sorted(want)
    for s, g in zip(STEPS, fx["els"]):
        assert got[g].enc.scale == SCALE and got[g].ring.primes == want[g].ring.primes
        np.testing.assert_array_equal(I.ciphertext_to_numpy(got[g]), ct_duals(want[g]))
        dec = T.decrypt(fx["tkp"], got[g])
        ref = T.decrypt(fx["tkp"], T.rotate(fx["tgks"].for_element(g), fx["tc"]))
        if fx["kind"] == "plain-rns":
            # the plain window-0 gadget's key-switch noise drowns the message:
            # hoisted against per-rotation agreement only
            np.testing.assert_allclose(dec, ref, atol=1e-9)
        else:
            np.testing.assert_allclose(dec, np.roll(fx["vals"], s), atol=2e-4)
            np.testing.assert_allclose(dec, ref, atol=2e-4)


def test_rotate_sum_matches_reference(fx, monkeypatch):
    """Lazy ModDown: one contraction for the identity term plus three
    rotations, bit-equal to the reference and equal to the plaintext sum."""
    c, tc, els = fx["c"], fx["tc"], fx["els"]
    want = F.rotate_sum(fx["gks"], [(None, c)] + [(g, c) for g in els])
    if fx["kind"] in FAST:
        monkeypatch.setattr(trlwe, "rotate", _no_fallback)
    before = dict(trlwe.hoist_counts)
    got = T.rotate_sum(fx["tgks"], [(None, tc)] + [(g, tc) for g in els])
    monkeypatch.undo()
    fast = fx["kind"] in FAST
    assert trlwe.hoist_counts["decompose_calls"] - before["decompose_calls"] == (3 if fast else 0)
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got), ct_duals(want))
    eager = tc
    for g in els:
        eager = T.ct_add(eager, T.rotate(fx["tgks"].for_element(g), tc))
    dec, ref = T.decrypt(fx["tkp"], got), T.decrypt(fx["tkp"], eager)
    if fx["kind"] == "plain-rns":
        np.testing.assert_allclose(dec, ref, atol=1e-9)
    else:
        expect = fx["vals"] + sum(np.roll(fx["vals"], s) for s in STEPS)
        np.testing.assert_allclose(dec, expect, atol=1e-3)
        np.testing.assert_allclose(dec, ref, atol=1e-3)
    if fx["kind"] == "window8":      # the fallback is the eager schedule itself
        np.testing.assert_array_equal(I.ciphertext_to_numpy(got), I.ciphertext_to_numpy(eager))


def test_rotate_sum_term_forms(fx):
    """Identity-only sums, element 1 as identity, None terms skipped, the
    empty list refused."""
    tc, g = fx["tc"], fx["els"][0]
    twice = T.rotate_sum(fx["tgks"], [(None, tc), (1, tc), (g, None)])
    np.testing.assert_array_equal(I.ciphertext_to_numpy(twice),
                                  I.ciphertext_to_numpy(T.ct_add(tc, tc)))
    one = T.rotate_sum(fx["tgks"], [(g, tc)])
    want = F.rotate_sum(fx["gks"], [(g, fx["c"])])
    np.testing.assert_array_equal(I.ciphertext_to_numpy(one), ct_duals(want))
    with pytest.raises(ValueError):
        T.rotate_sum(fx["tgks"], [(g, None)])


def test_rotate_sum_scale_mismatch_guard(fx):
    """The fast path rejects mixed-scale terms just as the fallback's
    ct_add does."""
    tc, g = fx["tc"], fx["els"][0]
    tc2 = T.CipherText(tc.params, tc.cs, tc.ring, enc=T.CKKSTag(SCALE * 2))
    with pytest.raises(ValueError):
        T.rotate_sum(fx["tgks"], [(None, tc), (g, tc2)])
    with pytest.raises(ValueError):
        T.rotate_sum(fx["tgks"], [(g, tc), (g, tc2)])


def test_rotate_sum_rejects_mixed_params():
    tparams, other = make_params(T, "hybrid"), make_params(T, "hybrid")
    gen = torch.Generator().manual_seed(4)
    kp = T.keygen(tparams, gen)
    gks = T.keygen_galois_set(gen, kp.priv, [1])
    g = T.galois_element_for_steps(N, 1)
    c = T.encrypt(kp, T.make_plaintext(tparams.ring_cipher, np.ones(H), SCALE), gen)
    c_other = T.CipherText(other, c.cs, c.ring, enc=c.enc)
    with pytest.raises(T.UsageError):
        T.rotate_sum(gks, [(g, c), (g, c_other)])


def test_hoisted_conjugation():
    """The conjugation element 2N−1 also rides the hoisted path."""
    params, tparams = make_params(F, "hybrid"), make_params(T, "hybrid")
    ks = jax.random.split(jax.random.PRNGKey(2), 4)
    kp = F.keygen(params, ks[0])
    vals = (np.linspace(-1, 1, H) + 1j * np.linspace(0.5, -0.5, H)) * 0.8
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, SCALE), ks[1])
    g = 2 * N - 1
    gks = F.GaloisKeys([F.keygen_galois(ks[2], kp.priv, galois_element=g)])
    tgks = carry_keys(params, tparams, gks)
    tc = I.ciphertext(tparams, tparams.ring_cipher, ct_duals(c), SCALE, device="cpu")
    got = T.rotate_many(tgks, tc, [g])[g]
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got),
                                  ct_duals(F.rotate_many(gks, c, [g])[g]))
    tkp = I.priv_key(tparams, np.asarray(rr.ensure_primal(params.ring_key,
                                                          kp.priv.secret).primal), device="cpu")
    np.testing.assert_allclose(T.decrypt(tkp, got), np.conj(vals), atol=2e-4)


@pytest.mark.parametrize("kind", ["hybrid", "modraise"])
def test_port_made_key_set_and_batched_ciphertext(kind):
    """Keys of the port's own; a batched ciphertext (components [2, L, N])
    hoists like its two ciphertexts one by one."""
    tparams = make_params(T, kind)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(tparams, gen)
    gks = T.keygen_galois_set(gen, kp.priv, STEPS)
    els = [T.galois_element_for_steps(N, s) for s in STEPS]
    ring = tparams.ring_cipher
    vals = [np.linspace(-1.0, 1.0, H), np.linspace(0.2, 0.9, H) ** 2]
    cts = [T.encrypt(kp, T.make_plaintext(ring, v, SCALE), gen) for v in vals]
    single = [T.rotate_many(gks, c, els) for c in cts]
    for v, out in zip(vals, single):
        for s, g in zip(STEPS, els):
            np.testing.assert_allclose(T.decrypt(kp, out[g]).real, np.roll(v, s), atol=2e-4)
    stacked = T.CipherText(tparams, tuple(
        T.RingElt(dual=torch.stack([T.ringops.ensure_dual(ring, c.cs[j]).dual for c in cts]))
        for j in range(2)), ring, enc=cts[0].enc)
    before = dict(trlwe.hoist_counts)
    both = T.rotate_many(gks, stacked, els)
    assert trlwe.hoist_counts["decompositions"] - before["decompositions"] == 2
    assert trlwe.hoist_counts["decompose_calls"] - before["decompose_calls"] == 1
    assert trlwe.hoist_counts["key_products"] - before["key_products"] == 6
    assert trlwe.hoist_counts["key_product_calls"] - before["key_product_calls"] == 3
    for g in els:
        for i in range(2):
            for j in range(2):
                assert torch.equal(T.ringops.ensure_dual(ring, both[g].cs[j]).dual[i],
                                   T.ringops.ensure_dual(ring, single[i][g].cs[j]).dual)


def test_dual_perm_on_device_is_cached():
    g = T.galois_element_for_steps(64, 3)
    perm = tntt.galois_dual_perm_dev(64, g, "cpu")
    assert perm is tntt.galois_dual_perm_dev(64, g, torch.device("cpu"))
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), tntt.galois_dual_perm(64, g))


@pytest.mark.parametrize("at", [None, Fraction(2) ** 20])
def test_mul_plain_vector_matches_reference(fx, at):
    vec = np.linspace(-0.7, 0.9, H)
    if at is None:
        want, got = F.mul_plain_vector(fx["c"], vec), T.mul_plain_vector(fx["tc"], vec)
    else:
        from toyfhe_tpu.core.ckks_encoding import mul_plain_vector_at
        want = mul_plain_vector_at(fx["c"], vec, at)
        got = T.mul_plain_vector_at(fx["tc"], vec, at)
    assert got.enc.scale == want.enc.scale == SCALE * (SCALE if at is None else at)
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got), ct_duals(want))
    untagged = T.CipherText(fx["tc"].params, fx["tc"].cs, fx["tc"].ring)
    with pytest.raises(ValueError):
        T.mul_plain_vector(untagged, vec)
