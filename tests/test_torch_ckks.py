"""toyfhe_tpu_torch RLWE/CKKS engine against the reference.

* the golden ``ckks_device_tower`` scenario: imported secret, ciphertext and
  eval key; square → keyswitch → rescale; raw decrypted integers exact;
* reference keys and ciphertexts carried across with ``interop``: ``ct_mul``,
  ``keyswitch`` (gadget windows 0 and 10, single and batched) and
  ``ct_rescale`` bit-equal;
* the port's own keygen / encrypt / decrypt round trip and square.
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
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import golden as G
from toyfhe_tpu.core import ring as ref_ring
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "reference_vectors.json")


def test_ckks_device_tower_bitexact():
    """Port of test_device_ckks_device_tower_bitexact: every integer of the
    square → RNS keyswitch → rescale chain pinned to the golden record."""
    with open(GOLDEN_PATH) as f:
        g = json.load(f)["scenarios"]["ckks_device_tower"]
    n = g["params"]["n"]
    tower = [int(h, 16) for h in g["params"]["tower"]]
    ring = T.make_ring(n, tower)
    assert T.make_rns_ring(n, [p.bit_length() - 1 for p in tower]).primes == tower
    params = T.CKKSParams(ring, 0, 3.2)

    imp = lambda xs: ring.from_bigint([int(h, 16) for h in xs])
    kp = I.priv_key(params, imp(g["material"]["secret"]), device="cpu")
    c = I.ciphertext(params, ring, [imp(x) for x in g["material"]["ct"]],
                     domain="primal", device="cpu")
    ek = I.eval_mult_key(params, [imp(m) for m in g["material"]["ek_masks"]],
                         [imp(m) for m in g["material"]["ek_maskeds"]],
                         domain="primal", device="cpu")

    out = T.ct_rescale(T.keyswitch(ek, T.ct_mul(c, c)))
    assert out.ring.primes == tower[:-1]
    raw = T.ringops.ensure_primal(out.ring, T.decrypt_raw(kp, out))
    ints = out.ring.to_bigint(raw.primal.numpy())
    assert G.vec_matches(g["checks"]["raw_rescaled"], ints), \
        "decode diverged from golden vector"


def _ref_duals(ring, c):
    return np.stack([np.asarray(ref_ring.ensure_dual(ring, x).dual) for x in c.cs])


@pytest.fixture(scope="module", params=[0, 10], ids=["window0", "window10"])
def carried(request):
    """Reference keys and two ciphertexts (N=64, L=4), exported as numpy and
    imported into the port."""
    window = request.param
    n = 64
    ring = F.make_rns_ring(n, (30, 29, 29, 28))
    params = F.CKKSParams(ring, window, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(11), 4)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    vals = np.linspace(0.1, 1.0, n // 2)
    scale = Fraction(2) ** 40
    cts = [F.encrypt(kp, F.make_plaintext(ring, vals * (i + 1), scale), k)
           for i, k in enumerate(jax.random.split(ks[2], 2))]

    tring = T.make_rns_ring(n, (30, 29, 29, 28))
    assert tring.primes == ring.primes
    tparams = T.CKKSParams(tring, window, 3.2)
    tkp = I.priv_key(tparams, np.asarray(kp.priv.secret.primal), device="cpu")
    dual = lambda x: np.asarray(ref_ring.ensure_dual(ring, x).dual)
    tek = I.eval_mult_key(tparams, [dual(kc.mask) for kc in ek.key.key],
                          [dual(kc.masked) for kc in ek.key.key], device="cpu")
    tcts = [I.ciphertext(tparams, tring, _ref_duals(ring, c), scale, device="cpu") for c in cts]
    return dict(ring=ring, ek=ek, cts=cts, tring=tring, tkp=tkp, tek=tek,
                tcts=tcts, vals=vals, scale=scale, kp=kp)


def test_carried_ct_mul(carried):
    for c, tc in zip(carried["cts"], carried["tcts"]):
        want = _ref_duals(carried["ring"], F.ct_mul(c, c))
        np.testing.assert_array_equal(I.ciphertext_to_numpy(T.ct_mul(tc, tc)), want)


def test_carried_keyswitch_and_rescale(carried):
    ring, ek, tek = carried["ring"], carried["ek"], carried["tek"]
    for c, tc in zip(carried["cts"], carried["tcts"]):
        ks = F.keyswitch(ek, F.ct_mul(c, c))
        tks = T.keyswitch(tek, T.ct_mul(tc, tc))
        np.testing.assert_array_equal(I.ciphertext_to_numpy(tks), _ref_duals(ring, ks))
        rs, trs = F.ct_rescale(ks), T.ct_rescale(tks)
        assert trs.ring.primes == rs.ring.primes and trs.enc == T.CKKSTag(rs.enc.scale)
        want = np.stack([np.asarray(x.primal) for x in rs.cs])
        np.testing.assert_array_equal(I.ciphertext_to_numpy(trs, "primal"), want)


def test_carried_batched_keyswitch(carried):
    """Leading batch axes broadcast through the key switch."""
    ring, ek = carried["ring"], carried["ek"]
    stacked = F.ct_stack([F.ct_mul(c, c) for c in carried["cts"]])
    want = _ref_duals(ring, F.keyswitch(ek, stacked))
    tsq = [T.ct_mul(tc, tc) for tc in carried["tcts"]]
    tstacked = T.CipherText(tsq[0].params,
                            tuple(T.RingElt(dual=torch.stack([t.cs[i].dual for t in tsq]))
                                  for i in range(3)),
                            tsq[0].ring, enc=tsq[0].enc)
    got = I.ciphertext_to_numpy(T.keyswitch(carried["tek"], tstacked))
    np.testing.assert_array_equal(got, want)


def test_carried_decrypt(carried):
    """The port decrypts the reference's ciphertexts to the reference's raw
    integers, and decodes them to the encrypted values (fresh noise ≈ 2^6
    at scale 2^40: 1e-6 leaves wide margin)."""
    ring, kp = carried["ring"], carried["kp"]
    for i, (c, tc) in enumerate(zip(carried["cts"], carried["tcts"])):
        want = np.asarray(ref_ring.ensure_primal(ring, F.decrypt_raw(kp, c)).primal)
        got = T.ringops.ensure_primal(carried["tring"], T.decrypt_raw(carried["tkp"], tc))
        np.testing.assert_array_equal(I.to_numpy(got.primal), want)
        vals = T.decrypt(carried["tkp"], tc).real
        np.testing.assert_allclose(vals, carried["vals"] * (i + 1), atol=1e-6)


def test_carried_public_key(carried):
    """The port encrypts under the reference's public key; the reference
    decrypts the port's ciphertext (and the port does) to the values,
    within the fresh-noise bound of test_carried_decrypt."""
    ring, kp = carried["ring"], carried["kp"]
    dual = lambda x: np.asarray(ref_ring.ensure_dual(ring, x).dual)
    tparams = carried["tcts"][0].params
    tpub = I.pub_key(tparams, dual(kp.pub.key.mask), dual(kp.pub.key.masked),
                     domain="dual", device="cpu")
    vals = carried["vals"][::-1].copy()
    gen = torch.Generator().manual_seed(12)
    tc = T.encrypt(tpub, T.make_plaintext(carried["tring"], vals, carried["scale"]), gen)
    np.testing.assert_allclose(T.decrypt(carried["tkp"], tc).real, vals, atol=1e-6)
    cs = tuple(F.RingElt(dual=jnp.asarray(d)) for d in I.ciphertext_to_numpy(tc))
    c = F.CipherText(kp.pub.params, cs, ring, enc=F.CKKSTag(carried["scale"]))
    np.testing.assert_allclose(F.decrypt(kp, c).real, vals, atol=1e-6)


@pytest.mark.parametrize("window", [0, 10])
def test_own_keys_round_trip_and_square(window):
    """Port-only keygen → encrypt → decrypt, then square → relinearize →
    rescale → decrypt. Tolerances: a fresh ciphertext at scale 2^40 decodes
    within 1e-6 (noise ≈ 2^6); the square at scale 2^80/q_last ≈ 2^52 within
    2e-4, the bound the reference's step test uses."""
    n = 64
    ring = T.make_rns_ring(n, (30, 29, 29, 28))
    params = T.CKKSParams(ring, window, 3.2)
    gen = torch.Generator().manual_seed(4)
    kp = T.keygen(params, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    vals = np.linspace(-1.0, 1.0, n // 2)
    c = T.encrypt(kp, T.make_plaintext(ring, vals, Fraction(2) ** 40), gen)
    np.testing.assert_allclose(T.decrypt(kp, c).real, vals, atol=1e-6)
    sq = T.ct_rescale(T.keyswitch(ek, T.ct_mul(c, c)))
    assert sq.ring.nlimbs == 3 and sq.enc.scale == Fraction(2) ** 80 / ring.primes[-1]
    np.testing.assert_allclose(T.decrypt(kp, sq).real, vals ** 2, atol=2e-4)
    added = T.ct_add(c, c)
    np.testing.assert_allclose(T.decrypt(kp, added).real, 2 * vals, atol=1e-6)


def test_rescale_dual_matches_rescale():
    n = 32
    ring = T.make_rns_ring(n, (30, 29, 28))
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(0, p, (2, n)) for p in ring.primes], axis=-2)
    a = I.ring_elt(primal=x, device="cpu")
    sub, r = T.ringops.rescale(ring, a)
    sub2, rd = T.ringops.rescale_dual(ring, T.ringops.ensure_dual(ring, a))
    assert sub is sub2 is ring.drop_last()
    assert torch.equal(T.ringops.ensure_dual(sub, r).dual, rd.dual)
    # reference ring.rescale on the same residues
    rring = F.make_rns_ring(n, (30, 29, 28))
    _, want = ref_ring.rescale(rring, F.RingElt(primal=jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(I.to_numpy(r.primal), np.asarray(want.primal))
