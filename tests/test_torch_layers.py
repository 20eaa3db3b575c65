"""toyfhe_tpu_torch compiled encrypted layers against the reference's.

Every layer of ``toyfhe_tpu_torch.parallel.layers`` on the reference's
keys and ciphertexts, carried across as numpy: bit-equal to the same layer
of ``toyfhe_tpu.parallel.layers`` on the ModulusRaised (window 0) and the
HybridRaised fixtures of tests/test_layers.py, at a dropped tower, and the
windowed special-prime key switch at window 8. ``BatchEncryptor`` samples,
so its output is decrypted with the reference's secret instead.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu.parallel import layers as RL
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

N = 32


def carry(params, tparams, kp, ek, gk):
    """The reference's secret, public key, eval key and Galois key as the
    port's (key-ring residues carried as numpy)."""
    kr = params.ring_key
    prim = lambda x: np.asarray(rr.ensure_primal(kr, x).primal)
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    stacks = lambda k: ([dual(c.mask) for c in k.key.key], [dual(c.masked) for c in k.key.key])
    tkp = T.KeyPair(I.priv_key(tparams, prim(kp.priv.secret), device="cpu"),
                    I.pub_key(tparams, prim(kp.pub.key.mask), prim(kp.pub.key.masked), device="cpu"))
    return (tkp, I.eval_mult_key(tparams, *stacks(ek), device="cpu"),
            I.galois_key(tparams, gk.galois_element, *stacks(gk), device="cpu"))


def make_fixture(tower, window=0, hybrid=None, seed=0, scale_log2=28):
    """Keys and one encryption of linspace(0.5, 4) in both packages, as the
    fixtures of tests/test_layers.py make them."""
    ring, tring = F.make_rns_ring(N, tower), T.make_rns_ring(N, tower)
    if hybrid is None:
        params = F.ModulusRaised(F.CKKSParams(ring, window, 3.2))
        tparams = T.ModulusRaised(T.CKKSParams(tring, window, 3.2))
    else:
        params = F.HybridRaised(F.CKKSParams(ring, 0, 3.2), *hybrid)
        tparams = T.HybridRaised(T.CKKSParams(tring, 0, 3.2), *hybrid)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    gk = F.keygen_galois(ks[2], kp.priv, steps=4)
    scale = Fraction(2) ** scale_log2
    vals = np.linspace(0.5, 4.0, N // 2)
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, scale), ks[3])
    tkp, tek, tgk = carry(params, tparams, kp, ek, gk)
    return dict(params=params, tparams=tparams, kp=kp, ek=ek, gk=gk, c=c, tkp=tkp,
                tek=tek, tgk=tgk, vals=vals, scale=scale)


@pytest.fixture(scope="module")
def modraise():
    return make_fixture((30, 29, 28, 29))              # 3 data limbs + special


@pytest.fixture(scope="module")
def hybrid():
    # 6 ct limbs + 2 raising primes; dnum = 3 groups of alpha = 2
    return make_fixture((28,) * 6 + (30, 30), hybrid=(3, 2), scale_log2=26)


FIXTURES = ["modraise", "hybrid"]


def primal(ring, c):
    return [np.asarray(rr.ensure_primal(ring, x).primal) for x in c.cs]


def at_level(fx, limbs):
    c = fx["c"]
    while c.ring.nlimbs > limbs:
        c = F.ct_modswitch_drop(c)
    return c


def tring_of(fx, ring):
    return fx["tparams"].ring_key.select(range(ring.nlimbs))


def diag_duals(ring, d, scale, seed=1):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, d))
    nrep = ring.n // 2 // d
    return np.stack([np.asarray(rr.ensure_dual(ring, F.ckks_encode(
        ring, np.tile(np.diag(np.roll(W, k, axis=1)), nrep).astype(complex), scale)).dual)
        for k in range(d)])


def assert_pair(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(I.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("name, limbs", [("modraise", 3), ("hybrid", 6), ("hybrid", 3)])
def test_rotate_matmul_layer(request, name, limbs):
    fx = request.getfixturevalue(name)
    c = at_level(fx, limbs)
    ring = c.ring
    d = 4
    diag = diag_duals(ring, d, fx["scale"])
    want = RL.RotateMatmulLayer(fx["params"], fx["gk"], fx["gk"].galois_element, d, ring)(
        *[jnp.asarray(x) for x in primal(ring, c)], jnp.asarray(diag))
    layer = TL.RotateMatmulLayer(fx["tparams"], fx["tgk"], fx["tgk"].galois_element, d,
                                 tring_of(fx, ring))
    assert isinstance(layer.ka, TL.HybridKeyArrays) == (name == "hybrid")
    got = layer(*[I.tensor(x, "cpu") for x in primal(ring, c)], I.tensor(diag, "cpu"))
    assert_pair(got, want)


@pytest.mark.parametrize("name, limbs", [("modraise", 3), ("hybrid", 6), ("hybrid", 3)])
def test_square_relin_layer(request, name, limbs):
    fx = request.getfixturevalue(name)
    c = at_level(fx, limbs)
    ring = c.ring
    want = RL.SquareRelinLayer(fx["params"], fx["ek"], ring)(
        *[jnp.asarray(x) for x in primal(ring, c)])
    layer = TL.SquareRelinLayer(fx["tparams"], fx["tek"], tring_of(fx, ring))
    got = layer(*[I.tensor(x, "cpu") for x in primal(ring, c)])
    assert_pair(got, want)
    assert layer.sub_ring.primes == ring.drop_last().primes
    out = T.CipherText(fx["tparams"], tuple(T.RingElt(primal=x) for x in got),
                       layer.sub_ring, enc=T.CKKSTag(fx["scale"] ** 2 / ring.primes[-1]))
    np.testing.assert_allclose(T.decrypt(fx["tkp"], out).real, fx["vals"] ** 2, atol=1e-3)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("dual_out", [False, True])
def test_conv_layer(request, name, dual_out):
    fx = request.getfixturevalue(name)
    ring = fx["c"].ring
    rng = np.random.default_rng(3)
    G, C = 5, 3
    lim = min(ring.primes)
    cts = rng.integers(0, lim, (G, 2, ring.nlimbs, N)).astype(np.uint32)
    w_res = rng.integers(0, lim, (C, G, ring.nlimbs, 1)).astype(np.uint32)
    bias = rng.integers(0, lim, (C, ring.nlimbs, N)).astype(np.uint32)
    want = RL.ConvLayer(fx["params"], ring, C, dual_out=dual_out)(
        jnp.asarray(cts), jnp.asarray(w_res), jnp.asarray(bias))
    got = TL.ConvLayer(fx["tparams"], fx["tparams"].ring_cipher, C, dual_out=dual_out)(
        I.tensor(cts, "cpu"), I.tensor(w_res, "cpu"), I.tensor(bias, "cpu"))
    assert got.shape == (C, 2, ring.nlimbs - 1, N)
    np.testing.assert_array_equal(I.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("dual_out", [False, True])
def test_bias_rescale_layer(request, name, dual_out):
    fx = request.getfixturevalue(name)
    ring = fx["c"].ring
    rng = np.random.default_rng(4)
    c1, c2, bias = (rng.integers(0, min(ring.primes), (ring.nlimbs, N)).astype(np.uint32)
                    for _ in range(3))
    want = RL.BiasRescaleLayer(ring, dual_out=dual_out)(
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(bias))
    got = TL.BiasRescaleLayer(fx["tparams"].ring_cipher, dual_out=dual_out)(
        I.tensor(c1, "cpu"), I.tensor(c2, "cpu"), I.tensor(bias, "cpu"))
    assert_pair(got, want)


@pytest.mark.parametrize("name", FIXTURES)
def test_dual_rescale(request, name):
    fx = request.getfixturevalue(name)
    ring = fx["c"].ring
    rng = np.random.default_rng(5)
    x = rng.integers(0, min(ring.primes), (2, 3, ring.nlimbs, N)).astype(np.uint32)
    want = RL.DualRescale(ring).fn(jnp.asarray(x))
    tring = fx["tparams"].ring_cipher
    got = TL.DualRescale(tring)(I.tensor(x, "cpu"))
    np.testing.assert_array_equal(I.to_numpy(got), np.asarray(want))
    # and it equals the primal rescale between the transforms
    _, prim = T.ringops.rescale(tring, T.RingElt(dual=I.tensor(x, "cpu")))
    assert torch.equal(got, T.ringops.ensure_dual(tring.drop_last(), prim).dual)


@pytest.fixture(scope="module")
def windowed():
    """ModulusRaised with window 8, as tests/test_layers.py's slow windowed
    test builds it."""
    return make_fixture((30, 29, 28, 29), window=8, seed=7)


@pytest.mark.parametrize("drop", [False, True])
def test_modraise_keyswitch_window8(windowed, drop):
    """``_modraise_keyswitch`` at window 8 against the reference's, at the
    full level and after one rescale (digit count pinned to the key's
    decomposition ring), and equal to the engine's rotate."""
    fx = windowed
    c = F.ct_rescale(fx["c"]) if drop else fx["c"]
    ring = c.ring
    g = primal(ring, F.apply_galois_ct(c, fx["gk"].galois_element))
    ka = RL.build_modraise_key_arrays(fx["params"], fx["gk"].key, ring)
    want = RL._modraise_keyswitch(ka, *[jnp.asarray(x) for x in g])
    tka = TL.build_modraise_key_arrays(fx["tparams"], fx["tgk"].key, tring_of(fx, ring))
    assert (tka.window, tka.k_per_limb) == (ka.window, ka.k_per_limb) == (8, 4)
    got = TL._modraise_keyswitch(tka, *[I.tensor(x, "cpu") for x in g])
    assert_pair(got, want)
    seq = F.rotate(fx["gk"], c)
    assert_pair(got, primal(seq.ring, seq))


@pytest.mark.parametrize("name", FIXTURES)
def test_key_arrays_match_reference(request, name):
    fx = request.getfixturevalue(name)
    ring = fx["c"].ring
    ka = RL.build_key_arrays(fx["params"], fx["gk"].key, ring)
    tka = TL.build_key_arrays(fx["tparams"], fx["tgk"].key, fx["tparams"].ring_cipher)
    assert tka.exp_ring.primes == ka.exp_ring.primes
    np.testing.assert_array_equal(I.to_numpy(tka.masks), np.asarray(ka.masks))
    np.testing.assert_array_equal(I.to_numpy(tka.maskeds), np.asarray(ka.maskeds))
    if name == "hybrid":
        np.testing.assert_array_equal(I.to_numpy(tka.P_res), np.asarray(ka.P_res))
        for s, (inv, _) in enumerate(ka.resc):
            np.testing.assert_array_equal(I.to_numpy(getattr(tka, f"resc{s}")), np.asarray(inv))
    else:
        np.testing.assert_array_equal(I.to_numpy(tka.ps_res), np.asarray(ka.ps_res))
        np.testing.assert_array_equal(I.to_numpy(tka.inv_ps_mont), np.asarray(ka.inv_ps_mont))


@pytest.mark.parametrize("name", FIXTURES)
def test_batch_encryptor(request, name):
    """Samples cannot match jax.random's stream: decrypt with the carried
    secret and hold each slot within the reference's CKKS tolerance, and
    check the rounded-Gaussian noise's support and moments."""
    fx = request.getfixturevalue(name)
    tparams = fx["tparams"]
    ring = tparams.ring_cipher
    B = 3
    vals = [np.linspace(-1.0, 1.0, N // 2) * (i + 1) for i in range(B)]
    pts = torch.stack([T.ckks_encode(ring, v.astype(complex), fx["scale"], "cpu").primal
                       for v in vals])
    enc = TL.BatchEncryptor(tparams, fx["tkp"].pub)
    cts = enc(pts, torch.Generator().manual_seed(3))
    assert cts.shape == (B, 2, ring.nlimbs, N) and cts.dtype == torch.int64
    for i in range(B):
        c = T.CipherText(tparams, (T.RingElt(dual=cts[i, 0]), T.RingElt(dual=cts[i, 1])),
                         ring, enc=T.CKKSTag(fx["scale"]))
        np.testing.assert_allclose(T.decrypt(fx["tkp"], c).real, vals[i], atol=1e-3)
    ints = enc.sample(torch.Generator().manual_seed(4), 2000).float()
    assert ints.abs().max() <= 6 * enc.sigma and torch.equal(ints, ints.round())
    assert abs(float(ints.mean())) < 0.03
    assert abs(float(ints.std()) - np.sqrt(enc.sigma ** 2 + 1 / 12)) < 0.02


def test_layers_follow_to():
    """Buffers move with ``Module.to`` and the layer runs where they are."""
    fx = make_fixture((30, 29, 28, 29))
    ring = fx["c"].ring
    layer = TL.SquareRelinLayer(fx["tparams"], fx["tek"], fx["tparams"].ring_cipher)
    names = {n for n, _ in layer.named_buffers()}
    assert {"inv_q_mont", "ka.masks", "ka.maskeds", "ka.ps_res", "ka.inv_ps_mont"} <= names
    assert all(b.device.type == "cpu" for b in layer.buffers())
    assert layer.to("cpu") is layer
    got = layer(*[I.tensor(x, "cpu") for x in primal(ring, fx["c"])])
    assert got[0].shape == (ring.nlimbs - 1, N)
