"""The rest of the RLWE / CKKS surface against the reference, bit for bit.

On the reference's bootstrap ``setup`` shape (N = 32, a 30-bit and five
26-bit limbs, windowed digits; tests/test_bootstrap.py) the reference
encrypts; its ciphertexts are carried across as numpy, and every function
of ``rlwe`` (``ct_sub``, ``ct_add_ring``, ``modswitch``, ``ct_stack``,
``ct_index``) and of ``ckks_encoding`` (``mul_plain_scalar(_at)``,
``retag``, ``mul_int``, ``ct_drop_to``, ``ct_to``, ``mul_plain_vectors``,
``add_plain``) must give the reference's residues, tower and exact
``Fraction`` scale tag. Plus the port's encode store: the same values, and
no encode on a second pass.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import ckks_encoding as RCE
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu.core import rlwe as RL
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import ckks_encoding as TCE
from toyfhe_tpu_torch.core import rlwe as TL
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

N = 32
H = N // 2
TOWER = (30, 26, 26, 26, 26, 26)


def ct_duals(c):
    return np.stack([np.asarray(rr.ensure_dual(c.ring, x).dual) for x in c.cs])


def carry_ct(tparams, c):
    """A reference ciphertext as the port's, on the same tower."""
    ring = tparams.ring_cipher.select(range(c.ring.nlimbs))
    scale = None if c.enc is None else c.enc.scale
    return I.ciphertext(tparams, ring, ct_duals(c), scale, device="cpu")


def assert_same(ref, got):
    """Same tower, same exact scale tag, same residues."""
    assert got.ring.primes == ref.ring.primes
    assert len(got.cs) == len(ref.cs)
    if ref.enc is None:
        assert got.enc is None
    else:
        assert isinstance(got.enc.scale, Fraction) and got.enc.scale == ref.enc.scale
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got), ct_duals(ref))


@pytest.fixture(scope="module")
def fx():
    ring = F.make_rns_ring(N, TOWER)
    params = F.CKKSParams(ring, 4, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(21), 4)
    kp = F.keygen(params, ks[0])
    rng = np.random.default_rng(7)
    vals = rng.uniform(-1, 1, H) + 1j * rng.uniform(-1, 1, H)
    vals2 = rng.uniform(-1, 1, H) + 1j * rng.uniform(-1, 1, H)
    scale = Fraction(2) ** 26
    c = F.encrypt(kp, F.make_plaintext(ring, vals, scale), ks[1])
    c2 = F.encrypt(kp, F.make_plaintext(ring, vals2, scale), ks[2])
    tring = T.make_rns_ring(N, TOWER)
    tparams = T.CKKSParams(tring, 4, 3.2)
    return dict(params=params, tparams=tparams, c=c, c2=c2,
                tc=carry_ct(tparams, c), tc2=carry_ct(tparams, c2), rng=rng)


def test_ct_sub_and_add_ring(fx):
    c, c2, tc, tc2 = fx["c"], fx["c2"], fx["tc"], fx["tc2"]
    assert_same(RL.ct_sub(c, c2), TL.ct_sub(tc, tc2))
    assert_same(RL.ct_add(c, c2), TL.ct_add(tc, tc2))
    slots = fx["rng"].uniform(-1, 1, H)
    pe = F.ckks_encode(c.ring, slots, c.enc.scale)
    tpe = T.ckks_encode(tc.ring, slots, tc.enc.scale, "cpu")
    np.testing.assert_array_equal(I.to_numpy(tpe.primal), np.asarray(pe.primal))
    assert_same(RL.ct_add_ring(c, pe), TL.ct_add_ring(tc, tpe))
    with pytest.raises(T.UsageError):
        TL.ct_sub(tc, carry_ct(T.CKKSParams(fx["tparams"].ring_cipher, 4, 3.2), c2))


def test_modswitch_is_the_rescale(fx):
    c, tc = fx["c"], fx["tc"]
    assert_same(RL.modswitch(c), TL.modswitch(tc))
    assert_same(F.ct_rescale(c), TL.modswitch(tc))
    with pytest.raises(NotImplementedError):
        TL.modswitch(tc, 97)


def test_ct_stack_and_index(fx):
    c, c2, tc, tc2 = fx["c"], fx["c2"], fx["tc"], fx["tc2"]
    ref = RL.ct_stack([c, c2, c])
    got = TL.ct_stack([tc, tc2, tc])
    assert_same(ref, got)
    for i in range(3):
        assert_same(RL.ct_index(ref, i), TL.ct_index(got, i))
    # a batched stack: the new axis goes inside the batch axis
    nested = TL.ct_stack([got, got])
    assert nested.cs[0].dual.shape == (3, 2, len(TOWER), N)
    assert torch.equal(TL.ct_index(nested, 1).cs[1].dual, got.cs[1].dual)
    with pytest.raises(T.UsageError):
        TL.ct_stack([tc, T.ct_rescale(tc2)])


@pytest.mark.parametrize("x", [0.37, -1.25, 3.0])
def test_mul_plain_scalar(fx, x):
    c, tc = fx["c"], fx["tc"]
    assert_same(RCE.mul_plain_scalar(c, x), TCE.mul_plain_scalar(tc, x))
    at = Fraction(2) ** 20 * 3 / 7
    assert_same(RCE.mul_plain_scalar_at(c, x, at), TCE.mul_plain_scalar_at(tc, x, at))
    with pytest.raises(ValueError):
        TCE.mul_plain_scalar_at(tc, x, 0)


def test_retag_mul_int_drop(fx):
    c, tc = fx["c"], fx["tc"]
    s = Fraction(c.enc.scale) * 5 / 3
    assert_same(RCE.retag(c, s), TCE.retag(tc, s))
    assert_same(RCE.mul_int(c, 2), TCE.mul_int(tc, 2))
    assert_same(RCE.mul_int(c, -7), TCE.mul_int(tc, -7))
    assert_same(RCE.ct_drop_to(c, 3), TCE.ct_drop_to(tc, 3))
    with pytest.raises(ValueError, match="cannot raise"):
        TCE.ct_drop_to(TCE.ct_drop_to(tc, 3), 4)


@pytest.mark.parametrize("nl,ratio", [(4, Fraction(3, 2)), (3, Fraction(1, 5)), (5, 1)])
def test_ct_to(fx, nl, ratio):
    c, tc = fx["c"], fx["tc"]
    c2 = F.ct_rescale(RCE.mul_plain_scalar_at(c, 0.5, Fraction(2) ** 20))
    tc2 = T.ct_rescale(TCE.mul_plain_scalar_at(tc, 0.5, Fraction(2) ** 20))
    target = Fraction(c2.enc.scale) * ratio
    assert_same(RCE.ct_to(c2, nl, target), TCE.ct_to(tc2, nl, target))
    with pytest.raises(ValueError, match="no spare level"):
        TCE.ct_to(tc2, tc2.ring.nlimbs, target * 2)


def test_mul_plain_vectors(fx):
    c, c2, tc, tc2 = fx["c"], fx["c2"], fx["tc"], fx["tc2"]
    vecs = fx["rng"].uniform(-1, 1, (2, H)) + 1j * fx["rng"].uniform(-1, 1, (2, H))
    ref, got = RL.ct_stack([c, c2]), TL.ct_stack([tc, tc2])
    assert_same(RCE.mul_plain_vectors(ref, vecs), TCE.mul_plain_vectors(got, vecs))
    at = Fraction(2) ** 24 / 3
    assert_same(RCE.mul_plain_vectors(ref, vecs, at_scale=at),
                TCE.mul_plain_vectors(got, vecs, at_scale=at))
    assert_same(RCE.mul_plain_vector_at(c, vecs[0], at), TCE.mul_plain_vector_at(tc, vecs[0], at))


@pytest.mark.parametrize("vals", [0.75, -1.0, "vector"])
def test_add_plain(fx, vals):
    c, tc = fx["c"], fx["tc"]
    if vals == "vector":
        vals = fx["rng"].uniform(-1, 1, H)
    assert_same(RCE.add_plain(c, vals), TCE.add_plain(tc, vals))
    low = F.ct_rescale(c)
    assert_same(RCE.add_plain(low, vals), TCE.add_plain(T.ct_rescale(tc), vals))


def test_encode_cache_reuses_encodes(fx, monkeypatch):
    """Inside ``encode_cache`` a keyed encode is made once: the same values
    as without the store, and a second pass calls no encode."""
    c, c2, tc, tc2 = fx["c"], fx["c2"], fx["tc"], fx["tc2"]
    vecs = fx["rng"].uniform(-1, 1, (2, H))
    ref = RCE.add_plain(RCE.mul_plain_vectors(RL.ct_stack([c, c2]), vecs), 0.5)
    store = {}
    calls = []
    real = TCE.ckks_encode
    monkeypatch.setattr(TCE, "ckks_encode", lambda *a: calls.append(1) or real(*a))
    for _ in range(2):
        with TCE.encode_cache(store):
            got = TCE.add_plain(TCE.mul_plain_vectors(TL.ct_stack([tc, tc2]), vecs,
                                                      key=("w",)), 0.5)
        assert_same(ref, got)
    assert len(store) == 2 and len(calls) == 3     # two vectors and one constant, once
    got = TCE.add_plain(TCE.mul_plain_vectors(TL.ct_stack([tc, tc2]), vecs, key=("w",)), 0.5)
    assert_same(ref, got)
    assert len(calls) == 6                         # no store: encoded again
