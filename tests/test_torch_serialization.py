"""toyfhe_tpu_torch's key and ciphertext files against the reference's.

* round trips in the port (the reference's three tests): a ciphertext and
  the key pair, the relinearization key, a Galois key, and a hybrid
  (dnum-grouped) key at the full Q·P tower — each loads to the same tensors
  on the same ring objects (a rescaled ciphertext's ring is the params'
  shorter tower) and computes as before;
* the file format: the same array names, ``uint32`` residues and header as
  the reference's files for the same objects;
* across packages: files the port writes load in the reference and decrypt
  to the port's values, bit for bit; files the reference writes load in the
  port, equal to the reference's tensors, and decrypt to its values.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.utils import serialization as rser
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.utils import serialization as ser

torch.set_num_threads(1)

N = 32
TOWER = (30, 29, 29)


def same_elt(a, b):
    for domain in ("primal", "dual"):
        x, y = getattr(a, domain), getattr(b, domain)
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(torch.as_tensor(np.asarray(x).astype(np.int64)),
                               torch.as_tensor(np.asarray(y).astype(np.int64)))


def same_ksk(a, b):
    assert len(a.key) == len(b.key)
    for x, y in zip(a.key, b.key):
        same_elt(x.mask, y.mask)
        same_elt(x.masked, y.masked)


@pytest.fixture(scope="module")
def port():
    params = T.CKKSParams(T.make_rns_ring(N, TOWER), 4, 3.2)
    gen = torch.Generator().manual_seed(0)
    kp = T.keygen(params, gen)
    vals = np.arange(1, 17, dtype=np.float64)
    c = T.encrypt(kp, T.make_plaintext(params.ring_cipher, vals, Fraction(2) ** 40), gen)
    return dict(params=params, kp=kp, c=c, vals=vals,
                ek=T.keygen_eval_mult(gen, kp.priv),
                gk=T.keygen_galois(gen, kp.priv, steps=1))


def test_roundtrip(port, tmp_path):
    params, kp, c, vals = port["params"], port["kp"], port["c"], port["vals"]
    ser.save_keypair(str(tmp_path / "kp.npz"), kp)
    ser.save_ciphertext(str(tmp_path / "ct.npz"), c)
    kp2 = ser.load_keypair(str(tmp_path / "kp.npz"), params, device="cpu")
    c2 = ser.load_ciphertext(str(tmp_path / "ct.npz"), params, device="cpu")
    same_elt(kp.priv.secret, kp2.priv.secret)
    same_elt(kp.pub.key.mask, kp2.pub.key.mask)
    for a, b in zip(c.cs, c2.cs):
        same_elt(a, b)
    assert c2.ring is params.ring_cipher and c2.enc == c.enc
    np.testing.assert_allclose(T.decrypt(kp2, c2).real, vals, atol=1e-6)

    ser.save_keyswitch_key(str(tmp_path / "ek.npz"), port["ek"].key)
    ek2 = T.EvalMultKey(ser.load_keyswitch_key(str(tmp_path / "ek.npz"), params, device="cpu"))
    same_ksk(port["ek"].key, ek2.key)
    assert ek2.key.ring is port["ek"].key.ring
    y = T.keyswitch(ek2, T.ct_mul(c, c))
    np.testing.assert_allclose(T.decrypt(kp, y).real, vals ** 2, atol=1e-2)

    # a rescaled ciphertext reloads on the params' own shorter tower
    r = T.ct_rescale(y)
    ser.save_ciphertext(str(tmp_path / "r.npz"), r)
    r2 = ser.load_ciphertext(str(tmp_path / "r.npz"), params, device="cpu")
    assert r2.ring is params.ring_cipher.drop_last() and r2.enc == r.enc
    np.testing.assert_array_equal(T.decrypt(kp, r2), T.decrypt(kp, r))


def test_galois_and_evalmult_key_roundtrip(port, tmp_path):
    params, kp, c, vals = port["params"], port["kp"], port["c"], port["vals"]
    ser.save_galois_key(str(tmp_path / "gk.npz"), port["gk"])
    gk2 = ser.load_galois_key(str(tmp_path / "gk.npz"), params, device="cpu")
    assert gk2.galois_element == port["gk"].galois_element
    same_ksk(port["gk"].key, gk2.key)
    np.testing.assert_allclose(T.decrypt(kp, T.rotate(gk2, c)), np.roll(vals.astype(complex), 1),
                               atol=1e-4)
    ser.save_eval_mult_key(str(tmp_path / "ek.npz"), port["ek"])
    ek2 = ser.load_eval_mult_key(str(tmp_path / "ek.npz"), params, device="cpu")
    y = T.keyswitch(ek2, T.ct_mul(c, c))
    np.testing.assert_allclose(T.decrypt(kp, y).real, vals ** 2, atol=1e-2)


def test_hybrid_key_roundtrip(tmp_path):
    ring = T.make_rns_ring(N, (28,) * 4 + (30, 30))
    params = T.HybridRaised(T.CKKSParams(ring, 0, 3.2), 2, 2)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    assert len(ek.key.key) == 2                      # dnum digits, not L
    ser.save_eval_mult_key(str(tmp_path / "hek.npz"), ek)
    ek2 = ser.load_eval_mult_key(str(tmp_path / "hek.npz"), params, device="cpu")
    assert ek2.key.ring is params.ring_key
    vals = np.linspace(0.2, 1.5, 16)
    c = T.encrypt(kp, T.make_plaintext(params.ring_cipher, vals, Fraction(2) ** 26), gen)
    y = T.ct_rescale(T.keyswitch(ek2, T.ct_mul(c, c)))
    np.testing.assert_array_equal(T.decrypt(kp, y), T.decrypt(kp, T.ct_rescale(
        T.keyswitch(ek, T.ct_mul(c, c)))))
    np.testing.assert_allclose(T.decrypt(kp, y).real, vals ** 2, atol=1e-3)


def test_file_format_is_the_references(port, tmp_path):
    """The port's file and the reference's file for the same key pair and
    ciphertext hold the same array names, dtypes and headers."""
    params, kp, c = port["params"], port["kp"], port["c"]
    ser.save_keypair(str(tmp_path / "kp.npz"), kp)
    ser.save_ciphertext(str(tmp_path / "ct.npz"), c)
    rparams = F.CKKSParams(F.make_rns_ring(N, TOWER), 4, 3.2)
    rkp = rser.load_keypair(str(tmp_path / "kp.npz"), rparams)
    rc = rser.load_ciphertext(str(tmp_path / "ct.npz"), rparams)
    rser.save_keypair(str(tmp_path / "rkp.npz"), rkp)
    rser.save_ciphertext(str(tmp_path / "rct.npz"), rc)
    for mine, theirs in (("kp.npz", "rkp.npz"), ("ct.npz", "rct.npz")):
        with np.load(tmp_path / mine) as a, np.load(tmp_path / theirs) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert all(a[k].dtype == np.uint32 for k in a.files if k != "header")


def test_port_files_load_in_the_reference(port, tmp_path):
    params, kp, c = port["params"], port["kp"], port["c"]
    ser.save_keypair(str(tmp_path / "kp.npz"), kp)
    ser.save_ciphertext(str(tmp_path / "ct.npz"), c)
    ser.save_galois_key(str(tmp_path / "gk.npz"), port["gk"])
    rparams = F.CKKSParams(F.make_rns_ring(N, TOWER), 4, 3.2)
    rkp = rser.load_keypair(str(tmp_path / "kp.npz"), rparams)
    rc = rser.load_ciphertext(str(tmp_path / "ct.npz"), rparams)
    assert rc.enc.scale == c.enc.scale
    np.testing.assert_array_equal(F.decrypt(rkp, rc), T.decrypt(kp, c))
    rgk = rser.load_galois_key(str(tmp_path / "gk.npz"), rparams)
    np.testing.assert_array_equal(F.decrypt(rkp, F.rotate(rgk, rc)),
                                  T.decrypt(kp, T.rotate(port["gk"], c)))


def test_reference_files_load_in_the_port(tmp_path):
    ring = F.make_rns_ring(N, (28,) * 4 + (30, 30))
    rparams = F.HybridRaised(F.CKKSParams(ring, 0, 3.2), 2, 2)
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    rkp = F.keygen(rparams, ks[0])
    rek = F.keygen_eval_mult(ks[1], rkp.priv)
    rgk = F.keygen_galois(ks[2], rkp.priv, steps=2)
    vals = np.linspace(-0.8, 0.9, 16)
    rc = F.encrypt(rkp, F.make_plaintext(rparams.ring_cipher, vals, Fraction(2) ** 26), ks[3])
    rser.save_keypair(str(tmp_path / "kp.npz"), rkp)
    rser.save_ciphertext(str(tmp_path / "ct.npz"), rc)
    rser.save_eval_mult_key(str(tmp_path / "ek.npz"), rek)
    rser.save_galois_key(str(tmp_path / "gk.npz"), rgk)

    params = T.HybridRaised(T.CKKSParams(T.make_rns_ring(N, (28,) * 4 + (30, 30)), 0, 3.2), 2, 2)
    kp = ser.load_keypair(str(tmp_path / "kp.npz"), params, device="cpu")
    c = ser.load_ciphertext(str(tmp_path / "ct.npz"), params, device="cpu")
    ek = ser.load_eval_mult_key(str(tmp_path / "ek.npz"), params, device="cpu")
    gk = ser.load_galois_key(str(tmp_path / "gk.npz"), params, device="cpu")
    same_elt(rkp.priv.secret, kp.priv.secret)
    same_ksk(rek.key, ek.key)
    same_ksk(rgk.key, gk.key)
    assert c.ring is params.ring_cipher and gk.galois_element == rgk.galois_element
    np.testing.assert_array_equal(T.decrypt(kp, c), F.decrypt(rkp, rc))
    sq = T.ct_rescale(T.keyswitch(ek, T.ct_mul(c, c)))
    np.testing.assert_array_equal(T.decrypt(kp, sq),
                                  F.decrypt(rkp, F.ct_rescale(F.keyswitch(rek, F.ct_mul(rc, rc)))))
    np.testing.assert_array_equal(T.decrypt(kp, T.rotate(gk, c)), F.decrypt(rkp, F.rotate(rgk, rc)))


def test_wrong_kind_raises(port, tmp_path):
    ser.save_ciphertext(str(tmp_path / "ct.npz"), port["c"])
    with pytest.raises(ValueError, match="ciphertext"):
        ser.load_keypair(str(tmp_path / "ct.npz"), port["params"], device="cpu")
