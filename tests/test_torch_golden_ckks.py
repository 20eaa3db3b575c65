"""The four golden CKKS scenarios not yet held on the port: ``ckks_triv``,
``ckks_modswitch``, ``ckks_rotate`` and ``ckks_matmul``
(tests/golden/reference_vectors.json), with the tolerances of the
reference's own device tests (tests/test_reference_vectors.py): the golden
run's reference-asserted bound plus the device suite's bound at its
re-planned tower. The keys come from the port's own generator.
"""

import json
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "reference_vectors.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)["scenarios"]


def _want(rec):
    return np.array([complex(r, i) for r, i in rec])


def test_port_ckks_triv(golden):
    g = golden["ckks_triv"]
    n = g["params"]["n"]
    ring = T.make_rns_ring(n, (30, 29, 29))
    params = T.CKKSParams(ring, 4, 3.2)
    gen = torch.Generator().manual_seed(4)
    kp = T.keygen(params, gen)
    vals = np.linspace(0.0, 1.0, n // 2)
    c = T.encrypt(kp, T.make_plaintext(ring, vals, Fraction(2) ** 40), gen)
    got = T.decrypt(kp, T.ct_mul(c, c))
    # golden ≤ 1e-4 from the truth + device ≤ 1e-4
    assert np.max(np.abs(got - _want(g["checks"]["dec_sq"]))) < 2e-4


def test_port_ckks_modswitch(golden):
    g = golden["ckks_modswitch"]
    n = g["params"]["n"]
    ring = T.make_rns_ring(n, (30, 29, 29))
    params = T.CKKSParams(ring, 4, 3.2)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(params, gen)
    c = T.encrypt(kp, T.make_plaintext(ring, np.full(n // 2, 2.0), Fraction(2) ** 55), gen)
    want = _want(g["checks"]["enc_modswitch"])
    # golden ≤ 1e-3 + device ≤ 1e-3, through the rescale and through the
    # generic modswitch (the rescale with no target)
    assert np.max(np.abs(T.decrypt(kp, T.ct_rescale(c)) - want)) < 2e-3
    assert np.max(np.abs(T.decrypt(kp, T.modswitch(c)) - want)) < 2e-3
    with pytest.raises(NotImplementedError):
        T.modswitch(c, 12289)


def test_port_ckks_rotate(golden):
    g = golden["ckks_rotate"]
    n = g["params"]["n"]
    ring = T.make_rns_ring(n, (30, 29))
    scale = Fraction(2) ** 40
    vals = np.arange(1, n // 2 + 1, dtype=np.complex128)
    vals[0] += 1j
    re = T.ckks_encode(ring, vals, scale, "cpu")
    got = T.ckks_decode(ring, T.ringops.apply_galois(ring, re, 3), scale)
    assert np.max(np.abs(got - _want(g["checks"]["plain_galois3"]))) < 1e-5

    params = T.CKKSParams(ring, 4, 3.2)
    gen = torch.Generator().manual_seed(6)
    kp = T.keygen(params, gen)
    c = T.encrypt(kp, T.CKKSPlaintext(ring, vals, scale), gen)
    gk = T.keygen_galois(gen, kp.priv, steps=1)
    got = T.decrypt(kp, T.rotate(gk, c))
    # golden ≤ 1e-3 + device ≤ 1e-4
    assert np.max(np.abs(got - _want(g["checks"]["enc_rotate_step1"]))) < 2e-3


def test_port_ckks_matmul(golden):
    g = golden["ckks_matmul"]
    n = g["params"]["n"]
    ring = T.make_rns_ring(n, (30, 29, 29))
    params = T.CKKSParams(ring, 4, 3.2)
    gen = torch.Generator().manual_seed(7)
    kp = T.keygen(params, gen)
    vals = np.arange(1, n // 2 + 1, dtype=np.float64)
    c = T.encrypt(kp, T.make_plaintext(ring, vals, Fraction(2) ** 40), gen)
    gk = T.keygen_galois(gen, kp.priv, steps=4)
    W = np.ones((4, 4), dtype=np.float64)
    nrep = n // 2 // 4
    result = T.mul_plain_vector(c, np.tile(np.diag(W), nrep))
    rotated = c
    for k in range(1, 4):
        rotated = T.rotate(gk, rotated)
        result = T.ct_add(result, T.mul_plain_vector(
            rotated, np.tile(np.diag(np.roll(W, k, axis=1)), nrep)))
    got = T.decrypt(kp, result)
    # golden ≤ 1e-5 + device ≤ 1e-5
    assert np.max(np.abs(got - _want(g["checks"]["matmul"]))) < 2e-5
