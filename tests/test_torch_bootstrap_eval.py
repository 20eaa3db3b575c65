"""The port's polynomial evaluation against the reference, bit for bit.

On a deep 30-bit windowed tower with a sparse secret (the reference's
``deep`` bootstrap shape, N = 32) and the reference's relinearization key
carried across as numpy: the Chebyshev basis, ``eval_chebyshev`` at a low
degree, Horner ``eval_poly`` and both arcsine corrections give the
reference's residues, tower and exact scale tag.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.core import ckks_encoding as RCE
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE

from .test_torch_bootstrap import N, H, carry_eval_key
from .test_torch_ckks_surface import assert_same, carry_ct

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def deep():
    """A deep 30-bit windowed tower with a sparse secret (the reference's
    ``deep`` shape) and its relinearization key."""
    ring = F.make_rns_ring(N, (30,) * 17)
    params = F.CKKSParams(ring, 4, 3.2, secret="sparse", hamming_weight=4)
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    tparams = T.CKKSParams(T.make_rns_ring(N, (30,) * 17), 4, 3.2, secret="sparse",
                           hamming_weight=4)
    rng = np.random.default_rng(11)
    xs = rng.uniform(-0.9, 0.9, H)
    c = F.encrypt(kp, F.make_plaintext(ring, xs + 0j, Fraction(2) ** 30), ks[2])
    return dict(params=params, tparams=tparams, ek=ek, tek=carry_eval_key(params, tparams, ek),
                c=c, tc=carry_ct(tparams, c), kp=kp, xs=xs)


def test_cheb_basis(deep):
    ref = RB.ChebBasis(deep["ek"], deep["c"])
    got = TB.ChebBasis(deep["tek"], deep["tc"])
    for i in (2, 3, 5, 4):
        assert_same(ref.get(i), got.get(i))
    with pytest.raises(ValueError):
        got.get(0)


def test_eval_chebyshev_low_degree(deep):
    coeffs = np.array([0.1, -0.4, 0.25, 0.0, 0.3, -0.05, 0.2])
    ref = RB.eval_chebyshev(deep["ek"], deep["c"], coeffs, 1.5)
    got = TB.eval_chebyshev(deep["tek"], deep["tc"], coeffs, 1.5)
    assert_same(ref, got)
    want = np.polynomial.chebyshev.chebval(deep["xs"] / 1.5, coeffs)
    np.testing.assert_allclose(F.decrypt(deep["kp"], ref).real, want, atol=1e-4)


def test_eval_poly(deep):
    coeffs = [0.0, 1.0, 0.0, -1 / 6, 0.0, 1 / 120]
    assert_same(RB.eval_poly(deep["ek"], deep["c"], coeffs),
                TB.eval_poly(deep["tek"], deep["tc"], coeffs))
    with pytest.raises(ValueError, match="constant"):
        TB.eval_poly(deep["tek"], deep["tc"], [1.0])


def test_arcsine_corrections(deep):
    s = RCE.mul_plain_scalar_at(deep["c"], 0.1, Fraction(2) ** 30)
    ts = TCE.mul_plain_scalar_at(deep["tc"], 0.1, Fraction(2) ** 30)
    s, ts = F.ct_rescale(s), T.ct_rescale(ts)
    assert_same(RB._arcsin_correct(deep["ek"], s), TB._arcsin_correct(deep["tek"], ts))
    assert_same(RB._arcsin_correct_from_sin(deep["ek"], s),
                TB._arcsin_correct_from_sin(deep["tek"], ts))
