"""The decodes of toyfhe_tpu_torch on towers its C++ CRT cannot hold.

At N = 16 over (30,)×63 (a modulus of 1890 bits, past the library's fixed
word count) and (30,)×65 (past its 64 primes), ``RingContext.native`` is
``None`` in both packages and each decode takes the exact Python CRT: the
CKKS encode → decode round trip and the BFV and BGV decodes equal the
reference's exactly. ``bgv_noise_budget`` equals the reference's on
(14,)×65, refused for its 65 primes at 910 bits; past 2^1024 both meters
raise ``OverflowError`` on log2(q/2), as the reference does.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T

torch.set_num_threads(1)

N = 16
TOWERS = {"63x30": (30,) * 63, "65x30": (30,) * 65}


@pytest.fixture(scope="module", params=list(TOWERS))
def rings(request):
    bits = TOWERS[request.param]
    rring, tring = F.make_rns_ring(N, bits), T.make_rns_ring(N, bits)
    assert rring.primes == tring.primes
    assert rring.native() is None and tring.native() is None
    return rring, tring


def _residues(primes, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, N, dtype=np.int64) for p in primes])


def _u32(a):
    return F.RingElt(primal=jnp.asarray(a.astype(np.uint32)))


def _t(a):
    return T.RingElt(primal=torch.as_tensor(a))


def test_ckks_round_trip_equals_the_reference(rings):
    rring, tring = rings
    slots = np.linspace(0.1, 0.9, N // 2).astype(complex)
    scale = Fraction(2) ** 40
    rpt = F.ckks_encode(rring, slots, scale)
    tpt = T.ckks_encode(tring, slots, scale, "cpu")
    np.testing.assert_array_equal(tpt.primal.numpy(), np.asarray(rpt.primal).astype(np.int64))
    want = F.ckks_decode(rring, rpt, scale)
    got = T.ckks_decode(tring, tpt, scale)
    assert np.array_equal(got, want)
    assert np.abs(got - slots).max() < 1e-9


@pytest.mark.parametrize("p", [65537, 257])
def test_exact_scheme_decodes_equal_the_reference(rings, p):
    rring, tring = rings
    res = _residues(tring.primes, p)
    for delta in (None, rring.modulus // (3 * p)):
        rb = F.BFVParams(rring, rring, F.PlainRing(N, p), 0, 3.2, delta)
        tb = T.BFVParams(tring, tring, T.PlainRing(N, p), 0, 3.2, delta)
        np.testing.assert_array_equal(tb.decode(_t(res), tring).coeffs,
                                      np.asarray(rb.decode(_u32(res), rring).coeffs))
    rg, tg = F.BGVParams(rring, p, 3.2), T.BGVParams(tring, p, 3.2)
    np.testing.assert_array_equal(tg.decode(_t(res), tring).coeffs,
                                  np.asarray(rg.decode(_u32(res), rring).coeffs))


def _budgets(rring, tring):
    c0, c1 = _residues(tring.primes, 3), _residues(tring.primes, 4)
    s = np.array([[int(v) % q for v in np.random.default_rng(5).integers(-1, 2, N)]
                  for q in tring.primes], dtype=np.int64)
    rparams, tparams = F.BGVParams(rring, 65537, 3.2), T.BGVParams(tring, 65537, 3.2)
    rc = F.CipherText(rparams, (_u32(c0), _u32(c1)), rring)
    tc = T.CipherText(tparams, (_t(c0), _t(c1)), tring)
    return (lambda: F.bgv_noise_budget(F.PrivKey(rparams, _u32(s)), rc),
            lambda: T.bgv_noise_budget(T.PrivKey(tparams, _t(s)), tc))


def test_bgv_noise_budget_equals_the_reference():
    bits = (14,) * 65
    rring, tring = F.make_rns_ring(N, bits), T.make_rns_ring(N, bits)
    assert rring.primes == tring.primes and len(set(tring.primes)) == 65
    assert rring.native() is None and tring.native() is None
    ref, port = _budgets(rring, tring)
    want = ref()
    assert port() == want and want > 0


def test_bgv_noise_budget_past_a_double_raises_like_the_reference(rings):
    ref, port = _budgets(*rings)
    with pytest.raises(OverflowError):
        ref()
    with pytest.raises(OverflowError):
        port()
