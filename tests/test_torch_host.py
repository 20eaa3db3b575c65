"""toyfhe_tpu_torch host constants equal the reference's exactly: prime
walks, primitive roots, Montgomery parameters and NTT tables."""

import numpy as np
import pytest
import torch

from toyfhe_tpu.ops import modmath as ref_mm
from toyfhe_tpu.ops import ntt as ref_ntt
from toyfhe_tpu.utils import numtheory as ref_nt
from toyfhe_tpu_torch.ops import modmath as mm
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

TOWERS = [(30, 29, 29, 28), (28,) * 3, (30, 28), (29,)]
NS = [1 << k for k in range(4, 14)]


@pytest.mark.parametrize("n", NS)
def test_prime_walk_and_roots(n):
    for tower in TOWERS:
        primes = nt.ntt_prime_chain(n, tower)
        assert primes == ref_nt.ntt_prime_chain(n, tower)
        assert all(p % (2 * n) == 1 and nt.is_prime(p) for p in primes)
    p = primes[0]
    assert (nt.minimal_primitive_root_of_unity(p, 2 * n)
            == ref_nt.minimal_primitive_root_of_unity(p, 2 * n))


def test_numtheory_scalars():
    for x in (0, 1, 2, 97, 2 ** 31 - 1, 2 ** 31 + 1, 3 * 5 * 7):
        assert nt.is_prime(x) == ref_nt.is_prime(x)
    assert nt.next_prime(2 ** 28 + 1, 64) == ref_nt.next_prime(2 ** 28 + 1, 64)
    assert nt.primitive_root(65537) == ref_nt.primitive_root(65537)
    for x in (-7, 0, 3, 4, 5, 6, 8):
        assert nt.centered(x, 7) == ref_nt.centered(x, 7)
    assert nt.invmod(3, 7) == ref_nt.invmod(3, 7)
    from fractions import Fraction
    big = Fraction(3 ** 700, 2 ** 1100)
    assert nt.frac_to_float(big) == ref_nt.frac_to_float(big)


@pytest.mark.parametrize("tower", TOWERS)
def test_mont_params_equal(tower):
    primes = nt.ntt_prime_chain(64, tower) + [2 ** 31 - 1, 3]
    got, want = mm.MontParams.make(primes), ref_mm.MontParams.make(primes)
    for f in ("p", "ninv", "r2", "r1", "half"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(
            getattr(got.select([0, 2]), f), getattr(want.select([0, 2]), f))
        dev = getattr(got.on("cpu"), f)
        assert dev.dtype == torch.int64
        np.testing.assert_array_equal(dev.numpy(), getattr(want, f).astype(np.int64))


def test_mont_params_reject_large_prime():
    with pytest.raises(ValueError):
        mm.MontParams.make([2 ** 31 + 11])


@pytest.mark.parametrize("n", NS)
def test_ntt_tables_equal(n):
    tower = TOWERS[NS.index(n) % len(TOWERS)]
    primes = nt.ntt_prime_chain(n, tower)
    got, want = tntt.NttTables(n, primes), ref_ntt.NttTables(n, primes)
    assert got.psis == want.psis
    np.testing.assert_array_equal(got.bitrev, want.bitrev)
    np.testing.assert_array_equal(got.psi_pow, want.psi_pow)
    np.testing.assert_array_equal(got.psi_ipow, want.psi_ipow)
    assert len(got.stage_tw) == len(want.stage_tw) == n.bit_length() - 1
    for a, b in zip(got.stage_tw + got.stage_tw_inv, want.stage_tw + want.stage_tw_inv):
        np.testing.assert_array_equal(a, b)
    d = got.on("cpu")
    np.testing.assert_array_equal(d["psi_pow"].numpy(), want.psi_pow.astype(np.int64))
    assert got.on("cpu") is d                # uploaded once per device
