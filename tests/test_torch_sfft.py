"""toyfhe_tpu_torch.core.sfft against the reference's special-FFT plan.

The port keeps its own copy of the reference's host numpy; every chain
diagonal, rotation step, BSGS grouping and the decode matrix must equal the
reference's array for array (the same float64 operations in the same order),
from the test rings up to the production N = 2^13.
"""

import numpy as np
import pytest

from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.core import sfft as RS
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import sfft as TS

PLANS = [(32, 4), (32, 16), (64, 16), (8192, 16)]


def _same_chains(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert len(ca) == len(cb)
        for la, lb in zip(ca, cb):
            assert sorted(la) == sorted(lb)
            for k in la:
                np.testing.assert_array_equal(np.asarray(la[k]), np.asarray(lb[k]))


@pytest.mark.parametrize("n,radix", PLANS)
def test_plan_chains_equal(n, radix):
    ref, got = RS.SfftPlan(n, radix), TS.SfftPlan(n, radix)
    assert (got.n, got.d, got.radix, got.nlevels) == (ref.n, ref.d, ref.radix, ref.nlevels)
    _same_chains(ref.c2s_chains, got.c2s_chains)
    _same_chains(ref.s2c_chains, got.s2c_chains)
    np.testing.assert_array_equal(got.perm, ref.perm)


@pytest.mark.parametrize("n,radix", PLANS)
def test_rotation_steps_and_bsgs_groups_equal(n, radix):
    ref, got = RS.SfftPlan(n, radix), TS.SfftPlan(n, radix)
    assert got.rotation_steps() == ref.rotation_steps()
    for chains in ("c2s_chains", "s2c_chains"):
        for ca, cb in zip(getattr(ref, chains), getattr(got, chains)):
            for la, lb in zip(ca, cb):
                assert TS.bsgs_split_offsets(lb.keys(), got.d) == \
                    RS.bsgs_split_offsets(la.keys(), ref.d)


@pytest.mark.parametrize("n", [16, 32, 64])
def test_decode_matrix_and_stages_equal(n):
    np.testing.assert_array_equal(TB.decode_matrix(n), RB.decode_matrix(n))
    d = n // 2
    for a, b in zip(TS.sfft_stages(d), RS.sfft_stages(d)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(TS.halfshift_diag(n), RS.halfshift_diag(n))
    np.testing.assert_array_equal(TS.bitrev_perm(d), RS.bitrev_perm(d))


def test_factorization_is_exact():
    """The port's own stages and chains reproduce the decode matrix (the
    reference's test_sfft_factorization, on the port's copy)."""
    for n in (16, 64):
        d = n // 2
        U = TB.decode_matrix(n)
        V, W = U[:, :d], U[:, d:]
        M = np.eye(d, dtype=complex)
        for s in TS.sfft_stages(d):
            M = TS.dense_from_diags(s, d) @ M
        perm = TS.bitrev_perm(d)
        np.testing.assert_allclose(M, V[:, perm], atol=1e-12)
        plan = TS.SfftPlan(n, radix=4)
        rng = np.random.default_rng(0)
        v = rng.normal(size=d) + 1j * rng.normal(size=d)

        def ap(chain, x):
            for lvl in chain:
                x = TS.dense_from_diags(lvl, d) @ x
            return x

        lo_ref = (np.conj(V).T @ v + V.T @ np.conj(v)) / n
        lo_got = ap(plan.c2s_chains[0], v) + ap(plan.c2s_chains[1], np.conj(v))
        np.testing.assert_allclose(lo_got, lo_ref[perm], atol=1e-12)
        lo2, hi2 = rng.normal(size=d), rng.normal(size=d)
        out_got = ap(plan.s2c_chains[0], lo2[perm]) + ap(plan.s2c_chains[1], hi2[perm])
        np.testing.assert_allclose(out_got, V @ lo2 + W @ hi2, atol=1e-12)
