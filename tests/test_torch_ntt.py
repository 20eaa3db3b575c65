"""toyfhe_tpu_torch NTT: the plain radix-2 transform bit-equal to the
reference's ``ntt``/``intt`` and to the K1 Pallas kernel (interpret mode),
the round trip, the CUDA wrapper's guards, and — on a CUDA device — the
hand-written kernel bit-equal to the plain transform.

The reference is imported inside the ``ref`` fixture, so the CUDA test runs
on a host that has torch but no jax (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.ops import ntt_cuda
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

# towers with every prime below 2^30, and with a prime at or above 2^30
TOWERS = [(29, 28), (30, 29, 28)]
LEADS = [(), (3,), (2, 3)]
NS = [1 << k for k in range(4, 13)]


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp

    from toyfhe_tpu.ops import ntt as ref_ntt
    return jnp, ref_ntt


def _residues(primes, lead, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, tuple(lead) + (n,)) for p in primes],
                    axis=-2).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("n", NS)
def test_plain_matches_reference(ref, n):
    jnp, ref_ntt = ref
    i = NS.index(n)
    tower, lead = TOWERS[i % 2], LEADS[i % 3]
    primes = nt.ntt_prime_chain(n, tower)
    tables, rtables = tntt.NttTables(n, primes), ref_ntt.NttTables(n, primes)
    x = _residues(primes, lead, n, i)
    np.testing.assert_array_equal(
        tntt.ntt(tables, _t(x)).numpy(),
        np.asarray(ref_ntt.ntt(rtables, jnp.asarray(x))).astype(np.int64))
    np.testing.assert_array_equal(
        tntt.intt(tables, _t(x)).numpy(),
        np.asarray(ref_ntt.intt(rtables, jnp.asarray(x))).astype(np.int64))


@pytest.mark.parametrize("n, n1", [(256, 2), (256, 8), (256, 64), (256, 128),
                                   (512, None)])
def test_plain_matches_pallas_k1(ref, n, n1):
    """The K1 Pallas kernel (interpret mode) across its n1 factorizations
    (``None``: the production choice ``lane_optimal_n1``, N/128)."""
    from toyfhe_tpu.ops import ntt_mxu as mxu
    from toyfhe_tpu.ops import ntt_mxu_pallas as mxp
    jnp, ref_ntt = ref
    primes = nt.ntt_prime_chain(n, (29, 28))
    mt = mxu.MxuNttTables(ref_ntt.NttTables(n, primes),
                          n1=n1 or mxu.lane_optimal_n1(n))
    tables = tntt.NttTables(n, primes)
    x = _residues(primes, (2,), n, n1 or 0)
    np.testing.assert_array_equal(
        tntt.ntt(tables, _t(x)).numpy(),
        np.asarray(mxp.ntt_mxu_nat(mt, jnp.asarray(x), True)).astype(np.int64))
    np.testing.assert_array_equal(
        tntt.intt(tables, _t(x)).numpy(),
        np.asarray(mxp.intt_mxu_nat(mt, jnp.asarray(x), True)).astype(np.int64))


@pytest.mark.parametrize("n", [16, 256, 4096])
def test_round_trip(n):
    primes = nt.ntt_prime_chain(n, (30, 29, 29, 28))
    tables = tntt.NttTables(n, primes)
    x = _t(_residues(primes, (2,), n, n))
    y = tntt.ntt(tables, x)
    assert not torch.equal(y, x)
    assert torch.equal(tntt.intt(tables, y), x)
    assert torch.equal(tntt.ntt_plain(tables, tntt.intt_plain(tables, x)), x)


def test_ntt_is_negacyclic_product():
    """NTT diagonalizes multiplication mod x^N + 1 (schoolbook oracle)."""
    from toyfhe_tpu_torch.ops import modmath as mm
    n = 16
    primes = nt.ntt_prime_chain(n, (29,))
    p = primes[0]
    tables = tntt.NttTables(n, primes)
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, p, (2, 1, n))
    want = [0] * n
    for i in range(n):
        for j in range(n):
            k, t = (i + j) % n, int(a[0, i]) * int(b[0, j])
            want[k] = (want[k] + (t if i + j < n else -t)) % p
    prod = mm.mul_mod(tntt.ntt(tables, _t(a)), tntt.ntt(tables, _t(b)), tables.mp)
    np.testing.assert_array_equal(tntt.intt(tables, prod).numpy()[0], want)


def test_cuda_wrapper_guards():
    """The kernel wrapper takes CUDA tensors only; the dispatcher sends CPU
    tensors to the plain transform and refuses other devices."""
    tables = tntt.NttTables(16, nt.ntt_prime_chain(16, (29,)))
    x = torch.zeros(1, 16, dtype=torch.int64)
    before = dict(ntt_cuda.launches)
    with pytest.raises(ValueError):
        ntt_cuda.launch(tables, x, False)
    with pytest.raises(ValueError):
        tntt.ntt(tables, x.to("meta"))
    assert torch.equal(tntt.ntt(tables, x), x)     # NTT(0) = 0 on the plain path
    assert ntt_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 256, 4096, 8192, 1 << 15])
def test_cuda_kernel_matches_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    primes = nt.ntt_prime_chain(n, (30, 29, 28))
    tables = tntt.NttTables(n, primes)
    x = _t(_residues(primes, (4,), n, n)).to(dev)
    before = dict(ntt_cuda.launches)
    fwd, inv = tntt.ntt(tables, x), tntt.intt(tables, x)
    torch.cuda.synchronize()
    assert ntt_cuda.launches["fwd"] == before["fwd"] + 1
    assert ntt_cuda.launches["inv"] == before["inv"] + 1
    assert torch.equal(fwd, tntt.ntt_plain(tables, x))
    assert torch.equal(inv, tntt.intt_plain(tables, x))
    assert torch.equal(tntt.intt(tables, fwd), x)
    with pytest.raises(TypeError):
        ntt_cuda.launch(tables, x.to(torch.int32), False)
    with pytest.raises(ValueError):
        ntt_cuda.launch(tables, x[..., : n // 2].contiguous(), False)
