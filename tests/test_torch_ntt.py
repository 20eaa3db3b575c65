"""toyfhe_tpu_torch NTT: the plain radix-2 transform bit-equal to the
reference's ``ntt``/``intt`` and to the K1 Pallas kernel (interpret mode),
the round trip, the CUDA wrapper's guards, the cluster kernel's schedule twin
(pass plan, index maps, lazy value range, cluster chooser) bit-equal to the
plain transform and the reference, and — on a CUDA device — both
hand-written kernels bit-equal to the plain transform.

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


# towers for the cluster kernel: lazy butterflies (every prime below 2^30)
# and fully reduced ones (a prime in [2^30, 2^31))
LAZY_TOWER, FULL_TOWER = (27, 28, 29), (30, 29)
SCHEDULE_NS = [1 << k for k in range(4, 14)]


@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
@pytest.mark.parametrize("n", SCHEDULE_NS)
def test_schedule_matches_plain_and_reference(ref, n, tower):
    """The cluster kernel's schedule at every legal cluster size, 1 and 3
    rows: bit-equal to the plain transform and to the reference's."""
    jnp, ref_ntt = ref
    primes = nt.ntt_prime_chain(n, tower)
    tables, rtables = tntt.NttTables(n, primes), ref_ntt.NttTables(n, primes)
    lazy = tower is LAZY_TOWER
    for lead in ((), (3,)):
        x = _residues(primes, lead, n, n + len(lead))
        for inverse, plain, rfn in ((False, tntt.ntt_plain, ref_ntt.ntt),
                                    (True, tntt.intt_plain, ref_ntt.intt)):
            want = plain(tables, _t(x))
            np.testing.assert_array_equal(
                want.numpy(), np.asarray(rfn(rtables, jnp.asarray(x))).astype(np.int64))
            for cluster in ntt_cuda.legal_clusters(n):
                got, seen = ntt_cuda.ntt_schedule(tables, _t(x), inverse, cluster)
                assert torch.equal(got, want), (cluster, inverse, lead)
                assert seen < (4 if lazy else 1) * max(primes)
            if lazy:                          # the fully reduced flag on a lazy tower
                got, seen = ntt_cuda.ntt_schedule(tables, _t(x), inverse, 1, lazy=False)
                assert torch.equal(got, want) and seen < max(primes)


@pytest.mark.parametrize("radix", [2, 4])
def test_schedule_other_radices(radix):
    n = 256
    primes = nt.ntt_prime_chain(n, LAZY_TOWER)
    tables = tntt.NttTables(n, primes)
    x = _t(_residues(primes, (2,), n, radix))
    for cluster in ntt_cuda.legal_clusters(n):
        assert torch.equal(ntt_cuda.ntt_schedule(tables, x, False, cluster, radix)[0],
                           tntt.ntt_plain(tables, x))
        assert torch.equal(ntt_cuda.ntt_schedule(tables, x, True, cluster, radix)[0],
                           tntt.intt_plain(tables, x))


@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_schedule_lazy_range_on_the_worst_input(n):
    """Every residue p - 1: the lazy values stay below 4p < 2^32 in every
    pass, and the output is still canonical and exact."""
    primes = nt.ntt_prime_chain(n, (29, 29, 28))
    tables = tntt.NttTables(n, primes)
    x = _t(np.stack([np.full((2, n), p - 1) for p in primes], axis=-2))
    for cluster in ntt_cuda.legal_clusters(n):
        for inverse, plain in ((False, tntt.ntt_plain), (True, tntt.intt_plain)):
            got, seen = ntt_cuda.ntt_schedule(tables, x, inverse, cluster)
            assert seen < 4 * max(primes) < 1 << 32
            assert seen >= max(primes)                 # the range is really used
            assert torch.equal(got, plain(tables, x))
    with pytest.raises(ValueError):                    # no lazy values with a 31-bit prime
        full = tntt.NttTables(n, nt.ntt_prime_chain(n, FULL_TOWER))
        ntt_cuda.ntt_schedule(full, x[..., :2, :], False, 1, lazy=True)


@pytest.mark.parametrize("logn", range(4, 16))
def test_schedule_plan(logn):
    n = 1 << logn
    for cluster in ntt_cuda.legal_clusters(n):
        local, kf = ntt_cuda.schedule_plan(logn, cluster)
        logc = cluster.bit_length() - 1
        assert sum(local) + kf == logn and all(1 <= k <= 3 for k in local + (kf,))
        assert kf >= logc                              # the cross-block stages close the plan
        assert sum(local) <= logn - logc               # local passes stay inside a block
        # one barrier after the load and after each local pass, one cluster
        # barrier at the end: at most 8 at N = 2^13 (radix-2: 14)
        assert 1 + len(local) + (cluster > 1) <= (8 if logn <= 13 else 9)
        if cluster == 1:
            assert len(local) + 1 == -(-logn // 3)
        packed, got = ntt_cuda.pack_plan(local), []
        while packed:
            got.append(packed & 3)
            packed >>= 2
        assert tuple(got) == local
    assert n // max(ntt_cuda.legal_clusters(n)) >= 8
    with pytest.raises(ValueError):
        ntt_cuda.schedule_plan(logn, 16)
    if logn < 6:
        with pytest.raises(ValueError):
            ntt_cuda.schedule_plan(logn, 8)


@pytest.mark.parametrize("m", [3, 9, 10, 11, 13, 15])
def test_swizzle_is_a_bank_spreading_permutation(m):
    q = np.arange(1 << m)
    w = ntt_cuda.swizzle(q, m)
    assert sorted(w.tolist()) == q.tolist()
    assert np.array_equal(w ^ 1, ntt_cuda.swizzle(q ^ 1, m))     # neighbours stay neighbours
    if m >= ntt_cuda.SWIZZLE_MIN_LOG:
        # the load: lanes u..u+31 store the positions bitrev(2u) of a block
        for u0 in (0, 32, (1 << (m - 1)) - 32):
            pos = ntt_cuda._bitrev(2 * (u0 + np.arange(32)), m)
            assert len(set((ntt_cuda.swizzle(pos, m) % 32).tolist())) == 32


def test_choose_cluster():
    small, big = [2 ** 28 - 57, 2 ** 29 - 3], [2 ** 30 + 3, 2 ** 28 - 57]
    for n in (16, 256, 4096, 8192, 16384, 32768):
        floor = 2 if n >= ntt_cuda.SPLIT_FROM_N else 1
        for polys in (1, 8, 12, 28, 42, 66, 100, 131, 132, 196, 1000):
            c, lazy = ntt_cuda.choose_cluster(polys, n, small)
            assert lazy and c in ntt_cuda.legal_clusters(n) and (n // 8) % c == 0
            assert polys * c <= ntt_cuda.BLOCK_CAP or c == floor
            if c > floor:
                assert n // c >= ntt_cuda.MIN_CHOSEN_BLOCK_N
            if polys >= ntt_cuda.BLOCK_CAP:
                assert c == floor
            assert ntt_cuda.choose_cluster(polys, n, big) == (c, False)
    # the serving launches: few polynomials of N = 2^13 get more than one block
    assert ntt_cuda.choose_cluster(12, 8192, small)[0] == 4
    assert ntt_cuda.choose_cluster(28, 8192, small)[0] == 4
    assert ntt_cuda.choose_cluster(196, 4096, small)[0] == 1
    tables = tntt.NttTables(64, nt.ntt_prime_chain(64, FULL_TOWER))
    with pytest.raises(ValueError):
        ntt_cuda.cluster_args(tables, 4, False, lazy=True)       # a 31-bit prime
    with pytest.raises(ValueError):
        ntt_cuda.cluster_args(tables, 4, False, cluster=16)
    assert ntt_cuda.cluster_args(tables, 4, True, cluster=8) == (2, 6, 1, 8, 0, 3, 3)
    x = torch.zeros(2, 64, dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt_cuda.launch(tables, x, False, cluster=2)             # a CPU tensor


@pytest.mark.cuda
@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
@pytest.mark.parametrize("n", [16, 64, 512, 2048, 8192, 1 << 14, 1 << 15])
def test_cuda_k1_matches_plain_at_every_launch_shape(n, tower):
    """As dispatched and at every legal cluster size, lazy and fully
    reduced: all equal to the plain transform."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    primes = nt.ntt_prime_chain(n, tower)
    tables = tntt.NttTables(n, primes)
    x = _t(_residues(primes, (3,), n, n)).to(dev)
    flags = (False, True) if tower is LAZY_TOWER else (False,)
    for inverse, plain in ((False, tntt.ntt_plain), (True, tntt.intt_plain)):
        want = plain(tables, x)
        before = ntt_cuda.launches["inv" if inverse else "fwd"]
        assert torch.equal(ntt_cuda.launch(tables, x, inverse), want)
        count = 1
        for cluster in ntt_cuda.legal_clusters(n):
            for lazy in flags:
                got = ntt_cuda.launch(tables, x, inverse, cluster, lazy)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (cluster, lazy, inverse)
                count += 1
        assert ntt_cuda.launches["inv" if inverse else "fwd"] == before + count
    with pytest.raises(ValueError):
        ntt_cuda.launch(tables, x, False, cluster=16)


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
