"""toyfhe_tpu_torch K4 and K6 cluster kernels: their host side on the CPU.

The schedule twins ``ntt_pallas_cuda.polymul_schedule`` and
``pallas_keyswitch_cuda.keyswitch_schedule`` follow the CUDA kernels pass for
pass and index for index (the DIF plan, which block reads which residues, the
fused middle, the digit shares, the partial sums and the cluster reduction,
the closing pass). Here they are held bit-equal to the plain twins
``polymul_plain`` and ``fused_keyswitch_plain`` -- which
tests/test_torch_polymul.py and tests/test_torch_keyswitch.py hold to the
reference's Pallas kernels in interpret mode -- at every legal cluster size,
with lazy and with fully reduced butterflies; the lazy value ranges are
checked on the worst input; and the pass plans and the cluster choosers are
checked over log2 N = 4 .. 15. Tolerance: none, integers bit-equal. On a CUDA
device every launch shape of each kernel is held to its plain twin.

Nothing here imports the reference, so the ``cuda`` tests run on a host that
has torch but no jax (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.ops import ntt_pallas as tnp
from toyfhe_tpu_torch.ops import ntt_pallas_cuda as k4c
from toyfhe_tpu_torch.ops import pallas_keyswitch as tpks
from toyfhe_tpu_torch.ops import pallas_keyswitch_cuda as k6c
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

# every prime below 2^30 (lazy butterflies), and a prime in [2^30, 2^31)
LAZY_TOWER, FULL_TOWER = (27, 28, 29), (30, 29)


def lrn_residues(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return I.tensor(np.stack([rng.integers(0, p, (rows, n)) for p in primes]), "cpu")


def pallas_tables(n, tower):
    return tnp.PallasNttTables(tntt.NttTables(n, nt.ntt_prime_chain(n, tower)))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
@pytest.mark.parametrize("n", [16, 64, 1024, 8192])
def test_k4_schedule_matches_plain(n, tower):
    pt = pallas_tables(n, tower)
    lazy = tower is LAZY_TOWER
    a, b = lrn_residues(pt.primes, 3, n, n), lrn_residues(pt.primes, 3, n, n + 1)
    want = tnp.polymul_plain(pt, a, b)
    for cluster in k4c.legal_polymul_clusters(n):
        got, seen = k4c.polymul_schedule(pt, a, b, cluster)
        assert torch.equal(got, want), cluster
        assert seen < (4 if lazy else 2) * max(pt.primes) < 1 << 32
    if lazy:                                  # the fully reduced flag on a lazy tower
        got, seen = k4c.polymul_schedule(pt, a, b, 1, lazy=False)
        assert torch.equal(got, want) and seen < 2 * max(pt.primes)
    else:
        with pytest.raises(ValueError):
            k4c.polymul_schedule(pt, a, b, 1, lazy=True)
    with pytest.raises(ValueError):
        k4c.polymul_schedule(pt, a, b, 8)


@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_k4_schedule_lazy_range_on_the_worst_input(n):
    """Every residue p - 1: the lazy values stay below 4p < 2^32 in every
    pass (below 2p on the way forward and into the product), and the output
    is still canonical and exact."""
    pt = pallas_tables(n, (29, 29, 28))
    a = torch.stack([torch.full((2, n), p - 1, dtype=torch.int64) for p in pt.primes])
    want = tnp.polymul_plain(pt, a, a)
    for cluster in k4c.legal_polymul_clusters(n):
        got, seen = k4c.polymul_schedule(pt, a, a, cluster)
        assert max(pt.primes) <= seen < 4 * max(pt.primes) < 1 << 32
        assert torch.equal(got, want)


@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
def test_forward_values_stay_below_2p(tower):
    """The forward side alone: DIF butterflies keep [0, 2p) when lazy and
    [0, p) otherwise, on the worst input."""
    n = 256
    pt = pallas_tables(n, tower)
    lazy = tower is LAZY_TOWER
    ar = k4c._DifArith(pt.tables, lazy)
    (_, tw), _ = k4c._int64_tables(pt.tables)
    x = torch.stack([torch.full((n,), p - 1, dtype=torch.int64) for p in pt.primes])[None]
    low, pos = k4c._pass_positions(8, 5, 3)
    out = k4c._stages_dif(ar, x[..., torch.as_tensor(pos)][:, :, None], tw, 5, 3, low)
    assert int(out.max()) < (2 if lazy else 1) * max(pt.primes)
    assert ar.max_seen < (4 if lazy else 2) * max(pt.primes)


@pytest.mark.parametrize("logn", range(4, 16))
def test_polymul_plan(logn):
    n = 1 << logn
    legal = k4c.legal_polymul_clusters(n)
    assert legal and all(8 <= n // c <= k4c.MAX_BLOCK_N for c in legal)
    assert (1 in legal) == (logn <= 14) and set(legal) <= set(k4c.POLYMUL_CLUSTERS)
    for cluster in legal:
        plan = k4c.polymul_plan(logn, cluster)
        logc = cluster.bit_length() - 1
        kl, fwd, bwd, kf = plan["kl"], plan["fwd"], plan["bwd"], plan["kf"]
        # forward: cross stages + load pass + local passes + middle cover every stage once
        assert logc + kl + sum(fwd) + k4c.MIDDLE == logn
        # backward: middle + local passes + closing pass, the cross-block stages in the closing
        assert k4c.MIDDLE + sum(bwd) + kf == logn and max(logc, 1) <= kf <= 3
        assert k4c.MIDDLE + sum(bwd) <= logn - logc           # local passes stay inside a block
        assert 0 <= kl <= 3 and all(1 <= k <= 3 for k in fwd + bwd)
        assert (kl, fwd) == k4c.forward_plan(logn - logc)
        # ceil((log2 N - 3) / 3) passes on either side of the middle when C = 1
        if cluster == 1:
            assert 1 + len(fwd) == len(bwd) + 1 == -(-(logn - 3) // 3)
        # 8 barriers at N = 2^14 where radix-2 stages take 3 log2 N + 3
        assert k4c.plan_barriers(plan) <= 8 < 3 * logn + 3
        for packed, want in ((k4c.pack_plan(fwd), fwd), (k4c.pack_plan(bwd), bwd)):
            got = []
            while packed:
                got.append(packed & 3)
                packed >>= 2
            assert tuple(got) == want
    with pytest.raises(ValueError):
        k4c.polymul_plan(logn, 8)
    if logn < 5:
        with pytest.raises(ValueError):
            k4c.polymul_plan(logn, 4)
    assert k4c.forward_plan(3) == (0, ())
    with pytest.raises(ValueError):
        k4c.forward_plan(2)


def test_choose_polymul_cluster():
    small, big = [2 ** 28 - 57, 2 ** 29 - 3], [2 ** 30 + 3, 2 ** 28 - 57]
    for logn in range(4, 16):
        n = 1 << logn
        legal = k4c.legal_polymul_clusters(n)
        for polys in (1, 8, 28, 33, 66, 67, 128, 132, 133, 1000):
            c, lazy = k4c.choose_polymul_cluster(polys, n, small)
            floor = 2 if n >= k4c.SPLIT_FROM_N else 1
            assert lazy and c in legal
            assert polys * c <= k4c.BLOCK_CAP or c == floor
            if c > floor:
                assert n // c >= k4c.MIN_CHOSEN_BLOCK_N
            assert k4c.choose_polymul_cluster(polys, n, big) == (c, False)
    assert k4c.choose_polymul_cluster(28, 8192, small)[0] == 4       # the serving shape
    assert k4c.choose_polymul_cluster(128, 16384, small)[0] == 2     # the A/B batch
    assert k4c.choose_polymul_cluster(200, 8192, small)[0] == 1
    assert k4c.choose_polymul_cluster(128, 32768, small)[0] == 2     # one block cannot hold 2^15
    pt = pallas_tables(64, FULL_TOWER)
    with pytest.raises(ValueError):
        k4c.polymul_args(pt, 4, lazy=True)                           # a 31-bit prime
    with pytest.raises(ValueError):
        k4c.polymul_args(pt, 4, cluster=8)
    assert k4c.polymul_args(pt, 4, cluster=4) == (4, 0, 1, 0, 0, 3)
    assert k4c.polymul_block_shape(8192, 4) == {"threads": 256, "smem": 4 * 2 * 2048}


def test_k4_variant_guards():
    """The launcher refuses CPU tensors, as dispatched and at a forced
    cluster size, and counts no launch."""
    pt = pallas_tables(64, LAZY_TOWER)
    a = torch.zeros((3, 2, 64), dtype=torch.int64)
    before = dict(k4c.polymul_launches)
    for kwargs in ({}, {"cluster": 2}):
        with pytest.raises(ValueError):
            k4c.launch_polymul(pt, a, a, **kwargs)                   # CPU tensors
    assert k4c.polymul_launches == before


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def synthetic_fk(n, tower, window, seed):
    """A FusedKeyswitch over ``tower`` (its last prime the special) with
    uniform key duals from a numpy seed."""
    tables = tntt.NttTables(n, nt.ntt_prime_chain(n, tower))
    lc = len(tower) - 1
    kpl = -(-max(p.bit_length() for p in tables.primes[:lc]) // window)
    rng = np.random.default_rng(seed)
    keys = [I.tensor(np.stack([rng.integers(0, p, (lc * kpl, n)) for p in tables.primes], 1),
                     "cpu") for _ in range(2)]
    return tpks.FusedKeyswitch(tables, keys[0], keys[1], window, kpl, lc)


def k6_inputs(fk, lead, seed):
    rng = np.random.default_rng(seed)
    primes = fk.pt.primes
    c2 = I.tensor(np.stack([rng.integers(0, p, lead + (fk.n,)) for p in primes[:-1]], -2), "cpu")
    c1e = I.tensor(np.stack([rng.integers(0, p, lead + (fk.n,)) for p in primes], -2), "cpu")
    return c2, c1e


K6_SCHEDULE_CASES = [  # (N, tower incl. special, window, lead)
    (16, (28, 28, 29), 8, ()),
    (64, (28, 28, 28, 29), 8, (2,)),
    (64, (29, 28, 29), 5, ()),
    (256, (28, 29, 28, 29), 5, (2,)),
    (1024, (28, 28, 29), 8, ()),
    (8192, (28, 28, 29), 8, ()),
    (32, (30, 29, 28, 29), 8, (2,)),          # a prime above 2^30: fully reduced
    (128, (29, 28, 30), 5, ()),
]


@pytest.mark.parametrize("n, tower, window, lead", K6_SCHEDULE_CASES)
def test_k6_schedule_matches_plain(n, tower, window, lead):
    fk = synthetic_fk(n, tower, window, n + window)
    c2, c1e = k6_inputs(fk, lead, n)
    want = tpks.fused_keyswitch_plain(fk, c2, c1e)
    lazy = max(fk.pt.primes) < k6c.LAZY_PRIME_LIMIT
    legal = k6c.legal_clusters(n, fk.ndig)
    assert 1 in legal and (n < 32 or 8 in legal)
    for cluster in legal:
        got, seen = k6c.keyswitch_schedule(fk, c2, c1e, cluster)
        assert got[0].shape == lead + (fk.Lc + 1, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cluster
        assert seen < (4 if lazy else 2) * max(fk.pt.primes) < 1 << 32
    if lazy:
        got, seen = k6c.keyswitch_schedule(fk, c2, c1e, max(legal), lazy=False)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert seen < 2 * max(fk.pt.primes)
    else:
        with pytest.raises(ValueError):
            k6c.keyswitch_schedule(fk, c2, c1e, 1, lazy=True)
    with pytest.raises(ValueError):
        k6c.keyswitch_schedule(fk, c2, c1e, 16)


@pytest.mark.parametrize("n, window", [(16, 8), (1024, 5), (4096, 8)])
def test_k6_schedule_lazy_range_on_the_worst_input(n, window):
    """Every residue of c2, c1e and the key rows p - 1: the accumulators and
    the cluster sums stay below 4p < 2^32, and the outputs are exact."""
    tower = (29, 28, 29)
    fk = synthetic_fk(n, tower, window, 0)
    primes = fk.pt.primes
    top = torch.as_tensor(primes, dtype=torch.int64)[:, None] - 1
    fk.masks = top[None].expand(fk.ndig, -1, n).contiguous()
    fk.maskeds = fk.masks.clone()
    c2, c1e = top[:-1].expand(-1, n).contiguous(), top.expand(-1, n).contiguous()
    want = tpks.fused_keyswitch_plain(fk, c2, c1e)
    for cluster in k6c.legal_clusters(n, fk.ndig):
        got, seen = k6c.keyswitch_schedule(fk, c2, c1e, cluster)
        assert max(primes) <= seen < 4 * max(primes) < 1 << 32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("logn", range(4, 16))
def test_keyswitch_plan_and_chooser(logn):
    n = 1 << logn
    small, big = [2 ** 28 - 57, 2 ** 29 - 3], [2 ** 30 + 3, 2 ** 28 - 57]
    for ndig in (1, 3, 6, 28, 42):
        legal = k6c.legal_clusters(n, ndig)
        assert legal[0] == 1 and all(g <= ndig and n // k6c.half(g) >= 8 for g in legal)
        for g in legal:
            plan = k6c.keyswitch_plan(logn, g)
            logh = k6c.half(g).bit_length() - 1
            assert plan["kl"] + sum(plan["fwd"]) + k6c.MIDDLE == logn and 1 <= plan["kl"] <= 3
            assert sum(plan["bwd"]) + plan["kf"] == logn and max(logh, 1) <= plan["kf"] <= 3
            assert sum(plan["bwd"]) <= logn - logh
            assert 1 + len(plan["fwd"]) + 1 == -(-(logn - 3) // 3) + 1     # passes a digit
            shares = [len(range(b, ndig, g)) for b in range(g)]
            assert sum(shares) == ndig and min(shares) >= 1 and max(shares) - min(shares) <= 1
        for pairs in (1, 8, 16, 17, 32, 33, 66, 132, 200):
            g, lazy = k6c.choose_cluster(pairs, n, ndig, small)
            assert lazy and g in legal and (pairs * g <= k6c.BLOCK_CAP or g == 1)
            bigger = [h for h in legal if h > g]
            assert all(pairs * h > k6c.BLOCK_CAP for h in bigger)
            assert k6c.choose_cluster(pairs, n, ndig, big) == (g, False)
    with pytest.raises(ValueError):
        k6c.keyswitch_plan(logn, 16)
    assert k6c.acc_items(n) == (1 if logn <= 12 else 2 if logn == 13 else 0)
    shape = k6c.block_shape(n)
    assert shape["threads"] == min(512, max(32, n // 8)) and shape["smem"] <= 232448


def test_k6_chooser_at_the_mnist_width_and_guards():
    """Path (b): one row of 8 output limbs, 28 digits -> 8 blocks a pair,
    4 or 3 digits each; a batch of 4 rows -> 4 blocks a pair."""
    primes = nt.ntt_prime_chain(8192, (28,) * 7 + (29,))
    assert k6c.choose_cluster(8, 8192, 28, primes) == (8, True)
    assert k6c.choose_cluster(32, 8192, 28, primes) == (4, True)
    assert sorted(len(range(b, 28, 8)) for b in range(8)) == [3] * 4 + [4] * 4
    fk = synthetic_fk(32, (28, 28, 29), 8, 1)
    assert k6c.cluster_args(fk, 3) == (8, 1, 2, 0, k6c.pack_plan((3,)), 2)
    for kwargs in ({"cluster": 16}, {"cluster": 3}):
        with pytest.raises(ValueError):
            k6c.cluster_args(fk, 3, **kwargs)
    full = synthetic_fk(32, (30, 28, 29), 8, 1)
    with pytest.raises(ValueError):
        k6c.cluster_args(full, 3, lazy=True)
    c2, c1e = k6_inputs(fk, (), 0)
    before = dict(k6c.launches)
    for kwargs in ({}, {"cluster": 2}):
        with pytest.raises(ValueError):
            k6c.launch(fk, c2, c1e, **kwargs)                        # CPU tensors
    assert k6c.launches == before


# ---------------------------------------------------------------------------
# the kernels on a CUDA device
# ---------------------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
@pytest.mark.parametrize("n", [16, 64, 1024, 8192, 1 << 14, 1 << 15])
def test_cuda_k4_matches_plain_at_every_launch_shape(n, tower):
    dev = cuda_device()
    pt = pallas_tables(n, tower)
    a, b = (lrn_residues(pt.primes, 5, n, n + i).to(dev) for i in range(2))
    want = tnp.polymul_plain(pt, a, b)
    before = k4c.polymul_launches["k4"]
    outs = [tnp.polymul_pallas_raw(pt, a, b)]
    for cluster in k4c.legal_polymul_clusters(n):
        for lazy in ((False, True) if tower is LAZY_TOWER else (False,)):
            outs.append(k4c.launch_polymul(pt, a, b, cluster=cluster, lazy=lazy))
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got in outs)
    assert k4c.polymul_launches["k4"] == before + len(outs)
    with pytest.raises(ValueError):
        k4c.launch_polymul(pt, a, b, cluster=8)


@pytest.mark.cuda
@pytest.mark.parametrize("n, tower, window, lead", K6_SCHEDULE_CASES + [
    (8192, (28,) * 7 + (29,), 8, ()), (1 << 14, (28, 28, 29), 8, (2,)),
    (1 << 15, (28, 28, 29), 8, ())])
def test_cuda_k6_matches_plain_at_every_launch_shape(n, tower, window, lead):
    dev = cuda_device()
    fk = synthetic_fk(n, tower, window, n + window)
    c2, c1e = (x.to(dev) for x in k6_inputs(fk, lead, n))
    want = tpks.fused_keyswitch_plain(fk, c2, c1e)
    lazy_ok = max(fk.pt.primes) < k6c.LAZY_PRIME_LIMIT
    before = k6c.launches["k6"]
    outs = [fk(c2, c1e)]
    for cluster in k6c.legal_clusters(n, fk.ndig):
        for lazy in ((False, True) if lazy_ok else (False,)):
            outs.append(k6c.launch(fk, c2, c1e, cluster=cluster, lazy=lazy))
    torch.cuda.synchronize()
    assert all(torch.equal(g1, want[0]) and torch.equal(g2, want[1]) for g1, g2 in outs)
    assert k6c.launches["k6"] == before + len(outs)
    with pytest.raises(ValueError):
        k6c.launch(fk, c2, c1e, cluster=16)
