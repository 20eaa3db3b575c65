"""toyfhe_tpu_torch K3 and K5 redesigned kernels: their host side on the CPU.

The schedule twins ``hybrid_ks_cuda.hybrid_ks_schedule`` and
``ntt_pallas_cuda.bitrev_schedule`` follow the CUDA kernels pass for pass and
index for index (K3: the digit built in the load pass, the swizzled
bit-reversed scatter, the DIT plan, the closing pass with the key products,
the digit shares and the cluster sum, or the polynomial split over the
cluster; K5: which block reads which residues, the cross-block stages, the
DIF plan, the last pass and where a block's row lands). Here they are held
bit-equal to the plain twins ``fused_hybrid_ks_plain`` and
``ntt_bitrev_plain`` -- which tests/test_torch_hybrid.py and
tests/test_torch_keyswitch.py hold to the reference's Pallas kernels in
interpret mode -- at every legal cluster size, with lazy and with fully
reduced arithmetic; the lazy value ranges are checked on the worst input; and
the pass plans and the choosers are checked over log2 N = 4 .. 15. Tolerance:
none, integers bit-equal. On a CUDA device every launch shape of each kernel is held to its
plain twin.

Nothing here imports the reference, so the ``cuda`` tests run on a host that
has torch but no jax (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.ops import hybrid_ks
from toyfhe_tpu_torch.ops import hybrid_ks_cuda as k3c
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.ops import ntt_pallas as tnp
from toyfhe_tpu_torch.ops import ntt_pallas_cuda as k5c
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

# every prime below 2^30 (lazy arithmetic), and a prime in [2^30, 2^31)
LAZY_TOWER, FULL_TOWER = (27, 28, 29), (30, 29)

# (name, tower bits, dnum, num_special, ct limbs the step runs on): the MNIST
# serving gadget, its square layer one limb down, the dnum = 4 fixture, and a
# gadget with a raising prime above 2^30 (fully reduced arithmetic)
HYBRID_CONFIGS = (
    ("mnist", (28,) * 7 + (29,) * 4, 2, 4, 7),
    ("mnist_ring1", (28,) * 7 + (29,) * 4, 2, 4, 6),
    ("bench", (28,) * 7 + (29,) * 3, 4, 3, 7),
)
FULL_CONFIG = ("full", (28,) * 4 + (30, 29), 2, 2, 4)


def make_fks(n, config, seed, device="cpu"):
    """A FusedHybridKS of ``config`` at ring degree ``n`` with uniform key
    duals from a numpy seed."""
    _, tower, dnum, k, lt = config
    params = T.HybridRaised(T.CKKSParams(T.make_rns_ring(n, tower), 0, 3.2), dnum, k)
    key_ring = params.ring_key
    rng = np.random.default_rng(seed)
    shape = (params.dnum, key_ring.nlimbs, key_ring.n)
    lim = min(key_ring.primes)
    ek = I.eval_mult_key(params, rng.integers(0, lim, shape), rng.integers(0, lim, shape),
                         device=device)
    return hybrid_ks.FusedHybridKS(params, ek, lt=lt)


def y_hat(fks, lead, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    primes = fks.ct_ring.primes
    return I.tensor(np.stack([rng.integers(0, p, lead + (fks.exp_ring.n,)) for p in primes], -2),
                    device)


def k3_variants(fks):
    """(scheme, cluster) of every legal launch shape of the cluster kernel."""
    n, dnum = fks.exp_ring.n, fks.dnum_t
    return [(s, g) for s in k3c.SCHEMES for g in k3c.legal_clusters(n, dnum, s)]


def pallas_tables(n, tower):
    return tnp.PallasNttTables(tntt.NttTables(n, nt.ntt_prime_chain(n, tower)))


def lrn_residues(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return I.tensor(np.stack([rng.integers(0, p, (rows, n)) for p in primes]), "cpu")


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (2,)], ids=["nolead", "lead2"])
@pytest.mark.parametrize("config", HYBRID_CONFIGS + (FULL_CONFIG,), ids=lambda c: c[0])
@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_k3_schedule_matches_plain(n, config, lead):
    fks = make_fks(n, config, n + len(lead))
    y = y_hat(fks, lead, n)
    want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
    lazy_ok = max(fks.exp_ring.primes) < k3c.LAZY_PRIME_LIMIT
    assert lazy_ok == (config is not FULL_CONFIG)
    variants = k3_variants(fks)
    assert ("digits", 1) in variants and ("digits", 2) in variants and ("poly", 2) in variants
    if n >= 8192 and lead:
        variants = variants[::2]                   # the widest case: every other variant
    for scheme, g in variants:
        for lazy in ((True, False) if lazy_ok and n < 8192 else (None,)):
            got, seen = k3c.hybrid_ks_schedule(fks, y, g, lazy=lazy, scheme=scheme)
            assert got[0].shape == lead + (fks.exp_ring.nlimbs, n)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (scheme, g)
            is_lazy = lazy_ok if lazy is None else lazy
            assert seen < (4 * max(fks.exp_ring.primes) if is_lazy else 1 << 31) < 1 << 32
    if not lazy_ok:
        with pytest.raises(ValueError):
            k3c.hybrid_ks_schedule(fks, y, 1, lazy=True)
    with pytest.raises(ValueError):
        k3c.hybrid_ks_schedule(fks, y, 8)
    with pytest.raises(ValueError):
        k3c.hybrid_ks_schedule(fks, y, 1, scheme="poly")
    with pytest.raises(ValueError):
        k3c.hybrid_ks_schedule(fks, y, 2, scheme="rows")


@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_k3_schedule_lazy_range_on_the_worst_input(n):
    """Every key residue p - 1 and every ŷ residue 2^31 - 1 (a REDC operand
    mod p_t that was never reduced mod p_t): the uncorrected products and
    the sums stay below 2p, the DIT values below 4p < 2^32, and the outputs
    are canonical and exact."""
    fks = make_fks(n, HYBRID_CONFIGS[0], 0)
    primes = fks.exp_ring.primes
    top = torch.as_tensor(primes, dtype=torch.int64)[:, None] - 1
    for name in ("km", "kd"):
        setattr(fks, name, top[None].expand(fks.dnum_t, -1, n).contiguous())
    y = torch.full((fks.lt, n), (1 << 31) - 1, dtype=torch.int64)
    want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
    for scheme, g in k3_variants(fks):
        got, seen = k3c.hybrid_ks_schedule(fks, y, g, scheme=scheme)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(max(got[0].max(), got[1].max())) < max(primes)
        # the largest value seen is the unreduced operand itself or a DIT value
        assert max(primes) <= seen < 4 * max(primes) < 1 << 32


def test_k3_lazy_product_of_an_unreduced_operand_stays_below_2p():
    """REDC without the correction on a 32-bit operand and a constant below
    p < 2^30: (a c + m p) / 2^32 < 2p, for ŷ at 2^31 - 1 and for a DIT value
    just below 4p."""
    pt = pallas_tables(16, (29, 29))
    ar = k5c._DifArith(pt.tables, True)
    p = torch.as_tensor(pt.primes, dtype=torch.int64).reshape(1, -1, 1)
    for a in ((1 << 31) - 1, int(4 * min(pt.primes) - 1), (1 << 32) - 1):
        out = ar.mul(torch.full((1, 2, 4), a, dtype=torch.int64), (p - 1).expand(1, 2, 4))
        assert bool((out < 2 * p).all()) and bool((out >= 0).all())


@pytest.mark.parametrize("logn", range(4, 16))
def test_k3_plan_and_chooser(logn):
    n = 1 << logn
    small, big = [2 ** 28 - 57, 2 ** 29 - 3], [2 ** 30 + 3, 2 ** 28 - 57]
    for dnum in (1, 2, 3, 4, 7):
        digits = k3c.legal_clusters(n, dnum)
        assert digits[0] == 1 and all(g <= dnum for g in digits)
        for g in digits:
            shares = [len(range(b, dnum, g)) for b in range(g)]
            assert sum(shares) == dnum and min(shares) >= 1
            plan = k3c.hybrid_ks_plan(logn, g)
            assert sum(plan["local"]) + plan["kf"] == logn and 1 <= plan["kf"] <= 3
            assert len(plan["local"]) + 1 == -(-logn // 3)           # passes a digit
            shape = k3c.block_shape(n, g)
            assert shape["threads"] == min(512, max(32, n // 8)) and shape["smem"] <= 232448
            assert shape["barriers"] <= min(6, logn) < logn + 2      # radix-2 stages: one a stage
            # a thread's 16 accumulators a channel cover the closing pass's items
            if n <= k3c.REG_ACC_MAX_N:
                assert (4 >> (plan["kf"] - 1)) * shape["threads"] >= n >> (plan["kf"] + 1)
        poly = k3c.legal_clusters(n, dnum, "poly")
        assert all(c > 1 and 8 <= n // c <= k3c.REG_ACC_MAX_N for c in poly)
        assert (2 in poly) == (logn <= 14) and (4 in poly) == (logn >= 5)
        for c in poly:
            plan = k3c.hybrid_ks_plan(logn, c, "poly")
            logc = c.bit_length() - 1
            assert sum(plan["local"]) + plan["kf"] == logn and max(logc, 1) <= plan["kf"] <= 3
            assert sum(plan["local"]) <= logn - logc                 # local passes stay in a block
            shape = k3c.block_shape(n, c, "poly")
            assert shape["smem"] == 4 * 2 * (n // c) and shape["barriers"] <= 6
        for pairs in (1, 11, 40, 44, 66, 67, 132, 133, 176, 1000):
            scheme, g, lazy = k3c.choose_cluster(pairs, n, dnum, small)
            assert lazy and g in k3c.legal_clusters(n, dnum, scheme)
            assert k3c.choose_cluster(pairs, n, dnum, big) == (scheme, g, False)
            if scheme == "digits":
                assert g <= dnum
                assert pairs * g <= k3c.BLOCK_CAP or g == (2 if dnum >= 2 and logn >= 13 else 1)
            elif pairs * g > k3c.BLOCK_CAP:                          # the launch fills the card
                assert dnum == 1 and logn >= 13 and g == min(k3c.legal_clusters(n, dnum, "poly"))
            else:                                                    # further than the digits go
                assert n // g >= 2048 and all(
                    pairs * h > k3c.BLOCK_CAP for h in digits if h >= g)
        assert k3c.scratch_words(44, n, 2, "digits") == (44 * 2 * 2 * n if logn == 15 else 0)
    with pytest.raises(ValueError):
        k3c.hybrid_ks_plan(logn, 8)
    with pytest.raises(ValueError):
        k3c.legal_clusters(n, 2, "rows")


def test_k3_chooser_at_the_serving_shapes_and_guards():
    """The MNIST gadget (44 pairs, 2 digits) and the dnum = 4 fixture (40
    pairs): two blocks a pair, one or two digits each; 16 rows fill the card
    with one block a pair."""
    primes = nt.ntt_prime_chain(8192, (28,) * 7 + (29,) * 4)
    assert k3c.choose_cluster(44, 8192, 2, primes) == ("digits", 2, True)
    assert k3c.choose_cluster(40, 8192, 4, primes) == ("digits", 2, True)
    assert k3c.choose_cluster(176, 8192, 2, primes) == ("digits", 2, True)      # 16 rows
    assert k3c.choose_cluster(176, 8192, 1, primes) == ("poly", 2, True)
    assert k3c.choose_cluster(176, 4096, 2, primes) == ("digits", 1, True)
    assert k3c.choose_cluster(28, 8192, 1, primes) == ("poly", 4, True)         # one digit group
    assert k3c.choose_cluster(44, 16384, 2, primes) == ("digits", 2, True)
    assert k3c.choose_cluster(176, 32768, 2, primes) == ("digits", 2, True)
    assert k3c.choose_cluster(176, 32768, 1, primes) == ("poly", 4, True)       # 2^14 a block: no
    fks = make_fks(32, HYBRID_CONFIGS[0], 1)
    pairs = fks.exp_ring.nlimbs
    assert k3c.cluster_args(fks, pairs) == (2, 1, 1, k3c.pack_plan((3,)), 2)
    assert k3c.cluster_args(fks, pairs, cluster=1) == (1, 1, 1, k3c.pack_plan((3,)), 2)
    assert k3c.cluster_args(fks, pairs, cluster=4, scheme="poly", lazy=False) == \
        (1, 4, 0, k3c.pack_plan((3,)), 2)
    assert k3c.cluster_args(fks, pairs, scheme="poly")[:2] == (1, 2)
    for kwargs in ({"cluster": 4}, {"cluster": 3}, {"cluster": 1, "scheme": "poly"},
                   {"cluster": 8, "scheme": "poly"}, {"scheme": "rows"}):
        with pytest.raises(ValueError):
            k3c.cluster_args(fks, pairs, **kwargs)
    full = make_fks(32, FULL_CONFIG, 1)
    with pytest.raises(ValueError):
        k3c.cluster_args(full, 6, lazy=True)                         # a 31-bit prime
    y = y_hat(fks, (), 0)
    before = dict(k3c.launches)
    for kwargs in ({}, {"cluster": 2}):
        with pytest.raises(ValueError):
            k3c.launch(fks, y, **kwargs)                             # a CPU tensor
    assert k3c.launches == before


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
@pytest.mark.parametrize("n", [16, 64, 1024, 8192])
def test_k5_schedule_matches_plain(n, tower):
    pt = pallas_tables(n, tower)
    lazy = tower is LAZY_TOWER
    a = lrn_residues(pt.primes, 3, n, n)
    want = tnp.ntt_bitrev_plain(pt, a)
    legal = k5c.legal_bitrev_clusters(n)
    assert legal == ((1, 2) if n == 16 else (1, 2, 4))
    for cluster in legal:
        got, seen = k5c.bitrev_schedule(pt, a, cluster)
        assert torch.equal(got, want), cluster
        assert seen < (4 if lazy else 2) * max(pt.primes) < 1 << 32
    if lazy:                                  # the fully reduced flag on a lazy tower
        got, seen = k5c.bitrev_schedule(pt, a, max(legal), lazy=False)
        assert torch.equal(got, want) and seen < 2 * max(pt.primes)
    else:
        with pytest.raises(ValueError):
            k5c.bitrev_schedule(pt, a, 1, lazy=True)
    with pytest.raises(ValueError):
        k5c.bitrev_schedule(pt, a, 8)


@pytest.mark.parametrize("n", [16, 1024, 8192])
def test_k5_schedule_lazy_range_on_the_worst_input(n):
    """Every residue p - 1: the lazy values stay below 2p after every
    butterfly (the difference fed to the REDC below 4p < 2^32), and the
    output is canonical and exact."""
    pt = pallas_tables(n, (29, 29, 28))
    a = torch.stack([torch.full((2, n), p - 1, dtype=torch.int64) for p in pt.primes])
    want = tnp.ntt_bitrev_plain(pt, a)
    for cluster in k5c.legal_bitrev_clusters(n):
        got, seen = k5c.bitrev_schedule(pt, a, cluster)
        assert max(pt.primes) <= seen < 4 * max(pt.primes) < 1 << 32
        assert torch.equal(got, want) and int(got.max()) < max(pt.primes)


@pytest.mark.parametrize("logn", range(4, 16))
def test_k5_plan_and_chooser(logn):
    n = 1 << logn
    small, big = [2 ** 28 - 57, 2 ** 29 - 3], [2 ** 30 + 3, 2 ** 28 - 57]
    legal = k5c.legal_bitrev_clusters(n)
    assert legal[0] == 1 and all(n // c >= 8 for c in legal) and (4 in legal) == (logn >= 5)
    for cluster in legal:
        plan = k5c.bitrev_plan(logn, cluster)
        logc = cluster.bit_length() - 1
        # cross stages + load pass + local passes + last pass cover every stage once
        assert logc + plan["kl"] + sum(plan["fwd"]) + k5c.MIDDLE == logn
        assert 0 <= plan["kl"] <= 3 and all(1 <= k <= 3 for k in plan["fwd"])
        assert (plan["kl"], plan["fwd"]) == k5c.forward_plan(logn - logc)
        shape = k5c.bitrev_block_shape(n, cluster)
        assert shape["threads"] == min(512, max(32, n // cluster // 8))
        assert shape["smem"] == 4 * n // cluster <= 232448
        assert shape["barriers"] == max(1, -(-(logn - logc - 3) // 3)) <= 4 < logn + 1
        # the load pass pairs neighbouring items: its stride stays above one word
        assert logn - logc - plan["kl"] >= 3
    with pytest.raises(ValueError):
        k5c.bitrev_plan(logn, 8)
    if logn < 5:
        with pytest.raises(ValueError):
            k5c.bitrev_plan(logn, 4)
    for polys in (1, 8, 28, 33, 34, 66, 67, 128, 132, 133, 1000):
        c, lazy = k5c.choose_bitrev_cluster(polys, n, small)
        assert lazy and c in legal and (polys * c <= k5c.BLOCK_CAP or c == 1)
        if c > 1:
            assert n // c >= k5c.MIN_CHOSEN_BLOCK_N
        assert k5c.choose_bitrev_cluster(polys, n, big) == (c, False)


def test_k5_chooser_at_the_measured_shapes_and_guards():
    small = [2 ** 28 - 57, 2 ** 29 - 3]
    assert k5c.choose_bitrev_cluster(8, 8192, small) == (4, True)        # the windowed rotation
    assert k5c.choose_bitrev_cluster(28, 8192, small) == (4, True)
    assert k5c.choose_bitrev_cluster(128, 16384, small) == (1, True)     # fills the card alone
    assert k5c.choose_bitrev_cluster(8, 32768, small) == (4, True)
    assert k5c.choose_bitrev_cluster(8, 2048, small) == (1, True)
    pt = pallas_tables(64, FULL_TOWER)
    with pytest.raises(ValueError):
        k5c.bitrev_args(pt, 4, lazy=True)                                # a 31-bit prime
    with pytest.raises(ValueError):
        k5c.bitrev_args(pt, 4, cluster=8)
    assert k5c.bitrev_args(pt, 4, cluster=4) == (4, 0, 1, 0)
    assert k5c.bitrev_args(pallas_tables(8192, LAZY_TOWER), 8) == (4, 1, 2, k5c.pack_plan((3, 3)))
    a = torch.zeros((2, 3, 64), dtype=torch.int64)
    before = dict(k5c.launches)
    for kwargs in ({}, {"cluster": 2}, {"row_major": True}):
        with pytest.raises(ValueError):
            k5c.launch(pt, a, **kwargs)                                  # a CPU tensor
    assert k5c.launches == before


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_bitrev_rows_keeps_the_row_major_layout(lead):
    """``ntt_bitrev_rows`` of [..., L, N] equals the limb-major transform of
    the same polynomials, put back where they lay."""
    pt = pallas_tables(64, LAZY_TOWER)
    rng = np.random.default_rng(len(lead))
    x = I.tensor(np.stack([rng.integers(0, p, lead + (64,)) for p in pt.primes], -2), "cpu")
    got = tnp.ntt_bitrev_rows(pt, x)
    rows = x.reshape(-1, pt.L, 64)
    want = torch.stack([tnp.ntt_bitrev_plain(pt, r[:, None])[:, 0] for r in rows])
    assert got.shape == x.shape and torch.equal(got.reshape(-1, pt.L, 64), want)
    with pytest.raises(ValueError):
        tnp.ntt_bitrev_rows(pt, x.to("meta"))


def test_fused_windowed_keyswitch_still_equals_the_unfused_one():
    """``_modraise_keyswitch_fused`` hands K5 the row-major batch as it is."""
    n, tower, window = 64, (28, 28, 29), 8
    params = T.ModulusRaised(T.CKKSParams(T.make_rns_ring(n, tower), window, 3.2))
    gen = torch.Generator(device="cpu").manual_seed(5)
    kp = T.keygen(params, gen)
    gk = T.keygen_galois(gen, kp.priv, steps=1)
    ka = TL.build_modraise_key_arrays(params, gk.key)
    fk = TL.build_fused_keyswitch(ka)
    rng = np.random.default_rng(5)
    primes = params.ring_cipher.primes
    for lead in ((), (3,)):
        c1p, c2p = (I.tensor(np.stack([rng.integers(0, p, lead + (n,)) for p in primes], -2),
                             "cpu") for _ in range(2))
        fused = TL._modraise_keyswitch_fused(ka, fk, c1p, c2p)
        unfused = TL._modraise_keyswitch(ka, c1p, c2p)
        assert all(torch.equal(f, u) for f, u in zip(fused, unfused))


# ---------------------------------------------------------------------------
# the experiments tool and the build log
# ---------------------------------------------------------------------------

def test_k3_experiment_patches_still_apply():
    """Every source variant of ``tools.k3_experiments`` finds the text it
    replaces in ``csrc/hybrid_ks.cu``, changes it, and builds under a stem of
    its own beside the original; the tool refuses to run without a card."""
    from toyfhe_tpu_torch.ops import cuda_lib
    from toyfhe_tpu_torch.tools import k3_experiments as kx

    original = k3c.LIB.source.read_text()
    assert set(kx.KNOCK_OUTS) < set(kx.PATCHES)
    texts = {name: kx.patched_source(name) for name in kx.PATCHES}
    assert all(text != original for text in texts.values())
    assert len(set(texts.values())) == len(texts)
    kx.PATCHES["stale"] = (("no such text in the source", ""),)
    try:
        with pytest.raises(ValueError):
            kx.patched_source("stale")
    finally:
        del kx.PATCHES["stale"]
    assert all(lt is None or lt < gadget[3] for _, gadget, _, _, lt in kx.SHAPES)
    assert all(sum(local) + kf == 13 for local, kf in kx.PLANS)
    lib = cuda_lib.CudaLibrary("hybrid_ks_variant", {}, source=k3c.LIB.source)
    assert lib.source == k3c.LIB.source and lib.library.name == "libtoyfhe_hybrid_ks_variant.so"
    with pytest.raises(SystemExit):
        kx.main(["timings"])                                       # no such experiment
    if not torch.cuda.is_available():
        for argv in ([], ["shapes"], ["plans", "patches"]):
            with pytest.raises(SystemExit, match="no CUDA device"):
                kx.main(argv)


def test_spill_bytes_reads_the_build_log():
    from toyfhe_tpu_torch.ops import cuda_lib

    lib = cuda_lib.CudaLibrary("hybrid_ks", {})
    assert lib.spill_bytes("anything") is None                    # not built by this process
    lib.build_info["log"] = "\n".join([
        "ptxas info    : Compiling entry function '_Z6kernelILi3ELb1EEv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z6kernelILi3ELb1EEv",
        "    80 bytes stack frame, 192 bytes spill stores, 184 bytes spill loads",
        "ptxas info    : Used 128 registers",
        "ptxas info    : Compiling entry function '_Z6kernelILi1ELb1EEv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z6kernelILi1ELb1EEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"])
    assert lib.spill_bytes("kernelILi3ELb1EE") == 192
    assert lib.spill_bytes("kernelILi1ELb1EE") == 0
    assert lib.spill_bytes("kernelILi2ELb1EE") is None


# ---------------------------------------------------------------------------
# the kernels on a CUDA device
# ---------------------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(), (4,)], ids=["nolead", "lead4"])
@pytest.mark.parametrize("config", HYBRID_CONFIGS + (FULL_CONFIG,), ids=lambda c: c[0])
@pytest.mark.parametrize("n", [16, 256, 8192, 1 << 14, 1 << 15])
def test_cuda_k3_matches_plain_at_every_launch_shape(n, config, lead):
    dev = cuda_device()
    fks = make_fks(n, config, n, dev)
    y = y_hat(fks, lead, n, dev)
    want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
    lazy_ok = max(fks.exp_ring.primes) < k3c.LAZY_PRIME_LIMIT
    before = k3c.launches["k3"]
    outs = [fks(y)]
    for scheme, g in k3_variants(fks):
        for lazy in ((False, True) if lazy_ok else (False,)):
            outs.append(k3c.launch(fks, y, cluster=g, scheme=scheme, lazy=lazy))
    torch.cuda.synchronize()
    assert all(torch.equal(g1, want[0]) and torch.equal(g2, want[1]) for g1, g2 in outs)
    assert k3c.launches["k3"] == before + len(outs)
    with pytest.raises(ValueError):
        k3c.launch(fks, y, cluster=8)


@pytest.mark.cuda
@pytest.mark.parametrize("tower", [LAZY_TOWER, FULL_TOWER], ids=["lazy", "full"])
@pytest.mark.parametrize("n", [16, 64, 1024, 8192, 1 << 14, 1 << 15])
def test_cuda_k5_matches_plain_at_every_launch_shape(n, tower):
    dev = cuda_device()
    pt = pallas_tables(n, tower)
    a = lrn_residues(pt.primes, 5, n, n).to(dev)
    want = tnp.ntt_bitrev_plain(pt, a)
    before = k5c.launches["k5"]
    outs = [tnp.ntt_pallas_bitrev(pt, a),
            tnp.ntt_bitrev_rows(pt, a.transpose(0, 1).contiguous()).transpose(0, 1)]
    for cluster in k5c.legal_bitrev_clusters(n):
        for lazy in ((False, True) if tower is LAZY_TOWER else (False,)):
            outs.append(k5c.launch(pt, a, cluster=cluster, lazy=lazy))
    torch.cuda.synchronize()
    assert all(torch.equal(got, want) for got in outs)
    assert k5c.launches["k5"] == before + len(outs)
    with pytest.raises(ValueError):
        k5c.launch(pt, a, cluster=8)
