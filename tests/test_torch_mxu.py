"""toyfhe_tpu_torch four-step digit transform (K2) against the reference.

``MxuNttTables`` array for array equal to the reference's over several N
and stage-1 edges; ``ntt_mxu`` / ``intt_mxu`` bit-equal to the reference's
and to the port's radix-2 transform; K2's plain twin bit-equal to the
reference's ``ntt_mxu_pallas`` in the Pallas interpreter in both
recombination modes; the tensor-core kernel's operand layouts and the numpy
emulation of its ``mma`` fragment walk bit-equal to the twin's digit dots, to
the twin and to the reference in the Pallas interpreter; and, on a CUDA
device, the hand-written kernel bit-equal to its twin.

The reference is imported inside the ``ref`` fixture, so the ``cuda`` tests
run on a host that has torch but no jax (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.ops import ntt_mxu as tmxu
from toyfhe_tpu_torch.ops import ntt_mxu_pallas as tmxp
from toyfhe_tpu_torch.ops import ntt_mxu_pallas_cuda
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

TABLE_FIELDS = ("w1", "w1i", "w2", "w2i", "tw", "twi", "cs", "corr", "r1_mont", "hi_mont",
                "cs32", "cs48", "corr2", "psi_pow", "psi_ipow")


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp

    from toyfhe_tpu.ops import ntt as ref_ntt
    from toyfhe_tpu.ops import ntt_mxu as ref_mxu
    from toyfhe_tpu.ops import ntt_mxu_pallas as ref_mxp
    return jnp, ref_ntt, ref_mxu, ref_mxp


def lrn_residues(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, (rows, n)) for p in primes]).astype(np.uint32)


@pytest.mark.parametrize("n, n1", [(256, 2), (256, 8), (256, 64), (256, 128), (1024, 8),
                                   (1024, 128), (4096, 64), (4096, 128)])
def test_tables_match_reference(ref, n, n1):
    _, ref_ntt, ref_mxu, _ = ref
    primes = nt.ntt_prime_chain(n, (29, 28))
    want = ref_mxu.MxuNttTables(ref_ntt.NttTables(n, primes), n1=n1)
    got = tmxu.MxuNttTables(tntt.NttTables(n, primes), n1=n1)
    assert (got.n, got.n1, got.n2) == (want.n, want.n1, want.n2) == (n, n1, n // n1)
    for name in TABLE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.paired_ok == want.paired_ok and got.paired_ok


@pytest.mark.parametrize("n", [128, 256, 4096, 8192, 16384, 32768])
def test_lane_optimal_n1(ref, n):
    assert tmxu.lane_optimal_n1(n) == ref[2].lane_optimal_n1(n)


def test_tables_reject_what_the_digits_cannot_hold():
    with pytest.raises(ValueError):
        tmxu.MxuNttTables(tntt.NttTables(256, nt.ntt_prime_chain(256, (30,))))
    with pytest.raises(ValueError):
        tmxu.MxuNttTables(tntt.NttTables(256, nt.ntt_prime_chain(256, (28,))), n1=96)


def test_row_view_matches_own_tables(ref):
    _, ref_ntt, ref_mxu, _ = ref
    n, rows = 256, (0, 1, 3)
    primes = nt.ntt_prime_chain(n, (28, 29, 28, 29, 28))
    root = tmxu.MxuNttTables(tntt.NttTables(n, primes))
    view = tmxu.MxuRowView(root, rows)
    own = tmxu.MxuNttTables(tntt.NttTables(n, [primes[i] for i in rows]))
    want = ref_mxu.MxuRowView(ref_mxu.MxuNttTables(ref_ntt.NttTables(n, primes)), rows)
    assert view.primes == own.primes == want.primes and view.paired_ok
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(view, name), getattr(own, name), err_msg=name)
        np.testing.assert_array_equal(getattr(view, name), getattr(want, name), err_msg=name)
    x = I.tensor(lrn_residues(own.primes, 2, n, 3).transpose(1, 0, 2), "cpu")
    assert torch.equal(tmxu.ntt_mxu(view, x), tmxu.ntt_mxu(own, x))
    assert torch.equal(tmxu.intt_mxu(view, x), tmxu.intt_mxu(own, x))


@pytest.mark.parametrize("n1", [2, 8, 64, 128])
def test_four_step_matches_reference_and_radix2(ref, n1):
    jnp, ref_ntt, ref_mxu, _ = ref
    n = 256
    primes = nt.ntt_prime_chain(n, (29, 28))
    t, rt = tntt.NttTables(n, primes), ref_ntt.NttTables(n, primes)
    mt, rmt = tmxu.MxuNttTables(t, n1=n1), ref_mxu.MxuNttTables(rt, n1=n1)
    a = lrn_residues(primes, 8, n, 0).transpose(1, 0, 2)              # [R, L, N]
    x = I.tensor(a, "cpu")
    fwd, inv = tmxu.ntt_mxu(mt, x), tmxu.intt_mxu(mt, x)
    np.testing.assert_array_equal(I.to_numpy(fwd), np.asarray(ref_mxu.ntt_mxu(rmt, jnp.asarray(a))))
    np.testing.assert_array_equal(I.to_numpy(inv), np.asarray(ref_mxu.intt_mxu(rmt, jnp.asarray(a))))
    assert torch.equal(fwd, tntt.ntt_plain(t, x)) and torch.equal(inv, tntt.intt_plain(t, x))
    assert torch.equal(tmxu.intt_mxu(mt, fwd), x)
    # no lead axis and two lead axes
    assert torch.equal(tmxu.ntt_mxu(mt, x[0]), fwd[0])
    assert torch.equal(tmxu.ntt_mxu(mt, x.reshape(2, 4, len(primes), n)).reshape(x.shape), fwd)


def test_balanced_digits(ref):
    jnp, _, ref_mxu, _ = ref
    v = np.random.default_rng(5).integers(0, 2 ** 30, 4096).astype(np.uint32)
    got = tmxu._balanced_digits_device(I.tensor(v, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_mxu._balanced_digits_device(
        jnp.asarray(v))).astype(np.int64))
    assert int(got.min()) >= -128 and int(got.max()) <= 127
    assert torch.equal(sum(got[d] << (8 * d) for d in range(4)), I.tensor(v, "cpu"))


@pytest.mark.parametrize("paired", [False, True, None])
def test_k2_plain_twin_matches_reference_interpreter(ref, paired):
    """The fixture of tests/test_ntt_pallas.py (N=256, two primes, 8 rows)."""
    jnp, ref_ntt, ref_mxu, ref_mxp = ref
    n, R = 256, 8
    primes = nt.ntt_prime_chain(n, (29, 28))
    t, rt = tntt.NttTables(n, primes), ref_ntt.NttTables(n, primes)
    mt, rmt = tmxu.MxuNttTables(t), ref_mxu.MxuNttTables(rt)
    a = lrn_residues(primes, R, n, 0)
    xm = a.reshape(len(primes), R, 128, mt.n2)
    psis = np.asarray(rmt.psi_pow).reshape(len(primes), 128, mt.n2)
    want = np.asarray(ref_mxp.ntt_mxu_pallas(rmt, jnp.asarray(xm), jnp.asarray(psis), True, paired))
    got = tmxp.ntt_mxu_pallas_plain(mt, I.tensor(xm, "cpu"), I.tensor(psis, "cpu"), paired)
    np.testing.assert_array_equal(I.to_numpy(got), want)
    # the dispatching entry point takes the twin on the CPU and counts no launch
    before = dict(ntt_mxu_pallas_cuda.launches)
    assert torch.equal(tmxp.ntt_mxu_pallas(mt, I.tensor(xm, "cpu"), I.tensor(psis, "cpu"), paired), got)
    assert ntt_mxu_pallas_cuda.launches == before
    nat = tmxp.ntt_mxu_pallas_natural(mt, I.tensor(a, "cpu"))
    np.testing.assert_array_equal(
        I.to_numpy(nat), np.asarray(ref_mxp.ntt_mxu_pallas_natural(rmt, jnp.asarray(a), True)))
    assert torch.equal(nat.transpose(0, 1), tntt.ntt_plain(t, I.tensor(a, "cpu").transpose(0, 1)))


@pytest.mark.parametrize("n", [128, 512, 2048])
def test_k2_plain_twin_other_sizes(n):
    primes = nt.ntt_prime_chain(n, (28, 29, 28))
    t = tntt.NttTables(n, primes)
    mt = tmxu.MxuNttTables(t)
    a = I.tensor(lrn_residues(primes, 3, n, n), "cpu")
    want = tntt.ntt_plain(t, a.transpose(0, 1)).transpose(0, 1)
    x, psis = a.reshape(3, 3, 128, mt.n2), tmxp.psi_table(mt, "cpu")
    for paired in (False, True):
        got = tmxp.ntt_mxu_pallas_plain(mt, x, psis, paired)
        assert torch.equal(got.transpose(-1, -2).reshape(a.shape), want)


def test_k2_guards():
    n = 256
    primes = nt.ntt_prime_chain(n, (28, 28))
    t = tntt.NttTables(n, primes)
    mt = tmxu.MxuNttTables(t)
    x, psis = torch.zeros((2, 1, 128, 2), dtype=torch.int64), tmxp.psi_table(mt, "cpu")
    with pytest.raises(ValueError):
        tmxp.ntt_mxu_pallas(tmxu.MxuNttTables(t, n1=64), x, psis)
    with pytest.raises(ValueError):
        tmxp.ntt_mxu_pallas(mt, x.reshape(2, 1, 2, 128), psis)
    with pytest.raises(TypeError):
        tmxp.ntt_mxu_pallas(mt, x.to(torch.int32), psis)
    mt.paired_ok = False
    with pytest.raises(ValueError):
        tmxp.ntt_mxu_pallas(mt, x, psis, True)
    assert torch.equal(tmxp.ntt_mxu_pallas(mt, x, psis), x)          # None -> 7-term
    before = dict(ntt_mxu_pallas_cuda.launches)
    with pytest.raises(ValueError):
        ntt_mxu_pallas_cuda.launch(mt, x, psis, False)                  # CPU tensors
    assert ntt_mxu_pallas_cuda.launches == before
    assert ntt_mxu_pallas_cuda.contraction_pad(2) == 32     # whole mma steps
    assert ntt_mxu_pallas_cuda.contraction_pad(128) == 128


K2C = ntt_mxu_pallas_cuda


def _k2_fixture(n2, rows=2, tower=(29, 28)):
    n = 128 * n2
    primes = nt.ntt_prime_chain(n, tower)
    t = tntt.NttTables(n, primes)
    mt = tmxu.MxuNttTables(t)
    a = lrn_residues(primes, rows, n, n2)
    return t, mt, a, a.reshape(len(primes), rows, 128, n2)


@pytest.mark.parametrize("n2", [2, 8, 32, 128])
def test_k2_operand_layouts(n2):
    """W and the data planes as the fragment loads read them: one row per
    output index, the contraction index contiguous, rows padded so that the
    8 rows x 4 words of a fragment load fall into 32 banks, zeros beyond the
    matrix; everything fits one block's shared memory."""
    _, mt, _, _ = _k2_fixture(n2, rows=1)
    n2p, k2p = K2C.output_pad(n2), K2C.contraction_pad(n2)
    assert n2p % K2C.TILE == 0 and k2p % K2C.K_STEP == 0 and n2p >= n2 and k2p >= n2
    w1, w2 = K2C.w_planes(mt.w1, 128, 128), K2C.w_planes(mt.w2, n2p, k2p)
    assert w1.shape == (2, 4, 128, 128 + K2C.ROW_PAD) and w2.shape == (2, 4, n2p, k2p + K2C.ROW_PAD)
    np.testing.assert_array_equal(w1[..., :128], mt.w1.transpose(0, 1, 3, 2))
    np.testing.assert_array_equal(w2[:, :, :n2, :n2], mt.w2.transpose(0, 1, 3, 2))
    assert not w1[..., 128:].any() and not w2[:, :, n2:].any() and not w2[..., n2:].any()
    for stride in (w1.shape[-1], w2.shape[-1]):
        words = {(g * stride // 4 + tig) % 32 for g in range(8) for tig in range(4)}
        assert stride % 16 == 0 and len(words) == 32
    dig = np.arange(4 * 128 * n2).reshape(4, 128, n2).astype(np.int8)
    pa, pb = K2C.stage1_planes(dig, n2), K2C.stage2_planes(dig, n2)
    np.testing.assert_array_equal(pa[:, :n2, :128], dig.transpose(0, 2, 1))
    np.testing.assert_array_equal(pb[:, :, :n2], dig)
    assert pa.shape == (4, n2p, 144) and pb.shape == (4, 128, k2p + 16)
    assert K2C.block_smem(n2) == w1[0].nbytes + pa.nbytes + pb.nbytes <= 232448
    assert w2[0].nbytes <= pa.nbytes                   # W2 is copied over the stage-1 planes
    assert K2C.rows_per_block(8, 16) == 1 and K2C.rows_per_block(8, 64) == 4
    assert K2C.rows_per_block(3, 1) == 1


def test_k2_mma_emulation_is_a_matrix_product():
    """The fragment layout: lanes' registers in, D = A·B out."""
    rng = np.random.default_rng(7)
    A = rng.integers(-128, 128, (16, 64)).astype(np.int8)
    B = rng.integers(-128, 128, (8, 64)).astype(np.int8)      # [n, k], k contiguous
    c = np.zeros((32, 4), dtype=np.int64)
    for k0 in (0, 32):
        c = K2C.mma_m16n8k32(c, K2C.a_fragment(A, 0, k0), K2C.b_fragment(B, 0, k0))
    D = A.astype(np.int64) @ B.astype(np.int64).T
    lane = np.arange(32)
    for i in range(4):
        np.testing.assert_array_equal(c[:, i], D[(lane >> 2) + 8 * (i >> 1),
                                                 2 * (lane & 3) + (i & 1)])


@pytest.mark.parametrize("n2", [2, 8, 32])
def test_k2_tile_groups_match_the_twins_digit_dots(n2):
    """One warp tile of each stage through the fragment walk == the 7
    diagonal sums of the twin's 16 digit dots."""
    _, mt, _, xm = _k2_fixture(n2, rows=1)
    l = 1
    dig = tmxu._balanced_digits_device(I.tensor(xm[l, 0], "cpu"))            # [4, 128, n2]
    w1, w2 = I.tensor(mt.w1[l], "cpu"), I.tensor(mt.w2[l], "cpu")            # [4, K, J]
    s1 = [sum(tmxu.digit_dot("kj,kc->jc", w1[d], dig[s - d])
              for d in range(4) if 0 <= s - d < 4) for s in range(7)]
    s2 = [sum(tmxu.digit_dot("kj,ck->cj", w2[d], dig[s - d])
              for d in range(4) if 0 <= s - d < 4) for s in range(7)]
    planes = dig.numpy().astype(np.int8)
    n2p, k2p = K2C.output_pad(n2), K2C.contraction_pad(n2)
    m0 = 48
    got1 = K2C.tile_groups(K2C.w_planes(mt.w1, 128, 128)[l], K2C.stage1_planes(planes, n2),
                           m0, 0, 128)
    got2 = K2C.tile_groups(K2C.stage2_planes(planes, n2), K2C.w_planes(mt.w2, n2p, k2p)[l],
                           m0, 0, k2p)
    cols = min(n2, 16)
    for s in range(7):
        np.testing.assert_array_equal(got1[s][:, :cols], s1[s].numpy()[m0:m0 + 16, :cols])
        np.testing.assert_array_equal(got2[s][:, :cols], s2[s].numpy()[m0:m0 + 16, :cols])
        assert not got1[s][:, cols:].any() and not got2[s][:, cols:].any()
    assert max(int(np.abs(g).max()) for g in (got1, got2)) < 1 << 23


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("n2", [2, 8, 32])
def test_k2_fragment_walk_matches_twin_and_interpreter(ref, n2, paired):
    """The kernel's whole data flow in numpy (layouts, fragment walk, both
    stages) == the plain twin == the reference's kernel in the Pallas
    interpreter == the radix-2 transform."""
    jnp, ref_ntt, ref_mxu, ref_mxp = ref
    t, mt, a, xm = _k2_fixture(n2)
    psis = tmxp.psi_table(mt, "cpu")
    got = K2C.ntt_mxu_fragments(mt, I.tensor(xm, "cpu"), psis, paired)
    assert torch.equal(got, tmxp.ntt_mxu_pallas_plain(mt, I.tensor(xm, "cpu"), psis, paired))
    rmt = ref_mxu.MxuNttTables(ref_ntt.NttTables(t.n, t.primes))
    rpsis = np.asarray(rmt.psi_pow).reshape(len(t.primes), 128, n2)
    want = np.asarray(ref_mxp.ntt_mxu_pallas(rmt, jnp.asarray(xm), jnp.asarray(rpsis), True, paired))
    np.testing.assert_array_equal(I.to_numpy(got), want)
    nat = got.transpose(-1, -2).reshape(a.shape).transpose(0, 1)
    assert torch.equal(nat, tntt.ntt_plain(t, I.tensor(a, "cpu").transpose(0, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096, 8192, 16384])
def test_cuda_k2_matches_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    primes = nt.ntt_prime_chain(n, (29, 28, 28))
    t = tntt.NttTables(n, primes)
    mt = tmxu.MxuNttTables(t)
    a = I.tensor(lrn_residues(primes, 4, n, n), dev)
    x, psis = a.reshape(3, 4, 128, mt.n2), tmxp.psi_table(mt, dev)
    before = ntt_mxu_pallas_cuda.launches["k2"]
    for paired in (False, True):
        got = tmxp.ntt_mxu_pallas(mt, x, psis, paired)
        torch.cuda.synchronize()
        assert torch.equal(got, tmxp.ntt_mxu_pallas_plain(mt, x, psis, paired))
    assert ntt_mxu_pallas_cuda.launches["k2"] == before + 2
    assert torch.equal(tmxp.ntt_mxu_pallas_natural(mt, a).transpose(0, 1),
                       tntt.ntt(t, a.transpose(0, 1)))
    with pytest.raises(TypeError):
        ntt_mxu_pallas_cuda.launch(mt, x.to(torch.int32), psis, False)
    with pytest.raises(ValueError):
        ntt_mxu_pallas_cuda.launch(mt, x.transpose(0, 1), psis, False)
