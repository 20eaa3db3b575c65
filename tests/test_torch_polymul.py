"""toyfhe_tpu_torch fused polynomial product (K4) against the reference.

K4's plain twin bit-equal to the reference's ``polymul_pallas`` in the
Pallas interpreter at N = 256, to the O(N²) schoolbook product at small N,
and to ``intt(mul_mod(ntt, ntt))`` of both packages; and, on a CUDA device,
the hand-written kernels (the cluster kernel as dispatched and both
shared-memory variants of the one-block radix-2 kernel) bit-equal to the
twin. The cluster kernel's schedule twin is in
tests/test_torch_k4_k6_schedule.py.

The reference is imported inside the ``ref`` fixture, so the ``cuda`` tests
run on a host that has torch but no jax (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from toyfhe_tpu_torch.ops import modmath as tmm
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.ops import ntt_pallas as tnp
from toyfhe_tpu_torch.ops import ntt_pallas_cuda
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp

    from toyfhe_tpu.ops import modmath as ref_mm
    from toyfhe_tpu.ops import ntt as ref_ntt
    from toyfhe_tpu.ops import ntt_pallas as ref_np
    return jnp, ref_mm, ref_ntt, ref_np


def lrn_residues(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, (rows, n)) for p in primes]).astype(np.uint32)


def unfused(t, a, b):
    """intt(mul_mod(ntt(a), ntt(b))) on [L, R, N] operands through the
    [R, L, N] transforms."""
    at, bt = a.transpose(0, 1), b.transpose(0, 1)
    return tntt.intt(t, tmm.mul_mod(tntt.ntt(t, at), tntt.ntt(t, bt), t.mp)).transpose(0, 1)


def test_k4_plain_twin_matches_reference_interpreter(ref):
    """The fixture of tests/test_ntt_pallas.py (N=256, two primes, 8 rows)."""
    jnp, ref_mm, ref_ntt, ref_np = ref
    n, R = 256, 8
    primes = nt.ntt_prime_chain(n, (29, 28))
    t, rt = tntt.NttTables(n, primes), ref_ntt.NttTables(n, primes)
    pt, rpt = tnp.PallasNttTables(t), ref_np.PallasNttTables(rt)
    a, b = lrn_residues(primes, R, n, 0), lrn_residues(primes, R, n, 1)
    want = np.asarray(ref_np.polymul_pallas(rpt, jnp.asarray(a), jnp.asarray(b), 8, True))
    got = tnp.polymul_plain(pt, I.tensor(a, "cpu"), I.tensor(b, "cpu"))
    np.testing.assert_array_equal(I.to_numpy(got), want)
    at, bt = jnp.asarray(a.transpose(1, 0, 2)), jnp.asarray(b.transpose(1, 0, 2))
    xla = np.asarray(ref_ntt.intt(rt, ref_mm.mul_mod(ref_ntt.ntt(rt, at), ref_ntt.ntt(rt, bt),
                                                     rt.mp))).transpose(1, 0, 2)
    np.testing.assert_array_equal(I.to_numpy(got), xla)
    assert torch.equal(got, unfused(t, I.tensor(a, "cpu"), I.tensor(b, "cpu")))
    # the dispatching entry points take the twin on the CPU and count no launch
    before = dict(ntt_pallas_cuda.polymul_launches)
    assert torch.equal(tnp.polymul_pallas_raw(pt, I.tensor(a, "cpu"), I.tensor(b, "cpu")), got)
    assert torch.equal(tnp.polymul_pallas(pt, I.tensor(a, "cpu"), I.tensor(b, "cpu")), got)
    assert ntt_pallas_cuda.polymul_launches == before


@pytest.mark.parametrize("n, tower", [(16, (30, 28)), (64, (29, 28, 28))])
def test_k4_plain_twin_matches_schoolbook(ref, n, tower):
    primes = nt.ntt_prime_chain(n, tower)
    pt = tnp.PallasNttTables(tntt.NttTables(n, primes))
    a, b = lrn_residues(primes, 3, n, n), lrn_residues(primes, 3, n, n + 1)
    got = tnp.polymul_plain(pt, I.tensor(a, "cpu"), I.tensor(b, "cpu")).numpy()
    for l, p in enumerate(primes):
        for r in range(3):
            want = tntt.naive_negacyclic_mul(a[l, r], b[l, r], p)
            np.testing.assert_array_equal(got[l, r], want)
            np.testing.assert_array_equal(
                want, ref[2].naive_negacyclic_mul(a[l, r], b[l, r], p).astype(np.int64))


@pytest.mark.parametrize("n", [32, 1024, 4096])
def test_k4_plain_twin_matches_unfused(n):
    primes = nt.ntt_prime_chain(n, (30, 29, 28))
    t = tntt.NttTables(n, primes)
    pt = tnp.PallasNttTables(t)
    a, b = I.tensor(lrn_residues(primes, 2, n, 7), "cpu"), I.tensor(lrn_residues(primes, 2, n, 8), "cpu")
    got = tnp.polymul_plain(pt, a, b)
    assert torch.equal(got, unfused(t, a, b))
    assert torch.equal(got, tnp.polymul_plain(pt, b, a))
    one = torch.zeros_like(a)
    one[..., 0] = 1
    assert torch.equal(tnp.polymul_plain(pt, a, one), a)


def test_k4_guards():
    n = 64
    primes = nt.ntt_prime_chain(n, (28, 28))
    pt = tnp.PallasNttTables(tntt.NttTables(n, primes))
    a = torch.zeros((2, 3, n), dtype=torch.int64)
    with pytest.raises(ValueError):
        tnp.polymul_pallas_raw(pt, a, a[:, :2])
    with pytest.raises(ValueError):
        tnp.polymul_pallas_raw(pt, a[:1], a[:1])
    with pytest.raises(TypeError):
        tnp.polymul_pallas_raw(pt, a.to(torch.int32), a.to(torch.int32))
    before = dict(ntt_pallas_cuda.polymul_launches)
    with pytest.raises(ValueError):
        ntt_pallas_cuda.launch_polymul(pt, a, a)                        # CPU tensors
    assert ntt_pallas_cuda.polymul_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 8192, 16384, 32768])
def test_cuda_k4_matches_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    primes = nt.ntt_prime_chain(n, (30, 28, 28))
    t = tntt.NttTables(n, primes)
    pt = tnp.PallasNttTables(t)
    a, b = I.tensor(lrn_residues(primes, 4, n, 1), dev), I.tensor(lrn_residues(primes, 4, n, 2), dev)
    want = tnp.polymul_plain(pt, a, b)
    before = ntt_pallas_cuda.polymul_launches["k4"]
    got = tnp.polymul_pallas_raw(pt, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, unfused(t, a, b))
    assert ntt_pallas_cuda.polymul_launches["k4"] == before + 1
    with pytest.raises(ValueError):
        ntt_pallas_cuda.launch_polymul(pt, a.transpose(0, 1), b.transpose(0, 1))
