"""toyfhe_tpu_torch fast base conversion (the hybrid key switch's ModUp).

``ops/fbc_cuda.py``: the plain twin, reached through both call sites (the
engine's ``HybridRaised.hybrid_decompose`` and its dual, and the compiled
layers' ``layers._hybrid_digits``), against a Python big-integer FBC,
Σ_a ŷ_a·[Q_j/q_a]_{p_t} mod p_t with ŷ_a = x_a·[(Q_j/q_a)⁻¹]_{q_a} mod q_a,
computed from the primes alone; a plan restricted to a subset of the
target rows, as a rank of a limb-sharded tower holds them; the kernel's
schedule twin (lazy Montgomery products summed in 64 bits, one reduction)
bit-equal and inside its value bounds at primes just under 2^31. Tolerance:
none, integers bit-equal. On a CUDA device the kernel is held to the plain
twin in every output layout.

Nothing here imports the reference, so the ``cuda`` test runs on a host
that has torch but no jax (``pytest --noconftest -m cuda``).
"""

import math

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.ops import fbc_cuda, modmath
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.utils import interop as I
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

N = 32

# (name, tower bits, dnum, num_special, ct limbs decomposed): alpha 1, 5, 6
# with a short last group, 7 in one group, and 10 (two chunks of the kernel)
TOWERS = (
    ("alpha1", (28,) * 4 + (30,), 4, 1, 4),
    ("alpha5", (28,) * 10 + (29,) * 6, 2, 6, 10),
    ("alpha6_short", (28,) * 11 + (29,) * 7, 2, 7, 11),
    ("alpha7", (28,) * 7 + (29,) * 8, 1, 8, 7),
    ("alpha5_drop", (28,) * 10 + (29,) * 6, 2, 6, 8),
)
LEADS = ((), (4,), (2, 3))


def make_params(tower, dnum, k):
    return T.HybridRaised(T.CKKSParams(T.make_rns_ring(N, tower), 0, 3.2), dnum, k)


def bigint_fbc(params, lt, x):
    """The digits [dnum_t, ..., T, N] of x [..., lt, N] (numpy int64) from the
    primes alone, in Python integers."""
    full = params.ring_cipher
    qs = full.primes[:lt]
    tgt = qs + params.ring_key.primes[params.L:]
    lead = x.shape[:-2]
    flat = x.reshape(-1, lt, x.shape[-1])
    out = []
    for j in range(params.dnum):
        lo, hi = j * params.alpha, min((j + 1) * params.alpha, lt)
        if lo >= hi:
            break
        qj = math.prod(qs[lo:hi])
        hat = [qj // q for q in qs[lo:hi]]
        yhat = [[[int(v) * pow(h % q, -1, q) % q for v in row[lo + a]]
                 for a, (h, q) in enumerate(zip(hat, qs[lo:hi]))] for row in flat]
        dig = np.array([[[sum(yh[a][i] * (hat[a] % p) for a in range(hi - lo)) % p
                          for i in range(x.shape[-1])] for p in tgt] for yh in yhat],
                       dtype=np.int64)
        out.append(dig.reshape(lead + (len(tgt), x.shape[-1])))
    return np.stack(out, 0)


def random_primal(primes, lead, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, lead + (N,)) for p in primes], axis=-2).astype(np.int64)


def synthetic_key(params, seed):
    key_ring = params.ring_key
    rng = np.random.default_rng(seed)
    shape = (params.dnum, key_ring.nlimbs, key_ring.n)
    lim = min(key_ring.primes)
    return I.eval_mult_key(params, rng.integers(0, lim, shape), rng.integers(0, lim, shape),
                           device="cpu")


@pytest.mark.parametrize("lead", LEADS, ids=lambda l: "lead" + "x".join(map(str, l)))
@pytest.mark.parametrize("name, tower, dnum, k, lt", TOWERS, ids=[t[0] for t in TOWERS])
def test_fbc_matches_bigint(name, tower, dnum, k, lt, lead):
    params = make_params(tower, dnum, k)
    ring = params.ring_cipher.select(range(lt))
    x = random_primal(ring.primes, lead, lt + len(lead))
    want = bigint_fbc(params, lt, x)                      # [dnum_t, ..., T, N]
    xt = torch.as_tensor(x)
    exp_ring, _ = params._tables(lt)
    T_ = exp_ring.nlimbs

    # the engine: the digits, and their dual with the in-group rows from x's dual
    got_ring, got = params.hybrid_decompose(ring, T.RingElt(primal=xt))
    assert got_ring.primes == exp_ring.primes
    np.testing.assert_array_equal(got.numpy(), want)
    want_dual = tntt.ntt(exp_ring.tables, torch.as_tensor(want))
    _, dual = params.hybrid_decompose_dual(ring, T.RingElt(primal=xt))
    assert torch.equal(dual, want_dual)

    # the compiled layers: digits inside, then K1's plain twin
    ka = TL.build_key_arrays(params, synthetic_key(params, lt).key, ring)
    assert torch.equal(TL._hybrid_digits(ka, xt), torch.movedim(want_dual, 0, -3))

    # a plan over every other target row, as a rank of a sharded tower holds them
    held = list(range(len(lead) % 2, T_, 2))
    _, groups = params._tables(lt)
    plan = fbc_cuda.make_plan(groups, ring.mp, exp_ring.mp.select(held), held)
    np.testing.assert_array_equal(fbc_cuda.fbc(plan, xt).numpy(), want[..., held, :])
    outs = fbc_cuda.fbc(plan, xt, out_of_group=True)
    for j, (lo, hi) in enumerate(plan.bounds):
        keep = [t for t in held if not lo <= t < hi]
        assert outs[j].shape == lead + (plan.out_rows(j), N)
        np.testing.assert_array_equal(outs[j].numpy(), want[j][..., keep, :])

    # the kernel's schedule: the same digits
    sched, seen = fbc_cuda.fbc_schedule(params.fbc_plan(ring), xt)
    np.testing.assert_array_equal(sched.numpy(), want)
    assert seen["redc"] < 1.5 * seen["p"] and seen["sum"] < 16 * seen["p"]


@pytest.mark.parametrize("alpha", [7, 10])
def test_schedule_stays_in_range_under_2_31(alpha):
    """The lazy products and the 64-bit sum at primes just under 2^31 and
    ŷ at its largest (q - 1 in every coefficient): each uncorrected REDC
    below 1.5 p, each sum before its reduction below 16 p (what the four
    conditional subtractions need), the result equal to the plain twin."""
    primes, p = [], (1 << 31) + 1
    while len(primes) < 2 * alpha + 1:                    # the largest NTT primes below 2^31
        p = nt.prev_prime(p - 2 * N, 2 * N)
        primes.append(p)
    params = T.HybridRaised(T.CKKSParams(T.RingContext(N, primes), 0, 3.2), 1, alpha + 1)
    ring = params.ring_cipher
    assert min(primes) > (1 << 31) - (1 << 20)
    plan = params.fbc_plan(ring)
    y = torch.as_tensor(np.asarray(ring.mp.p, dtype=np.int64) - 1).expand(2, alpha, N)
    got, seen = fbc_cuda.fbc_schedule(plan, y.contiguous(), premultiplied=True)
    assert torch.equal(got, fbc_cuda.fbc_plain(plan, y, premultiplied=True))
    assert seen["redc"] < 1.5 * seen["p"] and seen["sum"] < 16 * seen["p"] < 1 << 64
    x = torch.as_tensor(random_primal(ring.primes, (3,), alpha))
    got, seen = fbc_cuda.fbc_schedule(plan, x)
    assert torch.equal(got, fbc_cuda.fbc_plain(plan, x))
    np.testing.assert_array_equal(got.numpy(), bigint_fbc(params, alpha, x.numpy()))


def test_fbc_refuses_what_it_does_not_take():
    params = make_params((28,) * 4 + (30,), 4, 1)
    plan = params.fbc_plan(params.ring_cipher)
    x = torch.zeros(2, 4, N, dtype=torch.int64)
    with pytest.raises(TypeError):
        fbc_cuda.fbc(plan, x.to(torch.int32))
    with pytest.raises(ValueError):
        fbc_cuda.fbc(plan, x[:, :3])
    with pytest.raises(ValueError):
        fbc_cuda.launch(plan, x)                          # a CPU tensor
    with pytest.raises(ValueError):
        fbc_cuda.fbc(plan, x.to("meta"))


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, tower, dnum, k, lt", TOWERS, ids=[t[0] for t in TOWERS])
def test_cuda_kernel_equals_plain(name, tower, dnum, k, lt):
    """The kernel against the plain twin at N = 2^13 in every output layout,
    premultiplied or not, and over a subset of the target rows."""
    dev = cuda_device()
    n = 1 << 13
    params = T.HybridRaised(T.CKKSParams(T.make_rns_ring(n, tower), 0, 3.2), dnum, k)
    ring = params.ring_cipher.select(range(lt))
    gen = torch.Generator(device=dev).manual_seed(lt)
    x = torch.cat([torch.randint(0, p, (4, 1, n), generator=gen, device=dev, dtype=torch.int64)
                   for p in ring.primes], dim=-2)
    exp_ring, groups = params._tables(lt)
    held = list(range(1, exp_ring.nlimbs, 2))
    for plan in (params.fbc_plan(ring),
                 fbc_cuda.make_plan(groups, ring.mp, exp_ring.mp.select(held), held)):
        y = fbc_cuda.fbc_plain(plan, x)
        before = fbc_cuda.launches["fbc"]
        assert torch.equal(fbc_cuda.fbc(plan, x), y)
        assert torch.equal(fbc_cuda.fbc(plan, x, digits_inner=True), torch.movedim(y, 0, -3))
        for g, w in zip(fbc_cuda.fbc(plan, x, out_of_group=True),
                        fbc_cuda.fbc_plain(plan, x, out_of_group=True)):
            assert torch.equal(g, w)
        yhat = modmath.mont_mul(x, modmath.const(plan.inv, dev), plan.ct_mp)
        assert torch.equal(fbc_cuda.fbc(plan, yhat, premultiplied=True), y)
        torch.cuda.synchronize()
        assert fbc_cuda.launches["fbc"] - before >= 3
