"""toyfhe_tpu_torch key products of the hybrid key switch.

``ops/keyprod_cuda.py``: the plain twin, and the CPU dispatch of
``key_products``, against the formula the call sites wrote before the
kernel (``mod_sum(mul_mod(keys, digits))`` once a key component, the
Galois permutation as an ``index_select`` of the digits, each rotation's
sums added by ``add_mod``), bit for bit, over both digit layouts, with and
without the permutation and the accumulator, with and without leading
axes, at the hybrid and the ModulusRaised gadgets' shapes and with a prime
in [2^30, 2^31); one case against Python integers; the kernel's arithmetic
(a canonical Montgomery product added mod p a digit, one product by R² mod
p at the end) modelled in torch and equal at the largest residues below
2^31; every key switch of the engine, the compiled layers and the fused
square step routed through ``key_products``. Tolerance: none, integers
bit-equal. On a CUDA device the kernel is held to the plain twin at the
cells' shapes.

Nothing here imports the reference, so the ``cuda`` tests run on a host
that has torch but no jax (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import rlwe
from toyfhe_tpu_torch.ops import fbc_cuda, keyprod_cuda as kp, modmath
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.parallel import layers as TL, ops as pops
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

N = 32


def ntt_primes(count, bits, n=N):
    """``count`` NTT-friendly primes below 2^bits, largest first."""
    out, p = [], (1 << bits) + 1
    while len(out) < count:
        p = nt.prev_prime(p - 2 * n, 2 * n)
        out.append(p)
    return out


# (name, dnum, primes of the T rows): the hybrid gadget's digits over the
# expanded tower, the ModulusRaised gadget's one digit a ct limb over Lc + 1
# rows, and a tower with primes in [2^30, 2^31)
SHAPES = (
    ("hybrid", 4, ntt_primes(8, 28) + ntt_primes(2, 30)),
    ("modraised", 6, ntt_primes(6, 28) + ntt_primes(1, 30)),
    ("top_bit", 3, ntt_primes(5, 31)),
)
LEADS = ((), (3,), (2, 2))


def operands(primes, dnum, lead, inner, seed):
    rng = np.random.default_rng(seed)
    p = np.asarray(primes, dtype=np.int64)[:, None]
    rows = lambda shape: torch.as_tensor(rng.integers(0, p, shape + (len(primes), N)))
    digits = rows(lead + (dnum,) if inner else (dnum,) + lead)
    return digits, rows((dnum,)), rows((dnum,)), rows((2,) + lead)


def formula(digits, masks, maskeds, mp, inner, perm=None, acc=None):
    """The call sites' torch formula before the kernel (``rlwe``: digits
    first, key stacks reshaped to broadcast; ``layers`` / ``ops``: digits
    inner, summed over axis -3)."""
    if perm is not None:
        digits = digits.index_select(-1, perm)
    if inner:
        acc1 = modmath.mod_sum(modmath.mul_mod(digits, maskeds, mp), mp, -3)
        acc2 = modmath.mod_sum(modmath.mul_mod(digits, masks, mp), mp, -3)
    else:
        shp = masks.shape[:1] + (1,) * (digits.dim() - 3) + masks.shape[1:]
        acc2 = modmath.mod_sum(modmath.mul_mod(masks.reshape(shp), digits, mp), mp, axis=0)
        acc1 = modmath.mod_sum(modmath.mul_mod(maskeds.reshape(shp), digits, mp), mp, axis=0)
    if acc is not None:
        acc1 = modmath.add_mod(acc[0], acc1, mp)
        acc2 = modmath.add_mod(acc[1], acc2, mp)
    return torch.stack([acc1, acc2])


def _redc(a, b, p, ninv):
    """REDC(a·b) = (a·b + m·p) / 2^32, corrected into [0, p)."""
    t = fbc_cuda._redc(a, b, p, ninv)
    return torch.where(t >= p, t - p, t)


def schedule(digits, masks, maskeds, mp, inner, perm=None, acc=None):
    """The kernel's arithmetic on the CPU: per digit a canonical Montgomery
    product added mod p into each component's sum, then one product by
    R² mod p; the accumulator added last. Returns the result and the
    largest value any step held before its correction."""
    col = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64))
    p, ninv, r2 = col(mp.p), col(mp.ninv), col(mp.r2)
    if perm is not None:
        digits = digits.index_select(-1, perm)
    d = torch.movedim(digits, -3, 0) if inner else digits
    sums = [torch.zeros_like(d[0]), torch.zeros_like(d[0])]
    seen = 0
    for j in range(d.shape[0]):
        for c, k in enumerate((maskeds, masks)):
            t = fbc_cuda._redc(k[j], d[j], p, ninv)
            s = sums[c] + torch.where(t >= p, t - p, t)
            seen = max(seen, int(t.max()), int(s.max()))
            sums[c] = torch.where(s >= p, s - p, s)
    out = torch.stack([_redc(a, r2, p, ninv) for a in sums])
    if acc is not None:
        s = out + acc
        out = torch.where(s >= p, s - p, s)
    return out, seen


@pytest.mark.parametrize("lead", LEADS, ids=lambda l: "lead" + "x".join(map(str, l)))
@pytest.mark.parametrize("inner", [False, True], ids=["digits_outer", "digits_inner"])
@pytest.mark.parametrize("name, dnum, primes", SHAPES, ids=[s[0] for s in SHAPES])
def test_plain_equals_formula(name, dnum, primes, inner, lead):
    mp = modmath.MontParams.make(primes)
    digits, masks, maskeds, acc = operands(primes, dnum, lead, inner, len(lead) + dnum)
    perm = tntt.galois_dual_perm_dev(N, 5, "cpu")
    for pm in (None, perm):
        want = formula(digits, masks, maskeds, mp, inner, pm)
        got = kp.key_products(digits, masks, maskeds, mp, digits_inner=inner, perm=pm)
        assert got.shape == (2,) + lead + (len(primes), N)
        assert torch.equal(got, want)
        assert torch.equal(kp.key_products_plain(digits, masks, maskeds, mp, inner, pm), want)
        assert torch.equal(schedule(digits, masks, maskeds, mp, inner, pm)[0], want)

        # the accumulator: added, in place, and returned
        into = acc.clone()
        back = kp.key_products(digits, masks, maskeds, mp, digits_inner=inner, perm=pm, acc=into)
        want_acc = formula(digits, masks, maskeds, mp, inner, pm, acc)
        assert back is into and torch.equal(into, want_acc)
        assert torch.equal(schedule(digits, masks, maskeds, mp, inner, pm, acc)[0], want_acc)


def test_matches_python_integers():
    primes = ntt_primes(3, 31)
    mp = modmath.MontParams.make(primes)
    digits, masks, maskeds, acc = operands(primes, 5, (2,), False, 7)
    g = 3
    perm = tntt.galois_dual_perm_dev(N, g, "cpu")
    got = kp.key_products(digits, masks, maskeds, mp, perm=perm, acc=acc.clone()).numpy()
    d, m, md, a = (x.numpy() for x in (digits, masks, maskeds, acc))
    src = [((2 * k + 1) * g % (2 * N) - 1) // 2 for k in range(N)]
    for r in range(2):
        for t, p in enumerate(primes):
            for k in range(N):
                s1 = int(a[0, r, t, k]) + sum(int(md[j, t, k]) * int(d[j, r, t, src[k]])
                                              for j in range(5))
                s2 = int(a[1, r, t, k]) + sum(int(m[j, t, k]) * int(d[j, r, t, src[k]])
                                              for j in range(5))
                assert (got[0, r, t, k], got[1, r, t, k]) == (s1 % p, s2 % p)


@pytest.mark.parametrize("dnum", [1, 12])
def test_schedule_at_the_largest_residues(dnum):
    """Every residue p − 1 at primes just under 2^31: each REDC value and
    each sum before its correction below 2p < 2^32, the result equal to
    the formula."""
    primes = ntt_primes(4, 31)
    assert min(primes) > (1 << 31) - (1 << 20)
    mp = modmath.MontParams.make(primes)
    top = torch.as_tensor(np.asarray(primes, dtype=np.int64) - 1)[:, None]
    digits = top.expand(dnum, 2, 4, N).contiguous()
    keys = top.expand(dnum, 4, N).contiguous()
    acc = top.expand(2, 2, 4, N).contiguous()
    got, seen = schedule(digits, keys, keys, mp, False, acc=acc)
    assert torch.equal(got, formula(digits, keys, keys, mp, False, acc=acc))
    assert seen < 2 * max(primes) < 1 << 32


def test_refuses_what_it_does_not_take():
    primes = ntt_primes(3, 28)
    mp = modmath.MontParams.make(primes)
    digits, masks, maskeds, acc = operands(primes, 2, (3,), False, 1)
    with pytest.raises(TypeError):
        kp.key_products(digits.to(torch.int32), masks, maskeds, mp)
    with pytest.raises(ValueError):
        kp.key_products(digits[:1], masks, maskeds, mp)            # dnum differs
    with pytest.raises(ValueError):
        kp.key_products(digits, masks, maskeds, mp, digits_inner=True)
    with pytest.raises(ValueError):
        kp.key_products(digits, masks, maskeds, mp.select([0, 1]))
    with pytest.raises(ValueError):
        kp.key_products(digits, masks, maskeds, mp, perm=torch.arange(N - 1))
    with pytest.raises(ValueError):
        kp.key_products(digits, masks, maskeds, mp, acc=acc[:, :1])
    with pytest.raises(ValueError):
        kp.launch(digits, masks, maskeds, mp)                      # a CPU tensor
    with pytest.raises(ValueError):
        kp.key_products(digits.to("meta"), masks.to("meta"), maskeds.to("meta"), mp)


# ---------------------------------------------------------------------------
# every key switch of the cells goes through key_products
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    seen, real = [], kp.key_products

    def spy(*args, **kw):
        seen.append(dict(inner=kw.get("digits_inner", False), perm=kw.get("perm") is not None,
                         acc=kw.get("acc") is not None))
        return real(*args, **kw)

    monkeypatch.setattr(kp, "key_products", spy)
    return seen


def hybrid_setup():
    params = T.HybridRaised(T.CKKSParams(T.make_rns_ring(N, (28,) * 6 + (30,) * 2), 0, 3.2), 3, 2)
    gen = torch.Generator().manual_seed(24)
    keys = T.keygen(params, gen)
    gks = rlwe.keygen_galois_set(gen, keys.priv, [1, 2, 3])
    ek = rlwe.keygen_eval_mult(gen, keys.priv)
    return params, gen, keys, gks, ek


def test_engine_routes_through_key_products(calls):
    params, gen, keys, gks, ek = hybrid_setup()
    pt = T.make_plaintext(params.ring_cipher, np.arange(N // 2) / N, 2 ** 26)
    c = rlwe.encrypt(keys.pub, pt, gen)
    els = [k.galois_element for k in gks.keys]
    rlwe.rotate_many(gks, c, els)
    assert calls == [dict(inner=False, perm=True, acc=False)] * 3
    calls.clear()
    rlwe.rotate_sum(gks, [(g, c) for g in els] + [(None, c)])
    assert calls == [dict(inner=False, perm=True, acc=i > 0) for i in range(3)]
    calls.clear()
    rlwe.keyswitch(ek, rlwe.ct_mul(c, c))
    assert calls == [dict(inner=False, perm=False, acc=False)]


def test_layers_and_fused_step_route_through_key_products(calls):
    params, gen, keys, gks, ek = hybrid_setup()
    ring = params.ring_cipher
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.stack([rng.integers(0, p, (2, 2, N)) for p in ring.primes], -2))
    TL.SquareRelinLayer(params, ek, ring, eager=True)(x[:, 0], x[:, 1])
    assert calls == [dict(inner=True, perm=False, acc=True)]
    calls.clear()
    gk = gks.keys[0]
    TL.RotateMatmulLayer(params, gk, gk.galois_element, 2, ring, eager=True)(
        x[:, 0], x[:, 1], x[0])
    assert calls == [dict(inner=True, perm=False, acc=True)]
    calls.clear()
    step, place = pops.make_hybrid_fused_step(params, ek, eager=True)
    step(place(tntt.ntt(ring.tables, x)))
    assert calls == [dict(inner=True, perm=False, acc=False)]


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (label, dnum, T, leads, N): the ResNet's top tower, mnist-boot's dense 1
# and refresh top, the BSGS dense layers, and two other ring degrees
CUDA_CASES = (
    ("resnet top", 12, 66, ((), (1,), (2,), (4,)), 1 << 13),
    ("mnist-boot dense 1", 8, 53, ((4,),), 1 << 13),
    ("refresh top", 9, 55, ((2,), (4,)), 1 << 13),
    ("bsgs dense", 2, 11, ((4,), (2, 2)), 1 << 13),
    ("bsgs dense, 9 rows", 2, 9, ((4,),), 1 << 13),
    ("N=2^10", 3, 7, ((3,),), 1 << 10),
    ("N=2^14", 2, 5, ((2,),), 1 << 14),
)


@pytest.mark.cuda
@pytest.mark.parametrize("label, dnum, nt_, leads, n", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_cuda_kernel_equals_plain(label, dnum, nt_, leads, n):
    """The kernel against the plain twin in both digit layouts, with and
    without a Galois permutation and an accumulator; a prime in
    [2^30, 2^31) among the rows."""
    dev = cuda_device()
    primes = ntt_primes(nt_ - 1, 28, n) + ntt_primes(1, 31, n)
    mp = modmath.MontParams.make(primes)
    gen = torch.Generator(device=dev).manual_seed(dnum * nt_)
    p = torch.as_tensor(primes, device=dev)[:, None]
    rand = lambda shape: torch.randint(0, 1 << 31, shape + (nt_, n), generator=gen,
                                       device=dev) % p
    perm = tntt.galois_dual_perm_dev(n, 5 ** 7 % (2 * n), dev)
    masks, maskeds = rand((dnum,)), rand((dnum,))
    before = kp.launches["key_products"]
    for lead in leads:
        acc = rand((2,) + lead)
        for inner in (False, True):
            digits = rand(lead + (dnum,) if inner else (dnum,) + lead)
            for pm in (None, perm):
                want = kp.key_products_plain(digits, masks, maskeds, mp, inner, pm)
                got = kp.key_products(digits, masks, maskeds, mp, digits_inner=inner, perm=pm)
                into = acc.clone()
                kp.key_products(digits, masks, maskeds, mp, digits_inner=inner, perm=pm,
                                acc=into)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (label, lead, inner, pm is not None)
                assert torch.equal(into, kp.key_products_plain(digits, masks, maskeds, mp,
                                                               inner, pm, acc.clone()))
    assert kp.launches["key_products"] - before == 8 * len(leads)
