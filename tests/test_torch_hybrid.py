"""toyfhe_tpu_torch hybrid (dnum-gadget) key switch against the reference.

Host tables and digit decompositions of ``HybridRaised`` bit-equal to
``toyfhe_tpu.core.hybrid``; the engine's square → hybrid keyswitch →
rescale on reference keys carried across as numpy, bit-equal and decrypting
within 2e-4; the fused key switch K3's plain twin bit-equal to the
reference's unfused digit pipeline and to its Pallas kernel in interpret
mode; and, on a CUDA device, the hand-written K3 kernel bit-equal to the
plain twin.

The reference is imported inside the ``ref`` fixture, so the ``cuda`` tests
run on a host that has torch but no jax (``pytest --noconftest -m cuda``).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import rlwe as trlwe
from toyfhe_tpu_torch.ops import hybrid_ks, hybrid_ks_cuda
from toyfhe_tpu_torch.ops import ntt as tntt
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

SCALE = Fraction(2) ** 26


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    import toyfhe_tpu as F
    return jax, jnp, F


def hybrid_params(pkg, n, L, k, dnum, ct_bits=28, sp_bits=30):
    """(ring, HybridRaised) of package ``pkg`` over L ct primes of
    ``ct_bits`` and k raising primes of ``sp_bits``."""
    ring = pkg.make_rns_ring(n, (ct_bits,) * L + (sp_bits,) * k)
    return ring, pkg.HybridRaised(pkg.CKKSParams(ring, 0, 3.2), dnum, k)


def synthetic_keys(params, seed):
    """``dnum`` key components of uniform duals over ``ring_key``, as
    uint32 numpy (mask stack, masked stack)."""
    key_ring = params.ring_key
    rng = np.random.default_rng(seed)
    shape = (params.dnum, key_ring.nlimbs, key_ring.n)
    lim = min(key_ring.primes)
    return (rng.integers(0, lim, shape).astype(np.uint32),
            rng.integers(0, lim, shape).astype(np.uint32))


def ref_eval_key(jnp, params, masks, maskeds):
    from toyfhe_tpu.core.ring import RingElt
    from toyfhe_tpu.core.rlwe import EvalMultKey, KeyComponent, KeySwitchKey
    comps = [KeyComponent(mask=RingElt(dual=jnp.asarray(m)),
                          masked=RingElt(dual=jnp.asarray(md)))
             for m, md in zip(masks, maskeds)]
    return EvalMultKey(KeySwitchKey(params, comps, params.ring_key))


def carry_keys(params, tparams, kp, ek):
    """The reference's secret (primal, full L+k tower) and eval key (dnum
    dual components over ``ring_key``) as the port's keys."""
    from toyfhe_tpu.core import ring as ref_ring
    key_ring = params.ring_key
    dual = lambda x: np.asarray(ref_ring.ensure_dual(key_ring, x).dual)
    secret = np.asarray(ref_ring.ensure_primal(key_ring, kp.priv.secret).primal)
    tkp = I.priv_key(tparams, secret, device="cpu")
    tek = I.eval_mult_key(tparams, [dual(c.mask) for c in ek.key.key],
                          [dual(c.masked) for c in ek.key.key], device="cpu")
    return tkp, tek


def ct_duals(ring, c):
    from toyfhe_tpu.core import ring as ref_ring
    return np.stack([np.asarray(ref_ring.ensure_dual(ring, x).dual) for x in c.cs])


# ---------------------------------------------------------------------------
# host tables and decompositions
# ---------------------------------------------------------------------------

TABLE_CASES = [(8, 4, 2, 8), (8, 4, 2, 3), (7, 2, 4, 7), (7, 2, 4, 6),
               (7, 4, 3, 7), (6, 3, 2, 5)]


@pytest.mark.parametrize("L, dnum, k, lt", TABLE_CASES)
def test_tables_match_reference(ref, L, dnum, k, lt):
    _, _, F = ref
    ring, params = hybrid_params(F, 32, L, k, dnum)
    tring, tparams = hybrid_params(T, 32, L, k, dnum)
    assert tring.primes == ring.primes
    assert tparams.hybrid_factors() == params.hybrid_factors()
    exp_ring, groups = params._tables(lt)
    texp, tgroups = tparams._tables(lt)
    assert texp.primes == exp_ring.primes
    assert len(tgroups) == len(groups)
    for (b, inv, cst), (tb, tinv, tcst) in zip(groups, tgroups):
        assert tb == b
        np.testing.assert_array_equal(tinv, np.asarray(inv))
        np.testing.assert_array_equal(tcst, np.asarray(cst))
    assert tparams.hybrid_key_limbs(texp) == params.hybrid_key_limbs(exp_ring)
    want = params._fused_tables(exp_ring)
    got = tparams._fused_tables(texp)
    assert got[0].primes == want[0].primes and got[1].primes == want[1].primes
    pinv, wts, dinvs = got[2:]
    for g, w in zip([pinv, *wts, *dinvs], [want[2], *want[3], *want[4]]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("L, dnum, k, lt, lead", [(8, 4, 2, 8, ()), (7, 2, 4, 6, (2,)),
                                                  (8, 4, 2, 3, (3,))])
def test_decompose_matches_reference(ref, L, dnum, k, lt, lead):
    _, jnp, F = ref
    from toyfhe_tpu.core.ring import RingElt
    ring, params = hybrid_params(F, 32, L, k, dnum)
    _, tparams = hybrid_params(T, 32, L, k, dnum)
    sub, tsub = params.ring_cipher.select(range(lt)), tparams.ring_cipher.select(range(lt))
    rng = np.random.default_rng(lt)
    xp = np.stack([rng.integers(0, p, lead + (32,)) for p in sub.primes],
                  axis=-2).astype(np.uint32)
    for name in ("hybrid_decompose", "hybrid_decompose_dual"):
        exp_ring, want = getattr(params, name)(sub, RingElt(primal=jnp.asarray(xp)))
        texp, got = getattr(tparams, name)(tsub, T.RingElt(primal=I.tensor(xp, "cpu")))
        assert texp.primes == exp_ring.primes
        assert got.shape == (len(params._tables(lt)[1]),) + lead + (exp_ring.nlimbs, 32)
        np.testing.assert_array_equal(I.to_numpy(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the engine: ct_rescale(keyswitch(ek, ct_mul(c, c)))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dnum, k, limbs", [(2, 4, 8), (4, 2, 8), (4, 2, 3)])
def test_engine_square_relin_matches_reference(ref, dnum, k, limbs):
    """At (dnum, k) = (2, 4) and (4, 2), N = 32, and after drops to 3 limbs,
    below a group boundary (groups of α = 2 become [q0 q1], [q2]) — the
    shapes of tests/test_hybrid_gadget.py."""
    jax, _, F = ref
    n = 32
    ring, params = hybrid_params(F, n, 8, k, dnum)
    tring, tparams = hybrid_params(T, n, 8, k, dnum)
    ks = jax.random.split(jax.random.PRNGKey(2), 5)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    rng = np.random.default_rng(7)
    vals = (rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)) * 0.8
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, SCALE), ks[3])
    tkp, tek = carry_keys(params, tparams, kp, ek)
    tc = I.ciphertext(tparams, tparams.ring_cipher, ct_duals(c.ring, c), SCALE, device="cpu")
    while c.ring.nlimbs > limbs:
        c, tc = F.ct_modswitch_drop(c), T.ct_modswitch_drop(tc)
    assert tc.ring.primes == c.ring.primes
    out = F.ct_rescale(F.keyswitch(ek, F.ct_mul(c, c)))
    tout = T.ct_rescale(T.keyswitch(tek, T.ct_mul(tc, tc)))
    assert tout.ring.primes == out.ring.primes
    np.testing.assert_array_equal(I.ciphertext_to_numpy(tout), ct_duals(out.ring, out))
    np.testing.assert_allclose(T.decrypt(tkp, tout), vals ** 2, atol=2e-4)


def test_contract_fused_matches_sequential():
    """hybrid_contract of a dual accumulator (the fused ModDown) equals the
    k sequential rescales it takes on the same accumulator in primal form."""
    _, tparams = hybrid_params(T, 64, 6, 3, 3)
    exp = tparams._tables(5)[0]
    rng = np.random.default_rng(4)
    acc = I.tensor(np.stack([rng.integers(0, p, (2, 64)) for p in exp.primes], axis=-2), "cpu")
    ring_d, fused = tparams.hybrid_contract(exp, T.RingElt(dual=acc))
    ring_p, seq = tparams.hybrid_contract(exp, T.RingElt(primal=tntt.intt(exp.tables, acc)))
    assert ring_d is ring_p is tparams.ring_cipher.select(range(5))
    assert fused.primal is None and seq.dual is None
    assert torch.equal(fused.dual, tntt.ntt(ring_d.tables, seq.primal))


def test_encrypt_decrypt_port_keys():
    """Keys, encryption and decryption made by the port alone: the secret
    and eval key live on the full L+k tower, ciphertexts on the first L."""
    n = 32
    _, tparams = hybrid_params(T, n, 6, 2, 3)
    gen = torch.Generator().manual_seed(5)
    kp = T.keygen(tparams, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    assert kp.priv.secret.shape == (8, n) and len(ek.key.key) == 3
    vals = np.linspace(-0.9, 0.9, n // 2)
    c = T.encrypt(kp, T.make_plaintext(tparams.ring_cipher, vals, SCALE), gen)
    assert c.ring is tparams.ring_cipher and c.cs[0].shape == (6, n)
    # fresh encryption noise (a few hundred at σ = 3.2, N = 32) over the
    # scale 2^26 is ~1e-5
    np.testing.assert_allclose(T.decrypt(kp, c).real, vals, atol=1e-4)
    out = T.ct_rescale(T.keyswitch(ek, T.ct_mul(c, c)))
    np.testing.assert_allclose(T.decrypt(kp, out).real, vals ** 2, atol=2e-4)


def test_passthrough_params_and_guards():
    _, tparams = hybrid_params(T, 32, 6, 2, 3)
    base = tparams.params
    assert tparams.sigma == base.sigma and tparams.scheme_name() == "CKKS"
    assert tparams.ring_key is base.ring_cipher
    assert tparams.ring_cipher.primes == base.ring_cipher.primes[:6]
    assert trlwe.bgv_plain_modulus(tparams) is None
    with pytest.raises(ValueError):
        T.HybridRaised(base, 7, 2)                        # dnum > L
    with pytest.raises(ValueError):
        T.HybridRaised(base, 3, 0)
    with pytest.raises(ValueError):                   # P too small for α = 6
        T.HybridRaised(T.CKKSParams(T.make_rns_ring(32, (28,) * 7 + (20,)), 0, 3.2), 1, 1)

    # a BGV base: the contraction takes the p-adapted rounding at each
    # special prime, on the primal form, in place of the fused ModDown
    bgv = T.HybridRaised(T.BGVParams(base.ring_cipher, 257, 3.2), 3, 2)
    assert trlwe.bgv_plain_modulus(bgv) == 257
    exp = bgv._tables(6)[0]
    acc = torch.as_tensor(np.random.default_rng(0).integers(0, 1 << 27, (2, 8, 32)))
    ring, got = bgv.hybrid_contract(exp, T.RingElt(dual=acc))
    want_ring, want = exp, T.ringops.ensure_primal(exp, T.RingElt(dual=acc))
    for _ in range(2):
        want_ring, want = T.ringops.rescale_adapted(want_ring, want, 257)
    assert ring is want_ring and ring.primes == exp.primes[:6] and got.dual is None
    assert torch.equal(got.primal, want.primal)


def test_ring_select_repeated_rows():
    """Derived towers slice the root's tables, repeated rows included (the
    merged inverse transform of make_hybrid_fused_step)."""
    ring = T.make_rns_ring(64, (28, 28, 29, 30))
    sub = ring.select((3, 2, 3, 1, 1))
    fresh = tntt.NttTables(64, sub.primes, sub.psis)
    assert sub.primes == [ring.primes[i] for i in (3, 2, 3, 1, 1)]
    for name in ("psi_pow", "psi_ipow"):
        np.testing.assert_array_equal(getattr(sub.tables, name), getattr(fresh, name))
    for a, b in zip(sub.tables.stage_tw + sub.tables.stage_tw_inv,
                    fresh.stage_tw + fresh.stage_tw_inv):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sub.mp.p, fresh.mp.p)
    x = I.tensor(np.random.default_rng(0).integers(0, min(sub.primes), (2, 5, 64)), "cpu")
    assert torch.equal(tntt.ntt(sub.tables, x), tntt.ntt(fresh, x))
    assert sub.select((1, 0)).primes == [ring.primes[2], ring.primes[3]]


# ---------------------------------------------------------------------------
# K3: the fused key switch
# ---------------------------------------------------------------------------

K3_CASES = [  # (L, dnum, k, lt, lead): full tower; shortened + batched
    (4, 2, 2, None, ()),
    (5, 2, 3, 4, (2,)),
]


@pytest.mark.parametrize("L, dnum, k, lt, lead", K3_CASES)
def test_k3_plain_matches_unfused_reference(ref, L, dnum, k, lt, lead):
    """The plain twin against the reference's unfused digit pipeline
    (hybrid_decompose → NTT → key contraction), as
    tests/test_fused_keyswitch.py runs it, at N = 256."""
    _, jnp, F = ref
    from toyfhe_tpu.core import rlwe as ref_rlwe
    from toyfhe_tpu.core.ring import RingElt
    from toyfhe_tpu.ops import modmath as ref_mm
    from toyfhe_tpu.ops import ntt as ref_ntt
    n = 256
    _, params = hybrid_params(F, n, L, k, dnum, sp_bits=29)
    _, tparams = hybrid_params(T, n, L, k, dnum, sp_bits=29)
    masks, maskeds = synthetic_keys(params, L)
    ek = ref_eval_key(jnp, params, masks, maskeds)
    tek = I.eval_mult_key(tparams, masks, maskeds, device="cpu")
    lt_ = params.ring_cipher.nlimbs if lt is None else lt
    sub = params.ring_cipher.select(range(lt_))
    rng = np.random.default_rng(5)
    xp = rng.integers(0, min(sub.primes), lead + (lt_, n)).astype(np.uint32)

    exp_ring, digits = params.hybrid_decompose(sub, RingElt(primal=jnp.asarray(xp)))
    ddual = ref_ntt.ntt(exp_ring.tables, digits)
    m, md = ref_rlwe._hybrid_key_stack(params, ek.key, exp_ring, int(digits.shape[0]),
                                       ddual.ndim - 3)
    mp = exp_ring.mp
    want1 = np.asarray(ref_rlwe._mod_sum(ref_mm.mul_mod(md, ddual, mp), mp))
    want2 = np.asarray(ref_rlwe._mod_sum(ref_mm.mul_mod(m, ddual, mp), mp))

    fks = hybrid_ks.FusedHybridKS(tparams, tek, lt=lt)
    acc1, acc2 = fks(fks.premultiply(I.tensor(xp, "cpu")))
    assert acc1.shape == lead + (exp_ring.nlimbs, n)
    np.testing.assert_array_equal(I.to_numpy(acc1), want1)
    np.testing.assert_array_equal(I.to_numpy(acc2), want2)


def test_k3_plain_matches_pallas_interpret(ref):
    """The plain twin against ``FusedHybridKS(...)(y, interpret=True)``, the
    TPU kernel in the Pallas interpreter, at N = 256 (as
    tests/test_ntt_pallas.py runs it)."""
    _, jnp, F = ref
    from toyfhe_tpu.ops.pallas_hybrid_ks import FusedHybridKS
    n = 256
    _, params = hybrid_params(F, n, 4, 2, 2, sp_bits=29)
    _, tparams = hybrid_params(T, n, 4, 2, 2, sp_bits=29)
    masks, maskeds = synthetic_keys(params, 1)
    rng = np.random.default_rng(1)
    y = rng.integers(0, min(params.ring_key.primes), (2, 4, n)).astype(np.uint32)
    rf = FusedHybridKS(params, ref_eval_key(jnp, params, masks, maskeds))
    want1, want2 = rf(rf.premultiply(jnp.asarray(y)), interpret=True)
    fks = hybrid_ks.FusedHybridKS(tparams, I.eval_mult_key(tparams, masks, maskeds, device="cpu"))
    np.testing.assert_array_equal(fks.cst, rf.cst)
    np.testing.assert_array_equal(fks.inv_col, rf.inv_col)
    acc1, acc2 = fks(fks.premultiply(I.tensor(y, "cpu")))
    np.testing.assert_array_equal(I.to_numpy(acc1), np.asarray(want1))
    np.testing.assert_array_equal(I.to_numpy(acc2), np.asarray(want2))


def test_k3_wrapper_guards():
    """The kernel wrapper takes CUDA tensors only; the dispatcher sends CPU
    tensors to the plain twin and refuses other devices."""
    _, tparams = hybrid_params(T, 32, 4, 2, 2, sp_bits=29)
    fks = hybrid_ks.FusedHybridKS(tparams, I.eval_mult_key(tparams, *synthetic_keys(tparams, 0), device="cpu"))
    y = torch.zeros(4, 32, dtype=torch.int64)
    before = dict(hybrid_ks_cuda.launches)
    with pytest.raises(ValueError):
        hybrid_ks_cuda.launch(fks, y)
    with pytest.raises(ValueError):
        fks(y.to("meta"))
    acc1, acc2 = fks(y)
    assert acc1.shape == (6, 32) and not acc1.any() and not acc2.any()
    assert hybrid_ks_cuda.launches == before


# the three K3 shapes of the serving path, at N = 256 here
CUDA_CASES = [(7, 2, 4, 7), (7, 2, 4, 6), (7, 4, 3, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("L, dnum, k, lt", CUDA_CASES)
@pytest.mark.parametrize("lead", [(), (4,)])
def test_cuda_k3_matches_plain(L, dnum, k, lt, lead):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    n = 256
    _, tparams = hybrid_params(T, n, L, k, dnum, sp_bits=29)
    tek = I.eval_mult_key(tparams, *synthetic_keys(tparams, lt), device=dev)
    fks = hybrid_ks.FusedHybridKS(tparams, tek, lt=lt)
    sub = tparams.ring_cipher.select(range(lt))
    rng = np.random.default_rng(lt)
    y = I.tensor(rng.integers(0, min(sub.primes), lead + (lt, n)), dev)
    before = hybrid_ks_cuda.launches["k3"]
    got = fks(y)
    torch.cuda.synchronize()
    assert hybrid_ks_cuda.launches["k3"] == before + 1
    want = hybrid_ks.fused_hybrid_ks_plain(fks, y)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(TypeError):
        hybrid_ks_cuda.launch(fks, y.to(torch.int32))
    with pytest.raises(ValueError):
        hybrid_ks_cuda.launch(fks, y[..., : lt - 1, :].contiguous())
