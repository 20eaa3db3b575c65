"""toyfhe_tpu_torch BFV against the reference, on the CPU.

* ``bfv_params``: the same ring, auxiliary base, Δ and planned budget as
  ``toyfhe_tpu.bfv_params``, compared as host integers;
* shared tensors: the reference's keys carried across with ``interop``, both
  packages encrypting with the same ephemeral secret and noise (u, e₁, e₂),
  then encrypt → ``ct_mul`` → ``keyswitch`` → ``ct_mul`` bit-equal at every
  step (gadget windows 0 and 4, and under ``ModulusRaised``), with equal
  decodes and equal invariant noise budgets;
* slot encoding bit-equal; the port alone through the reference's
  ``bfv_noise`` ordering and window asserts and its usage errors.

The chain on the card against the CPU is a ``cuda`` test of
``test_torch_exact_golden.py``, which imports no JAX.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import ring as ref_ring
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

N = 64


# ---------------------------------------------------------------------------
# carrying state between the packages
# ---------------------------------------------------------------------------

def base_of(params):
    while hasattr(params, "params"):
        params = params.params
    return params


def embed(x, ring):
    """A signed integer vector [N] as residues over ``ring``, uint32."""
    return jnp.asarray(np.stack([np.mod(x, p) for p in ring.primes]).astype(np.uint32))


def ref_dual(ring, x):
    return np.asarray(ref_ring.ensure_dual(ring, x).dual)


def ref_primal(ring, x):
    return np.asarray(ref_ring.ensure_primal(ring, x).primal)


def carry_keys(rparams, tparams, kp, ek):
    """The reference's key pair and relinearization key in the port."""
    kr = rparams.ring_key
    tkp = T.KeyPair(I.priv_key(tparams, ref_primal(kr, kp.priv.secret), device="cpu"),
                    I.pub_key(tparams, ref_primal(kr, kp.pub.key.mask),
                              ref_primal(kr, kp.pub.key.masked), device="cpu"))
    tek = I.eval_mult_key(tparams, [ref_dual(ek.key.ring, c.mask) for c in ek.key.key],
                          [ref_dual(ek.key.ring, c.masked) for c in ek.key.key],
                          device="cpu")
    return tkp, tek


def noise_vectors(n, seed, sigma=3.2, shift=1):
    """(u, e₁, e₂) as signed integer vectors, rounded gaussians."""
    rng = np.random.default_rng(seed)
    u = np.rint(rng.normal(0, sigma, n)).astype(np.int64)
    e1, e2 = (np.rint(rng.normal(0, sigma, n)).astype(np.int64) * shift for _ in range(2))
    return u, e1, e2


def ref_encrypt(kp, plain, u, e1, e2):
    """The reference's ``encrypt`` with its samplers replaced by the given
    vectors (the encryption draws u first, then e₁ and e₂)."""
    base = base_of(kp.pub.params)
    queue = [e1, e2]
    base.secret_sampler = lambda key, ring, batch=(): F.RingElt(primal=embed(u, ring))
    base.noise = lambda key, ring, batch=(): F.RingElt(primal=embed(queue.pop(0), ring))
    try:
        return F.encrypt(kp, plain, jax.random.PRNGKey(0))
    finally:
        del base.secret_sampler, base.noise


def assert_same_ct(rc, tc):
    """Same tower, same component count, bit-equal residues."""
    assert tc.ring.primes == list(rc.ring.primes) and len(tc.cs) == len(rc.cs)
    for rx, tx in zip(rc.cs, tc.cs):
        np.testing.assert_array_equal(I.elt_to_numpy(tc.ring, tx, "primal"),
                                      ref_primal(rc.ring, rx))


# ---------------------------------------------------------------------------
# parameter generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,emc", [(7, 3), (53, 2), (65537, 1), (65537, 4)])
def test_bfv_params_match(p, emc):
    r, t = F.bfv_params(p, eval_mult_count=emc), T.bfv_params(p, eval_mult_count=emc)
    for rr, tr in ((r.ring_cipher, t.ring_cipher), (r.aux_ring, t.aux_ring)):
        assert (tr.n, tr.primes, tr.psis) == (rr.n, list(rr.primes), list(rr.psis))
    assert (t.delta, t.planned_q_bits, t.plain.p, t.plain.has_slots) == \
        (r.delta, r.planned_q_bits, r.plain.p, r.plain.has_slots)
    np.testing.assert_array_equal(t._delta_res, np.asarray(r._delta_res).astype(np.int64))
    if (p, emc) == (65537, 4):
        # the full-width slice: N = 8192, 7 q limbs of 28 bits, 9 auxiliary
        assert t.ring_cipher.n == 8192 and t.ring_cipher.nlimbs == 7
        assert all(28 < math.log2(q) < 28.01 for q in t.ring_cipher.primes)
        assert t.aux_ring.nlimbs == 9 and len(t.mul_ctx().ext_ring.primes) == 16


# ---------------------------------------------------------------------------
# shared tensors through the multiply
# ---------------------------------------------------------------------------

SETUPS = {"window0": (0, None), "window4": (4, None), "modraised": (0, "modraised")}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def shared(request):
    window, wrap = SETUPS[request.param]
    tower = (29, 28, 28) + ((30,) if wrap else ())
    rbase = F.BFVParams(F.make_rns_ring(N, tower), None, F.PlainRing(N, 257), window, 3.2)
    tbase = T.BFVParams(T.make_rns_ring(N, tower), None, T.PlainRing(N, 257), window, 3.2)
    rparams = F.ModulusRaised(rbase) if wrap else rbase
    tparams = T.ModulusRaised(tbase) if wrap else tbase
    ks = jax.random.split(jax.random.PRNGKey(21), 2)
    kp = F.keygen(rparams, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    tkp, tek = carry_keys(rparams, tparams, kp, ek)
    rng = np.random.default_rng(22)
    slots = [rng.integers(0, 257, N) for _ in range(2)]
    cts, tcts = [], []
    for i, s in enumerate(slots):
        u, e1, e2 = noise_vectors(N, 30 + i)
        cts.append(ref_encrypt(kp, F.slot_encode(rparams.plaintext_space(), s), u, e1, e2))
        tcts.append(I.encrypt_with_noise(
            tkp, T.slot_encode(tparams.plaintext_space(), s, device="cpu"), u, e1, e2,
            device="cpu"))
    return dict(kp=kp, ek=ek, tkp=tkp, tek=tek, cts=cts, tcts=tcts, slots=slots)


def test_encrypt_with_shared_noise(shared):
    for rc, tc, s in zip(shared["cts"], shared["tcts"], shared["slots"]):
        assert_same_ct(rc, tc)
        got = T.slot_decode(T.decrypt(shared["tkp"], tc), device="cpu")
        np.testing.assert_array_equal(got, s)
        np.testing.assert_array_equal(got, F.slot_decode(F.decrypt(shared["kp"], rc)))


def ref_exact_meters(monkeypatch):
    """Send the reference's invariant noise budget down its exact Python CRT
    path, which the port keeps: its C++ meter takes the distance from the Δ
    lattice as a difference of doubles, which rounds it to a multiple of
    2^(log2 Δ − 53) near the lattice's midpoints. Its decodes and its BGV
    meter keep the C++ CRT, as the port's do."""
    exact = F.invariant_noise_budget

    def budget(key, c):
        with monkeypatch.context() as m:
            m.setattr(ref_ring.RingContext, "native", lambda self: None)
            return exact(key, c)

    monkeypatch.setattr(F, "invariant_noise_budget", budget)


def test_mul_keyswitch_mul(shared, monkeypatch):
    """encrypt → ct_mul → keyswitch → ct_mul, bit-equal at every step; the
    decodes and the invariant noise budgets equal too."""
    ref_exact_meters(monkeypatch)
    (a, b), (ta, tb) = shared["cts"], shared["tcts"]
    kp, tkp = shared["kp"], shared["tkp"]
    steps = []
    prod, tprod = F.ct_mul(a, b), T.ct_mul(ta, tb)
    steps.append((prod, tprod))
    ks, tks = F.keyswitch(shared["ek"], prod), T.keyswitch(shared["tek"], tprod)
    assert len(tks.cs) == 2
    steps.append((ks, tks))
    steps.append((F.ct_mul(ks, a), T.ct_mul(tks, ta)))
    for rc, tc in steps:
        assert_same_ct(rc, tc)
        np.testing.assert_array_equal(T.decrypt(tkp, tc).coeffs, F.decrypt(kp, rc).coeffs)
        rb, tbud = F.invariant_noise_budget(kp, rc), T.invariant_noise_budget(tkp, tc)
        assert tbud == pytest.approx(rb, rel=1e-12)
        # the meter measures against the base tower's Δ, as the reference
        # does, so it reads a ciphertext short of that tower (ModulusRaised)
        # as out of budget although it decodes
        assert tbud > 0 or tc.ring.nlimbs < base_of(tc.params).ring_cipher.nlimbs
    sa, sb = shared["slots"]
    want = sa * sb % 257 * sa % 257
    np.testing.assert_array_equal(T.slot_decode(T.decrypt(tkp, steps[-1][1]), device="cpu"),
                                  want)


def test_batched_mul_keyswitch(shared):
    """A stacked pair through the multiply and the key switch equals the
    singles."""
    ta, tb = shared["tcts"]
    both = T.ct_stack([ta, tb])
    out = T.keyswitch(shared["tek"], T.ct_mul(both, both))
    for i, tc in enumerate((ta, tb)):
        one = T.keyswitch(shared["tek"], T.ct_mul(tc, tc))
        np.testing.assert_array_equal(I.ciphertext_to_numpy(T.ct_index(out, i)),
                                      I.ciphertext_to_numpy(one))


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(64, 257), (4096, 65537)])
def test_slot_encoding_matches(n, p):
    rring, tring = F.PlainRing(n, p), T.PlainRing(n, p)
    assert tring.has_slots and rring.has_slots
    slots = np.random.default_rng(n).integers(0, p, n)
    rp, tp = F.slot_encode(rring, slots), T.slot_encode(tring, slots, device="cpu")
    np.testing.assert_array_equal(tp.coeffs, rp.coeffs)
    np.testing.assert_array_equal(T.slot_decode(tp, device="cpu"), F.slot_decode(rp))
    np.testing.assert_array_equal(T.slot_decode(tp, device="cpu"), slots)
    # a leading axis of plaintexts encodes each row
    two = T.slot_encode(tring, np.stack([slots, slots[::-1]]), device="cpu")
    np.testing.assert_array_equal(two.coeffs[0], tp.coeffs)
    np.testing.assert_array_equal(T.slot_decode(two, device="cpu")[1], slots[::-1])


def test_plain_oracle_and_scalars():
    rring, tring = F.PlainRing(N, 257), T.PlainRing(N, 257)
    rng = np.random.default_rng(5)
    x, y = rng.integers(0, 257, N), rng.integers(0, 257, N)
    np.testing.assert_array_equal(
        T.coeff_encode(tring, x).mul(T.coeff_encode(tring, y)).coeffs,
        F.coeff_encode(rring, x).mul(F.coeff_encode(rring, y)).coeffs)
    np.testing.assert_array_equal(T.coeff_encode(tring, x - 128).centered(),
                                  F.coeff_encode(rring, x - 128).centered())
    assert T.scalar_decode(T.scalar_encode(tring, 300)) == 43
    assert not T.PlainRing(N, 256).has_slots
    with pytest.raises(ValueError):
        T.PlainRing(N, 256).tables


# ---------------------------------------------------------------------------
# the port alone: the reference suite's own asserts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bfv7():
    return T.bfv_params(7, eval_mult_count=3)


def test_bfv_noise(bfv7):
    """The reference's ``bfv_noise`` asserts: strict budget ordering through
    three multiplies and relinearizations, and the final budget inside the
    window shifted by the RNS re-planning slack."""
    gen = torch.Generator().manual_seed(3)
    kp = T.keygen(bfv7, gen)
    ek = T.keygen_eval_mult(gen, kp.priv)
    c1 = T.encrypt(kp, T.scalar_encode(bfv7.plaintext_space(), 2), gen)
    b1 = T.invariant_noise_budget(kp, c1)
    c1sq = T.ct_mul(c1, c1)
    assert T.invariant_noise_budget(kp, c1sq) < b1
    cswitch1 = T.keyswitch(ek, c1sq)
    bswitch1 = T.invariant_noise_budget(kp, cswitch1)
    cswitchmul = T.ct_mul(cswitch1, c1)
    assert T.invariant_noise_budget(kp, cswitchmul) < bswitch1 < b1
    cswitch2 = T.keyswitch(ek, cswitchmul)
    cswitchmul2 = T.ct_mul(cswitch2, c1)
    bswitchmul2 = T.invariant_noise_budget(kp, cswitchmul2)
    assert bswitchmul2 < T.invariant_noise_budget(kp, cswitch2) < bswitch1
    slack = math.log2(bfv7.ring_cipher.modulus) - (math.ceil(bfv7.planned_q_bits) + 1)
    assert 1 < bswitchmul2 < 10 + max(0.0, slack) + 2, (bswitchmul2, slack)
    assert T.decrypt(kp, cswitchmul2)[0] == pow(2, 4, 7)


def test_usage_errors(bfv7):
    bfv53 = T.BFVParams(T.make_rns_ring(N, (29, 28)), None, T.PlainRing(N, 53), 0, 3.2)
    gen = torch.Generator().manual_seed(5)
    kp7 = T.BFVParams(T.make_rns_ring(N, (29, 28)), None, T.PlainRing(N, 7), 0, 3.2)
    kp1, kp2 = T.keygen(kp7, gen), T.keygen(bfv53, gen)
    c1 = T.encrypt(kp1, T.scalar_encode(kp7.plaintext_space(), 1), gen)
    c2 = T.encrypt(kp2, T.scalar_encode(bfv53.plaintext_space(), 1), gen)
    with pytest.raises(T.UsageError):
        T.ct_add(c1, c2)
    with pytest.raises(T.UsageError):
        T.ct_mul(c1, c2)


def test_bfv_with_raising_modifiers():
    """BFV under both raising modifiers, including a multiply after a rescale
    (Δ and the BEHZ context are rebuilt at the shorter tower)."""
    for wrap in (T.ModulusRaised, lambda p: T.HybridRaised(p, 2, 2)):
        ring = T.make_rns_ring(N, (28,) * 4 + (30, 30))
        params = wrap(T.BFVParams(ring, None, T.PlainRing(N, 257), 0, 3.2))
        gen = torch.Generator().manual_seed(7)
        kp = T.keygen(params, gen)
        ek = T.keygen_eval_mult(gen, kp.priv)
        c = T.encrypt(kp, T.scalar_encode(params.plaintext_space(), 6), gen)
        y = T.keyswitch(ek, T.ct_mul(c, c))
        assert T.decrypt(kp, y)[0] == 36
        z = T.ct_rescale(y)
        assert T.decrypt(kp, z)[0] == 36
        w = T.keyswitch(ek, T.ct_mul(z, z))
        assert T.decrypt(kp, w)[0] == 36 * 36 % 257
