"""toyfhe_tpu_torch's exact host engine, PolyCRT and golden recorder against
the reference's, on the CPU.

* general cyclotomics: ``cyclotomic_poly``, the factorisations over 𝔽p (the
  same ``random.Random`` draws, so the same order) and Hensel lifting equal
  the reference's on the same inputs;
* ``PolyCRTContext``: factors, isomorphism tables, encode / decode and
  ``galois_slot_permutation`` equal at (m, p) = (7, 2) (where both refuse the
  permutation: its probe needs distinct slot constants 2, 3, … below p^k),
  at (7, 2^3) and at ``bfv_uint8``'s m = 31 over ℤ/2^8;
* the host engine: the Kronecker multiply, the CKKS host encode / decode,
  and ``bfv_uint8``'s relinearization and slot rotation over the prime
  cyclotomic ring, equal step for step from the same seed;
* the golden recorder: ``golden.SCENARIOS[name](SEED)`` reproduces
  ``tests/golden/reference_vectors.json`` exactly for every host scenario of
  the reference's fast list, and (``slow``, as the reference marks them) of
  its slow list;
* the bootstrap pin: the reference's golden keys, context and input, built as
  its ``run_ckks_bootstrap`` builds them (no JAX refresh), carried across;
  the port's ``bootstrap`` reproduces the recorded ``ct_c0`` and ``ct_c1``;
  and the port's own ``run_ckks_bootstrap`` on the CPU stays in the
  recorded error band.
"""

import dataclasses
import json
import os
import random
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.core import generic_ring as RG
from toyfhe_tpu.core import host_engine as RHE
from toyfhe_tpu.core import polycrt as RPC
from toyfhe_tpu.core import refparams as RRP
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import generic_ring as G
from toyfhe_tpu_torch.core import golden as GO
from toyfhe_tpu_torch.core import host_engine as HE
from toyfhe_tpu_torch.core import polycrt as PC
from toyfhe_tpu_torch.core import refparams as RP
from toyfhe_tpu_torch.utils import numtheory as nt

from .test_torch_bootstrap import carry_context
from .test_torch_ckks_surface import carry_ct

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "reference_vectors.json")
# the reference's own lists (tests/test_reference_vectors.py); its slow list
# also replays ckks_bootstrap, which is test_bootstrap_pin here
FAST_HOST = ["ckks_rotate", "ckks_modswitch", "ckks_matmul", "bgv_triv", "bfv_crt",
             "polycrt_encoding", "bfv_uint8", "ckks_modraise", "ckks_device_tower"]
SLOW_HOST = ["bfv_triv", "bfv_keyswitch", "ckks_triv", "bfv_simd", "bfv_noise"]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        data = json.load(f)
    assert data["seed"] == GO.SEED
    return data["scenarios"]


# ---------------------------------------------------------------------------
# general cyclotomic rings and PolyCRT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 7, 8, 12, 15, 21, 31, 36, 105])
def test_cyclotomic_poly(m):
    assert G.cyclotomic_poly(m) == RG.cyclotomic_poly(m)


@pytest.mark.parametrize("m,p,seed", [(7, 2, 0), (31, 2, 0), (31, 2, 5), (21, 2, 1),
                                      (15, 2, 0), (35, 3, 2), (63, 2, 3)])
def test_factoring_and_hensel(m, p, seed):
    f = G.poly_mod_q(G.cyclotomic_poly(m), p)
    facs = G.factor_squarefree_fp(f, p, seed)
    assert facs == RG.factor_squarefree_fp(f, p, seed)
    for k in (2, 8):
        phi = G.poly_mod_q(G.cyclotomic_poly(m), p ** k)
        lifted = G.hensel_lift_factors(phi, facs, p, k)
        assert lifted == RG.hensel_lift_factors(phi, facs, p, k)
        prod = [1]
        for g in lifted:
            prod = G._poly_mul_int(prod, g)
        assert G.poly_mod_q(prod, p ** k) == phi


@pytest.mark.parametrize("m,p,k", [(7, 2, 1), (7, 2, 3), (31, 2, 8)])
def test_polycrt_context(m, p, k):
    ctx, ref = PC.PolyCRTContext(m, p, k), RPC.PolyCRTContext(m, p, k)
    for attr in ("factors", "rho", "tau", "crt_terms", "nslots", "d"):
        assert getattr(ctx, attr) == getattr(ref, attr), attr
    rng = random.Random(m * k)
    slots = [[rng.randrange(ctx.q) for _ in range(ctx.d)] for _ in range(ctx.nslots)]
    coeffs = ctx.encode(slots)
    assert coeffs == ref.encode(slots)
    assert ctx.decode(coeffs) == ref.decode(coeffs) == slots
    units = [g for g in range(2, m) if np.gcd(g, m) == 1]
    if ctx.nslots + 1 >= ctx.q:
        # the permutation probes the slots with the distinct constants
        # 2, 3, ...: both packages refuse a slot ring too small for them
        for P in (ctx, ref):
            with pytest.raises(AssertionError):
                P.galois_slot_permutation(units[0])
        return
    for g in units:
        assert ctx.galois_slot_permutation(g) == ref.galois_slot_permutation(g)
    assert ctx.rotation_generator() == ref.rotation_generator()


# ---------------------------------------------------------------------------
# the host engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bits", [(16, (40,)), (64, (28, 28, 28)), (1 << 10, (30,) * 4)])
def test_kronecker_multiply(n, bits):
    moduli = nt.ntt_prime_chain(n, bits)
    ring, ref = HE.Pow2HostRing(n, moduli=moduli), RHE.Pow2HostRing(n, moduli=moduli)
    rng = random.Random(n)
    a, b = ring.sample_uniform(rng), ring.sample_uniform(rng)
    got = ring.mul(a, b)
    assert got == ref.mul(a, b)
    # schoolbook negacyclic product as the oracle (small n only)
    if n <= 64:
        want = [0] * n
        for i, x in enumerate(a):
            for j, y in enumerate(b):
                k, s = (i + j) % n, -1 if i + j >= n else 1
                want[k] = (want[k] + s * x * y) % ring.q
        assert got == want
    assert ring.galois(a, 5) == ref.galois(a, 5)
    if len(moduli) > 1:
        (sub, r), (rsub, rr) = ring.rescale(a), ref.rescale(a)
        assert r == rr and sub.moduli == rsub.moduli


def test_ckks_host_encode_decode():
    n = 64
    ring = HE.Pow2HostRing(n, moduli=nt.ntt_prime_chain(n, (30, 30, 30)))
    rng = np.random.default_rng(4)
    slots = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    scale = Fraction(2) ** 40
    coeffs = HE.ckks_encode_host(ring, slots, scale)
    assert coeffs == RHE.ckks_encode_host(RHE.Pow2HostRing(n, moduli=ring.moduli), slots, scale)
    dec = HE.ckks_decode_host(ring, coeffs, scale)
    assert np.array_equal(dec, RHE.ckks_decode_host(ring, coeffs, scale))
    assert np.max(np.abs(dec - slots)) < 1e-9


def _uint8_params(E, GR):
    m = 31
    q = nt.next_prime(2 ** 51 + 1)
    qbig = nt.next_prime(2 ** 111 + 1)
    return E.HostParams(ring=GR.GenericRing(m, q), scheme="bfv", p=256,
                        ring_big=GR.GenericRing(m, qbig), relin_window=1, delta=q // 256)


def test_bfv_uint8_relinearize_and_rotate():
    """bfv_uint8's ring: multiply → relinearize and a PolyCRT slot rotation,
    the same ciphertexts and keys as the reference's engine from the same
    seed, and the decoded slots squared and permuted."""
    outs = []
    for E, GR, P in ((HE, G, PC), (RHE, RG, RPC)):
        params = _uint8_params(E, GR)
        ctx = P.PolyCRTContext(31, 2, 8)
        rng = random.Random(99)
        kp = E.keygen(params, rng)
        ek = E.keygen_eval_mult(params, kp, rng)
        vals = [1, 2, 3, 4, 5, 6]
        c = E.encrypt(params, kp, ctx.encode(vals), rng)
        csq = E.ct_mul(params, c, c)
        cs = E.keyswitch(params, ek, csq)
        g, order = ctx.rotation_generator()
        gk = E.keygen_galois(params, kp, rng, galois_element=g)
        cr = E.rotate(params, gk, c)
        outs.append((kp.secret, ek.maskeds, csq, cs, cr,
                     ctx.decode(E.decrypt(params, kp, cs)), ctx.decode(E.decrypt(params, kp, cr)),
                     ctx.galois_slot_permutation(g)))
    assert outs[0] == outs[1]
    _, _, csq, cs, _, dec_sq, dec_rot, perm = outs[0]
    assert len(csq) == 3 and len(cs) == 2
    assert [s[0] for s in dec_sq[:6]] == [v * v % 256 for v in range(1, 7)]
    vals = [1, 2, 3, 4, 5, 6] + [0] * (len(perm) - 6)
    assert [s[0] for s in dec_rot] == [vals[perm[i]] for i in range(len(perm))]


def test_refparams_equal():
    for p, emc in ((53, 2), (7, 3), (65537, 1), (65537, 4), (257, 0)):
        assert dataclasses.astuple(RP.bfv_reference_paramgen(p, eval_mult_count=emc)) == \
            dataclasses.astuple(RRP.bfv_reference_paramgen(p, eval_mult_count=emc))
    for name in ("bfv_crt_reference_tower", "ckks_modswitch_reference_tower",
                 "ckks_rotate_reference_tower", "mnist_reference_tower", "bgv_palisade_ring"):
        assert getattr(RP, name)() == getattr(RRP, name)()


def test_host_bfv_generic():
    outs = []
    for GR in (G, RG):
        ring, big = GR.GenericRing(31, nt.next_prime(2 ** 51 + 1)), \
            GR.GenericRing(31, nt.next_prime(2 ** 111 + 1))
        scheme = GR.HostBFV(ring, big, 256)
        rng = random.Random(42)
        kp = scheme.keygen(rng)
        c = scheme.encrypt(kp, list(range(1, 31)), rng)
        outs.append((c, scheme.decrypt(kp, scheme.mul(c, c))))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the golden recorder
# ---------------------------------------------------------------------------

def assert_reproduced(golden, name):
    got, want = GO.SCENARIOS[name](GO.SEED), golden[name]
    assert got["params"] == want["params"], "parameter derivation drifted"
    assert got["checks"] == want["checks"], f"{name} diverged"
    assert got.get("material") == want.get("material")


@pytest.mark.parametrize("name", FAST_HOST)
def test_host_reproduces_golden(golden, name):
    assert_reproduced(golden, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW_HOST)
def test_host_reproduces_golden_slow(golden, name):
    assert_reproduced(golden, name)


def test_vec_record_round_trip():
    short, long = list(range(10)), list(range(2000))
    assert GO.vec_matches(GO.vec_record(short), short)
    rec = GO.vec_record(long)
    assert "sha256" in rec and GO.vec_matches(rec, long)
    assert not GO.vec_matches(rec, long[:-1] + [0])
    zs = np.array([1 + 2j, -0.5j])
    assert GO.cvec_err(GO.cvec_record(zs), zs) == 0.0


# ---------------------------------------------------------------------------
# the bootstrap pin
# ---------------------------------------------------------------------------

def test_bootstrap_pin(golden):
    """The reference's golden keys, context and exhausted input, built as its
    ``run_ckks_bootstrap`` builds them, through the port's refresh: the
    refreshed residues are the recorded ones."""
    g = golden["ckks_bootstrap"]
    seed = GO.SEED
    n = 32
    ring = F.make_rns_ring(n, (30,) * 23)
    params = F.ModulusRaised(F.CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=8))
    ks = jax.random.split(jax.random.PRNGKey(seed % (2 ** 31)), 4)
    kp = F.keygen(params, ks[0])
    ctx = RB.setup_bootstrap(ks[1], kp.priv, K=6.0, deg=30, radix=16, arcsin=True,
                             double_angle=2)
    rng = np.random.default_rng(seed % (2 ** 31))
    vals = (rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)) * 0.7
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, Fraction(2) ** 27), ks[2])
    while c.ring.nlimbs > 1:
        c = F.ct_modswitch_drop(c)

    tparams = T.ModulusRaised(T.CKKSParams(T.make_rns_ring(n, (30,) * 23), 0, 3.2,
                                           secret="sparse", hamming_weight=8))
    out = TB.bootstrap(carry_context(params, tparams, ctx), carry_ct(tparams, c))
    assert out.ring.nlimbs == g["params"]["out_levels"]
    comps = [T.ringops.ensure_primal(out.ring, x).primal.numpy().ravel() for x in out.cs]
    assert GO.vec_matches(g["checks"]["ct_c0"], comps[0])
    assert GO.vec_matches(g["checks"]["ct_c1"], comps[1])


def test_port_bootstrap_scenario_in_band(golden):
    got = GO.run_ckks_bootstrap(GO.SEED, device="cpu")
    want = golden["ckks_bootstrap"]
    assert got["params"]["out_levels"] == want["params"]["out_levels"]
    assert {k: v for k, v in got["params"].items() if k != "out_levels"} == \
        {k: v for k, v in want["params"].items() if k != "out_levels"}
    assert 0 < got["checks"]["err_vs_input"] < 2e-2
    assert set(got["checks"]) == set(want["checks"])
