"""Golden-vector scenarios: ToyFHE.jl's test suite, run exactly.

Port of ``toyfhe_tpu/core/golden.py``. Each scenario reproduces one
reference test file — the same parameter derivation (:mod:`.refparams`), the
same operation sequence, the same assertions — on the exact host engine
(:mod:`.host_engine`), at the reference's own 40/50/60-bit moduli that the
device's < 2^31 RNS path re-plans away. The decoded results are the records
of ``tests/golden/reference_vectors.json``: ``run_all`` recomputes them, and
every host scenario reproduces its record bit for bit.

Beyond the reference's literal assertions (scalar plaintexts), every
scenario also runs a full-width deterministic plaintext vector, so
"decodes identically" pins every slot/coefficient, not just index 0.

Vectors longer than ``_FULL_LIMIT`` are recorded as SHA-256 digest +
prefix, still a bit-exact check.

``ckks_bootstrap`` is the one scenario off the host engine: it runs the
port's refresh on ``device`` with keys from a ``torch.Generator``, which
cannot replay the reference's ``jax.random`` keys, so its residues are its
own; it asserts the recorded scenario's error band.
"""

from __future__ import annotations

import hashlib
import random
from fractions import Fraction
from typing import Dict, List

import numpy as np
import torch

from ..utils import numtheory as nt
from . import host_engine as HE
from . import plain as PL
from . import refparams as RP

SEED = 20260820
_FULL_LIMIT = 512


# ---------------------------------------------------------------------------
# record helpers
# ---------------------------------------------------------------------------

def vec_record(xs) -> dict:
    xs = [int(x) for x in xs]
    if len(xs) <= _FULL_LIMIT:
        return {"full": xs}
    h = hashlib.sha256(repr(xs).encode()).hexdigest()
    return {"sha256": h, "len": len(xs), "prefix": xs[:64]}


def vec_matches(rec: dict, xs) -> bool:
    xs = [int(x) for x in xs]
    if "full" in rec:
        return rec["full"] == xs
    return (rec["len"] == len(xs) and rec["prefix"] == xs[:64]
            and hashlib.sha256(repr(xs).encode()).hexdigest() == rec["sha256"])


def cvec_record(zs) -> list:
    """Complex slot vector → [[re, im], ...] float64 record."""
    return [[float(z.real), float(z.imag)] for z in np.asarray(zs)]


def cvec_err(rec: list, zs) -> float:
    got = np.asarray(zs, dtype=np.complex128)
    want = np.array([complex(r, i) for r, i in rec])
    return float(np.max(np.abs(got - want))) if len(rec) else 0.0


def _plain_vec(rng: np.random.Generator, n: int, p: int) -> List[int]:
    return [int(x) for x in rng.integers(0, p, size=n)]


# ---------------------------------------------------------------------------
# scenarios (host side)
# ---------------------------------------------------------------------------

def run_bfv_triv(seed: int = SEED) -> dict:
    """test/bfv_triv.jl — BFVParams(53; eval_mult_count=2):
    6 → dec 6; square → 0x24.  Plus a full coefficient vector."""
    rp = RP.bfv_reference_paramgen(53, eval_mult_count=2)
    ring = HE.Pow2HostRing(rp.n, q=rp.qprime)
    big = HE.Pow2HostRing(rp.n, q=rp.qprime_large)
    params = HE.HostParams(ring=ring, scheme="bfv", p=53, sigma=rp.sigma,
                           ring_big=big, relin_window=rp.relin_window,
                           delta=rp.delta)
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    kp = HE.keygen(params, rng)

    out = {"params": {"n": rp.n, "qprime": hex(rp.qprime),
                      "qprime_large": hex(rp.qprime_large),
                      "delta": hex(rp.delta), "p": 53},
           "checks": {}}
    c = HE.encrypt(params, kp, [6], rng)
    d0 = HE.decrypt(params, kp, c)
    assert d0[0] == 6
    out["checks"]["dec"] = vec_record(d0)
    dsq = HE.decrypt(params, kp, HE.ct_mul(params, c, c))
    assert dsq[0] == 0x24
    out["checks"]["dec_sq"] = vec_record(dsq)

    m = _plain_vec(prng, rp.n, 53)
    cv = HE.encrypt(params, kp, m, rng)
    dv = HE.decrypt(params, kp, cv)
    assert dv == m
    out["checks"]["vec_dec"] = vec_record(dv)
    out["checks"]["vec_sq"] = vec_record(
        HE.decrypt(params, kp, HE.ct_mul(params, cv, cv)))
    out["plain"] = {"vec": vec_record(m)}
    return out


def run_bfv_keyswitch(seed: int = SEED) -> dict:
    """test/bfv_keyswitch.jl — BFVParams(7; eval_mult_count=3):
    2 → sq 4 → keyswitch (len 2) → 4 → ×c → 1. Plus full vector."""
    rp = RP.bfv_reference_paramgen(7, eval_mult_count=3)
    ring = HE.Pow2HostRing(rp.n, q=rp.qprime)
    big = HE.Pow2HostRing(rp.n, q=rp.qprime_large)
    params = HE.HostParams(ring=ring, scheme="bfv", p=7, sigma=rp.sigma,
                           ring_big=big, relin_window=rp.relin_window,
                           delta=rp.delta)
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    kp = HE.keygen(params, rng)
    ek = HE.keygen_eval_mult(params, kp, rng)

    out = {"params": {"n": rp.n, "qprime": hex(rp.qprime), "p": 7,
                      "relin_window": rp.relin_window},
           "checks": {}}
    c1 = HE.encrypt(params, kp, [2], rng)
    assert HE.decrypt(params, kp, c1)[0] == 2
    c1sq = HE.ct_mul(params, c1, c1)
    dsq = HE.decrypt(params, kp, c1sq)
    assert dsq[0] == 4
    out["checks"]["dec_sq"] = vec_record(dsq)
    cs = HE.keyswitch(params, ek, c1sq)
    assert len(cs) == 2
    dks = HE.decrypt(params, kp, cs)
    assert dks[0] == 4
    out["checks"]["dec_keyswitched"] = vec_record(dks)
    dmul = HE.decrypt(params, kp, HE.ct_mul(params, cs, c1))
    assert dmul[0] == 1
    out["checks"]["dec_mul_after_switch"] = vec_record(dmul)

    m = _plain_vec(prng, rp.n, 7)
    cv = HE.encrypt(params, kp, m, rng)
    cvs = HE.keyswitch(params, ek, HE.ct_mul(params, cv, cv))
    out["checks"]["vec_sq_switched"] = vec_record(HE.decrypt(params, kp, cvs))
    out["plain"] = {"vec": vec_record(m)}
    return out


def run_bfv_crt(seed: int = SEED) -> dict:
    """test/bfv_crt.jl — hand-built 2-limb 50-bit ciphertext tower +
    4-limb big ring, p=53, σ=3.2: 6 → dec 6; square → 0x24.

    The reference's literal 4-limb ℛbig (≈2^200) is ~4 bits SHORT of
    holding the exact centered tensor product at n=2048, q≈2^101 (max
    coefficient ≈2^204): a handful of coefficients wrap mod ℛbig and
    decode off-by-±1 — the reference test survives because it asserts
    only coefficient 0 (bfv_crt.jl:42-47). We therefore record the
    literal-params scalar assertions (index 0), and take the FULL-vector
    bit-exact contract on a sound big ring: the same nextprime walk
    continued two more steps (6 limbs ≈ 2^300), which makes multround
    exact for every coefficient."""
    n, ct_tower, big_tower = RP.bfv_crt_reference_tower()
    ring = HE.Pow2HostRing(n, moduli=ct_tower)
    big = HE.Pow2HostRing(n, moduli=big_tower)
    params = HE.HostParams(ring=ring, scheme="bfv", p=53, sigma=3.2,
                           ring_big=big, relin_window=1,
                           delta=ring.q // 53)
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    kp = HE.keygen(params, rng)

    out = {"params": {"n": n, "tower": [hex(q) for q in ct_tower],
                      "big_tower": [hex(q) for q in big_tower], "p": 53},
           "checks": {}}
    c = HE.encrypt(params, kp, [6], rng)
    d0 = HE.decrypt(params, kp, c)
    assert d0[0] == 6
    out["checks"]["dec"] = vec_record(d0)       # no mul: exact everywhere
    dsq = HE.decrypt(params, kp, HE.ct_mul(params, c, c))
    assert dsq[0] == 0x24
    out["checks"]["dec_sq0"] = int(dsq[0])      # literal reference assertion

    # sound-big-ring variant: same walk, 2 more primes (exact multround)
    s = 2 * n
    ext = list(big_tower)
    for _ in range(2):
        ext.append(nt.next_prime(ext[-1] + s, s))
    params_snd = HE.HostParams(ring=ring, scheme="bfv", p=53, sigma=3.2,
                               ring_big=HE.Pow2HostRing(n, moduli=ext),
                               relin_window=1, delta=ring.q // 53)
    out["params"]["big_tower_sound"] = [hex(q) for q in ext]
    dsq_snd = HE.decrypt(params_snd, kp, HE.ct_mul(params_snd, c, c))
    assert dsq_snd[0] == 0x24
    out["checks"]["dec_sq_sound"] = vec_record(dsq_snd)
    m = _plain_vec(prng, n, 53)
    cv = HE.encrypt(params_snd, kp, m, rng)
    out["checks"]["vec_sq"] = vec_record(
        HE.decrypt(params_snd, kp, HE.ct_mul(params_snd, cv, cv)))
    out["plain"] = {"vec": vec_record(m)}
    return out


def run_bgv_triv(seed: int = SEED) -> dict:
    """test/bgv_triv.jl — PALISADE m=4096 ring, p=256, σ=8/√(2π):
    6 → dec 6; square → 0x24."""
    n, q = RP.bgv_palisade_ring()
    ring = HE.Pow2HostRing(n, q=q)
    params = HE.HostParams(ring=ring, scheme="bgv", p=256)
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    kp = HE.keygen(params, rng)

    out = {"params": {"n": n, "q": hex(q), "p": 256}, "checks": {}}
    c = HE.encrypt(params, kp, [6], rng)
    d0 = HE.decrypt(params, kp, c)
    assert d0[0] == 6
    out["checks"]["dec"] = vec_record(d0)
    dsq = HE.decrypt(params, kp, HE.ct_mul(params, c, c))
    assert dsq[0] == 0x24
    out["checks"]["dec_sq"] = vec_record(dsq)

    m = _plain_vec(prng, n, 256)
    cv = HE.encrypt(params, kp, m, rng)
    out["checks"]["vec_sq"] = vec_record(
        HE.decrypt(params, kp, HE.ct_mul(params, cv, cv)))
    out["plain"] = {"vec": vec_record(m)}
    return out


def _ckks_decrypt_decode(params, kp, cs, scale):
    dec = HE.decrypt(params, kp, cs)
    # π is identity for CKKS; decrypt() returns centered coefficients.
    return HE.ckks_decode_host(params.ring, [x % params.ring.q for x in dec],
                               scale)


def run_ckks_triv(seed: int = SEED) -> dict:
    """test/ckks_triv.jl — ring from the BFV estimator (p=7, emc=3),
    scale 2^40, slots = LinRange(0,1,N/2): encode/square in plain, then
    encrypted dec and square (atol 1e-4)."""
    rp = RP.ckks_triv_reference_params()
    ring = HE.Pow2HostRing(rp.n, q=rp.qprime)
    params = HE.HostParams(ring=ring, scheme="ckks", sigma=rp.sigma)
    rng = random.Random(seed)
    scale = Fraction(2 ** 40)
    nslots = rp.n // 2
    slots = np.linspace(0.0, 1.0, nslots).astype(np.complex128)

    out = {"params": {"n": rp.n, "qprime": hex(rp.qprime), "scale": "2^40"},
           "checks": {}}
    # encoder in isolation (ckks_triv.jl:19-25): encode, ring-square, decode
    re = HE.ckks_encode_host(ring, slots, scale)
    sq = ring.mul(re, re)
    dec_sq = HE.ckks_decode_host(ring, sq, scale * scale)
    assert np.max(np.abs(dec_sq.real - np.linspace(0, 1, nslots) ** 2)) < 1e-4
    out["checks"]["plain_sq"] = cvec_record(dec_sq)

    kp = HE.keygen(params, rng)
    c = HE.encrypt(params, kp, re, rng)
    d = _ckks_decrypt_decode(params, kp, c, scale)
    assert np.max(np.abs(d.real - np.linspace(0, 1, nslots))) < 1e-4
    out["checks"]["dec"] = cvec_record(d)
    dsq = _ckks_decrypt_decode(params, kp, HE.ct_mul(params, c, c),
                               scale * scale)
    assert np.max(np.abs(dsq.real - np.linspace(0, 1, nslots) ** 2)) < 1e-4
    out["checks"]["dec_sq"] = cvec_record(dsq)
    return out


def run_ckks_modswitch(seed: int = SEED) -> dict:
    """test/ckks_modswitch.jl — N=2^5, 3×~40-bit tower, scale 2^60:
    rescale plain-only (atol 1e-5) and encrypted (atol 1e-3)."""
    n, tower = RP.ckks_modswitch_reference_tower()
    ring = HE.Pow2HostRing(n, moduli=tower)
    params = HE.HostParams(ring=ring, scheme="ckks", sigma=3.2)
    rng = random.Random(seed)
    scale = Fraction(2 ** 60)
    slots = np.full(n // 2, 2.0, dtype=np.complex128)

    out = {"params": {"n": n, "tower": [hex(q) for q in tower],
                      "scale": "2^60"}, "checks": {}}
    re = HE.ckks_encode_host(ring, slots, scale)
    sub, (rs,) = HE.modswitch(params, (re,))
    d = HE.ckks_decode_host(sub.ring, rs, scale / tower[-1])
    assert abs(d[0] - 2.0) < 1e-5
    out["checks"]["plain_modswitch"] = cvec_record(d)

    kp = HE.keygen(params, rng)
    c = HE.encrypt(params, kp, re, rng)
    sub, cs = HE.modswitch(params, c)
    d = _ckks_decrypt_decode(sub, kp, cs, scale / tower[-1])
    assert np.max(np.abs(d - slots)) < 1e-3
    out["checks"]["enc_modswitch"] = cvec_record(d)
    return out


def run_ckks_rotate(seed: int = SEED) -> dict:
    """test/ckks_rotate.jl — N=2^4, 2-limb tower, scale 2^60, slots
    1..N/2 with +1i at 0: plain galois(3) = circshift(-1); encrypted
    manual eval key; GaloisKey steps=1 = circshift(+1)."""
    n, tower = RP.ckks_rotate_reference_tower()
    ring = HE.Pow2HostRing(n, moduli=tower)
    params = HE.HostParams(ring=ring, scheme="ckks", sigma=3.2,
                           relin_window=1)
    rng = random.Random(seed)
    scale = Fraction(2 ** 60)
    slots = np.arange(1, n // 2 + 1, dtype=np.complex128)
    slots[0] += 1j

    out = {"params": {"n": n, "tower": [hex(q) for q in tower],
                      "scale": "2^60"}, "checks": {}}
    re = HE.ckks_encode_host(ring, slots, scale)
    dplain = HE.ckks_decode_host(ring, ring.galois(re, 3), scale)
    assert np.max(np.abs(dplain - np.roll(slots, -1))) < 1e-6
    out["checks"]["plain_galois3"] = cvec_record(dplain)

    kp = HE.keygen(params, rng)
    # manual eval key σ₃(s) ⇒ s (ckks_rotate.jl:35-40)
    c = HE.encrypt(params, kp, re, rng)
    sg = ring.galois(kp.secret, 3)
    ek = HE.make_eval_key(params, sg, kp, rng, galois_element=3)
    cg = tuple(ring.galois(ci, 3) for ci in c)
    d = _ckks_decrypt_decode(params, kp, HE.keyswitch(params, ek, cg), scale)
    assert np.max(np.abs(d - np.roll(slots, -1))) < 1e-3
    out["checks"]["enc_galois3"] = cvec_record(d)

    # GaloisKey steps API (ckks_rotate.jl:43-45)
    gk = HE.keygen_galois(params, kp, rng, steps=1)
    c2 = HE.encrypt(params, kp, re, rng)
    d2 = _ckks_decrypt_decode(params, kp, HE.rotate(params, gk, c2), scale)
    assert np.max(np.abs(d2 - np.roll(slots, 1))) < 1e-3
    out["checks"]["enc_rotate_step1"] = cvec_record(d2)
    return out


def run_ckks_matmul(seed: int = SEED) -> dict:
    """test/ckks_matmul.jl — N=2^5, 3-limb tower, 4×4 all-ones matrix by
    rotation-diagonal matmul on slots 1..16 (atol 1e-5)."""
    n = 2 ** 5
    s = 2 * n
    q0 = nt.next_prime(2 ** 40 + 1, s)
    q1 = nt.next_prime(q0 + s, s)
    ps = nt.next_prime(q1 + s, s)
    tower = [q0, q1, ps]
    ring = HE.Pow2HostRing(n, moduli=tower)
    params = HE.HostParams(ring=ring, scheme="ckks", sigma=3.2,
                           relin_window=1)
    rng = random.Random(seed)
    scale = Fraction(2 ** 40)
    nslots = n // 2
    slots = np.arange(1, nslots + 1, dtype=np.complex128)
    W = np.ones((4, 4))

    out = {"params": {"n": n, "tower": [hex(q) for q in tower],
                      "scale": "2^40"}, "checks": {}}
    kp = HE.keygen(params, rng)
    c = HE.encrypt(params, kp, HE.ckks_encode_host(ring, slots, scale), rng)
    gk = HE.keygen_galois(params, kp, rng, steps=4)

    def plain_mul(cs, vec):
        enc = HE.ckks_encode_host(ring, np.asarray(vec, np.complex128), scale)
        return tuple(ring.mul(ci, enc) for ci in cs)

    # encrypted_matmul (ckks_matmul.jl:34-43), mirrored in plain numpy
    result = plain_mul(c, np.tile(np.diag(W), 4))
    want = np.tile(np.diag(W), 4) * slots
    rotated = c
    rot_p = slots
    for k in range(2, 5):
        rotated = HE.rotate(params, gk, rotated)
        rot_p = np.roll(rot_p, 4)
        diag = np.tile(np.diag(np.roll(W, k - 1, axis=1)), 4)
        result = HE.ct_add(params, result, plain_mul(rotated, diag))
        want = want + diag * rot_p
    d = _ckks_decrypt_decode(params, kp, result, scale * scale)
    assert np.max(np.abs(d - want)) < 1e-5, np.max(np.abs(d - want))
    out["checks"]["matmul"] = cvec_record(d)
    return out


def _slot_coeffs(pring, slots) -> List[int]:
    """Slot values → plaintext coefficients as Python ints (the port's slot
    transform, run on the host)."""
    return [int(x) for x in PL.slot_encode(pring, slots, device="cpu").coeffs]


def _slot_values(pring, coeffs) -> np.ndarray:
    return PL.slot_decode(PL.PlainPoly(pring, np.asarray(coeffs, dtype=np.int64)),
                          device="cpu")


def run_bfv_simd(seed: int = SEED) -> dict:
    """test/bfv_simd.jl — BFVParams(65537; eval_mult_count=1), NTT
    SlotEncoding: slots (1,1,0,…)·(5,10,10,…) → (5,10,0,…). Plus a full
    deterministic slot vector. Slot order is the plaintext-field NTT of
    core/plain.py (exact integer arithmetic mod p — one convention for
    host and device)."""
    rp = RP.bfv_reference_paramgen(65537, eval_mult_count=1)
    ring = HE.Pow2HostRing(rp.n, q=rp.qprime)
    big = HE.Pow2HostRing(rp.n, q=rp.qprime_large)
    params = HE.HostParams(ring=ring, scheme="bfv", p=65537, sigma=rp.sigma,
                           ring_big=big, relin_window=rp.relin_window,
                           delta=rp.delta)
    rng = random.Random(seed)
    prng = np.random.default_rng(seed)
    pring = PL.PlainRing(rp.n, 65537)
    kp = HE.keygen(params, rng)

    out = {"params": {"n": rp.n, "qprime": hex(rp.qprime),
                      "qprime_large": hex(rp.qprime_large), "p": 65537},
           "checks": {}}
    s1 = np.zeros(rp.n, dtype=np.int64)
    s1[0] = s1[1] = 1                                  # plain[0]=plain[1]=1
    s2 = np.full(rp.n, 10, dtype=np.int64)
    s2[0] = 5                                          # plain2[:]=10, [0]=5
    c1 = HE.encrypt(params, kp, _slot_coeffs(pring, s1), rng)
    c2 = HE.encrypt(params, kp, _slot_coeffs(pring, s2), rng)
    y = HE.ct_mul(params, c1, c2)
    dec = _slot_values(pring, HE.decrypt(params, kp, y))
    assert dec[0] == 5 and dec[1] == 10 and not dec[2:].any()
    out["checks"]["slots_mul"] = vec_record(dec)

    sv = prng.integers(0, 65537, size=rp.n)
    cv = HE.encrypt(params, kp, _slot_coeffs(pring, sv), rng)
    decv = _slot_values(pring, HE.decrypt(params, kp, HE.ct_mul(params, cv, cv)))
    assert (decv == (sv * sv) % 65537).all()
    out["checks"]["vec_slots_sq"] = vec_record(decv)
    out["plain"] = {"slots": vec_record(sv)}
    return out


def run_bfv_noise(seed: int = SEED) -> dict:
    """test/bfv_noise.jl — BFVParams(7; eval_mult_count=3): the
    invariant-noise-budget trace through 3 muls + relins at the
    reference's own modulus. The worst Δ-lattice residues are exact
    integers — the recordable golden quantity; budgets (floats) follow
    from them. Asserts the reference's strict ordering and the final
    1 < b < 10 window (bfv_noise.jl:21-34)."""
    rp = RP.bfv_reference_paramgen(7, eval_mult_count=3)
    ring = HE.Pow2HostRing(rp.n, q=rp.qprime)
    big = HE.Pow2HostRing(rp.n, q=rp.qprime_large)
    params = HE.HostParams(ring=ring, scheme="bfv", p=7, sigma=rp.sigma,
                           ring_big=big, relin_window=rp.relin_window,
                           delta=rp.delta)
    rng = random.Random(seed)
    kp = HE.keygen(params, rng)
    ek = HE.keygen_eval_mult(params, kp, rng)

    c1 = HE.encrypt(params, kp, [2], rng)
    trace = []

    def probe(tag, cs):
        b, worst = HE.invariant_noise_budget(params, kp, cs)
        trace.append({"step": tag, "worst": hex(worst), "budget": round(b, 6)})
        return b

    b1 = probe("fresh", c1)
    c1sq = HE.ct_mul(params, c1, c1)
    b2 = probe("square", c1sq)
    assert b2 < b1
    cswitch1 = HE.keyswitch(params, ek, c1sq)
    bswitch1 = probe("keyswitch1", cswitch1)
    cswitchmul = HE.ct_mul(params, cswitch1, c1)
    bswitchmul = probe("mul2", cswitchmul)
    assert bswitchmul < bswitch1 < b1
    cswitch2 = HE.keyswitch(params, ek, cswitchmul)
    bswitch2 = probe("keyswitch2", cswitch2)
    cswitchmul2 = HE.ct_mul(params, cswitch2, c1)
    bswitchmul2 = probe("mul3", cswitchmul2)
    assert bswitchmul2 < bswitch2 < bswitch1
    assert 1 < bswitchmul2 < 10, bswitchmul2         # bfv_noise.jl:34
    dec = HE.decrypt(params, kp, cswitchmul2)
    assert dec[0] == pow(2, 4, 7)
    return {"params": {"n": rp.n, "qprime": hex(rp.qprime), "p": 7},
            "checks": {"trace": trace, "dec_final": vec_record(dec)}}


def run_bfv_uint8(seed: int = SEED) -> dict:
    """test/bfv_uint8.jl — prime cyclotomic found by factor count
    (m=31 for >3 slots over 𝔽₂), p=256 Hensel slots, q=nextprime(2^51),
    ℛbig at nextprime(2^111): slots (1..6) → squares mod 256."""
    from . import generic_ring as G
    from .polycrt import PolyCRTContext

    m = 2
    while True:                     # find_cyclotomic (bfv_uint8.jl:20-31)
        m = nt.next_prime(m + 1)
        d = 1
        while pow(2, d, m) != 1:
            d += 1
        if (m - 1) // d > 3:
            break
    q = nt.next_prime(2 ** 51 + 1)
    qbig = nt.next_prime(2 ** 111 + 1)
    ring = G.GenericRing(m, q)
    params = HE.HostParams(ring=ring, scheme="bfv", p=256,
                           ring_big=G.GenericRing(m, qbig),
                           relin_window=1, delta=q // 256)
    ctx = PolyCRTContext(m, 2, 8)
    rng = random.Random(seed)
    kp = HE.keygen(params, rng)

    vals = [1, 2, 3, 4, 5, 6]
    c1 = HE.encrypt(params, kp, ctx.encode(vals), rng)
    dec = HE.decrypt(params, kp, HE.ct_mul(params, c1, c1))
    slots = ctx.decode(dec)
    assert [s[0] for s in slots[:6]] == [v * v % 256 for v in vals]
    assert all(all(x == 0 for x in s[1:]) for s in slots[:6])
    return {"params": {"m": m, "q": hex(q), "qbig": hex(qbig), "p": 256,
                       "nslots": ctx.nslots, "d": ctx.d},
            "checks": {"dec_sq_poly": vec_record(dec),
                       "slots_sq": [s for s in slots]}}


def run_polycrt_encoding(seed: int = SEED) -> dict:
    """test/polycrt_encoding.jl — Φ₇ over 𝔽₂, no crypto: slots β+1,
    β²+1 encode to a ring element and decode back exactly
    (polycrt_encoding.jl:14-22)."""
    from .polycrt import PolyCRTContext

    ctx = PolyCRTContext(7, 2)
    assert ctx.nslots == 2 and ctx.d == 3
    slots = [[1, 1, 0], [1, 0, 1]]                  # β+1, β²+1
    coeffs = ctx.encode(slots)
    dec = ctx.decode(coeffs)
    assert dec[0] == [1, 1, 0] and dec[1] == [1, 0, 1]
    return {"params": {"m": 7, "p": 2, "nslots": 2, "d": 3},
            "checks": {"encoded_poly": vec_record(coeffs),
                       "decoded_slots": dec}}


def run_ckks_modraise(seed: int = SEED) -> dict:
    """test/ckks_modraise.jl — N=2^5, tower (q₀,q₁,pₛ) from the 2^40
    walk, ModulusRaised(CKKSParams(ℛ, 0, 3.2)), scale 2^40, slots
    1..N/2: keyswitch(make_eval_key(s⇒s), c) round-trips to the
    plaintext within 1e-8. Host semantics mirror modulusraising.jl:
    keys at the full tower encrypt pₛ·old; the ciphertext digit lift is
    per-ct-limb (relin_window=0); c₁ rides the pₛ-scaled channel; the
    accumulator is rescaled by pₛ."""
    n = 2 ** 5
    s = 2 * n
    q0 = nt.next_prime(2 ** 40 + 1, s)
    q1 = nt.next_prime(q0 + s, s)
    ps = nt.next_prime(q1 + s, s)
    full = HE.Pow2HostRing(n, moduli=[q0, q1, ps])
    ct_ring = HE.Pow2HostRing(n, moduli=[q0, q1])
    pfull = HE.HostParams(ring=full, scheme="ckks", sigma=3.2,
                          relin_window=0)
    rng = random.Random(seed)
    scale = Fraction(2 ** 40)
    slots = np.arange(1, n // 2 + 1, dtype=np.complex128)

    kp = HE.keygen(pfull, rng)                      # secret at full tower
    # encrypt at the full tower, drop the special limb
    # (modulusraising.jl:23-26)
    re = HE.ckks_encode_host(ct_ring, slots, scale)
    c_full = HE.encrypt(pfull, kp, [0] * n, rng)
    c = tuple([x % ct_ring.q for x in comp] for comp in c_full)
    c = (ct_ring.add(c[0], re), c[1])
    # eval key s ⇒ s lifted by pₛ (make_eval_key override,
    # modulusraising.jl:28-32), RNS digits over the FULL tower
    ek = HE.make_eval_key(pfull, full.scalar(ps, kp.secret), kp, rng)

    # keyswitch with expand/contract (modulusraising.jl:35-49): digits
    # are the ct-limb centered lifts; c₁ is pₛ-scaled into the full tower
    digits = [[nt.centered(x % qi, qi) % full.q for x in c[1]]
              for qi in [q0, q1]]
    c1e = [ps * (x % ct_ring.q) % full.q for x in c[0]]
    c2e = full.zero()
    for i, dig in enumerate(digits):                # first Lt key digits
        c2e = full.add(c2e, full.mul(ek.masks[i], dig))
        c1e = full.add(c1e, full.mul(ek.maskeds[i], dig))
    _, o1 = full.rescale(c1e)
    _, o2 = full.rescale(c2e)

    pct = HE.HostParams(ring=ct_ring, scheme="ckks", sigma=3.2)
    d = _ckks_decrypt_decode(pct, kp, (o1, o2), scale)
    err = float(np.max(np.abs(d - slots)))
    assert err < 1e-8, err                          # ckks_modraise.jl:30
    return {"params": {"n": n, "tower": [hex(q0), hex(q1), hex(ps)],
                       "scale": "2^40"},
            "checks": {"roundtrip": cvec_record(d),
                       "err": err}}


def run_ckks_device_tower(seed: int = SEED) -> dict:
    """Device-tower CKKS goldens: the host engine runs at the DEVICE's own
    re-planned <2^31 RNS tower and records the ciphertext, keys and raw
    decrypted integers for encrypt → square → RNS-keyswitch → rescale. The
    device test imports
    the recorded ciphertext/keys as residues, runs ITS engine, and the
    raw integers must match BIT-exactly (all ops are exact integer
    arithmetic) — no summed float tolerances."""
    n = 2 ** 5
    tower = nt.ntt_prime_chain(n, (28, 28, 28))
    ring = HE.Pow2HostRing(n, moduli=tower)
    params = HE.HostParams(ring=ring, scheme="ckks", sigma=3.2,
                           relin_window=0)
    rng = random.Random(seed)
    scale = Fraction(2 ** 26)
    slots = np.linspace(0.1, 1.0, n // 2).astype(np.complex128)

    kp = HE.keygen(params, rng)
    ek = HE.keygen_eval_mult(params, kp, rng)
    re = HE.ckks_encode_host(ring, slots, scale)
    c = HE.encrypt(params, kp, re, rng)
    csq = HE.ct_mul(params, c, c)
    cks = HE.keyswitch(params, ek, csq)
    sub, crs = HE.modswitch(params, cks)

    raw = HE.decrypt_raw(sub, kp, crs, sub.ring)
    d = HE.ckks_decode_host(sub.ring, raw, scale * scale / tower[-1])
    assert np.max(np.abs(d - slots ** 2)) < 1e-4

    hexv = lambda xs: [hex(int(x)) for x in xs]
    return {"params": {"n": n, "tower": [hex(q) for q in tower],
                       "scale": "2^26"},
            "material": {
                "secret": hexv(kp.secret),
                "ct": [hexv(comp) for comp in c],
                "ek_masks": [hexv(m) for m in ek.masks],
                "ek_maskeds": [hexv(m) for m in ek.maskeds]},
            "checks": {"raw_rescaled": vec_record(raw),
                       "decoded": cvec_record(d)}}


def run_ckks_bootstrap(seed: int = SEED, *, device) -> dict:
    """The golden CKKS bootstrap scenario on the port's refresh, on
    ``device``: the reference's configuration (N = 32, 23 30-bit limbs under
    ModulusRaised, a sparse secret of weight 8, ModRaise → factored
    CoeffToSlot (radix 16) → double-angle EvalMod with the arcsine
    correction → SlotToCoeff) and checks, with keys and encryption
    randomness from a ``torch.Generator`` seeded by ``seed``. Records the
    refreshed ciphertext's residues and the decoded slots, and asserts the
    reference's error band (< 2e-2)."""
    from . import bootstrap as B
    from .ckks import CKKSParams
    from .ckks_encoding import make_plaintext
    from .modraise import ModulusRaised
    from .ring import ensure_primal, make_rns_ring
    from .rlwe import ct_modswitch_drop, decrypt, encrypt, keygen

    n = 32
    ring = make_rns_ring(n, (30,) * 23)
    params = ModulusRaised(CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=8))
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 31))
    kp = keygen(params, gen)
    ctx = B.setup_bootstrap(gen, kp.priv, K=6.0, deg=30, radix=16, arcsin=True,
                            double_angle=2)
    rng = np.random.default_rng(seed % (2 ** 31))
    vals = (rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)) * 0.7
    c = encrypt(kp, make_plaintext(params.ring_cipher, vals, Fraction(2) ** 27), gen)
    while c.ring.nlimbs > 1:
        c = ct_modswitch_drop(c)
    out = B.bootstrap(ctx, c)

    comps = [ensure_primal(out.ring, x).primal.cpu().numpy().ravel() for x in out.cs]
    dec = np.asarray(decrypt(kp, out))
    err = float(np.max(np.abs(dec - vals)))
    assert err < 2e-2, f"golden bootstrap refresh broken: err {err:.2e}"
    return {"params": {"n": n, "tower": "23x30-bit", "radix": 16,
                       "K": 6.0, "deg": 30, "double_angle": 2,
                       "arcsin": True, "scale": "2^27",
                       "out_levels": out.ring.nlimbs},
            "checks": {"ct_c0": vec_record(comps[0]),
                       "ct_c1": vec_record(comps[1]),
                       "decoded": cvec_record(dec),
                       "err_vs_input": err}}


SCENARIOS = {
    "bfv_triv": run_bfv_triv,
    "bfv_keyswitch": run_bfv_keyswitch,
    "bfv_crt": run_bfv_crt,
    "bfv_simd": run_bfv_simd,
    "bfv_noise": run_bfv_noise,
    "bfv_uint8": run_bfv_uint8,
    "polycrt_encoding": run_polycrt_encoding,
    "bgv_triv": run_bgv_triv,
    "ckks_triv": run_ckks_triv,
    "ckks_modswitch": run_ckks_modswitch,
    "ckks_rotate": run_ckks_rotate,
    "ckks_matmul": run_ckks_matmul,
    "ckks_modraise": run_ckks_modraise,
    "ckks_device_tower": run_ckks_device_tower,
    "ckks_bootstrap": run_ckks_bootstrap,
}


def run_all(seed: int = SEED, *, device) -> Dict[str, dict]:
    """Every scenario's record; ``device`` runs the bootstrap scenario."""
    out = {name: fn(seed) for name, fn in SCENARIOS.items() if name != "ckks_bootstrap"}
    out["ckks_bootstrap"] = run_ckks_bootstrap(seed, device=device)
    return out
