"""toyfhe_tpu_torch's C++ CRT against the reference's, on the CPU.

* each of ``CrtNative``'s four functions returns the reference's array on
  the same residues, over towers at N ∈ {64, 2^13} with primes past 2^30,
  ``decode_bfv`` also on exact ties of the Δ lattice;
* ``decode_centered_mod`` and ``decode_bfv`` equal the exact Python CRT
  (``RingContext.to_bigint``), ``decode_centered_double`` lies within one
  rounding step of the exact centered value;
* the port's ``ckks_decode`` and ``bgv_noise_budget`` equal the reference's
  defaults (which take its C++ CRT) exactly at N = 2^13 with seven 28-bit
  limbs: the decode rounds as the library does, not as one exact division;
* a library that cannot be built raises with the compiler's message.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu import native as ref_native
from toyfhe_tpu_torch import native
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

# (N, limb bits): the reference's own test tower, one with three primes past
# 2^30, the serving data tower and a 16-limb tower with eight primes past 2^30
TOWERS = [(64, (30, 29, 28, 28)), (64, (30, 30, 30, 28, 28)),
          (1 << 13, (28,) * 7), (1 << 13, (30,) * 8 + (28,) * 8)]


def residues(primes, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, n, dtype=np.int64) for p in primes])


def embed(values, primes):
    """Integers (any sign) as residues [L, len(values)]."""
    return np.array([[int(v) % p for v in values] for p in primes], dtype=np.int64)


@pytest.fixture(scope="module", params=TOWERS, ids=lambda t: f"N{t[0]}-L{len(t[1])}")
def tower(request):
    n, bits = request.param
    primes = nt.ntt_prime_chain(n, bits)
    if ref_native.get_lib() is None:
        pytest.fail("the reference's C++ library did not build on this host")
    return n, primes, native.CrtNative(primes), ref_native.CrtNative(primes)


def test_four_functions_equal_the_reference(tower):
    n, primes, port, ref = tower
    q = int(np.prod([int(p) for p in primes], dtype=object))
    res = residues(primes, n, len(primes))
    for p in (2, 53, 65537):
        np.testing.assert_array_equal(port.decode_centered_mod(res, p),
                                      ref.decode_centered_mod(res, p))
        np.testing.assert_array_equal(port.decode_bfv(res, q // p, p),
                                      ref.decode_bfv(res, q // p, p))
        assert port.noise_worst(res, q // p) == ref.noise_worst(res, q // p)
    np.testing.assert_array_equal(port.decode_centered_double(res),
                                  ref.decode_centered_double(res))


def test_exact_against_the_python_crt(tower):
    n, primes, port, _ = tower
    ring = T.make_ring(n, primes)
    q = ring.modulus
    res = residues(primes, n, 7)
    xs = [nt.centered(x, q) for x in ring.to_bigint(res)]
    for p in (53, 65537):
        delta = q // p
        assert list(port.decode_centered_mod(res, p)) == [x % p for x in xs]
        assert list(port.decode_bfv(res, delta, p)) == [nt.divround(x, delta) % p for x in xs]
    got = port.decode_centered_double(res)
    want = np.array([float(x) for x in xs])
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -51)


def test_decode_bfv_ties(tower):
    """Values at exact midpoints of the Δ lattice (Δ even), both signs and at
    the ends of the centered range, round away from zero as the exact path."""
    n, primes, port, ref = tower
    q = int(np.prod([int(p) for p in primes], dtype=object))
    p = 65537
    delta = (q // p) & ~1
    rng = np.random.default_rng(11)
    ks = rng.integers(-(p // 2) + 1, p // 2, n)
    vals = [int(k) * delta + (delta // 2 if j % 2 else -(delta // 2)) for j, k in enumerate(ks)]
    vals[:4] = [delta // 2, -(delta // 2), (p // 2) * delta - delta // 2, 0]
    res = embed(vals, primes)
    want = [nt.divround(nt.centered(v % q, q), delta) % p for v in vals]
    assert list(port.decode_bfv(res, delta, p)) == want
    np.testing.assert_array_equal(port.decode_bfv(res, delta, p), ref.decode_bfv(res, delta, p))


@pytest.fixture(scope="module")
def serving():
    """Shared residues and a shared ternary secret at N = 2^13, seven 28-bit
    limbs, in both packages."""
    n, bits = 1 << 13, (28,) * 7
    rring, tring = F.make_rns_ring(n, bits), T.make_rns_ring(n, bits)
    assert rring.primes == tring.primes
    rng = np.random.default_rng(2026)
    c0, c1 = residues(tring.primes, n, 3), residues(tring.primes, n, 4)
    s = embed(rng.integers(-1, 2, n), tring.primes)
    return rring, tring, c0, c1, s


def test_ckks_decode_equals_the_reference(serving):
    rring, tring, c0, _, _ = serving
    scale = Fraction(2) ** 26
    want = F.ckks_decode(rring, F.RingElt(primal=jnp.asarray(c0.astype(np.uint32))), scale)
    got = T.ckks_decode(tring, T.RingElt(primal=torch.as_tensor(c0)), scale)
    assert np.array_equal(got, want)


def test_bgv_noise_budget_equals_the_reference(serving):
    rring, tring, c0, c1, s = serving
    rparams, tparams = F.BGVParams(rring, 65537, 3.2), T.BGVParams(tring, 65537, 3.2)
    u32 = lambda a: F.RingElt(primal=jnp.asarray(a.astype(np.uint32)))
    rkey = F.PrivKey(rparams, u32(s))
    tkey = T.PrivKey(tparams, T.RingElt(primal=torch.as_tensor(s)))
    rc = F.CipherText(rparams, (u32(c0), u32(c1)), rring)
    tc = T.CipherText(tparams, (T.RingElt(primal=torch.as_tensor(c0)),
                                T.RingElt(primal=torch.as_tensor(c1))), tring)
    assert T.bgv_noise_budget(tkey, tc) == F.bgv_noise_budget(rkey, rc)


def test_ring_native_is_kept_per_tower():
    ring = T.make_rns_ring(64, (30, 29, 28))
    assert ring.native() is ring.native()
    assert ring.drop_last().native() is not ring.native()
    assert ring.drop_last().native().L == 2


def test_build_failure_raises_with_the_compiler_message(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int fhe_crt_ctx_size( { return 0; }\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(broken, tmp_path / "libbroken.so")
    assert not (tmp_path / "libbroken.so").exists()
    # and the decodes do not fall back: the ring's first native() raises
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "lib.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        T.make_rns_ring(64, (30, 29)).native()


def test_bad_residue_shapes_raise(tower):
    n, primes, port, _ = tower
    with pytest.raises(ValueError):
        port.decode_centered_double(np.zeros((len(primes) + 1, 4), dtype=np.int64))
    with pytest.raises(ValueError):
        port.decode_bfv(np.zeros((2, len(primes), 4), dtype=np.int64), 5, 3)
