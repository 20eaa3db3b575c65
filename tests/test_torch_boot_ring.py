"""The port's composite-scale bootstrap tower against the reference.

``numtheory.balanced_pair_primes`` and ``bootstrap.make_boot_ring`` give the
reference's primes, up to the production tower (N = 2^13, 46 level limbs,
7 raising primes: 55 limbs); the deficit guards of tests/test_boot_ring.py
hold on the port's copies; and ``bootstrap._rescale_k`` raises on a
collapsed working scale.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.utils import numtheory as rnt
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE
from toyfhe_tpu_torch.utils import numtheory as tnt


def _simulate_deficit(pairs, levels):
    """log2 working-scale deficit after ``levels`` multiplies, consuming
    pairs from the end (e' = 2e − d, d = log2(pair) − 52)."""
    ds = [math.log2(p) - 52 for p in pairs]
    e = 0.0
    for d in ds[-levels:][::-1]:
        e = 2 * e - d
    return abs(e)


@pytest.mark.parametrize("n,npairs,bits,avoid", [
    (64, 4, 26, ()), (1 << 11, 23, 26, ()), (1 << 13, 23, 26, ()),
    (1 << 10, 12, 26, (67043329,)), (1 << 12, 5, 24, ())])
def test_balanced_pair_primes_equal(n, npairs, bits, avoid):
    assert tnt.balanced_pair_primes(n, npairs, bits, avoid=avoid) == \
        rnt.balanced_pair_primes(n, npairs, bits, avoid=avoid)


def test_prev_prime_equal():
    for start, step in ((1 << 26, 1), ((1 << 26) + 1, 2048), (100, 7), (3, 1)):
        assert tnt.prev_prime(start, step) == rnt.prev_prime(start, step)


@pytest.mark.parametrize("n,L,k", [(64, 8, 3), (64, 46, 10), (1 << 10, 24, 7),
                                   (1 << 13, 46, 7)])
def test_make_boot_ring_equal(n, L, k):
    got, ref = TB.make_boot_ring(n, L=L, num_special=k), RB.make_boot_ring(n, L=L, num_special=k)
    assert got.primes == ref.primes and got.n == ref.n
    assert got.nlimbs == 2 + L + k


@pytest.mark.parametrize("logn", [11, 13])
def test_balanced_pairs_stay_pinned(logn):
    n = 1 << logn
    primes = tnt.balanced_pair_primes(n, 23, 26)
    assert len(set(primes)) == 46
    for p in primes:
        assert p % (2 * n) == 1 and tnt.is_prime(p)
    pairs = [primes[2 * i] * primes[2 * i + 1] for i in range(23)]
    worst = max(abs(math.log2(p) - 52) for p in pairs)
    assert worst < 0.05, f"pair deficit {worst:.3f} bits"
    assert _simulate_deficit(pairs, 10) < 3.0


def test_reference_walk_collapses_at_2e13():
    n = 1 << 13
    up = tnt.ntt_prime_chain(n, (26,) * 46)
    up_pairs = [up[2 * i] * up[2 * i + 1] for i in range(23)]
    assert _simulate_deficit(up_pairs, 10) > 20.0
    bal = tnt.balanced_pair_primes(n, 23, 26)
    bal_pairs = [bal[2 * i] * bal[2 * i + 1] for i in range(23)]
    assert _simulate_deficit(bal_pairs, 10) < 3.0


def test_make_boot_ring_shape():
    ring = TB.make_boot_ring(64, L=8, num_special=3)
    assert ring.nlimbs == 2 + 8 + 3
    ps = ring.primes
    assert all(p >> 28 for p in ps[:2])
    assert all(p >> 28 for p in ps[-3:])
    for i in range(4):
        assert abs(math.log2(ps[2 + 2 * i] * ps[3 + 2 * i]) - 52) < 0.1
    assert len(set(ps)) == ring.nlimbs
    with pytest.raises(ValueError, match="even"):
        TB.make_boot_ring(64, L=7, num_special=3)


def test_rescale_collapse_guard():
    ring = T.make_rns_ring(32, (28, 28, 28, 28))
    params = T.CKKSParams(ring, 0, 3.2)
    gen = torch.Generator().manual_seed(0)
    kp = T.keygen(params, gen)
    c = T.encrypt(kp, T.make_plaintext(ring, np.ones(16) * 0.5, Fraction(2) ** 27), gen)
    low = TCE.retag(c, Fraction(2) ** 45)      # post-2-rescale scale about 2^-11
    with pytest.raises(ValueError, match="collapsed"):
        TB._rescale_k(low, 2)
    ok = TB._rescale_k(TCE.retag(c, Fraction(2) ** 100), 2)
    assert ok.ring.nlimbs == 2


def test_derived_towers_are_canonical():
    """A raised tower's drop_last is the ciphertext tower itself (ct_stack
    compares towers by identity)."""
    ring = T.make_rns_ring(16, (20, 20, 20, 20))
    sub = ring.drop_last()
    exp = sub.select([0, 1, 2])
    assert exp.select([0, 1]) is ring.select([0, 1])
    assert ring.select([0, 1, 2]) is sub
    assert sub.select([0, 1, 2]) is sub
    boot = TB.make_boot_ring(64, L=8, num_special=3)
    hp = T.HybridRaised(T.CKKSParams(boot, 0, 3.2), 5, 3)
    raised = boot.select(list(range(6)) + [10, 11, 12])
    assert raised.select(range(6)) is hp.ring_cipher.select(range(6))
    assert hp.ring_cipher.drop_last() is boot.select(range(9))
