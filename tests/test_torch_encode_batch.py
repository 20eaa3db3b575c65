"""The port's batched CKKS encode against the reference's per-vector one.

``ckks_encode_batch`` on a batch of slot vectors gives, row for row, the
residues of the reference's ``ckks_encode`` of each vector: on
``MNISTConfig()``'s 11-limb tower at N = 2^13 (a request's 49 grid
vectors, scale 2^28), on the bootstrapped recipe's 48-limb ciphertext tower
at N = 2^6 (scale 2^26), at a scale that is no power of two (every vector
through the exact loop), with one vector past the fast path's 2^52 bound
among fast ones, and on the rows a rank of a sharded tower holds. One vector
with an imaginary part fails the whole batch. The cached ℤm* map equals its
loop and cannot be written; ``public_preprocess``'s gather equals the
reference's loop.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from toyfhe_tpu.core import ckks_encoding as RCE
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu.models import mnist as RM
from toyfhe_tpu_torch.core import ckks_encoding as TCE
from toyfhe_tpu_torch.core import ring as TR
from toyfhe_tpu_torch.models import mnist as TM

torch.set_num_threads(1)

SMALL = dict(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)


def reference(primes, n, slots, scale) -> np.ndarray:
    """[G, L, N]: the reference's encode of each vector, one call each."""
    ring = rr.RingContext(n, primes)
    return np.stack([np.asarray(RCE.ckks_encode(ring, v, scale).primal).astype(np.int64)
                     for v in slots])


def slots_of(rng, g, n, mag=1.0):
    return mag * (rng.uniform(-1, 1, (g, n // 2)) + 1j * rng.uniform(-1, 1, (g, n // 2)))


def mnist_tower(whole=True):
    """``MNISTConfig()``'s key tower (7 ciphertext and 4 special limbs), or
    its ciphertext tower, which the pipelines encode to."""
    params = TM.make_params(TM.MNISTConfig())
    ring = params.ring_key if whole else params.ring_cipher
    return ring, Fraction(2) ** TM.MNISTConfig().scale_log2


def boot_tower():
    params, log2 = TM.make_bootstrapped_params(TM.MNISTConfig(**SMALL),
                                               **{k: TM.BOOTSTRAPPED_RECIPE[k]
                                                  for k in ("depth", "hamming_weight",
                                                            "scale_limbs")})
    return params.ring_cipher, Fraction(2) ** log2


@pytest.mark.parametrize("tower, limbs", [(mnist_tower, 11), (boot_tower, 48)],
                         ids=["mnist-11-limbs", "boot-48-limbs"])
def test_a_batch_equals_the_reference_vector_by_vector(tower, limbs):
    ring, scale = tower()
    assert ring.nlimbs == limbs
    slots = slots_of(np.random.default_rng(limbs), 49, ring.n)
    got = TCE.ckks_encode_batch(ring, slots, scale, "cpu")
    assert got.dtype == torch.int64 and got.shape == (49, limbs, ring.n)
    np.testing.assert_array_equal(got.numpy(), reference(ring.primes, ring.n, slots, scale))


def test_the_grid_of_a_request_equals_the_reference():
    """``MNISTConfig()``'s 64 images through ``public_preprocess`` and the
    batch encode, as the pipelines' ``encode`` calls them."""
    cfg = TM.MNISTConfig()
    ring, scale = mnist_tower(whole=False)
    imgs = np.random.default_rng(8).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    grid = TM.public_preprocess(cfg, imgs)
    np.testing.assert_array_equal(grid, RM.public_preprocess(RM.MNISTConfig(), imgs))
    flat = grid.reshape(cfg.grid ** 2, -1)
    np.testing.assert_array_equal(TCE.ckks_encode_batch(ring, flat, scale, "cpu").numpy(),
                                  reference(ring.primes, ring.n, flat.astype(complex), scale))


@pytest.mark.parametrize("scale", [Fraction(2) ** 50, Fraction(3 * 2 ** 40, 7)],
                         ids=["power-of-two", "no-power-of-two"])
def test_a_vector_past_the_fast_bound_takes_the_exact_loop(scale):
    """A constant slot vector of 64 encodes to the constant 64: at 2^50 it
    scales past 2^52, and that vector alone leaves ldexp + rint. At a scale
    that is no power of two every vector takes the exact loop."""
    ring = TR.make_rns_ring(64, (30,) * 12)
    rng = np.random.default_rng(4)
    slots = slots_of(rng, 4, 64, 1e-3)
    slots[2] = 64.0 * (1 + 1e-6 * rng.uniform(-1, 1, 32))
    got = TCE.ckks_encode_batch(ring, slots, scale, "cpu")
    np.testing.assert_array_equal(got.numpy(), reference(ring.primes, 64, slots, scale))


def test_one_imaginary_vector_fails_the_batch():
    """Slots of 2^40 leave float64 rounding above the guard's 1e-9 in the
    imaginary part: the reference refuses that vector, the port its batch."""
    ring = TR.make_rns_ring(64, (30,) * 3)
    slots = slots_of(np.random.default_rng(5), 3, 64)
    slots[1] *= 2.0 ** 40
    with pytest.raises(ValueError, match="imaginary"):
        RCE.ckks_encode(rr.RingContext(64, ring.primes), slots[1], 2 ** 10)
    with pytest.raises(ValueError, match="imaginary"):
        TCE.ckks_encode_batch(ring, slots, 2 ** 10, "cpu")
    TCE.ckks_encode_batch(ring, slots[[0, 2]], 2 ** 10, "cpu")
    with pytest.raises(ValueError, match="slots"):
        TCE.ckks_encode_batch(ring, slots[0], 2 ** 10, "cpu")


class _Coordinate:
    """Rank 1 of a 3-rank 'rp' axis: what a tower's view reads of a mesh."""

    shape = {"rp": 3}

    def index(self, axis):
        return 1


def test_a_sharded_tower_gets_its_held_rows():
    ring = TR.make_rns_ring(64, (30,) * 11)
    view = TR.shard_view(ring, _Coordinate(), "rp")
    assert list(view.held) == [1, 4, 7, 10]
    slots = slots_of(np.random.default_rng(6), 3, 64)
    slots[1] = 64.0                                     # past the bound: exact
    for scale in (Fraction(2) ** 50, Fraction(5 * 2 ** 40, 3)):
        whole = TCE.ckks_encode_batch(ring, slots, scale, "cpu")
        got = TCE.ckks_encode_batch(view, slots, scale, "cpu")
        assert torch.equal(got, whole[:, view.held])
        assert torch.equal(TCE.ckks_encode(view, slots[0], scale, "cpu").primal, got[0])


@pytest.mark.parametrize("n", [8, 64, 8192])
def test_the_slot_map_is_built_once_and_read_only(n):
    m, r1, r2 = 2 * n, [], []
    g = 1
    for _ in range(n // 2):
        g = g * 3 % m
        r1.append(g >> 1)
        r2.append((m - g) >> 1)
    got = TCE.zmstar_indices(n)
    assert got is TCE.zmstar_indices(n)
    np.testing.assert_array_equal(got[0], r1)
    np.testing.assert_array_equal(got[1], r2)
    for a, b in zip(got, RCE.zmstar_indices(n)):
        np.testing.assert_array_equal(a, b)
    for a in got:
        with pytest.raises(ValueError):
            a[0] = 0


def test_preprocess_equals_the_reference_loop():
    for kw in ({}, SMALL, dict(image=14, kernel=5, stride=3, ring_logn=9)):
        cfg, rcfg = TM.MNISTConfig(**kw), RM.MNISTConfig(**kw)
        imgs = np.random.default_rng(2).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
        for batch in (imgs, (imgs * 255).astype(np.uint8)):
            got = TM.public_preprocess(cfg, batch)
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, RM.public_preprocess(rcfg, batch))
