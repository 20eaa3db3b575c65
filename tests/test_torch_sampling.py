"""toyfhe_tpu_torch samplers: support, moments, the sparse secret's Hamming
weight, and reproducibility from a ``torch.Generator`` seed. (Streams
cannot match ``jax.random``'s, so only distributions are compared.)"""

import math

import numpy as np
import pytest
import torch

from toyfhe_tpu_torch.ops import modmath as mm
from toyfhe_tpu_torch.ops import sampling
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

N = 1 << 14
PRIMES = nt.ntt_prime_chain(64, (30, 29, 28))
MP = mm.MontParams.make(PRIMES)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _signed(x):
    """Centered lift of limb 0, and a check that every limb holds the same
    signed integer."""
    c = mm.centered(x, MP)
    assert torch.equal(c, c[..., :1, :].expand_as(c))
    return c[..., 0, :].double()


def test_uniform_support_and_mean():
    x = sampling.uniform(_gen(0), MP, N, batch=(2,))
    assert x.shape == (2, len(PRIMES), N) and x.dtype == torch.int64
    for l, p in enumerate(PRIMES):
        row = x[:, l].double()
        assert int(row.min()) >= 0 and int(row.max()) < p
        # mean of uniform[0, p) is (p-1)/2 with std p/sqrt(12·2N); allow 5 std
        assert abs(float(row.mean()) - (p - 1) / 2) < 5 * p / math.sqrt(12 * 2 * N)


@pytest.mark.parametrize("sigma, shift", [(3.2, 1), (8.0 / math.sqrt(2 * math.pi), 1), (3.2, 7)])
def test_discrete_gaussian_moments(sigma, shift):
    x = sampling.discrete_gaussian(_gen(1), MP, N, sigma, shift=shift)
    assert x.shape == (len(PRIMES), N)
    c = _signed(x)
    assert bool((torch.remainder(c, shift) == 0).all())
    v = c / shift
    # rounding adds 1/12 to the variance; 5 std of the sample mean / variance
    var = sigma ** 2 + 1 / 12
    assert abs(float(v.mean())) < 5 * math.sqrt(var / N)
    assert abs(float(v.var()) - var) < 5 * var * math.sqrt(2 / N)
    assert float(v.abs().max()) < 12 * sigma


@pytest.mark.parametrize("h", [1, 64, 192])
def test_sparse_ternary_weight(h):
    x = sampling.sparse_ternary(_gen(2), MP, 1024, h, batch=(3,))
    assert x.shape == (3, len(PRIMES), 1024)
    c = _signed(x)
    assert set(torch.unique(c).tolist()) <= {-1.0, 0.0, 1.0}
    assert (c != 0).sum(dim=-1).tolist() == [h] * 3


def test_zero():
    z = sampling.zero(MP, 16, batch=(2,), device="cpu")
    assert z.shape == (2, len(PRIMES), 16) and not z.any()


@pytest.mark.parametrize("name", ["uniform", "discrete_gaussian", "sparse_ternary"])
def test_same_seed_same_tensor(name):
    draw = {
        "uniform": lambda g: sampling.uniform(g, MP, 256),
        "discrete_gaussian": lambda g: sampling.discrete_gaussian(g, MP, 256, 3.2),
        "sparse_ternary": lambda g: sampling.sparse_ternary(g, MP, 256, 32),
    }[name]
    a, b, c = draw(_gen(5)), draw(_gen(5)), draw(_gen(6))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
