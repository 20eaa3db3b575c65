"""toyfhe_tpu_torch modular arithmetic bit-equal to toyfhe_tpu.ops.modmath,
on random residues and on the edges 0, 1, half, half+1 and p−1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toyfhe_tpu.ops import modmath as ref
from toyfhe_tpu_torch.ops import modmath as mm
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)

# primes below and at or above 2^30, up to the largest allowed (2^31 − 1)
PRIMES = [3, 65537] + nt.ntt_prime_chain(64, (28, 30)) + [2 ** 31 - 1]


def _operands():
    """a, b uint32[L, M]: every pair of edge values, then random residues."""
    rng = np.random.default_rng(7)
    rows_a, rows_b = [], []
    for p in PRIMES:
        h = p // 2
        edges = np.array(sorted({0, 1, h, h + 1, p - 1}), dtype=np.uint64)
        ea, eb = np.repeat(edges, len(edges)), np.tile(edges, len(edges))
        pad = 25 - len(ea)
        ea = np.concatenate([ea, np.zeros(pad, np.uint64)])
        eb = np.concatenate([eb, np.zeros(pad, np.uint64)])
        ra = rng.integers(0, p, 231, dtype=np.uint64)
        rb = rng.integers(0, p, 231, dtype=np.uint64)
        rows_a.append(np.concatenate([ea, ra]))
        rows_b.append(np.concatenate([eb, rb]))
    return (np.stack(rows_a).astype(np.uint32), np.stack(rows_b).astype(np.uint32))


A, B = _operands()
REF_MP = ref.MontParams.make(PRIMES)
MP = mm.MontParams.make(PRIMES)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _check(got, want):
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("name", ["mont_mul", "mul_mod", "add_mod", "sub_mod"])
def test_binary_ops(name):
    want = getattr(ref, name)(jnp.asarray(A), jnp.asarray(B), REF_MP)
    _check(getattr(mm, name)(_t(A), _t(B), MP), want)


@pytest.mark.parametrize("name", ["to_mont", "from_mont", "neg_mod", "centered"])
def test_unary_ops(name):
    _check(getattr(mm, name)(_t(A), MP), getattr(ref, name)(jnp.asarray(A), REF_MP))


def test_mont_params_on_device_form():
    """Ops take the host constants or their device form alike."""
    _check(mm.mont_mul(_t(A), _t(B), MP.on("cpu")),
           ref.mont_mul(jnp.asarray(A), jnp.asarray(B), REF_MP))


def test_from_signed():
    rng = np.random.default_rng(8)
    x = rng.integers(-(2 ** 31), 2 ** 31, A.shape, dtype=np.int64)
    x[:, :4] = [-(2 ** 31), -1, 0, 2 ** 31 - 1]
    want = ref.from_signed(jnp.asarray(x.astype(np.int32)), REF_MP)
    _check(mm.from_signed(_t(x), MP), want)


def test_centered_roundtrip():
    c = mm.centered(_t(A), MP)
    p = _t(REF_MP.p)
    assert bool(((c > -(p // 2) - 1) & (c <= p // 2)).all())
    _check(mm.from_signed(c, MP), A)


@pytest.mark.parametrize("axis", [0, 1])
def test_mod_sum(axis):
    terms = np.stack([A, B, A, B[:, ::-1], A[:, ::-1]], axis=axis)
    want = ref.mod_sum(jnp.asarray(terms), REF_MP, axis)
    _check(mm.mod_sum(_t(terms), MP, axis), want)


def test_umod():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2 ** 32, A.shape, dtype=np.uint64).astype(np.uint32)
    want = ref.umod(jnp.asarray(x), jnp.asarray(REF_MP.p))
    _check(mm.umod(_t(x), _t(REF_MP.p)), want)
