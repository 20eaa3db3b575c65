"""The port's whole CKKS refresh against the reference's compiled one.

The small hybrid configuration of the reference's sharded-bootstrap test
(N = 32, sixteen 30-bit limbs: 12 ciphertext limbs and 4 raising primes,
dnum 4, a sparse secret of weight 4, K 5, degree 8, the radix-16 factored
transforms): the reference's keys and exhausted ciphertexts are carried
across as numpy, and ``bootstrap`` must equal ``jax.jit(bootstrap)`` bit for
bit — every residue, the tower and the exact scale tag — cold and warm (the
warm refresh encodes nothing); ``bootstrap_batched`` on two ciphertexts must
equal their single refreshes. At degree 8 the refresh has no accuracy to
speak of (error about 8): this configuration is for bit-equality only.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import bootstrap as RB
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE

from .test_torch_bootstrap import carry_context
from .test_torch_ckks_surface import assert_same, carry_ct

torch.set_num_threads(1)

N = 32
H = N // 2


def _exhausted(params, kp, vals, key):
    c = F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, Fraction(2) ** 27), key)
    while c.ring.nlimbs > 1:
        c = F.ct_modswitch_drop(c)
    return c


@pytest.fixture(scope="module")
def fx():
    ring = F.make_rns_ring(N, (30,) * 16)
    params = F.HybridRaised(F.CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=4),
                            dnum=4, num_special=4)
    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    kp = F.keygen(params, ks[0])
    ctx = RB.setup_bootstrap(ks[1], kp.priv, K=5.0, deg=8, radix=16)
    rng = np.random.default_rng(3)
    vals = [(rng.uniform(-1, 1, H) + 1j * rng.uniform(-1, 1, H)) * 0.7 for _ in range(2)]
    cts = [_exhausted(params, kp, v, jax.random.fold_in(ks[2], i)) for i, v in enumerate(vals)]
    ref = jax.jit(RB.bootstrap)(ctx, cts[0])
    tparams = T.HybridRaised(T.CKKSParams(T.make_rns_ring(N, (30,) * 16), 0, 3.2,
                                          secret="sparse", hamming_weight=4), 4, 4)
    return dict(ref=ref, tctx=carry_context(params, tparams, ctx),
                tcts=[carry_ct(tparams, c) for c in cts])


def test_refresh_equals_jitted_reference(fx, monkeypatch):
    tctx, tc = fx["tctx"], fx["tcts"][0]
    cold = TB.bootstrap(tctx, tc)
    assert_same(fx["ref"], cold)
    assert cold.ring.nlimbs == fx["ref"].ring.nlimbs
    stored = len(tctx.plain_cache)
    assert stored > 0
    calls = []
    real = TCE.ckks_encode
    monkeypatch.setattr(TCE, "ckks_encode", lambda *a: calls.append(1) or real(*a))
    warm = TB.bootstrap(tctx, tc)
    assert_same(fx["ref"], warm)
    assert not calls and len(tctx.plain_cache) == stored


def test_batched_refresh_equals_singles(fx):
    tctx, tcts = fx["tctx"], fx["tcts"]
    out = TB.bootstrap_batched(tctx, T.ct_stack(tcts))
    assert out.cs[0].shape[:-2] == (2,)
    for i, tc in enumerate(tcts):
        single = TB.bootstrap(tctx, tc)
        got = T.ct_index(out, i)
        assert got.ring is single.ring and got.enc == single.enc
        for a, b in zip(got.cs, single.cs):
            assert torch.equal(T.ringops.ensure_dual(got.ring, a).dual,
                               T.ringops.ensure_dual(single.ring, b).dual)
    assert_same(fx["ref"], T.ct_index(out, 0))
