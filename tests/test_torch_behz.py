"""toyfhe_tpu_torch BEHZ multiply context against the reference, on the CPU.

Every ``BFVMulContext`` method and table, bit-equal to ``toyfhe_tpu`` on the
same residue arrays (made with numpy from a seed): at N = 64 on a 3-limb
tower with the default auxiliary base, and on the ``bfv_crt`` tower
(N = 2048, (30, 29) bits) with the hand-built auxiliary base that continues
the prime walk past 2^30.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import behz as RB
from toyfhe_tpu.core import ring as ref_ring
from toyfhe_tpu.utils import numtheory as ref_nt
from toyfhe_tpu_torch.core import behz as TB
from toyfhe_tpu_torch.utils import numtheory as nt

torch.set_num_threads(1)


def bfv_crt_rings(pkg, walk):
    """The ``bfv_crt`` scenario's ciphertext tower and auxiliary base."""
    n = 2048
    ring = pkg.make_rns_ring(n, (30, 29))
    last = max(ring.primes)
    aux = []
    for _ in range(4):
        last = walk.next_prime(last + 2 * n, interval=2 * n)
        aux.append(last)
    return ring, pkg.make_ring(n, aux)


@pytest.fixture(scope="module", params=["n64", "bfv_crt"])
def ctxs(request):
    if request.param == "n64":
        rring = F.make_rns_ring(64, (29, 28, 28))
        tring = T.make_rns_ring(64, (29, 28, 28))
        raux, taux = RB.make_aux_ring(rring), TB.make_aux_ring(tring)
    else:
        rring, raux = bfv_crt_rings(F, ref_nt)
        tring, taux = bfv_crt_rings(T, nt)
        assert max(taux.primes) > 1 << 30
    assert tring.primes == rring.primes and taux.primes == raux.primes
    return RB.BFVMulContext(rring, raux), TB.BFVMulContext(tring, taux)


def residues(primes, lead, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, lead + (n,)) for p in primes], axis=-2)


def same(ref, got):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), got.numpy())


TABLES = ("qhat_inv_mont_q", "qhat_mont_bsk", "mtilde_mont_q", "qhat_mod_mtilde",
          "q_mont_bsk", "mtilde_inv_mont_bsk", "qinv_mont_bsk", "qhalf_res_q",
          "qhalf_res_bsk", "bhat_inv_mont_b", "bhat_mont_q", "bhat_mont_msk",
          "binv_mont_msk", "b_res_q")


def test_tables_equal(ctxs):
    r, t = ctxs
    assert t.ext_ring.primes == r.ext_ring.primes and t.ext_ring.psis == r.ext_ring.psis
    for name in TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(r, name)).astype(np.int64),
                                      np.asarray(getattr(t, name)).astype(np.int64), name)
    assert int(r.neg_qinv_mtilde) == t.neg_qinv_mtilde and r.msk == t.msk


@pytest.mark.parametrize("method", ["smmrq_convert", "fbc_q_to_bsk"])
def test_q_to_bsk(ctxs, method):
    r, t = ctxs
    x = residues(r.ring.primes, (2,), r.ring.n, 1)
    same(getattr(r, method)(jnp.asarray(x, dtype=jnp.uint32)),
         getattr(t, method)(torch.as_tensor(x)))


def test_rns_floor(ctxs):
    r, t = ctxs
    wq = residues(r.ring.primes, (2,), r.ring.n, 2)
    wb = residues(r.aux.primes, (2,), r.ring.n, 3)
    same(r.rns_floor(jnp.asarray(wq, dtype=jnp.uint32), jnp.asarray(wb, dtype=jnp.uint32)),
         t.rns_floor(torch.as_tensor(wq), torch.as_tensor(wb)))


def test_sk_convert(ctxs):
    r, t = ctxs
    y = residues(r.aux.primes, (2,), r.ring.n, 4)
    same(r.sk_convert(jnp.asarray(y, dtype=jnp.uint32)), t.sk_convert(torch.as_tensor(y)))


def test_expand_and_contract(ctxs):
    r, t = ctxs
    x = residues(r.ring.primes, (2,), r.ring.n, 5)
    same(r.expand_component(F.RingElt(primal=jnp.asarray(x, dtype=jnp.uint32))).primal,
         t.expand_component(T.RingElt(primal=torch.as_tensor(x))).primal)
    w = residues(r.ext_ring.primes, (2,), r.ring.n, 6)
    for p in (7, 53, 65537):
        same(r.contract_component(F.RingElt(primal=jnp.asarray(w, dtype=jnp.uint32)), p).primal,
             t.contract_component(T.RingElt(primal=torch.as_tensor(w)), p).primal)
    # a dual input goes through the extended tower's inverse transform first
    wd = ref_ring.ensure_dual(r.ext_ring, F.RingElt(primal=jnp.asarray(w, dtype=jnp.uint32)))
    same(r.contract_component(F.RingElt(dual=wd.dual), 53).primal,
         t.contract_component(T.RingElt(dual=torch.as_tensor(np.asarray(wd.dual).astype(np.int64))),
                              53).primal)


def test_aux_ring_extra_bits():
    ring = T.make_rns_ring(64, (29, 28))
    for extra in (0, 30, 31):
        want = RB.make_aux_ring(F.make_rns_ring(64, (29, 28)), extra).primes
        assert TB.make_aux_ring(ring, extra).primes == want
