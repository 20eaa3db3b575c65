"""toyfhe_tpu_torch noise meters, estimator, planner and security table
against the reference, on the CPU.

* every ``est_*`` of the analytic CKKS estimator on the same ciphertext
  metadata (windowed, ModulusRaised, HybridRaised and sparse-secret
  parameters), equal to float64 rounding;
* ``ckks_precision`` / ``ckks_scale_bits`` on a shared ciphertext and key;
* ``plan_ckks_tower`` / ``plan_ckks_ring``, ``std_ring_dim``,
  ``palisade_ring``, ``estimate_security`` and ``security_level`` equal;
* the port alone raises the reference suite's ``SecurityWarning``s.
"""

import warnings
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.core import cryptparams as RCP
from toyfhe_tpu.core import noise as RNZ
from toyfhe_tpu.core import planner as RPL
from toyfhe_tpu.core import ring as ref_ring
from toyfhe_tpu_torch.core import cryptparams as TCP
from toyfhe_tpu_torch.core import noise as TNZ
from toyfhe_tpu_torch.core import planner as TPL
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

N = 64
SCALE = Fraction(2) ** 26
REL = 1e-12

PARAMS = {
    "windowed": ((30, 26, 26, 26), lambda pk, r: pk.CKKSParams(r, 4, 3.2)),
    "modraised": ((30, 26, 26, 26, 30), lambda pk, r: pk.ModulusRaised(pk.CKKSParams(r, 0, 3.2))),
    "hybrid": ((30, 26, 26, 26, 26, 26, 30, 30),
               lambda pk, r: pk.HybridRaised(pk.CKKSParams(r, 0, 3.2), 3, 2)),
    "sparse": ((30, 26, 26, 26),
               lambda pk, r: pk.CKKSParams(r, 4, 3.2, secret="sparse", hamming_weight=16)),
}


def metadata_cts(name):
    """A ciphertext of each package at the same tower, parameters and scale
    (zero residues: the estimator reads only the metadata), and one a rescale
    further down."""
    tower, make = PARAMS[name]
    out = []
    for pk, zeros in ((F, lambda s: jnp.zeros(s, jnp.uint32)),
                      (T, lambda s: torch.zeros(s, dtype=torch.int64))):
        params = make(pk, pk.make_rns_ring(N, tower))
        ring = params.ring_cipher
        sub = ring.drop_last()
        cts = []
        for r, scale in ((ring, SCALE * SCALE), (sub, SCALE * SCALE / ring.primes[-1])):
            elt = pk.RingElt(primal=zeros((r.nlimbs, N)))
            cts.append(pk.CipherText(params, (elt, elt), r, enc=pk.CKKSTag(scale)))
        out.append(cts)
    return out


def same_est(r, t):
    assert t.eps == pytest.approx(r.eps, rel=REL) and t.bound == pytest.approx(r.bound, rel=REL)
    assert t.precision_bits == pytest.approx(r.precision_bits, rel=REL)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_estimator_matches(name):
    (rc, rsub), (tc, tsub) = metadata_cts(name)
    pairs = {}
    pairs["fresh"] = (RNZ.est_fresh(rc, 0.9), TNZ.est_fresh(tc, 0.9))
    pairs["mul"] = (RNZ.est_mul(*[pairs["fresh"][0]] * 2), TNZ.est_mul(*[pairs["fresh"][1]] * 2))
    pairs["add"] = (RNZ.est_add(pairs["mul"][0], pairs["fresh"][0]),
                    TNZ.est_add(pairs["mul"][1], pairs["fresh"][1]))
    pairs["keyswitch"] = (RNZ.est_keyswitch(pairs["mul"][0], rc),
                          TNZ.est_keyswitch(pairs["mul"][1], tc))
    pairs["rotate"] = (RNZ.est_rotate(pairs["fresh"][0], rc), TNZ.est_rotate(pairs["fresh"][1], tc))
    pairs["rescale"] = (RNZ.est_rescale(pairs["keyswitch"][0], rsub),
                        TNZ.est_rescale(pairs["keyswitch"][1], tsub))
    pairs["mul_plain"] = (RNZ.est_mul_plain(pairs["rescale"][0], rsub, 0.7, 2 ** 26),
                          TNZ.est_mul_plain(pairs["rescale"][1], tsub, 0.7, 2 ** 26))
    for what, (r, t) in pairs.items():
        same_est(r, t)
    assert TNZ.ckks_scale_bits(tsub) == pytest.approx(RNZ.ckks_scale_bits(rsub), rel=REL)


def test_ckks_precision_matches():
    ring, tring = F.make_rns_ring(N, (30, 26, 26)), T.make_rns_ring(N, (30, 26, 26))
    params, tparams = F.CKKSParams(ring, 4, 3.2), T.CKKSParams(tring, 4, 3.2)
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    kp = F.keygen(params, ks[0])
    vals = np.linspace(-0.9, 0.9, N // 2)
    c = F.encrypt(kp, F.make_plaintext(ring, vals, SCALE), ks[1])
    tkp = I.priv_key(tparams, np.asarray(kp.priv.secret.primal), device="cpu")
    duals = [np.asarray(ref_ring.ensure_dual(ring, x).dual) for x in c.cs]
    tc = I.ciphertext(tparams, tring, duals, SCALE, device="cpu")
    want = RNZ.ckks_precision(kp, c, vals)
    assert TNZ.ckks_precision(tkp, tc, vals) == pytest.approx(want, rel=REL) and want > 8
    assert T.ckks_scale_bits(tc) == 26.0


@pytest.mark.parametrize("n", [32, 1024, 8192])
def test_planner_matches(n):
    for depth in (0, 1, 3, 7):
        for scale_bits in (20, 26, 29):
            for value_bits in (4, 8):
                for special in (True, False):
                    args = (n, depth, scale_bits, value_bits, special)
                    assert TPL.plan_ckks_tower(*args) == RPL.plan_ckks_tower(*args)
    for bad in (19, 30):
        with pytest.raises(ValueError):
            TPL.plan_ckks_tower(n, 1, bad)
    ring, s = TPL.plan_ckks_ring(n, 2, 26, 4, check_security=False)
    rring, rs = RPL.plan_ckks_ring(n, 2, 26, 4, check_security=False)
    assert (ring.primes, s) == (list(rring.primes), rs)


def ring_dim(mod, args):
    """``std_ring_dim``, or "over" where the table has no such budget."""
    try:
        return mod.std_ring_dim(*args)
    except ValueError:
        return "over"


def test_security_table_matches():
    for dist in ("HEStd_uniform", "HEStd_error", "HEStd_ternary"):
        td, rd = getattr(TCP, dist), getattr(RCP, dist)
        for n in (256, 1024, 2048, 4096, 8192, 12288, 16384, 32768, 65536):
            for log_q in (10, 27, 29, 54, 109, 118, 152, 203, 218, 220, 300, 881, 900):
                assert TCP.estimate_security(n, log_q, td) == RCP.estimate_security(n, log_q, rd)
        for level in ("HEStd_128_classic", "HEStd_192_classic", "HEStd_256_classic"):
            for log_q in (16, 60, 203, 438, 612):
                args_t, args_r = (td, getattr(TCP, level), log_q), (rd, getattr(RCP, level), log_q)
                assert ring_dim(TCP, args_t) == ring_dim(RCP, args_r)
    with pytest.raises(ValueError):
        TCP.std_ring_dim(TCP.HEStd_error, TCP.HEStd_128_classic, 1000)
    for m in (16, 1024, 2048, 4096):
        assert TCP.palisade_ring(m).primes == list(RCP.palisade_ring(m).primes)
    assert TCP.palisade_ring(4096) is TCP.palisade_ring(4096)


def test_security_level_matches():
    tower = (28,) * 4 + (30, 30)
    makers = [
        lambda pk, r: pk.HybridRaised(pk.CKKSParams(r, 0, 3.2), 2, 2),
        lambda pk, r: pk.CKKSParams(r, 0, 3.2, secret="sparse", hamming_weight=8),
        lambda pk, r: pk.ModulusRaised(pk.BGVParams(r, 257, 3.2)),
    ]
    for n in (64, 1024, 8192):
        for make in makers:
            t = make(T, T.make_rns_ring(n, tower))
            r = make(F, F.make_rns_ring(n, tower))
            assert T.security_level(t) == F.security_level(r)
    assert T.security_level(makers[0](T, T.make_rns_ring(8192, tower))) == 128


# ---------------------------------------------------------------------------
# the port alone: the reference suite's security asserts
# ---------------------------------------------------------------------------

def test_security_estimator():
    assert T.estimate_security(8192, 218, T.cryptparams.HEStd_ternary) == 128
    assert T.estimate_security(8192, 118, T.cryptparams.HEStd_ternary) == 256
    assert T.estimate_security(8192, 300, T.cryptparams.HEStd_ternary) == 0
    assert T.estimate_security(256, 10) == 0          # below the table
    assert T.estimate_security(12288, 218) == 128     # between rows: the lower N's budget
    ring = T.make_rns_ring(64, (28,) * 4 + (30, 30))
    assert T.security_level(T.HybridRaised(T.CKKSParams(ring, 0, 3.2), 2, 2)) == 0


def test_planner_security_warnings():
    with pytest.warns(TPL.SecurityWarning, match="wants N"):
        T.plan_ckks_ring(64, depth=1, scale_bits=26)
    with pytest.warns(TPL.SecurityWarning, match="exceeds the largest"):
        T.plan_ckks_ring(64, depth=40, scale_bits=28)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.plan_ckks_ring(64, depth=1, scale_bits=26, check_security=False)


def test_bfv_params_security_audit():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        T.bfv_params(7, eval_mult_count=0, limb_bits=30)
        assert any(issubclass(x.category, TPL.SecurityWarning) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        T.bfv_params(7, eval_mult_count=0, limb_bits=30, check_security=False)
        assert not any(issubclass(x.category, TPL.SecurityWarning) for x in w)
