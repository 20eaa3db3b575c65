"""The composite-scale refresh's pieces against the reference, bit for bit.

The production recipe of the bootstrapped MNIST (``scale_limbs`` = 2) cut
to N = 32 and 20 levels: ``make_boot_ring(32, 20, 7)`` (2 × 29-bit base,
20 balanced 26-bit levels, 7 raising primes) under the hybrid gadget (dnum
4, as ``mnist.make_bootstrapped_params`` picks it), K 5, factored
transforms of two levels (radix 4), the double-angle cosine and the
arcsine correction, with the reference's keys carried across as numpy.
Every step whose scale algebra differs under two-limb levels is held: the two-limb
FBC ModRaise, the retag by the composite q₀ and CoeffToSlot with its level
scales pinned (phase 1), SlotToCoeff with q₀/Δ folded in and pinned
(phase 3), ``eval_chebyshev`` with two-limb rescales on the stacked
halves, the double-angle squaring and both arcsine corrections. Each gives
the reference's residues, tower and exact scale tag.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.core import bootstrap as RB
from toyfhe_tpu.core import ckks_encoding as RCE
from toyfhe_tpu.core import rlwe as RL
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import ckks_encoding as TCE

from .test_torch_bootstrap import carry_context
from .test_torch_ckks_surface import assert_same, carry_ct

torch.set_num_threads(1)

N = 32
H = N // 2
DEPTH, DNUM, SPECIAL = 20, 4, 7
RECIPE = dict(K=5.0, deg=24, radix=4, arcsin=True, double_angle=2, scale_limbs=2)
SL = RECIPE["scale_limbs"]
SCALE = Fraction(2) ** 52


def _params(mod, ring):
    return mod.HybridRaised(mod.CKKSParams(ring, 0, 3.2, secret="sparse", hamming_weight=4),
                            DNUM, SPECIAL)


@pytest.fixture(scope="module")
def comp():
    params = _params(F, RB.make_boot_ring(N, DEPTH, SPECIAL))
    tparams = _params(T, TB.make_boot_ring(N, DEPTH, SPECIAL))
    assert tparams.params.ring_cipher.primes == params.params.ring_cipher.primes
    ks = jax.random.split(jax.random.PRNGKey(31), 4)
    kp = F.keygen(params, ks[0])
    ctx = RB.setup_bootstrap(ks[1], kp.priv, **RECIPE)
    rng = np.random.default_rng(31)
    vals = (rng.uniform(-1, 1, H) + 1j * rng.uniform(-1, 1, H)) * 0.7
    c = RCE.ct_drop_to(F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals, SCALE), ks[2]), SL)
    lo, hi = RB.bootstrap_phase1(ctx, c)
    xs = rng.uniform(-0.9, 0.9, H)
    x = F.encrypt(kp, F.make_plaintext(params.ring_cipher, xs + 0j, SCALE), ks[3])
    return dict(ctx=ctx, tctx=carry_context(params, tparams, ctx), c=c, tc=carry_ct(tparams, c),
                lo=lo, hi=hi, tlo=carry_ct(tparams, lo), thi=carry_ct(tparams, hi),
                x=x, tx=carry_ct(tparams, x))


def test_phase1_modraise_c2s_pinned(comp):
    """Two-limb FBC ModRaise, retag by q₀ = the base pair, CoeffToSlot with
    two-limb rescales and every level pinned to the base scale."""
    tlo, thi = TB.bootstrap_phase1(comp["tctx"], comp["tc"])
    assert_same(comp["lo"], tlo)
    assert_same(comp["hi"], thi)
    assert tlo.enc.scale == SCALE
    assert comp["tctx"].plan.nlevels == 2 and tlo.ring.nlimbs == 2 + DEPTH - 2 * SL


def test_phase3_s2c_pinned(comp):
    """SlotToCoeff with q₀/Δ folded into its first level, two-limb levels
    pinned to the base scale, on the stacked halves."""
    ctx, tctx = comp["ctx"], comp["tctx"]
    statics = RB._phase3_statics(ctx, comp["c"])
    assert TB._phase3_statics(tctx, comp["tc"]) == statics
    ref = RB.bootstrap_phase3(ctx, RL.ct_stack([comp["lo"], comp["hi"]]), *statics)
    got = TB.bootstrap_phase3(tctx, T.ct_stack([comp["tlo"], comp["thi"]]), *statics)
    assert_same(ref, got)
    assert got.enc.scale == SCALE


def test_eval_chebyshev_two_limb(comp):
    """The Paterson–Stockmeyer evaluation with two-limb rescales on the
    batch-2 ciphertext EvalMod stacks, at degree 5: one giant step, the
    aligned sum and the exact plain terms."""
    coeffs = np.array([0.1, -0.4, 0.25, 0.3, -0.05, 0.2])
    ek, tek, K = comp["ctx"].ek, comp["tctx"].ek, RECIPE["K"]
    ref = RB.eval_chebyshev(ek, RL.ct_stack([comp["lo"], comp["hi"]]), coeffs, K, scale_limbs=SL)
    got = TB.eval_chebyshev(tek, T.ct_stack([comp["tlo"], comp["thi"]]), coeffs, K,
                            scale_limbs=SL)
    assert_same(ref, got)


def test_double_angle_and_arcsine_two_limb(comp):
    """One double-angle squaring c ← 2c² − 1, then the arcsine correction of
    the unnormalised sine, and the one of the normalised sine, all with
    two-limb rescales."""
    ek, tek, x, tx = comp["ctx"].ek, comp["tctx"].ek, comp["x"], comp["tx"]
    ref = RCE.add_plain(RCE.mul_int(RB._mul_ct(ek, x, x, SL), 2), -1.0)
    got = TCE.add_plain(TCE.mul_int(TB._mul_ct(tek, tx, tx, SL), 2), -1.0)
    assert_same(ref, got)
    assert_same(RB._arcsin_correct_from_sin(ek, ref, SL),
                TB._arcsin_correct_from_sin(tek, got, SL))
    assert_same(RB._arcsin_correct(ek, x, SL), TB._arcsin_correct(tek, tx, SL))


def production_witness(logn: int = 10) -> dict:
    """The whole refresh of the production recipe (``depth`` 46, deg 24,
    two double-angle squarings, arcsine, ``scale_limbs`` 2, radix 16) at
    N = 2^logn: the reference's setup, its eager refresh of an input of
    amplitude 0.7 exhausted to the base pair, and the port's refresh of the
    same ciphertext on the same keys carried across. Returns both errors
    against the input, the limbs out, the seconds each took and whether the
    two outputs are bit-equal."""
    import time

    from toyfhe_tpu.models import mnist as RM
    from toyfhe_tpu_torch.models import mnist as TM
    from toyfhe_tpu_torch.utils import interop as I

    from .test_torch_mnist import export_setup

    boot = dict(TM.BOOTSTRAPPED_RECIPE)
    cfg, tcfg = RM.MNISTConfig(ring_logn=logn), TM.MNISTConfig(ring_logn=logn)
    setup, ctx = RM.fhe_setup_bootstrapped(cfg, jax.random.PRNGKey(25), **boot)
    tsetup = I.fhe_setup_bootstrapped_from_numpy(
        tcfg, **export_setup(setup), depth=boot["depth"], hamming_weight=boot["hamming_weight"],
        scale_limbs=boot["scale_limbs"], device="cpu")
    tctx = carry_context(setup.params, tsetup.params, ctx)
    rng = np.random.default_rng(25)
    h = 1 << (logn - 1)
    vals = (rng.uniform(-1, 1, h) + 1j * rng.uniform(-1, 1, h)) * 0.7
    c = RCE.ct_drop_to(F.encrypt(setup.kp, F.make_plaintext(setup.params.ring_cipher, vals,
                                                            SCALE), jax.random.PRNGKey(26)), SL)
    t0 = time.perf_counter()
    ref = RB.bootstrap_phase3(ctx, RB.bootstrap_phase2(ctx, *RB.bootstrap_phase1(ctx, c)),
                              *RB._phase3_statics(ctx, c))
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = TB.bootstrap(tctx, carry_ct(tsetup.params, c))
    port_s = time.perf_counter() - t0
    try:
        assert_same(ref, got)
        equal = True
    except AssertionError:
        equal = False
    return dict(logn=logn, limbs_out=got.ring.nlimbs, bit_equal=equal,
                reference_err=float(np.max(np.abs(F.decrypt(setup.kp, ref) - vals))),
                port_err=float(np.max(np.abs(T.decrypt(tsetup.kp, got) - vals))),
                reference_s=ref_s, port_s=port_s)


if __name__ == "__main__":
    # python -m tests.test_torch_bootstrap_composite [logN]: the production
    # witness (N = 2^10: about 12 minutes on the CPU, most of them the
    # reference's eager refresh)
    import json
    import sys

    print(json.dumps(production_witness(int(sys.argv[1]) if len(sys.argv) > 1 else 10)))
