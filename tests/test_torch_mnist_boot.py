"""The bootstrapped encrypted-MNIST pipeline of the port.

The reference's small bootstrapped geometry (tests/test_mnist.py: 8×8
images, 4×4 kernel, stride 4, 2 channels, 4 classes, N = 2^6) on the
composite recipe (depth 46: 2 + 46 + 7 limbs, the hybrid gadget, factored
transforms, double-angle EvalMod with the arcsine correction), seeded
weights and images:

* the port alone, eager and compiled: ≥ 15 limbs regained, every logit
  within 1e-3 of the plaintext model, all labels agreeing, and a second run
  of the compiled pipeline bit-identical to the first;
* on the reference's keys carried across, the two stages around the refresh
  are bit-equal to the reference's: the exhaust (divide by the prescale,
  align to the composite base) and dense 2 at the regained tower. The
  refresh itself is held in test_torch_bootstrap_parity.py;
* under ``slow``: the whole pipeline against the reference's on the same
  keys (different encryption randomness, so within the accuracy bound).
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from toyfhe_tpu.core import ckks_encoding as RCE
from toyfhe_tpu.models import mnist as RM
import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu_torch.models import mnist as TM
from toyfhe_tpu_torch.utils import interop as I

from .test_torch_bootstrap import carry_context
from .test_torch_ckks_surface import assert_same, carry_ct
from .test_torch_mnist import export_setup

torch.set_num_threads(1)

SMALL = dict(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)
BOOT = dict(depth=46, K=5.0, deg=24, scale_limbs=2, radix=16, arcsin=True, double_angle=2,
            hamming_weight=4)
PRESCALE = 32.0


def _data(cfg):
    weights = TM.init_params(cfg, 2)
    imgs = np.random.default_rng(3).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    return weights, imgs, TM.model_forward(cfg, weights, imgs)


def _check(logits, depth_out, plain):
    assert depth_out >= 15
    assert logits.shape == (plain.shape[1], plain.shape[0])
    err = np.abs(logits.T - plain).max()
    assert err < 1e-3, err
    np.testing.assert_array_equal(np.argmax(logits.T, -1), np.argmax(plain, -1))


@pytest.fixture(scope="module")
def port():
    cfg = TM.MNISTConfig(**SMALL)
    gen = torch.Generator().manual_seed(1)
    setup, ctx = TM.fhe_setup_bootstrapped(cfg, gen, **BOOT)
    return cfg, setup, ctx, _data(cfg)


def test_eager_bootstrapped_inference(port):
    cfg, setup, ctx, (weights, imgs, plain) = port
    assert setup.params.ring_cipher.nlimbs == 48 and setup.params.dnum == 9
    logits, depth_out = TM.encrypted_inference_bootstrapped(
        setup, ctx, weights, imgs, torch.Generator().manual_seed(4), prescale=PRESCALE)
    _check(logits, depth_out, plain)


def test_compiled_bootstrapped_pipeline(port):
    cfg, setup, ctx, (weights, imgs, plain) = port
    run = TM.build_bootstrapped_pipeline(setup, ctx, weights, prescale=PRESCALE)
    times = {}
    logits, depth_out = run(imgs, torch.Generator().manual_seed(4), layer_times=times)
    _check(logits, depth_out, plain)
    assert list(times) == ["encode", "encrypt", "conv", "square1", "dense1", "bias_rescale",
                           "square2", "exhaust", "modraise_c2s", "evalmod", "s2c", "dense2",
                           "decrypt"]
    again, depth2 = run(imgs, torch.Generator().manual_seed(4))
    assert depth2 == depth_out
    np.testing.assert_array_equal(again, logits)


def test_eager_encrypted_inference():
    """``encrypted_inference`` (the eager cross-check) decodes within the
    serving bound on the default tower, iterated and BSGS."""
    cfg = TM.MNISTConfig(image=14, kernel=5, stride=3, channels=2, classes=4, ring_logn=9)
    gen = torch.Generator().manual_seed(5)
    setup = TM.fhe_setup(cfg, gen)
    weights, imgs, plain = _data(cfg)
    got = TM.encrypted_inference(setup, weights, imgs, torch.Generator().manual_seed(6))
    assert np.abs(got.T - plain).max() < 0.5
    gks = TM.keygen_matmul_bsgs(setup, gen)
    got_b = TM.encrypted_inference(setup, weights, imgs, torch.Generator().manual_seed(6),
                                   gks_bsgs=gks)
    assert np.abs(got_b.T - plain).max() < 0.5
    assert np.abs(got_b - got).max() < 1e-2
    with pytest.raises(ValueError):
        TM.naive_rectangular_matmul(setup, np.ones((5, 4)), None)


@pytest.fixture(scope="module")
def shared():
    """The reference's bootstrapped setup, carried across."""
    cfg, tcfg = RM.MNISTConfig(**SMALL), TM.MNISTConfig(**SMALL)
    setup, ctx = RM.fhe_setup_bootstrapped(cfg, jax.random.PRNGKey(8), **BOOT)
    tsetup = I.fhe_setup_bootstrapped_from_numpy(
        tcfg, **export_setup(setup), depth=46, hamming_weight=4, scale_limbs=2, device="cpu")
    tctx = carry_context(setup.params, tsetup.params, ctx)
    weights, imgs, plain = _data(tcfg)
    return dict(cfg=cfg, setup=setup, ctx=ctx, tsetup=tsetup, tctx=tctx, weights=weights,
                imgs=imgs, plain=plain)


def test_carried_setup(shared):
    setup, tsetup = shared["setup"], shared["tsetup"]
    assert tsetup.params.params.ring_cipher.primes == setup.params.params.ring_cipher.primes
    assert tsetup.scale == setup.scale == Fraction(2) ** 26
    assert (tsetup.params.dnum, tsetup.params.num_special) == \
        (setup.params.dnum, setup.params.num_special)


def test_exhaust_equals_reference(shared):
    setup, tsetup = shared["setup"], shared["tsetup"]
    ring = setup.params.ring_cipher
    s4 = Fraction(2) ** 26 * Fraction(ring.primes[44], ring.primes[45])
    vals = np.random.default_rng(5).uniform(-20, 20, ring.n // 2)
    c = F.encrypt(setup.kp, F.make_plaintext(ring, vals, s4), jax.random.PRNGKey(9))
    c = RCE.ct_drop_to(c, 44)
    ref = RCE.ct_to(F.ct_rescale(RCE.mul_plain_scalar(c, 1.0 / PRESCALE)), 2, Fraction(2) ** 52)
    run = TM.build_bootstrapped_pipeline(tsetup, shared["tctx"], shared["weights"],
                                         prescale=PRESCALE)
    assert_same(ref, run.exhaust(carry_ct(tsetup.params, c)))


def test_dense2_at_regained_tower_equals_reference(shared):
    setup, tsetup, w = shared["setup"], shared["tsetup"], shared["weights"]
    cfg = shared["cfg"]
    ring = setup.params.ring_cipher
    vals = np.random.default_rng(6).uniform(-1, 1, ring.n // 2)
    c = F.encrypt(setup.kp, F.make_plaintext(ring, vals, Fraction(2) ** 52),
                  jax.random.PRNGKey(10))
    c = RCE.ct_drop_to(c, 15)
    ref = RM.naive_rectangular_matmul(setup, np.asarray(w["w2"]) * PRESCALE, c)
    b2 = np.concatenate([np.asarray(w["b2"]), np.zeros(cfg.positions - cfg.classes)])
    ref = RCE.add_plain(ref, np.repeat(b2, cfg.batch))
    run = TM.build_bootstrapped_pipeline(tsetup, shared["tctx"], w, prescale=PRESCALE)
    assert_same(ref, run.dense2(carry_ct(tsetup.params, c)))


@pytest.mark.slow
def test_whole_pipeline_against_reference(shared):
    """Both pipelines on the reference's keys: each within the accuracy
    bound, and within twice it of each other."""
    ref, _ = RM.build_bootstrapped_pipeline(shared["setup"], shared["ctx"], shared["weights"],
                                            prescale=PRESCALE)(shared["imgs"],
                                                               jax.random.PRNGKey(11))
    got, depth = TM.build_bootstrapped_pipeline(shared["tsetup"], shared["tctx"],
                                                shared["weights"], prescale=PRESCALE)(
        shared["imgs"], torch.Generator().manual_seed(11))
    _check(got, depth, shared["plain"])
    assert np.abs(np.asarray(ref) - got).max() < 2e-3
