"""toyfhe_tpu_torch encrypted-MNIST serving pipeline against the reference.

At the small hybrid configuration of tests/test_layers.py (N = 2^9,
dnum = 3, k = 3, two channels, four classes), with untrained weights drawn
from a numpy seed and the reference's ``fhe_setup`` keys carried across:
both packages' ``build_inference_pipeline`` start from the same encrypted
grid (each side's ``BatchEncryptor`` is replaced in the test by one that
returns it) and must produce bit-equal logits ciphertexts; the decrypted
logits stay within the reference's 0.5 of the plaintext ``model_forward``.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import toyfhe_tpu as F
from toyfhe_tpu.core import ring as rr
from toyfhe_tpu.models import mnist as RM
from toyfhe_tpu.parallel import layers as RL
from toyfhe_tpu_torch.core.rlwe import UsageError
from toyfhe_tpu_torch.models import mnist as TM
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.utils import interop as I

torch.set_num_threads(1)

SMALL = dict(image=14, kernel=5, stride=3, channels=2, classes=4, ring_logn=9,
             limb_bits=(30, 30, 28, 28, 28, 28, 28) + (30,) * 3, scale_log2=28,
             gadget="hybrid", dnum=3, num_special=3)


def export_setup(setup):
    """The reference setup's key material as numpy, for
    ``interop.fhe_setup_from_numpy``."""
    kr = setup.params.ring_key
    prim = lambda x: np.asarray(rr.ensure_primal(kr, x).primal)
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    stacks = lambda k: ([dual(c.mask) for c in k.key.key], [dual(c.masked) for c in k.key.key])
    ek_m, ek_md = stacks(setup.ek)
    gk_m, gk_md = stacks(setup.gk)
    return dict(secret=prim(setup.kp.priv.secret), pub_mask=prim(setup.kp.pub.key.mask),
                pub_masked=prim(setup.kp.pub.key.masked), ek_masks=ek_m, ek_maskeds=ek_md,
                gk_element=setup.gk.galois_element, gk_masks=gk_m, gk_maskeds=gk_md)


@pytest.fixture(scope="module")
def small():
    cfg, tcfg = RM.MNISTConfig(**SMALL), TM.MNISTConfig(**SMALL)
    setup = RM.fhe_setup(cfg, jax.random.PRNGKey(5))
    tsetup = I.fhe_setup_from_numpy(tcfg, **export_setup(setup), device="cpu")
    params = TM.init_params(tcfg, 3)
    imgs = np.random.default_rng(4).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    # the shared encrypted grid: the reference's own batched encryption
    I0 = RM.public_preprocess(cfg, imgs)
    ring0 = setup.params.ring_cipher
    pts = np.stack([np.asarray(F.ckks_encode(ring0, I0[i, j].astype(complex), setup.scale).primal)
                    for i in range(cfg.kernel) for j in range(cfg.kernel)])
    grid = np.asarray(RL.BatchEncryptor(setup.params, setup.kp.pub)(
        jnp.asarray(pts), jax.random.PRNGKey(6)))
    return dict(cfg=cfg, tcfg=tcfg, setup=setup, tsetup=tsetup, params=params, imgs=imgs,
                pts=pts, grid=grid)


def test_config_and_setup_carry(small):
    cfg, tcfg, setup, tsetup = small["cfg"], small["tcfg"], small["setup"], small["tsetup"]
    for name in ("positions", "grid", "batch", "features"):
        assert getattr(tcfg, name) == getattr(cfg, name)
    assert tsetup.params.ring_key.primes == setup.params.ring_key.primes
    assert tsetup.params.ring_cipher.primes == setup.params.ring_cipher.primes
    assert tsetup.gk.galois_element == setup.gk.galois_element == F.galois_element_for_steps(
        1 << cfg.ring_logn, cfg.batch)
    assert tsetup.scale == setup.scale
    np.testing.assert_array_equal(TM.public_preprocess(tcfg, small["imgs"]),
                                  RM.public_preprocess(cfg, small["imgs"]))
    np.testing.assert_allclose(TM.model_forward(tcfg, small["params"], small["imgs"]),
                               np.asarray(RM.model_forward(cfg, jax.tree_util.tree_map(
                                   jnp.asarray, small["params"]), jnp.asarray(small["imgs"]))),
                               rtol=1e-4, atol=1e-5)


def test_init_params_distributions():
    cfg = TM.MNISTConfig()
    p = TM.init_params(cfg, 0)
    assert p["conv_w"].shape == (7, 7, 4) and p["w1"].shape == (64, 256)
    assert p["w2"].shape == (10, 64) and not p["b1"].any() and not p["conv_b"].any()
    assert abs(p["conv_w"].std() - 0.2) < 0.03
    assert abs(p["w1"].std() - 1 / 16) < 0.005
    assert set(I.mnist_params(p)) == set(p)


class _FixedGrid:
    """Stands in for a BatchEncryptor: returns the shared grid after
    checking it was asked to encrypt the expected plaintexts."""

    def __init__(self, pts, grid, wrap):
        self.pts, self.grid, self.wrap = pts, grid, wrap

    def __call__(self, pts, rng):
        np.testing.assert_array_equal(np.asarray(pts).astype(np.int64),
                                      self.pts.astype(np.int64))
        return self.wrap(self.grid)


def test_pipeline_logits_ciphertext_bit_equal(small, monkeypatch):
    cfg, tcfg = small["cfg"], small["tcfg"]
    pts, grid = small["pts"], small["grid"]
    monkeypatch.setattr(RL, "BatchEncryptor",
                        lambda *a, **k: _FixedGrid(pts, grid, jnp.asarray))
    monkeypatch.setattr(TL, "BatchEncryptor",
                        lambda *a, **k: _FixedGrid(pts, grid, lambda g: I.tensor(g, "cpu")))
    want = RM.build_inference_pipeline(small["setup"], small["params"])(
        small["imgs"], jax.random.PRNGKey(0), _return_ct=True)
    run = TM.build_inference_pipeline(small["tsetup"], small["params"])
    times = {}
    got = run(small["imgs"], torch.Generator(), _return_ct=True, layer_times=times)
    assert got.ring.primes == want.ring.primes and got.enc.scale == want.enc.scale
    for g, w in zip(got.cs, want.cs):
        np.testing.assert_array_equal(I.to_numpy(g.dual), np.asarray(w.dual))
    assert list(times) == ["encode", "encrypt", "conv", "square1", "dense1", "bias_rescale",
                           "square2", "dense2"]

    logits = run(small["imgs"], torch.Generator()).T             # [B, classes]
    plain = TM.model_forward(tcfg, small["params"], small["imgs"])
    err = np.abs(logits - plain).max()
    assert logits.shape == (cfg.batch, cfg.classes) and err < 0.5
    top2 = np.sort(plain, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    assert np.array_equal(np.argmax(logits, -1)[clear], np.argmax(plain, -1)[clear])


def test_encrypted_inference_fast_port_keys(small):
    """The entry point with keys and sampling of the port's own, cached on
    the setup; the unported sharded schedule raises."""
    tcfg = small["tcfg"]
    gen = torch.Generator().manual_seed(8)
    tsetup = TM.fhe_setup(tcfg, gen)
    assert tsetup.gk.galois_element == F.galois_element_for_steps(1 << tcfg.ring_logn,
                                                                  tcfg.batch)
    plain = TM.model_forward(tcfg, small["params"], small["imgs"])
    logits = TM.encrypted_inference_fast(tsetup, small["params"], small["imgs"], gen)
    assert np.abs(logits.T - plain).max() < 0.5
    pipe = tsetup._pipeline
    TM.encrypted_inference_fast(tsetup, small["params"], small["imgs"], gen)
    assert tsetup._pipeline is pipe
    with pytest.raises(NotImplementedError):
        TM.build_inference_pipeline(tsetup, small["params"], mesh=object())
    with pytest.raises(ValueError):                    # dual flow needs BSGS keys
        TM.build_inference_pipeline(tsetup, small["params"], dual_flow=True)


def test_audit_pipeline_depth_raises_like_reference():
    """A tower too short for the four rescales, or whose survivors cannot
    hold the final scale², raises in both packages before any key is made."""
    for bits in ((28,) * 4 + (29,), (28,) * 5 + (29,)):
        cfg = dict(ring_logn=9, limb_bits=bits, gadget="modraise")
        with pytest.raises(F.UsageError):
            RM.fhe_setup(RM.MNISTConfig(**cfg), jax.random.PRNGKey(0))
        with pytest.raises(UsageError):
            TM.fhe_setup(TM.MNISTConfig(**cfg), torch.Generator())
    tcfg = TM.MNISTConfig(ring_logn=9)
    TM.audit_pipeline_depth(tcfg, TM.make_params(tcfg), Fraction(2) ** 28)
