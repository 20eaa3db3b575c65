"""toyfhe_tpu_torch's sharded MNIST serving pipeline against the reference's
(tests/test_sharded_pipeline.py).

The reference trains the model and builds its keys; both packages start
from the reference's own encrypted grid (each side's ``BatchEncryptor`` is
replaced by one that returns it). The reference runs its pipeline on one
device and over its dp 2 × rp 4 mesh; the port runs its pipeline on 8
spawned gloo ranks over dp 2 × rp 4 (``tests/torch_rank_cases.py``), on
the reference's keys. Every rank's logits ciphertext equals the port's
single-device pipeline's, and rank 0's equals the reference's bit for
bit; the labels agree with the plaintext model. The 49-ciphertext grid
is ``slow``, as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.models import mnist as M
from toyfhe_tpu.parallel import layers as RL
from jax.sharding import Mesh

from . import torch_rank_cases as RC
from .test_torch_hoist import ct_duals
from .test_torch_mnist import _FixedGrid, export_setup

torch.set_num_threads(1)

TINY = dict(image=8, kernel=4, stride=4, channels=2, classes=4, ring_logn=6)
GRID49 = dict(image=28, kernel=7, stride=3, channels=2, classes=4, ring_logn=9)


def _mesh(dp, rp):
    return Mesh(np.asarray(jax.devices()[: dp * rp]).reshape(dp, rp), ("dp", "rp"))


def _gks_arrays(setup, gks):
    kr = setup.params.ring_key
    from toyfhe_tpu.core import ring as rr
    dual = lambda x: np.asarray(rr.ensure_dual(kr, x).dual)
    return (np.asarray([k.galois_element for k in gks.keys]),
            np.stack([np.stack([dual(c.mask) for c in k.key.key]) for k in gks.keys]),
            np.stack([np.stack([dual(c.masked) for c in k.key.key]) for k in gks.keys]))


def _run_both(tmp, kw, prefix, steps, monkeypatch):
    """The reference's single-device and sharded logits ciphertexts, and the
    port's sharded run on the same keys, weights, images and grid."""
    cfg = M.MNISTConfig(**kw)
    kt, kf, ke = jax.random.split(jax.random.PRNGKey(2), 3)
    data = M.synthetic_dataset(cfg, jax.random.PRNGKey(8), 256)
    params, _ = M.train(cfg, kt, steps=steps, data=data)
    params = {k: np.asarray(v, dtype=np.float64) for k, v in params.items()}
    imgs = np.asarray(M.synthetic_dataset(cfg, jax.random.PRNGKey(3), cfg.batch)[0],
                      dtype=np.float64)
    setup = M.fhe_setup(cfg, kf)
    gks = M.keygen_matmul_bsgs(setup, jax.random.PRNGKey(9))
    I0 = M.public_preprocess(cfg, imgs)
    ring0 = setup.params.ring_cipher
    pts = np.stack([np.asarray(F.ckks_encode(ring0, I0[i, j].astype(complex),
                                             setup.scale).primal)
                    for i in range(cfg.kernel) for j in range(cfg.kernel)])
    grid = np.asarray(RL.BatchEncryptor(setup.params, setup.kp.pub)(jnp.asarray(pts), ke))
    monkeypatch.setattr(RL, "BatchEncryptor", lambda *a, **k: _FixedGrid(pts, grid, jnp.asarray))
    ref = M.build_inference_pipeline(setup, params, gks)(imgs, ke, _return_ct=True)
    sh = M.build_inference_pipeline(setup, params, gks, mesh=_mesh(2, 4))(imgs, ke,
                                                                          _return_ct=True)
    ref_ct, sh_ct = ct_duals(ref), ct_duals(sh)
    np.testing.assert_array_equal(sh_ct, ref_ct)          # the reference's own claim
    els, gm, gmd = _gks_arrays(setup, gks)
    inputs = {f"{prefix}_grid": grid.astype(np.int64), f"{prefix}_imgs": imgs,
              f"{prefix}_dp": 2, f"{prefix}_rp": 4, f"{prefix}_gks_elements": els,
              f"{prefix}_gks_masks": gm, f"{prefix}_gks_maskeds": gmd}
    for k, v in export_setup(setup).items():
        inputs[f"{prefix}_key_{k}"] = np.asarray(v)
    for k, v in kw.items():
        inputs[f"{prefix}_cfg_{k}"] = np.asarray(v)
    for k, v in params.items():
        inputs[f"{prefix}_param_{k}"] = v
    cases = {"pt": ["pipeline_tiny", "pipeline_tiny_iterated", "pipeline_tiny_primal"],
             "p49": ["pipeline_49"]}[prefix]
    arrays, infos = RC.spawn(tmp, inputs, cases)
    plain = np.asarray(M.model_forward(cfg, params, imgs))
    return cfg, ref_ct, arrays, infos, plain


def _check_flow(arrays, infos, case, plain):
    """A flow other than the reference's test's: every rank's logits
    ciphertext equal to the port's single-device pipeline's (which
    tests/test_torch_mnist*.py hold to the reference's)."""
    assert all(i[case]["equal_single"] for i in infos)
    assert np.array_equal(np.argmax(arrays[case]["logits"].T, -1), np.argmax(plain, -1))


def _check(cfg, ref_ct, got, infos, plain, max_err=None):
    np.testing.assert_array_equal(np.stack([got["c0"], got["c1"]]), ref_ct)
    assert all(i["equal_single"] for i in infos)
    logits = got["logits"].T                                  # [B, classes]
    assert np.array_equal(np.argmax(logits, -1), np.argmax(plain, -1))
    if max_err is not None:
        assert np.abs(logits - plain).max() < max_err
    # the collectives each rank issued: the conv's grid sum over 'dp' where
    # 'dp' splits the grid, the dense layer's channel sum, the sharded
    # square's two 'rp' sites and the gather of its rows
    sites = {"dense_channel_sum", "keyswitch_digit_share", "rescale_broadcast", "level_gather"}
    grid_cut = (cfg.kernel * cfg.kernel) % 2 == 0
    for info in infos:
        assert sites <= set(info["counts"])
        assert ("conv_grid_sum" in info["counts"]) == grid_cut


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return _run_both(tmp_path_factory.mktemp("pipeline"), TINY, "pt", 30, mp)


def test_sharded_pipeline_bit_equal(tiny):
    """dp 2 × rp 4 at the tiny geometry: logits ciphertext bit-equal to the
    reference's (single device and sharded) and to the port's single
    device; labels equal to the plaintext model's."""
    cfg, ref_ct, arrays, infos, plain = tiny
    _check(cfg, ref_ct, arrays["pipeline_tiny"], [i["pipeline_tiny"] for i in infos], plain)


@pytest.mark.parametrize("case", ["pipeline_tiny_iterated", "pipeline_tiny_primal"])
def test_sharded_pipeline_other_flows(tiny, case):
    """The iterated-rotation schedule and the BSGS primal flow over the same
    mesh: the dense layer's channel sum, the square layer on primal
    components."""
    _, _, arrays, infos, plain = tiny
    _check_flow(arrays, infos, case, plain)


@pytest.mark.slow
def test_sharded_pipeline_49ct_grid(tmp_path, monkeypatch):
    """The reference-shaped 49-ciphertext grid over dp 2 × rp 4 (the grid
    stays whole on 'dp', the channels are cut), bit-equal, logit error
    below 0.5."""
    cfg, ref_ct, arrays, infos, plain = _run_both(tmp_path, GRID49, "p49", 80, monkeypatch)
    _check(cfg, ref_ct, arrays["pipeline_49"], [i["pipeline_49"] for i in infos], plain,
           max_err=0.5)
