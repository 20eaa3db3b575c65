"""The frozen plain reference against the port's own plaintext pass."""

import numpy as np

from fhebench.reference import mnist_cnn as ref
from toyfhe_tpu_torch.models import mnist as M

MODEL = dict(image=28, kernel=7, stride=3, channels=4, classes=10, ring_logn=13)


def test_reference_equals_model_forward_at_the_served_size():
    cfg = M.MNISTConfig()
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0.0, 1.0, (cfg.batch, 28, 28))
    params = ref.init_params(MODEL, np.random.default_rng(9))
    np.testing.assert_allclose(ref.forward(MODEL, params, imgs),
                               M.model_forward(cfg, params, imgs), rtol=1e-12, atol=1e-12)
    assert ref.positions(MODEL) == cfg.positions == 64


def test_weights_follow_the_models_distributions():
    cfg = M.MNISTConfig()
    mine = ref.init_params(MODEL, np.random.default_rng(3))
    theirs = M.init_params(cfg, 3)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k])
