"""toyfhe_tpu_torch's plaintext training of the x²-CNN against the reference's.

On shared numpy parameters and batches, on the CPU:

* ``PlainCNN`` (float32, autograd) computes the reference's
  ``model_forward``, and the smoothed cross-entropy equals optax's (relative
  1e-6);
* ``warmup_cosine`` equals optax's ``warmup_cosine_decay_schedule`` at every
  update count for 80 and 300 steps (both in float32, in the same order of
  operations; relative 6e-7, five units in the last place, for XLA's
  float32 cosine against numpy's);
* three updates of clipped Adam on the warmup-cosine schedule, and one of
  plain Adam with a clipped gradient, equal optax's chain (relative 1e-5);
* the augmentation pool equals the one the reference's ``train`` builds, and
  the bilinear resize equals ``jax.image.resize`` (absolute 1e-6);
* ``train`` reaches > 0.9 held-out accuracy on the synthetic set in 80
  steps, as the reference's test does; the minibatch shift is
  ``jnp.roll``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toyfhe_tpu.models import mnist as RM
from toyfhe_tpu_torch.models import mnist as M

torch.set_num_threads(1)

SMALL = M.MNISTConfig(image=14, kernel=5, stride=3, channels=2, classes=4, ring_logn=9,
                      limb_bits=(30, 30, 28, 28, 28, 28, 28, 30), scale_log2=28,
                      gadget="modraise")
RSMALL = RM.MNISTConfig(image=14, kernel=5, stride=3, channels=2, classes=4, ring_logn=9,
                        limb_bits=(30, 30, 28, 28, 28, 28, 28, 30), scale_log2=28,
                        gadget="modraise")


def shared(seed, n=64):
    params = {k: v.astype(np.float32) for k, v in M.init_params(SMALL, seed).items()}
    params["conv_b"] = np.linspace(-0.1, 0.1, SMALL.channels).astype(np.float32)
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(n, SMALL.image, SMALL.image)).astype(np.float32)
    labels = rng.integers(0, SMALL.classes, n)
    return params, imgs, labels


def ref_loss(params, imgs, labels, smoothing):
    logits = RM.model_forward(RSMALL, params, imgs)
    onehot = jax.nn.one_hot(labels, RSMALL.classes)
    return optax.softmax_cross_entropy(
        logits, onehot * (1 - smoothing) + smoothing / RSMALL.classes).mean()


def test_forward_and_loss_equal_the_reference():
    params, imgs, labels = shared(1)
    model = M.PlainCNN(SMALL, params, "cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(imgs))
    want = RM.model_forward(RSMALL, {k: jnp.asarray(v) for k, v in params.items()}, imgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), M.model_forward(SMALL, params, imgs),
                               rtol=1e-4, atol=1e-4)
    for s in (0.0, 0.05):
        loss = torch.nn.functional.cross_entropy(got, torch.as_tensor(labels), label_smoothing=s)
        assert float(loss) == pytest.approx(float(ref_loss(params, imgs, labels, s)), rel=1e-6)


@pytest.mark.parametrize("steps", [80, 300])
def test_schedule_equals_optax(steps):
    lr = 1e-3
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, max(50, steps // 20), steps, lr * 0.05)
    sched = M.warmup_cosine(lr, steps)
    for count in range(steps + 5):
        assert sched(count) == pytest.approx(float(ref(count)), rel=6e-7, abs=0)
    assert sched(0) == 0.0


def run_optax(params, imgs, labels, opt, updates):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for _ in range(updates):
        grads = jax.grad(lambda q: ref_loss(q, imgs, labels, 0.05))(p)
        upd, state = opt.update(grads, state)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("case", ["schedule_clipped_3", "adam_clipped_1"])
def test_clipped_adam_equals_optax(case):
    params, imgs, labels = shared(2)
    # scaled weights make the gradient's global norm exceed 1, so the clip acts
    params["w2"] = params["w2"] * 4
    lr = 1e-3
    if case == "schedule_clipped_3":
        updates, sched = 3, M.warmup_cosine(lr, 300)
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
            optax.warmup_cosine_decay_schedule(0.0, lr, 50, 300, lr * 0.05)))
    else:
        updates, sched = 1, (lambda count: lr)
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    want = run_optax(params, imgs, labels, opt, updates)

    model = M.PlainCNN(SMALL, params, "cpu")
    topt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    x, y = torch.as_tensor(imgs), torch.as_tensor(labels)
    for count in range(updates):
        loss = M.train_step(model, topt, x, y, sched(count), clip=True, smoothing=0.05)
        if count == 0:
            norm = float(torch.sqrt(sum((p.grad * p.grad).sum() for p in model.parameters())))
            assert norm == pytest.approx(1.0)       # clipped from above 1
            assert float(loss) == pytest.approx(float(ref_loss(params, imgs, labels, 0.05)),
                                                rel=1e-6)
    got = model.params()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8, err_msg=k)
        assert not np.array_equal(got[k], params[k]) or k == "conv_b"


def test_clip_below_the_norm_leaves_the_gradient():
    p = torch.nn.Parameter(torch.tensor([0.3, 0.4]))
    p.grad = torch.tensor([0.3, 0.4])
    assert float(M.clip_by_global_norm_([p])) == pytest.approx(0.5)
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4]))
    p.grad = torch.tensor([3.0, 4.0])
    M.clip_by_global_norm_([p])
    assert torch.allclose(p.grad, torch.tensor([0.6, 0.8]))


def test_augmentation_pool_equals_the_references(monkeypatch):
    """The reference builds its pool inside ``train``: stop it where it
    compiles the update step and read the pool from the step's closure."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 1, (320, SMALL.image, SMALL.image)).astype(np.float32)
    labels = rng.integers(0, SMALL.classes, 320)

    class Captured(Exception):
        pass

    def capture(fn):
        cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
        raise Captured(cells)

    monkeypatch.setattr(jax, "jit", capture)
    with pytest.raises(Captured) as got:
        RM.train(RSMALL, jax.random.PRNGKey(0), steps=300, data=(imgs, labels))
    cells = got.value.args[0]
    assert cells["augment"]
    ntr = 320 * 4 // 5
    pool_i, pool_l = M.augmentation_pool(SMALL, imgs[:ntr], labels[:ntr])
    assert pool_i.shape == (9 * ntr, SMALL.image, SMALL.image) and pool_i.dtype == np.float32
    assert np.array_equal(pool_i, np.asarray(cells["imgs"]))
    assert np.array_equal(pool_l, np.asarray(cells["labels"]))


@pytest.mark.parametrize("shape", [(8, 28), (8, 14), (8, 8), (28, 14)])
def test_resize_equals_jax_image_resize(shape):
    n_in, n_out = shape
    imgs = np.random.default_rng(n_out).uniform(0, 1, (5, n_in, n_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(imgs), (5, n_out, n_out), "bilinear"))
    np.testing.assert_allclose(M.resize_bilinear(imgs, n_out), want, atol=1e-6, rtol=0)


def test_real_digits_equal_the_references():
    got, want = M.load_real_digits(SMALL), RM.load_real_digits(RSMALL)
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])


def test_shift_is_jnp_roll():
    imgs = np.arange(3 * 5 * 6, dtype=np.float32).reshape(3, 5, 6)
    dy, dx = np.array([-1, 0, 2]), np.array([1, -2, 0])
    got = M._shift(torch.as_tensor(imgs), torch.as_tensor(dy), torch.as_tensor(dx)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.roll(np.roll(imgs[i], dy[i], 0), dx[i], 1))


def test_plain_model_trains():
    data = M.synthetic_dataset(SMALL, torch.Generator().manual_seed(2), 256)
    params, acc = M.train(SMALL, torch.Generator().manual_seed(0), steps=80, data=data,
                          device="cpu")
    assert acc > 0.9, acc
    assert set(params) == {"conv_w", "conv_b", "w1", "b1", "w2", "b2"}
    assert params["w1"].shape == (SMALL.positions, SMALL.features)
