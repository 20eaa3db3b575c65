"""The encrypted ResNet of the port (``models/resnet.py``) against its plain
model (``models/resnet_plain.py``), seeded, on the CPU.

* In the clear, at the served size and at the toy one: the pipeline's
  layouts, weight folds, repacks and plans, applied to slot vectors, give
  the plain model's logits (batch norm, the input normalisation at the
  padded border, option-A shortcuts, pooling and FC).
* Each layer alone on ciphertexts at N = 2^7 (8×8 images at one channel a
  ciphertext, 4×4 at four): a stride-1 conv after a refresh's 2^52, a
  stride-2 conv and the masked repack to the next stage's layout, both
  option-A shortcuts, AppReLU with the configuration's own 15/15/27
  coefficients against the plain polynomial.
* The whole network on ciphertexts at the toy size — 8×8 images, widths
  (2, 4, 8), one block a stage, the composite refresh — against the plain
  model, and its three counters against their formulas.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from toyfhe_tpu_torch.core import ckks_encoding as CE
from toyfhe_tpu_torch.core import rlwe
from toyfhe_tpu_torch.models import mnist as M
from toyfhe_tpu_torch.models import resnet as RN
from toyfhe_tpu_torch.models import resnet_plain as P
from toyfhe_tpu_torch.models import sign_fit
from toyfhe_tpu_torch.utils import metrics

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1]
                     / "fhebench/configs/resnet20-cifar10.json").read_text())
FULL = CONFIG["model"]
TOY = dict(FULL, image=8, widths=[2, 4, 8], blocks_per_stage=1, classes=4, ring_logn=7)
TOY_DEGREES = (7, 7, 7)
TOY_RECIPE = dict(CONFIG["recipe"], depth=50)
N = 1 << TOY["ring_logn"]
SLOTS = N // 2


def clear_forward(model, params, img):
    """The pipeline in the clear: the same plans on slot vectors."""
    comps = model["relu"]["coeffs"]
    relu = lambda u: u * (1 + sign_fit.sign_approx(u, comps)) / 2
    slots = 1 << (model["ring_logn"] - 1)
    lays = RN.stage_layouts(model, slots)
    x = np.zeros((lays[0].n_ct, slots))
    for j, (s, c) in enumerate(lays[0].where):
        x[s, c * lays[0].hw:(c + 1) * lays[0].hw] = img[0, j].reshape(-1)
    x = RN.apply_plan(RN.conv_plan(*RN.stem_weights(model, params), lays[0], lays[1]), x)
    lin = lays[1]
    for i, width in enumerate(model["widths"]):
        for j in range(model["blocks_per_stage"]):
            name = f"s{i}.b{j}"
            x = relu(x)
            w1, b1 = RN.conv_weights(model, params, name + ".conv1")
            if i and not j:
                lfull, lout = RN.strided_layout(lin, width), lays[i + 1]
                h = RN.apply_plan(RN.repack_plan(lfull, lout, width),
                                  RN.apply_plan(RN.conv_plan(w1, b1, lin, lfull, 2), x))
                short = RN.apply_plan(RN.repack_plan(lin, lout, len(lin.where)), x)
            else:
                lout, short = lin, x
                h = RN.apply_plan(RN.conv_plan(w1, b1, lin, lout), x)
            h = RN.apply_plan(RN.conv_plan(*RN.conv_weights(model, params, name + ".conv2"),
                                           lout, lout), relu(h))
            h[:len(short)] += short
            x, lin = h, lout
    z = RN.apply_plan(RN.fc_plan(params["fc.w"] * model["bound"] / lin.hw, lin), relu(x))[0]
    for k in RN.pool_steps(lin.hw):
        z = z + np.roll(z, -k)
    return z[np.arange(model["classes"]) * lin.hw] + params["fc.b"]


@pytest.mark.parametrize("model", [FULL, TOY], ids=["served", "toy"])
def test_plans_in_the_clear_equal_the_plain_model(model):
    params = P.init_params(model, np.random.default_rng([2**31 + 9, 1]))
    img = np.random.default_rng(4).uniform(0.0, 1.0, (1, 3, model["image"], model["image"]))
    want = P.forward(model, params, img)[0]
    np.testing.assert_allclose(clear_forward(model, params, img), want, rtol=0, atol=1e-12)


def test_layouts_at_the_served_size():
    lays = RN.stage_layouts(FULL, 4096)
    assert [(l.side, l.cpc, l.n_ct) for l in lays] == [(32, 4, 1), (32, 4, 4), (16, 16, 2),
                                                          (8, 64, 1)]
    for lay, width in zip(lays[1:], FULL["widths"]):      # a permutation of the slots
        assert len(set(lay.where)) == width
        assert all(s < lay.n_ct and c < lay.cpc for s, c in lay.where)
    assert len(RN.rotation_shifts(FULL, 4096)) == 67


def test_batch_norm_fold():
    """conv + batch norm = the folded conv, and the first conv's fold of the
    input normalisation is exact at the zero-padded border."""
    rng = np.random.default_rng(8)
    params = P.init_params(TOY, rng)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (1, 3, 8, 8)))
    eps = TOY["bn_eps"]
    col = lambda v: torch.tensor(v, dtype=torch.float64)[:, None, None]
    norm = (x - col(TOY["mean"])) / col(TOY["std"])
    want = P._bn(P._conv(norm, params, "stem", 1), params, "stem", eps) / TOY["bound"]
    w, b = RN.stem_weights(TOY, params)
    got = torch.nn.functional.conv2d(x, torch.as_tensor(w), padding=1) + torch.as_tensor(b)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
    h = torch.as_tensor(rng.normal(size=(1, 2, 8, 8)))
    want = P._bn(P._conv(h, params, "s0.b0.conv2", 1), params, "s0.b0.conv2", eps)
    w, b = RN.conv_weights(TOY, params, "s0.b0.conv2")
    got = (torch.nn.functional.conv2d(h, torch.as_tensor(w), padding=1)
           + torch.as_tensor(b)[:, None, None] * TOY["bound"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)


@pytest.fixture(scope="module")
def keys():
    """A short composite tower at N = 2^7 and the toy's rotation keys."""
    params, _ = M.make_bootstrapped_params(types.SimpleNamespace(ring_logn=7), 26,
                                           hamming_weight=4, scale_limbs=2)
    gen = torch.Generator().manual_seed(21)
    kp = rlwe.keygen(params, gen)
    ek = rlwe.keygen_eval_mult(gen, kp.priv)
    gks = rlwe.GaloisKeys([rlwe.keygen_galois(gen, kp.priv, galois_element=RN.galois_element(N, s))
                           for s in RN.rotation_shifts(TOY, SLOTS)])
    return types.SimpleNamespace(params=params, kp=kp, ek=ek, gks=gks, gen=gen)


def encrypt(k, vecs, scale, limbs):
    ring = k.params.ring_cipher
    cts = [CE.ct_drop_to(rlwe.encrypt(k.kp, CE.make_plaintext(ring, v, scale), k.gen), limbs)
           for v in vecs]
    return rlwe.ct_stack(cts)


def decrypt(k, ct):
    return np.stack([rlwe.decrypt(k.kp, rlwe.ct_index(ct, i)).real
                     for i in range(RN._batch(ct))])


def to_slots(lay, x):
    """[C, side, side] → [n_ct, slots]."""
    out = np.zeros((lay.n_ct, SLOTS))
    for j, (s, c) in enumerate(lay.where):
        out[s, c * lay.hw:(c + 1) * lay.hw] = x[j].reshape(-1)
    return out


def from_slots(lay, v):
    return np.stack([v[s, c * lay.hw:(c + 1) * lay.hw].reshape(lay.side, lay.side)
                     for s, c in lay.where])


def test_conv_after_a_refresh(keys):
    """A stride-1 conv on a 2^52 input (two rescales) = torch's conv."""
    rng = np.random.default_rng(5)
    lay = RN.stage_layouts(TOY, SLOTS)[1]                     # 8×8, one channel a ciphertext
    x = rng.uniform(-0.5, 0.5, (2, 8, 8))
    w, b = rng.normal(size=(2, 2, 3, 3)) * 0.3, rng.normal(size=2) * 0.1
    ct = encrypt(keys, to_slots(lay, x), RN.BASE_SCALE, 6)
    out = RN.SlotMap(RN.conv_plan(w, b, lay, lay), keys.gks, 2)(ct)
    assert out.ring.nlimbs == 4
    want = torch.nn.functional.conv2d(torch.as_tensor(x)[None], torch.as_tensor(w),
                                      torch.as_tensor(b), padding=1)[0].numpy()
    np.testing.assert_allclose(from_slots(lay, decrypt(keys, out)), want, atol=1e-5)


def test_strided_conv_and_repack(keys):
    """A stride-2 conv to the even pixels (one limb: its output stays near
    2^52), then the masked repack into the next stage's layout (two) =
    torch's stride-2 conv."""
    rng = np.random.default_rng(6)
    lays = RN.stage_layouts(TOY, SLOTS)
    lin, lout = lays[1], lays[2]
    lfull = RN.strided_layout(lin, 4)
    x = rng.uniform(-0.5, 0.5, (2, 8, 8))
    w, b = rng.normal(size=(4, 2, 3, 3)) * 0.3, rng.normal(size=4) * 0.1
    ct = encrypt(keys, to_slots(lin, x), RN.BASE_SCALE, 6)
    full = RN.SlotMap(RN.conv_plan(w, b, lin, lfull, 2), keys.gks, 1)(ct)
    out = RN.SlotMap(RN.repack_plan(lfull, lout, 4), keys.gks, 2)(full)
    assert (RN._batch(full), RN._batch(out), out.ring.nlimbs) == (4, 1, 3)
    want = torch.nn.functional.conv2d(torch.as_tensor(x)[None], torch.as_tensor(w),
                                      torch.as_tensor(b), stride=2, padding=1)[0].numpy()
    np.testing.assert_allclose(from_slots(lout, decrypt(keys, out)), want, atol=1e-5)


@pytest.mark.parametrize("strided", [False, True])
def test_option_a_shortcut(keys, strided):
    """The block input added to the second conv's output: aligned by
    ``ct_to``, or (at a stride) its even pixels repacked, the new channels
    zero."""
    rng = np.random.default_rng(7)
    lays = RN.stage_layouts(TOY, SLOTS)
    lin, lout = (lays[1], lays[2]) if strided else (lays[1], lays[1])
    cout = len(lout.where)
    x = rng.uniform(-0.5, 0.5, (2, 8, 8))
    h = rng.uniform(-0.5, 0.5, (cout, lout.side, lout.side))
    xc = encrypt(keys, to_slots(lin, x), RN.BASE_SCALE, 6)
    ident = np.zeros((cout, cout, 3, 3))
    ident[np.arange(cout), np.arange(cout), 1, 1] = 1.0
    hc = RN.SlotMap(RN.conv_plan(ident, np.zeros(cout), lout, lout),
                    keys.gks, 2)(encrypt(keys, to_slots(lout, h), RN.BASE_SCALE, 6))
    if strided:
        out = RN._add_first(hc, RN.SlotMap(RN.repack_plan(lin, lout, 2), keys.gks, 2)(xc))
    else:
        out = rlwe.ct_add(hc, CE.ct_to(xc, hc.ring.nlimbs, hc.enc.scale))
    short = P._shortcut(torch.as_tensor(x)[None], cout, 2 if strided else 1)[0].numpy()
    np.testing.assert_allclose(from_slots(lout, decrypt(keys, out)), h + short, atol=1e-5)


def test_app_relu_against_the_plain_polynomial(keys):
    """AppReLU with the served configuration's 15/15/27 components on
    u ∈ [−1, 1]: 19 limbs, within 1e-5 of u·(1 + s(u))/2."""
    u = np.random.default_rng(9).uniform(-1.0, 1.0, (2, SLOTS))
    u[0, :8] = [0.0, 1e-5, -1e-5, 1e-3, -1e-3, 0.999, -0.999, 2.0 ** -13]
    ct = encrypt(keys, u, RN.WEIGHT_SCALE, 21)
    metrics.reset()
    out = RN.app_relu(keys.ek, ct, FULL["relu"]["coeffs"], {})
    assert out.ring.nlimbs == 2
    want = P.app_relu(torch.as_tensor(u), dict(FULL, bound=1.0)).numpy()
    np.testing.assert_allclose(decrypt(keys, out), want, atol=1e-5)
    # per ciphertext of the batch: each multiply of the batch of two counts twice
    assert metrics.counters["resnet.relu_ct_mults"] == 2 * metrics.counters["enc_mul"] > 0


def test_sign_fit_meets_its_precision():
    """The served coefficients: |AppReLU − ReLU| ≤ 2^−12.5 on [−1, 1], every
    component but the last within [−1, 1] there; a small fit by the same
    routine does what the toy needs."""
    comps = FULL["relu"]["coeffs"]
    assert [len(c) - 1 for c in comps] == FULL["relu"]["degrees"] == [15, 15, 27]
    assert sign_fit.relu_error(comps) < 2.0 ** -12.5
    x = np.linspace(-1.0, 1.0, 20001)
    for c in comps[:-1]:
        x = np.polynomial.chebyshev.chebval(x, c)
        assert np.abs(x).max() <= 1.0 + 1e-12
    assert sign_fit.relu_error(toy_coeffs()) < 2.0 ** -5


_TOY_COEFFS = []


def toy_coeffs():
    if not _TOY_COEFFS:
        _TOY_COEFFS.append(sign_fit.fit_composite_sign(TOY_DEGREES, alpha=6))
    return _TOY_COEFFS[0]


def test_whole_network_and_its_counters():
    """The toy ResNet on ciphertexts against the plain model on the same
    weights (the same AppReLU), and the request's counters against their
    formulas."""
    model = dict(TOY, relu=dict(alpha=6, degrees=list(TOY_DEGREES), coeffs=toy_coeffs()))
    params = P.init_params(model, np.random.default_rng([2**33 + 1, 1]))
    img = np.random.default_rng(10).uniform(0.0, 1.0, (1, 3, 8, 8))
    model["bound"] = 1.5 * P.relu_inputs_max(model, params, img)
    gen = torch.Generator().manual_seed(11)
    setup, ctx = RN.fhe_setup_resnet(model, TOY_RECIPE, gen)
    run = RN.build_resnet_pipeline(setup, ctx, params)
    metrics.reset()
    times = {}
    got = run(img, gen, layer_times=times)
    want = P.forward(model, params, img)
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got[:, 0], want[0], atol=2e-3 * np.abs(want).max())
    assert set(times) == {"encode", "encrypt", "conv", "relu", "modraise_c2s", "evalmod", "s2c",
                          "shortcut", "pool_fc", "decrypt"}

    lays = RN.stage_layouts(model, SLOTS)
    cts = [lay.n_ct for lay in lays[1:]]                       # 2, 1, 1 ciphertexts
    # a block refreshes its input and its first conv's output (the next
    # stage's layout at a stride); every refresh follows a ReLU, and one
    # more ReLU precedes the FC layer
    refresh = cts[0] + cts[0] + cts[0] + cts[1] + cts[1] + cts[2]
    counted = dict(metrics.counters)
    metrics.reset()
    RN.app_relu(ctx.ek, CE.ct_drop_to(rlwe.encrypt(setup.kp, CE.make_plaintext(
        setup.params.ring_cipher, np.zeros(SLOTS), RN.WEIGHT_SCALE), gen), 16),
        model["relu"]["coeffs"], {})
    one_relu = metrics.counters["resnet.relu_ct_mults"]
    assert counted["resnet.refresh_ciphertexts"] == refresh == 9
    assert counted["resnet.relu_ct_mults"] == (refresh + cts[2]) * one_relu
    # a degree-7 component: T2, T3 = T2·T1, q·T3, T6 = T3·T3, q·T6; then u·s(u)
    assert one_relu == 3 * 5 + 1
    assert counted["resnet.conv_rotations"] == conv_rotations(lays)


def conv_rotations(lays) -> int:
    """Rotations of the conv stages: per conv, the distinct nonzero tap
    shifts of each input ciphertext and, of each output, one rotation a
    nonzero channel offset between an input and an output channel slot;
    per stride-2 repack, side/2 − 1 column shifts of each source and, per
    output, side/2 − 1 row shifts for each group of sources (k of the four)
    and k − 1 channel shifts."""
    def taps(side):
        return len({(dy * side + dx) % SLOTS for dy in (-1, 0, 1) for dx in (-1, 0, 1)} - {0})

    def conv(lin, lout):
        offsets = {(ci - co) % lin.cpc for _, ci in lin.where for _, co in lout.where}
        return taps(lin.side) * lin.n_ct + lout.n_ct * len(offsets - {0})

    stem, s1, s2, s3 = lays
    total = conv(stem, s1) + 2 * conv(s1, s1)
    for lin, lout in ((s1, s2), (s2, s3)):
        full = RN.strided_layout(lin, 2 * len(lin.where))
        half, k = lin.side // 2, min(4, full.n_ct)
        total += conv(lin, full) + conv(lout, lout)
        total += full.n_ct * (half - 1) + lout.n_ct * (k * (half - 1) + k - 1)
    return total
