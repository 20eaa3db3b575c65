"""toyfhe_tpu_torch BSGS dense layers and the dual-flow serving pipeline
against the reference.

``encrypted_matmul_bsgs`` against ``encrypted_matmul`` and the plaintext
product on the fixture of tests/test_mnist.py, bit-equal to the reference's
on carried keys; at the small hybrid configuration of tests/test_layers.py
the pipeline with BSGS keys produces, from the same encrypted grid, a logits
ciphertext bit-equal to the reference's in the primal and in the dual flow
(which are bit-equal to each other) and logits within 1e-2 of the iterated
schedule's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
from toyfhe_tpu.models import mnist as RM
from toyfhe_tpu.parallel import layers as RL
from toyfhe_tpu_torch.core import bootstrap as TB
from toyfhe_tpu_torch.core import rlwe as trlwe
from toyfhe_tpu_torch.models import mnist as TM
from toyfhe_tpu_torch.parallel import layers as TL
from toyfhe_tpu_torch.utils import interop as I
import toyfhe_tpu_torch as T

from .test_torch_hoist import carry_keys, ct_duals
from .test_torch_mnist import SMALL, _FixedGrid, export_setup

torch.set_num_threads(1)

MODRAISE = dict(image=14, kernel=5, stride=3, channels=2, classes=4, ring_logn=9,
                limb_bits=(30, 30, 28, 28, 28, 28, 28, 30), scale_log2=28, gadget="modraise")


@pytest.mark.parametrize("d", [1, 2, 16, 17, 63, 64, 100])
def test_bsgs_split(d):
    from toyfhe_tpu.core import bootstrap as RB
    bs, gs = TB.bsgs_split(d)
    assert (bs, gs) == RB.bsgs_split(d) and bs * gs >= d


@pytest.fixture(scope="module", params=["modraise", "hybrid"])
def matmul(request):
    """tests/test_mnist.py's BSGS fixture, the keys carried across."""
    kw = MODRAISE if request.param == "modraise" else SMALL
    cfg, tcfg = RM.MNISTConfig(**kw), TM.MNISTConfig(**kw)
    kf, ke = jax.random.split(jax.random.PRNGKey(4), 2)
    setup = RM.fhe_setup(cfg, kf)
    tsetup = I.fhe_setup_from_numpy(tcfg, **export_setup(setup), device="cpu")
    gks = RM.keygen_matmul_bsgs(setup, jax.random.PRNGKey(6))
    tgks = carry_keys(setup.params, tsetup.params, gks)
    d = cfg.positions
    rng = np.random.default_rng(5)
    W, xfeat = rng.uniform(-1, 1, (d, d)), rng.uniform(-1, 1, d)
    slots = RM._rep_inner(xfeat, cfg.batch).astype(complex)
    c = F.encrypt(setup.kp, F.make_plaintext(setup.params.ring_cipher, slots, setup.scale), ke)
    tc = I.ciphertext(tsetup.params, tsetup.params.ring_cipher, ct_duals(c), setup.scale, device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, setup=setup, tsetup=tsetup, gks=gks, tgks=tgks, W=W,
                xfeat=xfeat, c=c, tc=tc)


def test_bsgs_keys(matmul):
    cfg, tcfg, gks, tgks = matmul["cfg"], matmul["tcfg"], matmul["gks"], matmul["tgks"]
    baby, giant = TM.bsgs_steps(tcfg)
    n = 1 << cfg.ring_logn
    want = sorted({F.galois_element_for_steps(n, s) for s in baby + giant})
    assert sorted(k.galois_element for k in gks.keys) == want
    own = TM.keygen_matmul_bsgs(matmul["tsetup"], torch.Generator().manual_seed(1))
    assert sorted(k.galois_element for k in own.keys) == want
    assert [k.galois_element for k in tgks.keys] == [k.galois_element for k in gks.keys]


def test_bsgs_matmul_matches_iterated_and_reference(matmul):
    setup, tsetup, W, tc = matmul["setup"], matmul["tsetup"], matmul["W"], matmul["tc"]
    before = dict(trlwe.hoist_counts)
    out = TM.encrypted_matmul_bsgs(tsetup, matmul["tgks"], W, tc)
    bs, gs = TB.bsgs_split(W.shape[1])
    assert trlwe.hoist_counts["decompositions"] - before["decompositions"] == gs
    assert trlwe.hoist_counts["key_products"] - before["key_products"] == bs + gs - 2
    want = RM.encrypted_matmul_bsgs(setup, matmul["gks"], W, matmul["c"])
    assert out.enc.scale == want.enc.scale == setup.scale ** 2
    np.testing.assert_array_equal(I.ciphertext_to_numpy(out), ct_duals(want))
    out_bsgs = T.decrypt(tsetup.kp, out).real
    out_iter = T.decrypt(tsetup.kp, TM.encrypted_matmul(tsetup, W, tc)).real
    expect = TM._rep_inner(W @ matmul["xfeat"], matmul["tcfg"].batch)
    np.testing.assert_allclose(out_bsgs, expect, atol=1e-3)
    np.testing.assert_allclose(out_bsgs, out_iter, atol=1e-3)


def test_iterated_matmul_matches_reference(matmul):
    W = matmul["W"][:, :]
    want = RM.encrypted_matmul(matmul["setup"], W, matmul["c"])
    got = TM.encrypted_matmul(matmul["tsetup"], W, matmul["tc"])
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got), ct_duals(want))


def test_bsgs_zero_and_sparse_weights(matmul):
    """Zero diagonals are skipped; an all-zero matrix gives the scale²-tagged
    zero ciphertext; merged term lists add by Galois element."""
    tsetup, tgks, tc = matmul["tsetup"], matmul["tgks"], matmul["tc"]
    d = matmul["W"].shape[1]
    zero = TM.encrypted_matmul_bsgs(tsetup, tgks, np.zeros((d, d)), tc)
    assert zero.enc.scale == tsetup.scale ** 2
    assert not any(T.ringops.ensure_dual(zero.ring, x).dual.any() for x in zero.cs)
    assert TM._bsgs_matmul_terms(tsetup, tgks, np.zeros((d, d)), tc) == []
    ident = TM._bsgs_matmul_terms(tsetup, tgks, np.eye(d), tc)
    assert [el for el, _ in ident] == [None]
    merged = TM._merge_bsgs_terms([ident, ident])
    assert [el for el, _ in merged] == [None]
    np.testing.assert_array_equal(I.ciphertext_to_numpy(merged[0][1]),
                                  I.ciphertext_to_numpy(T.ct_add(ident[0][1], ident[0][1])))
    want = RM.encrypted_matmul_bsgs(matmul["setup"], matmul["gks"], np.eye(d), matmul["c"])
    got = TM.encrypted_matmul_bsgs(tsetup, tgks, np.eye(d), tc)
    np.testing.assert_array_equal(I.ciphertext_to_numpy(got), ct_duals(want))


# ---------------------------------------------------------------------------
# the serving pipeline with BSGS keys
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg, tcfg = RM.MNISTConfig(**SMALL), TM.MNISTConfig(**SMALL)
    setup = RM.fhe_setup(cfg, jax.random.PRNGKey(5))
    tsetup = I.fhe_setup_from_numpy(tcfg, **export_setup(setup), device="cpu")
    gks = RM.keygen_matmul_bsgs(setup, jax.random.PRNGKey(9))
    tgks = carry_keys(setup.params, tsetup.params, gks)
    params = TM.init_params(tcfg, 3)
    imgs = np.random.default_rng(4).uniform(0.0, 1.0, (cfg.batch, cfg.image, cfg.image))
    I0 = RM.public_preprocess(cfg, imgs)
    ring0 = setup.params.ring_cipher
    pts = np.stack([np.asarray(F.ckks_encode(ring0, I0[i, j].astype(complex), setup.scale).primal)
                    for i in range(cfg.kernel) for j in range(cfg.kernel)])
    grid = np.asarray(RL.BatchEncryptor(setup.params, setup.kp.pub)(
        jnp.asarray(pts), jax.random.PRNGKey(6)))
    return dict(cfg=cfg, tcfg=tcfg, setup=setup, tsetup=tsetup, gks=gks, tgks=tgks,
                params=params, imgs=imgs, pts=pts, grid=grid)


@pytest.fixture(scope="module")
def port_cts(small):
    """The port's logits ciphertexts from the shared grid: the iterated
    schedule and the BSGS schedule in the primal and the dual flow."""
    orig = TL.BatchEncryptor
    TL.BatchEncryptor = lambda *a, **k: _FixedGrid(small["pts"], small["grid"], lambda g: I.tensor(g, "cpu"))
    try:
        out, counts = {}, {}
        for name, kw in (("iterated", {}),
                         ("primal", dict(gks_bsgs=small["tgks"], dual_flow=False)),
                         ("dual", dict(gks_bsgs=small["tgks"], dual_flow=True)),
                         ("default", dict(gks_bsgs=small["tgks"]))):
            run = TM.build_inference_pipeline(small["tsetup"], small["params"], **kw)
            before = dict(trlwe.hoist_counts)
            out[name] = run(small["imgs"], torch.Generator(), _return_ct=True)
            counts[name] = {k: trlwe.hoist_counts[k] - before[k] for k in before}
    finally:
        TL.BatchEncryptor = orig
    return out, counts


def test_bsgs_pipeline_dual_flow_bit_equal_to_primal(port_cts):
    out, _ = port_cts
    for name in ("dual", "default"):                  # the default is the dual flow
        assert out[name].ring.primes == out["primal"].ring.primes
        assert out[name].enc.scale == out["primal"].enc.scale
        for a, b in zip(out[name].cs, out["primal"].cs):
            assert torch.equal(a.dual, b.dual)


def test_bsgs_pipeline_counts(small, port_cts):
    """d = 16: (4, 4) split, 3 baby and 3 giant keys; the two channels ride
    one batched ciphertext."""
    _, counts = port_cts
    assert counts["iterated"] == dict.fromkeys(counts["iterated"], 0)
    want = {"decompositions": 2 + 3 + 1 + 3, "decompose_calls": 1 + 3 + 1 + 3,
            "key_products": 2 * 3 + 3 + 3 + 3, "key_product_calls": 3 + 3 + 3 + 3}
    assert counts["primal"] == counts["dual"] == want


def test_bsgs_pipeline_logits(small, port_cts):
    out, _ = port_cts
    tsetup, tcfg = small["tsetup"], small["tcfg"]
    logits = {k: T.decrypt(tsetup.kp, c).real.reshape(tcfg.positions, tcfg.batch)[:tcfg.classes].T
              for k, c in out.items()}
    plain = TM.model_forward(tcfg, small["params"], small["imgs"])
    assert np.abs(logits["dual"] - plain).max() < 0.5
    assert np.abs(logits["dual"] - logits["iterated"]).max() < 1e-2


@pytest.mark.parametrize("dual_flow", [False, True])
def test_bsgs_pipeline_ciphertext_bit_equal_to_reference(small, port_cts, monkeypatch, dual_flow):
    monkeypatch.setattr(RL, "BatchEncryptor",
                        lambda *a, **k: _FixedGrid(small["pts"], small["grid"], jnp.asarray))
    want = RM.build_inference_pipeline(small["setup"], small["params"], small["gks"],
                                       dual_flow=dual_flow)(
        small["imgs"], jax.random.PRNGKey(0), _return_ct=True)
    got = port_cts[0]["dual" if dual_flow else "primal"]
    assert got.ring.primes == want.ring.primes and got.enc.scale == want.enc.scale
    for g, w in zip(got.cs, want.cs):
        np.testing.assert_array_equal(I.to_numpy(g.dual), np.asarray(w.dual))


def test_pipeline_options(small):
    tsetup, params, tgks = small["tsetup"], small["params"], small["tgks"]
    with pytest.raises(ValueError):
        TM.build_inference_pipeline(tsetup, params, dual_flow=True)       # no BSGS keys
    with pytest.raises(TypeError):
        TM.build_inference_pipeline(tsetup, params, gks_bsgs=tgks, mesh=object())
    mcfg = TM.MNISTConfig(**MODRAISE)
    msetup = TM.fhe_setup(mcfg, torch.Generator().manual_seed(2))
    mgks = TM.keygen_matmul_bsgs(msetup, torch.Generator().manual_seed(3))
    with pytest.raises(ValueError):
        TM.build_inference_pipeline(msetup, TM.init_params(mcfg, 1), gks_bsgs=mgks,
                                    dual_flow=True)                       # not hybrid
    # BSGS keys without the hybrid gadget: the primal flow, by default
    imgs = small["imgs"]
    logits = TM.encrypted_inference_fast(msetup, small["params"], imgs,
                                         torch.Generator().manual_seed(4), gks_bsgs=mgks)
    assert np.abs(logits.T - TM.model_forward(mcfg, small["params"], imgs)).max() < 0.5


def test_no_diagonal_is_encoded_per_batch(small, monkeypatch):
    """Every weight diagonal is encoded when the pipeline is built: a batch
    encodes the input grid and nothing else."""
    tsetup, tcfg = small["tsetup"], small["tcfg"]
    run = TM.build_inference_pipeline(tsetup, small["params"], gks_bsgs=small["tgks"])
    calls = []
    real = TM.ckks_encode
    monkeypatch.setattr(TM, "ckks_encode", lambda *a, **k: calls.append(1) or real(*a, **k))
    from toyfhe_tpu_torch.core import ckks_encoding
    monkeypatch.setattr(ckks_encoding, "ckks_encode",
                        lambda *a, **k: calls.append(2) or real(*a, **k))
    run(small["imgs"], torch.Generator().manual_seed(1), _return_ct=True)
    assert calls == [1] * tcfg.kernel ** 2
