"""toyfhe_tpu_torch hybrid square → relinearize → rescale steps against the
reference's single-chip hybrid steps.

The three flavours — ``make_hybrid_sharded_step(None, ...)`` (v1), the same
with ``fused=True`` (the digit pipeline through the fused key switch K3)
and ``make_hybrid_fused_step`` (the fused transform schedule, ``merge_calls``
True and False) — on the fixture of tests/test_parallel.py (N=64, six
28-bit limbs in three groups plus two raising primes, real keys, batch 4),
at the full tower and one limb shorter; and ``fused=True`` at N=256 against
the reference's ``fused=False`` step, the reference's own equivalence
(tests/test_fused_keyswitch.py). Steps are bit-equal; decoded squares are
within 1e-3 (see the decrypt test for why not 2e-4 at this scale). Every
step's digit decomposition goes through ``ops.fbc_cuda.fbc``, once a step,
on one device and on two gloo ranks (``tests/torch_rank_cases.py``).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toyfhe_tpu as F
import toyfhe_tpu_torch as T
from toyfhe_tpu.parallel import ops as ref_ops
from toyfhe_tpu_torch.ops import fbc_cuda, hybrid_ks_cuda, ntt_cuda
from toyfhe_tpu_torch.parallel import ops as pops
from toyfhe_tpu_torch.utils import interop as I

from . import torch_rank_cases as RC
from .test_torch_hybrid import (carry_keys, ct_duals, hybrid_params, ref_eval_key,
                                synthetic_keys)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's hybrid fixture: N=64, (28,)*6 + (30, 30),
    dnum=3, k=2, keys from PRNGKey(1), four ciphertexts of vals·(i+1) at
    scale 2^26."""
    n, B = 64, 4
    ring, params = hybrid_params(F, n, 6, 2, 3)
    tring, tparams = hybrid_params(T, n, 6, 2, 3)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    kp = F.keygen(params, ks[0])
    ek = F.keygen_eval_mult(ks[1], kp.priv)
    vals = np.linspace(0.1, 1.0, n // 2)
    scale = Fraction(2) ** 26
    cts = [F.encrypt(kp, F.make_plaintext(params.ring_cipher, vals * (i + 1), scale), k)
           for i, k in enumerate(jax.random.split(ks[2], B))]
    batch = np.stack([ct_duals(params.ring_cipher, c) for c in cts])   # [B, 2, 6, N]
    tkp, tek = carry_keys(params, tparams, kp, ek)
    return dict(params=params, ek=ek, tparams=tparams, tkp=tkp, tek=tek,
                batch=batch, vals=vals, scale=scale)


def _ref_run(make, batch):
    step, place = make()
    return np.asarray(step(place(jnp.asarray(batch))))


def _port_run(make, batch):
    step, place = make()
    return I.to_numpy(step(place(batch)))


@pytest.mark.parametrize("short", [False, True])
def test_flavours_match_reference(setup, short):
    """v1 and the fused schedule (merge_calls True and False) against the
    reference's v1 and fused steps, at the full tower and at
    ``ct_ring=ring.drop_last()``; every flavour also with K3."""
    params, tparams, ek, tek = setup["params"], setup["tparams"], setup["ek"], setup["tek"]
    ring, tring = params.ring_cipher, tparams.ring_cipher
    batch = setup["batch"]
    if short:
        ring, tring = ring.drop_last(), tring.drop_last()
        batch = np.ascontiguousarray(batch[..., : ring.nlimbs, :])
    want = {m: _ref_run(lambda: ref_ops.make_hybrid_fused_step(params, ek, ring, m), batch)
            for m in (True, False)}
    if not short:        # the reference's v1 exists at the full tower only
        v1 = _ref_run(lambda: ref_ops.make_hybrid_sharded_step(None, params, ek), batch)
        np.testing.assert_array_equal(v1, want[True])
    for m in (True, False):
        got = _port_run(lambda: pops.make_hybrid_fused_step(tparams, tek, tring, m), batch)
        np.testing.assert_array_equal(got, want[m])
    for fused in (False, True):
        got = _port_run(lambda: pops.make_hybrid_sharded_step(
            None, tparams, tek, fused=fused, ct_ring=tring), batch)
        np.testing.assert_array_equal(got, want[True])
    got = _port_run(lambda: pops.make_hybrid_sharded_step(
        None, tparams, tek, fused_schedule=True, ct_ring=tring), batch)
    np.testing.assert_array_equal(got, want[True])
    assert not got[:, :, -1].any()                  # dropped limb zeroed


def test_step_matches_engine_and_decrypts(setup):
    """The fused-schedule step equals the port's own engine
    ct_rescale(keyswitch(ek, ct_mul(c, c))) on the surviving limbs, and
    decodes to the squares within 1e-3: the fixture's scale 2^26 leaves
    2^52/q_5 ≈ 2^24 after the rescale, where the relinearization noise
    reads as ~2e-4 (the reference's own output, bit-equal, reads the
    same)."""
    tparams, tek, tkp = setup["tparams"], setup["tek"], setup["tkp"]
    tring = tparams.ring_cipher
    L = tring.nlimbs
    out = _port_run(lambda: pops.make_hybrid_fused_step(tparams, tek), setup["batch"])
    sub = tring.drop_last()
    new_scale = setup["scale"] ** 2 / tring.primes[-1]
    for i, duals in enumerate(setup["batch"]):
        c = I.ciphertext(tparams, tring, duals, setup["scale"], device="cpu")
        seq = T.ct_rescale(T.keyswitch(tek, T.ct_mul(c, c)))
        np.testing.assert_array_equal(I.ciphertext_to_numpy(seq), out[i, :, :L - 1])
        got = T.decrypt(tkp, I.ciphertext(tparams, sub, out[i, :, :L - 1], new_scale, device="cpu"))
        np.testing.assert_allclose(got.real, (setup["vals"] * (i + 1)) ** 2, atol=1e-3)


def test_mesh_is_refused(setup):
    """A mesh that is not a ``sharding.Mesh`` is refused (the sharded
    steps themselves: tests/test_torch_sharding.py)."""
    with pytest.raises(TypeError):
        pops.make_hybrid_sharded_step(object(), setup["tparams"], setup["tek"])


@pytest.mark.parametrize("lt", [4, 3])
def test_fused_k3_step_matches_reference(lt):
    """``fused=True`` at N=256 (L=4, dnum=2, k=2, synthetic keys, batch 2)
    against the reference's ``fused=False`` step, and the port's three
    flavours against each other, at the full tower and at three limbs."""
    n = 256
    _, params = hybrid_params(F, n, 4, 2, 2, sp_bits=29)
    _, tparams = hybrid_params(T, n, 4, 2, 2, sp_bits=29)
    masks, maskeds = synthetic_keys(params, 2)
    ek = ref_eval_key(jnp, params, masks, maskeds)
    tek = I.eval_mult_key(tparams, masks, maskeds, device="cpu")
    ring, tring = params.ring_cipher, tparams.ring_cipher.select(range(lt))
    rng = np.random.default_rng(7)
    batch = rng.integers(0, min(ring.primes), (2, 2, lt, n)).astype(np.uint32)
    if lt == ring.nlimbs:
        want = _ref_run(lambda: ref_ops.make_hybrid_sharded_step(None, params, ek), batch)
    else:
        want = _ref_run(lambda: ref_ops.make_hybrid_fused_step(
            params, ek, ring.select(range(lt))), batch)
    for kw in (dict(fused=True), dict(fused=False), dict(fused_schedule=True)):
        got = _port_run(lambda: pops.make_hybrid_sharded_step(
            None, tparams, tek, ct_ring=tring, **kw), batch)
        np.testing.assert_array_equal(got, want)


def test_step_routes_transforms():
    """On the CPU every transform and the fused key switch take their plain
    twins: no kernel launch is counted."""
    _, tparams = hybrid_params(T, 32, 4, 2, 2, sp_bits=29)
    tek = I.eval_mult_key(tparams, *synthetic_keys(tparams, 3), device="cpu")
    before = dict(ntt_cuda.launches), dict(hybrid_ks_cuda.launches)
    step, place = pops.make_hybrid_sharded_step(None, tparams, tek, fused=True)
    out = step(place(np.zeros((1, 2, 4, 32), dtype=np.uint32)))
    assert out.shape == (1, 2, 4, 32) and out.dtype == torch.int64 and not out.any()
    assert (dict(ntt_cuda.launches), dict(hybrid_ks_cuda.launches)) == before


@pytest.fixture(scope="module")
def fbc_setup():
    """N=256, L=4, dnum=2, k=2, synthetic keys, batch 2, and the
    reference's single-chip v1 step on it."""
    n, L = 256, 4
    _, params = hybrid_params(F, n, L, 2, 2, sp_bits=29)
    _, tparams = hybrid_params(T, n, L, 2, 2, sp_bits=29)
    masks, maskeds = synthetic_keys(params, 5)
    ek = ref_eval_key(jnp, params, masks, maskeds)
    batch = np.random.default_rng(9).integers(
        0, min(params.ring_cipher.primes), (2, 2, L, n)).astype(np.uint32)
    want = _ref_run(lambda: ref_ops.make_hybrid_sharded_step(None, params, ek), batch)
    return dict(tparams=tparams, masks=masks, maskeds=maskeds, batch=batch, want=want,
                bits=(28,) * L + (29,) * 2, n=n)


@pytest.fixture(scope="module")
def fbc_ranks(fbc_setup, tmp_path_factory):
    """The two steps over rp 2 on two gloo ranks: rank 0's outputs, and
    every rank's count of ``fbc`` calls."""
    fx = fbc_setup
    inputs = dict(fbc_n=fx["n"], fbc_bits=np.asarray(fx["bits"]), fbc_dnum=2, fbc_k=2,
                  fbc_masks=fx["masks"], fbc_maskeds=fx["maskeds"], fbc_batch=fx["batch"])
    case = "hybrid_fbc_calls_rp2"
    arrays, infos = RC.spawn(tmp_path_factory.mktemp("fbc_calls"), inputs, [case], world=2)
    return arrays[case], [info[case] for info in infos]


@pytest.mark.parametrize("step", ["v1", "fused_merged", "fused_unmerged", "v1_rp2",
                                  "fused_rp2"])
def test_steps_decompose_through_fbc(fbc_setup, request, monkeypatch, step):
    """Each step calls ``fbc_cuda.fbc`` once for its one decomposition and
    stays bit-equal to the reference's v1 step: on one device the v1 step
    and the fused schedule with ``merge_calls`` True and False, over rp 2
    the v1 step and the fused schedule (counted on each rank)."""
    fx = fbc_setup
    if step.endswith("_rp2"):
        arrays, infos = request.getfixturevalue("fbc_ranks")
        name = step[:-len("_rp2")]
        assert [info[name] for info in infos] == [1, 1]
        np.testing.assert_array_equal(arrays[name], fx["want"])
        return
    real, calls = fbc_cuda.fbc, []
    monkeypatch.setattr(fbc_cuda, "fbc", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    tek = I.eval_mult_key(fx["tparams"], fx["masks"], fx["maskeds"], device="cpu")
    make = {"v1": lambda: pops.make_hybrid_sharded_step(None, fx["tparams"], tek),
            "fused_merged": lambda: pops.make_hybrid_fused_step(fx["tparams"], tek),
            "fused_unmerged": lambda: pops.make_hybrid_fused_step(fx["tparams"], tek,
                                                                  merge_calls=False)}[step]
    got = _port_run(make, fx["batch"])
    assert len(calls) == 1
    np.testing.assert_array_equal(got, fx["want"])
